"""device_idle_pct.serve: the share of a frame's wall time in which nothing
ran on the card: 1 - device busy a frame (the union of kernels, copies and
memsets, profiled) / wall time a frame (unprofiled), in %."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
