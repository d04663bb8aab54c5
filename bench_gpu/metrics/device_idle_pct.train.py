"""device_idle_pct.train: the share of a step's wall time in which nothing
ran on the card: 1 - device busy a step (the union of kernels, copies and
memsets, profiled) / wall time a step (unprofiled), in %."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
