"""mfu.serve: the model's FLOPs a frame, counted from the configuration's
shapes (bench_gpu/flops.py), over the unprofiled wall time a frame and
the card's published bfloat16 dense peak, in %."""

from bench_gpu.flops import PEAK_BF16_FLOPS


def read(t):
    return 100.0 * t.flops / t.wall_s / PEAK_BF16_FLOPS
