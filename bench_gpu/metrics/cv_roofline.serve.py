"""cv_roofline.serve: the cost-volume calls' bound a frame (each call's
bytes at the memory's peak or its float32 operations at the CUDA cores',
whichever is longer; bench_gpu/flops.py) over the device time of the
port's cost-volume kernels a frame in the profile, in %. Nothing when the
profile holds none of those kernels."""


def read(t):
    busy = t.by_class.get("cost_volume", 0.0)
    return 100.0 * t.cv_bound_s / busy if busy > 0 else None
