"""walk_ms_per_frame: device time a frame of every BVH walk kernel (the
window walk and its epilogue, fused and HBM forms; the capped, any-hit and
min walks; the sweeps)."""

KERNELS = r"walk\w*_kernel|sweep\w*_kernel"


def read(run):
    if run.trace is None:
        return None
    s, n = run.trace.device_s(KERNELS)
    return s * 1e3 / run.slice_frames if n else None
