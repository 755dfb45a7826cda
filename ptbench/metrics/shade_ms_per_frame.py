"""shade_ms_per_frame: device time a frame of the shading kernel
(``shade_bounce_kernel``, every instance)."""

KERNELS = r"shade_bounce_kernel"


def read(run):
    if run.trace is None:
        return None
    s, n = run.trace.device_s(KERNELS)
    return s * 1e3 / run.slice_frames if n else None
