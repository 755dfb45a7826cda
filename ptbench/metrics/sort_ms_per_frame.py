"""sort_ms_per_frame: device time a frame of the wavefront sort: the key
kernel, the kernels ``torch.sort`` launches (found by the ``aten::sort`` op
above them) and the plane gather."""

KERNELS = r"sort_key_kernel|gather_planes_kernel"


def read(run):
    if run.trace is None:
        return None
    s, n = run.trace.device_s(KERNELS, under="aten::sort")
    return s * 1e3 / run.slice_frames if n else None
