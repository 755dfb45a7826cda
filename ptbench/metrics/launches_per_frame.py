"""launches_per_frame: device activities (kernels, copies, sets) in the
traced slice over its frames."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return len(tr.device) / run.slice_frames
