"""hbm_resolve_launches_per_frame: device activities (kernels, copies, sets)
a frame launched inside the program's ``resolve`` spans, the HBM route's
torch resolve of its capped shadow queries (ptbench/span_launches.py)."""

from ptbench import span_launches


def read(run):
    got = span_launches.launched_in(run, "resolve")
    if got is None:
        return None
    return got[1] / run.slice_frames
