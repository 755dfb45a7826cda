"""prepare_idle_ms_per_frame: device-idle time inside the program's
``prepare`` spans (a wavefront's host work before its bounces: pixel order,
ids, jitter, camera rays, hero bins, the initial state), a frame of the
traced slice (ptbench/spans.py)."""

from ptbench import spans


def read(run):
    recs = spans.slice_records(run)
    if recs is None:
        return None
    off = spans.clock_offset(run.trace, recs)
    if off is None:
        return None
    idle = spans.idle_within(run.trace, spans.span_intervals(recs, "prepare", off))
    return idle * 1e3 / run.slice_frames
