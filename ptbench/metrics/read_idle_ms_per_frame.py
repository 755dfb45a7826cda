"""read_idle_ms_per_frame: the whole of each device-idle gap that begins
inside one of the program's ``host_read`` spans, a frame of the traced
slice (ptbench/spans.py): the device's wait for the host across a read."""

from ptbench import spans


def read(run):
    recs = spans.slice_records(run)
    if recs is None:
        return None
    off = spans.clock_offset(run.trace, recs)
    if off is None:
        return None
    idle = spans.gaps_begun_in(run.trace, spans.span_intervals(recs, "host_read", off))
    return idle * 1e3 / run.slice_frames
