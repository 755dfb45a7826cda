"""hbm_resolve_ms_per_frame: device time a frame of the activities launched
inside the program's ``resolve`` spans: on the HBM route, the torch resolve
of the capped shadow queries' kernel rows
(ops/hopper_traverse.resolve_window_payload), read from the records' spans
and the device trace (ptbench/span_launches.py)."""

from ptbench import span_launches


def read(run):
    got = span_launches.launched_in(run, "resolve")
    if got is None:
        return None
    return got[0] * 1e3 / run.slice_frames
