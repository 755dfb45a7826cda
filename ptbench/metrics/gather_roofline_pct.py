"""gather_roofline_pct: the least time of one sort's gather at 3.35 TB/s
over the mean device time of a ``gather_planes_kernel`` launch.  The bytes
come from the cell's shapes (ptbench/bounds.py), never from the program."""

from ptbench import bounds


def read(run):
    if run.trace is None:
        return None
    s, n = run.trace.device_s(r"gather_planes_kernel")
    if not n:
        return None
    lanes = bounds.sort_lanes(run.height, run.width, run.traffic)
    least = bounds.least_seconds(bounds.gather_bytes(lanes, *bounds.carried_planes(run.traffic)))
    return 100.0 * least / (s / n)
