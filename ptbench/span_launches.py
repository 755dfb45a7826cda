"""The device activities the program's own spans launch: those of the traced
slice whose launch (the runtime call, on the trace's clock) falls inside one
of the records' spans of a name, the spans moved onto the trace's clock as
ptbench/spans.py moves them.

A program that keeps no records or no such span, and a slice not run on the
card, give None.
"""

from __future__ import annotations

import bisect

from ptbench import spans


def launched_in(run, name: str) -> tuple[float, int] | None:
    """(seconds, count) of the slice's device activities launched inside
    the program's ``name`` spans, or None where there is no such span."""
    recs = spans.slice_records(run)
    if recs is None:
        return None
    off = spans.clock_offset(run.trace, recs)
    if off is None:
        return None
    merged = spans._merged(spans.span_intervals(recs, name, off))
    if not merged:
        return None
    starts = [a for a, _ in merged]
    total, count = 0.0, 0
    for e, at in zip(run.trace.device, run.trace._launch):
        if at is None:
            continue
        k = bisect.bisect_right(starts, at[1]) - 1
        if k >= 0 and at[1] <= merged[k][1]:
            total += float(e["dur"])
            count += 1
    return total * 1e-6, count
