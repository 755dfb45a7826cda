"""The program's records of the traced slice's frames, and the device's idle
time inside the host spans they hold.

``Renderer.frame_records`` (tpu_pathtracer_torch/render/timing.py) keeps one
record a frame traced: its host reads, its shading launches and its spans,
each ``[name, start ns, end ns]`` on the host's wall clock.  The trace's
times are microseconds from the profiler's own base, which ``Trace`` does
not keep, so the spans move onto the trace's clock by one offset, found from
the program's own launches: the k-th ``shade_bounce_kernel`` of the slice
was launched (its ``cudaLaunchKernel``, on the trace's clock) inside the
k-th ``shade`` span (on the record's), near its end, and the k-th
``sort_key_kernel`` inside the k-th ``sort`` span, near its start; the
offsets every pair allows intersect in a window some microseconds wide.  (The slice range's start is
no anchor: the profiler's first range can hold the next one back by
milliseconds.)  The program's spans are also in the trace, as
``user_annotation`` ranges; ``Trace`` reads neither those nor their
``gpu_user_annotation`` shadows, so no earlier reading moves.

A program that keeps no records, and a slice not run on the card, give
None; each reader then returns None.
"""

from __future__ import annotations

import re
import statistics

# (span, kernel launched once inside each such span)
ANCHORS = (("shade", r"shade_bounce_kernel"), ("sort", r"sort_key_kernel"))


def slice_records(run) -> list[dict] | None:
    """The records of frames ``[slice_first, slice_first + slice_frames)``,
    or None unless the card ran the traced slice and the program recorded
    every frame of it."""
    if not run.cuda or run.trace is None:
        return None
    recs = getattr(run.renderer, "frame_records", None)
    if recs is None:
        return None
    first, n = run.slice_first, run.slice_frames
    got = [r for r in recs if first <= r["frame"] < first + n]
    return got if len(got) == n else None


def offset_window(trace, records: list[dict]) -> tuple[float, float, list[float]]:
    """(lo, hi, middles): the offsets (microseconds, trace minus record)
    that every anchor pair allows, and each pair's own middle.  An anchor
    counts only where the trace holds one of its launches a span."""
    lo, hi, mids = float("-inf"), float("inf"), []
    for name, kernel in ANCHORS:
        pat = re.compile(kernel)
        launches = sorted(at[1] for e, at in zip(trace.device, trace._launch)
                          if at is not None and pat.search(e["name"]))
        brackets = sorted((a * 1e-3, b * 1e-3)
                          for r in records for nm, a, b in r["spans"] if nm == name)
        if not launches or len(launches) != len(brackets):
            continue
        for t, (a, b) in zip(launches, brackets):
            lo, hi = max(lo, t - b), min(hi, t - a)
            mids.append(t - (a + b) / 2)
    return lo, hi, mids


def clock_offset(trace, records: list[dict]) -> float | None:
    """Microseconds to add to a record's time (in microseconds) to put it
    on the trace's clock: the middle of :func:`offset_window`, or, were it
    empty, the median of the pairs' middles; None without an anchor."""
    lo, hi, mids = offset_window(trace, records)
    if not mids:
        return None
    return (lo + hi) / 2 if lo <= hi else statistics.median(mids)


def span_intervals(records: list[dict], name: str, offset: float) -> list[tuple[float, float]]:
    """The records' ``name`` spans on the trace's clock (microseconds,
    ``offset`` from :func:`clock_offset`), in order of their start."""
    return sorted((a * 1e-3 + offset, b * 1e-3 + offset)
                  for r in records for nm, a, b in r["spans"] if nm == name)


def idle_gaps(trace) -> list[tuple[float, float]]:
    """The slice's intervals with no device activity (microseconds), as
    ``Trace.top_idle_gaps`` finds them."""
    gaps, prev = [], trace.t0
    for a, b in trace.busy():
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if trace.t1 > prev:
        gaps.append((prev, trace.t1))
    return gaps


def _merged(intervals) -> list[list[float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def idle_within(trace, intervals) -> float:
    """Seconds of device-idle time inside the host ``intervals``
    (microseconds on the trace's clock; where they overlap, counted once)."""
    total = 0.0
    spans, j = _merged(intervals), 0
    for g0, g1 in idle_gaps(trace):
        while j < len(spans) and spans[j][1] <= g0:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < g1:
            total += min(g1, spans[k][1]) - max(g0, spans[k][0])
            k += 1
    return total * 1e-6


def gaps_begun_in(trace, intervals) -> float:
    """Seconds of the idle gaps that begin inside one of the host
    ``intervals``, each counted whole."""
    spans = _merged(intervals)
    return sum(g1 - g0 for g0, g1 in idle_gaps(trace)
               if any(a <= g0 < b for a, b in spans)) * 1e-6
