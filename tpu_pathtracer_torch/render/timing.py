"""Per-stage device timing of a frame with CUDA events.

``render_sample(..., timer=StageTimer())`` records an event pair around each
stage it runs (wavefront sort, nearest-hit walk, shadow walk, the whole
sample); :meth:`StageTimer.totals` then sums the milliseconds per stage name.
Without a timer the frame records nothing.  CUDA only.
"""

from __future__ import annotations

import contextlib

import torch


class StageTimer:
    def __init__(self):
        self._spans: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._spans.append((name, start, end))

    def totals(self) -> dict[str, float]:
        """Milliseconds per stage name, summed over every span recorded."""
        torch.cuda.synchronize()
        out: dict[str, float] = {}
        for name, start, end in self._spans:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out
