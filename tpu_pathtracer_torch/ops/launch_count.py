"""The kernel wrappers' launch counters.

Each wrapper counts its launches on its own function object --
``fn.launches``, and a form's launches on ``fn.launches_<form>`` (``_mt``,
``_resolve``, ``_capped``) -- through :func:`count`; tests and chip_smoke.py
read them.  A bounce whose launches replay as a CUDA graph
(render/graphs.py) calls no wrapper, so its replays are counted from its
capture: :func:`recording` collects what the capture counted, and
:func:`add` adds that again for each replay, to the wrappers the capture
called (a wrapper swapped for another after the capture is not what the
graph runs, and gains nothing).
"""

from __future__ import annotations

import contextlib
from collections import Counter

_recordings: list[Counter] = []


def count(fn, n: int = 1, **forms) -> None:
    """``n`` launches of the wrapper ``fn``, each of the forms given true
    (``count(window_walk, mt=tritest == "mt")``)."""
    got = Counter({"launches": n})
    for form, on in forms.items():
        got[f"launches_{form}"] = n * int(on)
    for name, k in got.items():
        setattr(fn, name, getattr(fn, name) + k)
        for rec in _recordings:
            rec[fn, name] += k


@contextlib.contextmanager
def recording():
    """Collect, as ``{(wrapper, counter): launches}``, what the wrappers
    count inside."""
    rec = Counter()
    _recordings.append(rec)
    try:
        yield rec
    finally:
        _recordings.remove(rec)


def add(rec: Counter, times: int = 1) -> None:
    """Add ``times`` over the counts of a :func:`recording` (-1 takes them
    back)."""
    for (fn, name), k in rec.items():
        setattr(fn, name, getattr(fn, name) + times * k)
