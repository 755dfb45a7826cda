"""A torch.profiler trace of a slice of the window, reduced to what the
per-layer metrics read.

The slice is the host range ``ptbench.slice`` (a ``record_function`` the
harness puts around whole frames that start and end with the device idle).
Device activities are the trace's kernels, copies and sets that start
inside it.  A kernel's host stack is the chain of CPU ops around the runtime
call that launched it, matched by the trace's correlation ids, so a metric
can take ``torch.sort``'s kernels by the ``aten::sort`` above them.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SLICE = "ptbench.slice"


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list, at most 96
    characters."""
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:96].strip()


def _stacks(ops: list, times: list) -> list:
    """Innermost-last chains of the ``ops`` ((start, end, name), properly
    nested, one thread) that enclose each of ``times``."""
    order = sorted(range(len(times)), key=times.__getitem__)
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    out = [()] * len(times)
    stack, j = [], 0
    for qi in order:
        t = times[qi]
        while j < len(ops) and ops[j][0] <= t:
            while stack and stack[-1][1] < ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[qi] = tuple(o[2] for o in stack)
    return out


class Trace:
    def __init__(self, events: list):
        slices = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == SLICE]
        if not slices:
            raise ValueError(f"the trace holds no {SLICE} range")
        w = slices[-1]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = sorted(
            (e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
             and self.t0 <= float(e["ts"]) < self.t1),
            key=lambda e: float(e["ts"]))
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        ops = defaultdict(list)
        for e in events:
            if e.get("cat") == "cpu_op" and e.get("ph") == "X":
                ts = float(e["ts"])
                ops[e["tid"]].append((ts, ts + float(e.get("dur", 0.0)), e["name"]))
        self._ops = ops
        # each device activity's launch (thread, time), and its host stack
        self._launch = []
        for e in self.device:
            rt = launches.get(e.get("args", {}).get("correlation"))
            self._launch.append((rt["tid"], float(rt["ts"])) if rt else None)
        self.stacks = [()] * len(self.device)
        by_tid = defaultdict(list)
        for i, at in enumerate(self._launch):
            if at is not None:
                by_tid[at[0]].append(i)
        for tid, idx in by_tid.items():
            for i, st in zip(idx, _stacks(ops[tid], [self._launch[i][1] for i in idx])):
                self.stacks[i] = st
        self.main_tid = max(by_tid, key=lambda t: len(by_tid[t])) if by_tid else None

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def kernels(self) -> list:
        return [e for e in self.device if e.get("cat") == "kernel"]

    def device_s(self, name_re: str | None = None, under: str | None = None) -> tuple[float, int]:
        """(seconds, count) of the device activities whose name matches
        ``name_re``, or whose host stack holds the op ``under``."""
        pat = re.compile(name_re) if name_re else None
        total, count = 0.0, 0
        for e, st in zip(self.device, self.stacks):
            if (pat is not None and pat.search(e["name"])) or (under is not None
                                                               and under in st):
                total += float(e["dur"])
                count += 1
        return total * 1e-6, count

    def busy(self) -> list:
        """The union of the device activities, clipped to the slice, as
        merged (start, end) intervals in microseconds."""
        merged = []
        for e in self.device:
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            elif b > a:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def top_device_ops(self, k: int = 10) -> list:
        tot = defaultdict(float)
        for e in self.device:
            tot[short_name(e["name"])] += float(e["dur"]) * 1e-6
        return sorted(([n, s] for n, s in tot.items()), key=lambda x: -x[1])[:k]

    def top_idle_gaps(self, k: int = 10) -> list:
        """Idle time of the device by what the host was doing: the innermost
        op of the launching thread where the gap began ("python" outside
        every op), then the op that launched the activity that ended it (the
        activity itself where no op encloses its launch)."""
        busy = self.busy()
        starts = {float(e["ts"]): i for i, e in reversed(list(enumerate(self.device)))}
        gaps, prev = [], self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        begun = _stacks(self._ops.get(self.main_tid, []), [g0 for g0, _ in gaps])
        tot = defaultdict(float)
        for (g0, g1), st in zip(gaps, begun):
            i = starts.get(g1)
            if i is None:
                ended = "end of slice"
            else:
                # the program's own kernels launch under no torch op
                ended = (self.stacks[i][-1] if self.stacks[i]
                         else short_name(self.device[i]["name"]))
            name = f"{st[-1] if st else 'python'} -> {ended}"
            tot[name] += (g1 - g0) * 1e-6
        return sorted(([n, s] for n, s in tot.items()), key=lambda x: -x[1])[:k]
