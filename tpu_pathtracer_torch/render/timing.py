"""Spans and counters of a frame.

A frame traces only while a ``torch.profiler`` records (``Renderer.profile``,
the CLI's ``--profile-dir``, a benchmark's traced slice) or when a
:class:`StageTimer` is passed (``Renderer.step(timer=...)``, and
``render_frame``, ``sample_sum`` and ``render_sample``, which take the same
``timer``).  :func:`frame_trace` decides once a frame; otherwise the frame
carries ``None`` and every span site costs one ``is None`` test: no
allocation, no event, no record.

Spans, one fixed vocabulary (``SPANS``), nested as::

    frame                    Renderer.step
      keys                   the host key schedule (frame_rng_key, fold_in)
      prepare                a wavefront's host work: order, ids, jitter,
                             camera rays, hero bins, the initial state
        host_read            every transfer of the frame path that waits
                             for the device: the camera's three basis
                             vectors (a copy from pageable host memory
                             waits for the stream) ...
      host_read              ... the sort bounds' two .tolist() ...
      bounce                 each bounce (args: bounce, lanes)
        host_read            ... and the ladder's live count
        sort                 the wavefront sort
        walk_nearest | walk_shadow | walk_fused
        uniforms             the bounce's random numbers
        shade                the shading (args: bounce, lanes)
      restore                the raster scatter and the sample sum, and
                             the wavefront's add to the frame's sum
      accumulate             the running mean
      sync                   Renderer.sync

While tracing, each span is a ``torch.profiler.record_function`` range (on
the profiler's clock, beside the device activities; the args string rides
along, though the Chrome export of some torch versions drops it); with a
timer also the timer's CUDA-event pair (:meth:`StageTimer.totals`).

Counters: a :class:`FrameTrace` keeps the frame's spans (name, start and end
on the host's wall clock, ``time.time_ns``), its host reads and the seconds
spent in them, one dict a shading launch (its lanes, the live lanes that
entered it where the ladder read them, the carried planes, the form) and the
device tensors the frame computes anyway: each wavefront's traced rays and
each env-lit launch's env picks and misses (the shading's counts).  :func:`records` reads those tensors once, after the frames, in one
host read a device: tracing adds no launch and no host read to a frame.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

SPANS = ("frame", "keys", "prepare", "host_read", "bounce", "sort", "walk_nearest",
         "walk_shadow", "walk_fused", "uniforms", "shade", "restore", "accumulate", "sync")
_OFF = contextlib.nullcontext()


class StageTimer:
    """CUDA-event spans: one event pair a span, milliseconds summed per span
    name by :meth:`totals`.  CUDA only."""

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


class FrameTrace:
    """One frame's spans and counters while tracing is on (module docstring).
    ``timer``: anything with a ``span(name)`` context manager (a
    :class:`StageTimer`), given each span too."""

    def __init__(self, frame: int | None = None, timer=None):
        self.frame = frame
        self.timer = timer
        self.spans: list[tuple[str, int, int]] = []
        self.host_reads = 0
        self.host_read_s = 0.0
        self.launches: list[dict] = []
        self._rays: list[torch.Tensor] = []
        self._env: list[tuple[dict, torch.Tensor, torch.Tensor]] = []
        self._record: dict | None = None

    def span(self, name: str, **args) -> "_Span":
        return _Span(self, name, " ".join(f"{k}={v}" for k, v in args.items()) or None)

    def intersector(self, intersect):
        """``intersect`` with each query inside a walk span: nearest queries
        "walk_nearest", capped ones "walk_shadow"; the any-hit ``occlusion``
        hook passes through as "walk_shadow" and the fused walk ``fused`` as
        "walk_fused", when present."""
        def fn(o, d, active, t_max=None, coherent=False):
            with self.span("walk_nearest" if t_max is None else "walk_shadow"):
                return intersect(o, d, active, t_max=t_max, coherent=coherent)

        def spanned(name, hook):
            def call(*a):
                with self.span(name):
                    return hook(*a)
            return call

        for attr, name in (("occlusion", "walk_shadow"), ("fused", "walk_fused")):
            hook = getattr(intersect, attr, None)
            if hook is not None:
                setattr(fn, attr, spanned(name, hook))
        return fn

    def shading(self, bounce: int, state, scene, live: int | None, inline: bool,
                kernel: bool, env_counts=None) -> None:
        """Count one shading launch over the wavefront ``state`` (its lanes,
        carried planes and hero bins; the scene's env and dispersion);
        ``env_counts``: an env-lit launch's (picks, misses) int64 device
        scalars, read later."""
        launch = {"bounce": bounce, "lanes": state.alive.shape[0], "live": live,
                  "planes": state.throughput.shape[0], "hero": state.bins is not None,
                  "inline": inline, "env": scene.env is not None,
                  "dispersion": scene.mat_ior_bins is not None, "kernel": kernel,
                  "env_picks": None, "env_misses": None}
        self.launches.append(launch)
        if env_counts is not None:
            self._env.append((launch, *env_counts))

    def rays(self, n: torch.Tensor) -> None:
        """Keep a wavefront's traced rays (an int64 device scalar)."""
        self._rays.append(n)

    def _pending(self) -> list[torch.Tensor]:
        return self._rays + [t for _, picks, misses in self._env for t in (picks, misses)]

    def _fill(self, values: list[int]) -> dict:
        rays, env = values[:len(self._rays)], values[len(self._rays):]
        for k, (launch, _, _) in enumerate(self._env):
            launch["env_picks"], launch["env_misses"] = env[2 * k], env[2 * k + 1]
        self._record = {"frame": self.frame, "host_reads": self.host_reads,
                        "host_read_s": self.host_read_s,
                        "traced_rays": sum(rays) if rays else None,
                        "launches": self.launches,
                        "spans": [list(s) for s in self.spans]}
        self._rays, self._env = [], []
        return self._record


class _Span:
    """A span of a FrameTrace: the profiler's range, then the timer's span,
    the host clock read just inside both."""

    __slots__ = ("trace", "name", "range", "timed", "t0")

    def __init__(self, trace: FrameTrace, name: str, args: str | None):
        self.trace, self.name = trace, name
        self.range = record_function(name, args)
        self.timed = None if trace.timer is None else trace.timer.span(name)

    def __enter__(self):
        self.range.__enter__()
        if self.timed is not None:
            self.timed.__enter__()
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        trace = self.trace
        trace.spans.append((self.name, self.t0, t1))
        if self.name == "host_read":
            trace.host_reads += 1
            trace.host_read_s += (t1 - self.t0) * 1e-9
        if self.timed is not None:
            self.timed.__exit__(*exc)
        self.range.__exit__(*exc)


def records(traces: list[FrameTrace]) -> list[dict]:
    """The traces' records, their device counters read: one host read a
    device for every trace not read before."""
    todo = [t for t in traces if t._record is None]
    by_device: dict[torch.device, list[torch.Tensor]] = {}
    for t in todo:
        for x in t._pending():
            by_device.setdefault(x.device, []).append(x)
    values = {dev: iter(torch.stack(xs).tolist()) for dev, xs in by_device.items()}
    for t in todo:
        t._fill([next(values[x.device]) for x in t._pending()])
    return [t._record for t in traces]


def profiling() -> bool:
    """Whether a torch.profiler records now."""
    return torch.autograd._profiler_enabled()


def frame_trace(timer=None, frame: int | None = None) -> FrameTrace | None:
    """The frame's tracing: ``timer`` itself if it is a :class:`FrameTrace`;
    a new one given the timer, or while a profiler records; else None."""
    if isinstance(timer, FrameTrace):
        return timer
    if timer is not None or profiling():
        return FrameTrace(frame, timer)
    return None


def span(trace: FrameTrace | None, name: str, **args):
    """``trace.span(name, **args)``, or a context that does nothing when
    tracing is off."""
    return _OFF if trace is None else trace.span(name, **args)

