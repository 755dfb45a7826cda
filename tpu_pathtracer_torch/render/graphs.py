"""Each bounce's launch chain, captured once as a CUDA graph and replayed.

A sorted frame waits for the device once a bounce, where the live-prefix
ladder reads its live count (render/wavefront.py:render_sample).  After
each read the host would issue the next bounce's launches one at a time --
the hand kernels and the glue between them (ATen copies, fills and
``where``s, the ladder's prefix copies and splices) -- while the device
waits.  Here a bounce's launches from its cut to its live count, a
*chain*, are captured the first time their key is met and replayed in
every later frame: one graph launch in place of the chain's.

A chain reads and writes the renderer's fixed buffers (the wavefront's
state and shadow pack in two sets, the camera inputs, the uniforms and the
live count, allocated outside every graph; render/wavefront.py:
``ChainBuffers``) and the memory of its own capture, and nothing else; no
tensor it allocates is read after the next replay, except the device
counters a capture hands back (:meth:`ChainGraphs.run`), which stay
allocated, so no later capture takes their memory.  What a frame keys on
stays outside: the uniforms take the frame's key and index as host
scalars, so they are drawn before each replay into the buffer the chain
reads.  The sort between two bounces stays outside too, launched from
Python after the replay (``torch.sort``'s passes run under its own
``aten::sort`` op, where a trace finds them), from one set into the other.

:class:`CudaCapture` captures on the card; a stand-in with the same call
(tests/test_torch_bounce_graphs.py) runs the chain where a graph would
replay it.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import launch_count
from .timing import FrameTrace, span


class CudaCapture:
    """Capture ``fn`` as a ``torch.cuda.CUDAGraph`` on a side stream, in one
    memory pool for every graph of its renderer -> (replay, the tensors
    ``fn`` returned while captured, which each replay rewrites).

    The pool belongs to a one-fill graph the capturer keeps: the caching
    allocator releases a pool when its last graph dies (a Renderer's reset,
    a rebuilt plan), and a later capture into it would fail."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = None
        self._anchor = None

    def _capture(self, graph, fn, pool=None):
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=pool)
            try:
                held = fn()
            finally:
                graph.capture_end()
        here.wait_stream(self.stream)
        return held

    def __call__(self, fn):
        if self._anchor is None:
            self.stream = torch.cuda.Stream(self.device)
            anchor = torch.cuda.CUDAGraph()
            self._anchor = anchor, self._capture(
                anchor, lambda: torch.zeros(1, device=self.device))
        graph = torch.cuda.CUDAGraph()
        held = self._capture(graph, fn, self._anchor[0].pool())
        return graph.replay, held


class ChainGraphs:
    """One wavefront's captured chains, by key, and the fixed ``buffers``
    they run on.  ``capture``: :class:`CudaCapture`, or a stand-in."""

    def __init__(self, capture, buffers):
        self.capture = capture
        self.buffers = buffers
        self.captures = 0
        self.replays = 0
        self._chains: dict = {}

    def run(self, key, chain, trace: FrameTrace | None, intersect, raw, live,
            spans: tuple = ()):
        """This frame's run of the chain ``chain(trace, intersect) -> its
        traced rays`` (an int64 device scalar) -> its device counters: the
        rays, then, where it replayed, the counts of the shading launches
        it added to ``trace`` (FrameTrace.replayed: env picks and misses,
        GGX and textured lanes).  A
        key met before replays its graph inside ``spans`` ((name, args)
        each), adds what its capture recorded to ``trace`` (``live``: this
        frame's ladder read) and to the kernel wrappers' launch counters
        (ops/launch_count.py), and hands back the counters its capture
        kept, which the replay rewrote.  A new key runs the chain eagerly
        -- the frame's own work, traced as any eager chain, and every lazy
        initialisation done -- then captures it with a trace of its own and
        the raw intersector ``raw``; the capture launches nothing, so the
        counts it made are taken back."""
        got = self._chains.get(key)
        if got is not None:
            replay, rec, held, counted = got
            with contextlib.ExitStack() as stack:
                for name, args in spans:
                    stack.enter_context(span(trace, name, **args))
                replay()
            launch_count.add(counted)
            if trace is not None:
                trace.replayed(rec, live)
            self.replays += 1
            return held
        out = chain(trace, intersect)
        recs = []

        def captured():
            # the chain's device counters: its rays, then its shading
            # launches' counts, which the replays rewrite
            rec = FrameTrace()
            recs.append(rec)
            return (chain(rec, rec.intersector(raw)), *rec.counters())

        with launch_count.recording() as counted:
            replay, held = self.capture(captured)
        launch_count.add(counted, -1)
        self._chains[key] = (replay, recs[0], held, counted)
        self.captures += 1
        if trace is not None:
            trace.graph_captures += 1
        return (out,)
