"""The bounce chains (render/graphs.py, render/wavefront.py:render_sample) on
the CPU, through a stand-in capturer that runs a chain where a graph would
replay it: frames through the chains are bit-equal to the eager loop (rgb;
S = 16 with C = 4, dispersion and a sky map; fused 2 spp; a ladder over
three rungs and more; the fused walk; skipped sorts; the GGX and textured
box, water-ggx-textured), a frame meets one key
a bounce and a steady frame captures nothing, no tensor a chain allocates
reaches the next chain, the sort's two sets alternate, a traced frame's
record holds what the eager frame's does, a timed frame runs the chains
from Python, and a capture's launch counts come back on each replay.

The stand-in is the graph's model: its capture runs the chain with every
write to memory that existed before undone (a capture records launches, it
runs none), and its replay runs the chain again and writes what it hands
back into the tensors the capture handed back (a graph rewrites its own
memory).  While it is on, every operator is checked: none may read a tensor
that an earlier chain allocated and did not hand back."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.ops import launch_count
from tpu_pathtracer_torch.render import wavefront
from tpu_pathtracer_torch.render.graphs import ChainGraphs
from tpu_pathtracer_torch.render.wavefront import ladder_sizes
from tpu_pathtracer_torch.scene import attach_dispersion, attach_env, load_scene, scene_path
from torch_parity import SpanLog, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W, DEPTH = 48, 64, 4
# 3,072 lanes: the ladder halves three times at this secondary tile
LADDER = dict(max_path_length=DEPTH, secondary_tile=16)
CASES = {
    "rgb": LADDER,
    "spectral-env": dict(LADDER, spectrum_samples=16, hero_wavelengths=4),
    "spp2-fuse2": dict(LADDER, samples_per_frame=2, fuse_samples=2),
    "fused-walk": dict(LADDER, fuse_shadow_walk=True),
    "skip": dict(LADDER, sort_bounce_skip="2"),
    "ggx-textured": LADDER,
}


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class StaleRead(AssertionError):
    pass


class StandIn(TorchDispatchMode):
    """A capturer (render/graphs.py: ``CudaCapture``'s call) that runs the
    chain where a graph would replay it, and, entered as a dispatch mode,
    checks that nothing reads memory a finished chain allocated and did not
    hand back."""

    def __init__(self):
        super().__init__()
        self.captures = 0
        self.replays = 0
        self._stale: dict[int, torch.Tensor] = {}   # storage -> a tensor on it
        self._made: dict[int, torch.Tensor] | None = None
        self._undo: list | None = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        for x in flat:
            if _storage(x) in self._stale:
                raise StaleRead(f"{func} reads memory an earlier chain allocated")
        if self._undo is not None:
            given = [*zip(func._schema.arguments, args),
                     *((a, kwargs[a.name]) for a in func._schema.arguments if a.name in kwargs)]
            for arg, x in given:
                if arg.alias_info is None or not arg.alias_info.is_write:
                    continue
                for t in (x if isinstance(x, (list, tuple)) else [x]):
                    if isinstance(t, torch.Tensor) and _storage(t) not in self._made:
                        self._undo.append((t, t.clone()))
        out = func(*args, **kwargs)
        if self._made is not None:
            ins = {_storage(x) for x in flat}
            for y in tree_flatten(out)[0]:
                if isinstance(y, torch.Tensor) and y.numel() and _storage(y) not in ins:
                    self._made.setdefault(_storage(y), y)
        return out

    def _chain(self, fn, undo: bool):
        self._made, self._undo = {}, ([] if undo else None)
        try:
            got = fn()
        finally:
            made, changed = self._made, self._undo
            self._made = self._undo = None
        for x, saved in reversed(changed or []):
            x.copy_(saved)
        return got, made

    def _retire(self, made: dict, held) -> None:
        kept = {_storage(x) for x in held}
        # the tensors stay referenced, so their memory is not handed out again
        self._stale.update({k: v for k, v in made.items() if k not in kept})

    def __call__(self, fn):
        held, made = self._chain(fn, undo=True)
        self._retire(made, held)
        self.captures += 1

        def replay():
            got, made = self._chain(fn, undo=False)
            for h, x in zip(held, got):
                h.copy_(x)
            self._retire(made, held)
            self.replays += 1

        return replay, held


def _scene(case: str):
    if case == "ggx-textured":
        return load_scene(scene_path("water-ggx-textured"), device="cpu", rough_materials=True)
    scene = load_scene(scene_path("cornellbox"), device="cpu",
                       samples=CASES[case].get("spectrum_samples", 3))
    if case == "spectral-env":
        img = np.random.default_rng(7).uniform(0.2, 2.0, (16, 32, 3)).astype(np.float32)
        scene = attach_dispersion(attach_env(scene, img), 0.0042)
    return scene


def _renderer(case: str, stand_in: StandIn | None = None, **kw) -> Renderer:
    cfg = RenderConfig(**{**CASES[case], **kw})
    r = Renderer(_scene(case), W, H, cfg, seed=11, device="cpu")
    if stand_in is not None:
        r._capture = stand_in
        r.reset()
    return r


def _frames(r: Renderer, n: int) -> list[np.ndarray]:
    out = []
    for _ in range(n):
        r.step()
        out.append(r.image().copy())
    return out


def _graphs(r: Renderer) -> list[ChainGraphs]:
    return [g for g, _ in r._plans._graphs.values()]


@pytest.fixture
def stand_in():
    s = StandIn()
    with s:
        yield s


def test_renderer_reset_hands_the_capturer_to_its_plans(stand_in):
    """A Renderer given a capturer builds each wavefront's chain graphs and
    their fixed buffers when its plans are built, at reset: two full-width
    sets, the camera inputs, the uniform rows and the live count."""
    r = _renderer("rgb", stand_in)
    g, = _graphs(r)
    n = H * W
    assert g.capture is stand_in and not g._chains
    for state, pack in g.buffers.sets:
        assert state.origin.shape == (3, n) and state.bins is None
        assert pack.contrib.shape == (3, n) and pack.ok.dtype == torch.bool
    assert g.buffers.inputs[0].shape == (3, n) and g.buffers.inputs[2] is None
    assert g.buffers.uniforms.shape == (6 * n,) and g.buffers.live.shape == ()
    assert Renderer(_scene("rgb"), W, H, RenderConfig(**LADDER), device="cpu")._capture is None


@pytest.mark.parametrize("case", list(CASES))
def test_chain_frames_equal_the_eager_loop(case, stand_in):
    """Three frames through the chains -- the first captures, the later
    replay -- are bit-equal to the eager loop's, and a later frame replays
    every chain it met before."""
    want = _frames(_renderer(case), 3)
    r = _renderer(case, stand_in)
    got = _frames(r, 3)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert stand_in.captures > 0 and stand_in.replays > 0
    assert sum(g.captures + g.replays for g in _graphs(r)) == 3 * DEPTH * len(_graphs(r))


def test_ladder_over_three_rungs_equals_the_eager_loop(stand_in):
    """A deeper frame whose ladder visits at least three widths -- each a
    key of its own -- is bit-equal to the eager loop, frame after frame."""
    kw = dict(max_path_length=7)
    want = _frames(_renderer("rgb", **kw), 3)
    r = _renderer("rgb", stand_in, **kw)
    got = _frames(r, 3)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    widths = {s for b, s, *_ in _graphs(r)[0]._chains if b >= 1}
    assert len(widths) >= 3 and widths <= set(ladder_sizes(H * W, r.cfg))


def _records(r: Renderer, frames: int) -> list[dict]:
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(frames):
            r.step()
        r.sync()
    return r.frame_records


def test_a_frame_meets_a_key_a_bounce_and_a_steady_frame_captures_nothing(stand_in):
    """Each bounce is one key (bounce, width): the first frame captures one
    a bounce, at the widths the eager ladder picks, and a frame replays
    every key met before and captures only the new ones; a frame that meets
    no new key captures nothing and replays a chain a bounce."""
    eager = _renderer("rgb")
    eager.step(timer=SpanLog())
    widths = [x["lanes"] for x in eager.frame_records[0]["launches"]]
    r = _renderer("rgb", stand_in)
    g, = _graphs(r)
    recs = _records(r, 1)
    assert [k[:2] for k in g._chains] == list(enumerate(widths))
    assert (recs[0]["graph_captures"], recs[0]["graph_replays"]) == (DEPTH, 0)
    seen = set(g._chains)
    for _ in range(4):
        rec = _records(r, 1)[-1]
        new = set(g._chains) - seen
        seen |= new
        assert rec["graph_captures"] == len(new)
        assert rec["graph_replays"] == DEPTH - len(new)
    steady = [rec for rec in r.frame_records[1:] if rec["graph_captures"] == 0]
    assert steady and all(rec["graph_replays"] == DEPTH for rec in steady)


@pytest.mark.parametrize("case", ["rgb", "spectral-env", "spp2-fuse2", "ggx-textured"])
def test_a_traced_frame_through_the_chains_records_what_the_eager_frame_does(case,
                                                                              stand_in):
    """A traced frame whose chains replay keeps the record the eager frame
    keeps: its shading launches (lanes, the ladder's live read, planes,
    hero, env, rough, textured, kernel, env picks and misses, GGX and
    textured lanes), traced rays and host reads;
    and it holds a shade span a replay and a sort span a sorting replay."""
    eager = _renderer(case)
    r = _renderer(case, stand_in)
    _frames(eager, 2)
    _frames(r, 2)
    want = _records(eager, 1)[-1]
    got = _records(r, 1)[-1]
    assert got["graph_captures"] == 0 and got["graph_replays"] == want["graph_replays"] + (
        DEPTH * len(_graphs(r)))
    for k in ("host_reads", "traced_rays", "launches", "hbm_walks", "plan_builds"):
        assert got[k] == want[k], k
    if case == "ggx-textured":
        assert all(x["ggx_lanes"] > 0 and x["tex_lanes"] > 0 for x in got["launches"][:2])
    names = [s[0] for s in got["spans"]]
    assert names.count("shade") == DEPTH * len(_graphs(r))
    assert names.count("sort") == (DEPTH - 1) * len(_graphs(r))


def test_no_tensor_a_chain_allocates_reaches_the_next_chain(stand_in):
    """While frames run through the chains, no operator -- in a later chain
    or between chains -- reads memory that a finished chain allocated and
    did not hand back (the stand-in raises); the check catches a chain
    whose output is read later."""
    r = _renderer("rgb", stand_in)
    _frames(r, 3)
    assert stand_in.replays >= DEPTH

    leaked = []

    def chain():
        t = torch.arange(4.0)
        leaked.append(t)
        return (t.sum(),)

    stand_in(chain)
    with pytest.raises(StaleRead):
        leaked[0] + 1


def test_the_sorts_two_sets_alternate(stand_in, monkeypatch):
    """The sort after bounce b reads set b % 2 and writes set (b + 1) % 2,
    once a sort, from Python (no chain holds it): the sets ping-pong by the
    bounce's parity, and a skipped sort keeps the set."""
    dst = []
    sort = wavefront.sort_wavefront

    def spy(state, wmin, winv, pack, out=None):
        assert state.origin is g.buffers.sets[1 - ids.index(id(out[0].origin))][0].origin
        dst.append(out)
        return sort(state, wmin, winv, pack, out=out)

    monkeypatch.setattr(wavefront, "sort_wavefront", spy)
    for case, sets_of in (("rgb", [1, 0, 1]), ("skip", [1, 0])):
        r = _renderer(case, stand_in)
        g, = _graphs(r)
        ids = [id(state.origin) for state, _ in g.buffers.sets]
        dst.clear()
        r.step()
        r.sync()
        assert [ids.index(id(out[0].origin)) for out in dst] == sets_of


def test_a_timed_frame_runs_the_chains_from_python(stand_in):
    """A frame a timer times (a StageTimer on the card) runs the same chains
    on the same fixed buffers, called from Python: it captures and replays
    nothing, spans every stage (the walks, uniforms and shading inside each
    bounce), and the frames before, among and after such frames stay
    bit-equal to the eager loop's."""
    want = _frames(_renderer("rgb"), 4)
    r = _renderer("rgb", stand_in)
    g, = _graphs(r)
    got, logs = [], []
    for i in range(4):
        log = SpanLog() if i in (0, 2) else None
        before = (g.captures, g.replays)
        r.step(timer=log)
        got.append(r.image().copy())
        if log is not None:
            logs.append(log.names)
            assert (g.captures, g.replays) == before
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert g.captures == DEPTH and g.replays == DEPTH
    for names in logs:
        assert names.count("bounce") == names.count("uniforms") == DEPTH
        assert names.count("shade") == DEPTH and names.count("sort") == DEPTH - 1


def test_launch_counts_of_a_capture_come_back_on_each_replay():
    """ops/launch_count.py: a count adds ``n`` launches and ``n`` to each
    form given true; a recording collects what was counted inside it, and
    adding it again (a replay) or taking it back (-1: a capture, which
    launches nothing) moves the wrappers it counted, and no other."""

    def wrapper():
        pass

    def other():
        pass

    wrapper.launches = wrapper.launches_mt = other.launches = 0
    with launch_count.recording() as rec:
        launch_count.count(wrapper, mt=True)
        launch_count.count(wrapper, 2, mt=False)
    launch_count.count(other)
    assert (wrapper.launches, wrapper.launches_mt, other.launches) == (3, 1, 1)
    assert rec == {(wrapper, "launches"): 3, (wrapper, "launches_mt"): 1}
    launch_count.add(rec, -1)
    assert (wrapper.launches, wrapper.launches_mt) == (0, 0)
    launch_count.add(rec)
    launch_count.add(rec)
    assert (wrapper.launches, wrapper.launches_mt, other.launches) == (6, 2, 1)
