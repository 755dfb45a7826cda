"""The frame's spans and counters (render/timing.py) on the CPU: a profiled
frame holds the span vocabulary nested as the module says, tracing leaves
the image bit for bit, ``Renderer.step`` forwards a timer, and the records
count what the frame did (traced rays, the ladder's lanes, host reads) and
exist only while tracing."""

import json
import os
from collections import Counter

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.render.stats import count_traced_rays_exact
from tpu_pathtracer_torch.render.timing import SPANS
from tpu_pathtracer_torch.render.wavefront import _rung, ladder_sizes
from torch_parity import SpanLog, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W, DEPTH = 48, 64, 4
# the live-prefix ladder engages at this size: 3,072 lanes halve three times
LADDER = dict(max_path_length=DEPTH, secondary_tile=16)
PIPELINES = {"sorted": LADDER, "unsorted": dict(LADDER, sort_rays=False),
             "prefix": dict(LADDER, prefix_sort=True)}


def _renderer(**kw):
    return Renderer("cornellbox", W, H, RenderConfig(**kw), seed=5, device="cpu")


def _profiled(r, frames: int, tmp):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(frames):
            r.step()
        r.sync()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]


def _tree(events):
    """Each range -> (name, parent's name or None, index of its frame)."""
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in events), key=lambda x: (x[0], -x[1]))
    stack, out, frame = [], [], -1
    for a, b, name in ranges:
        while stack and stack[-1][1] < b:
            stack.pop()
        frame += name == "frame"
        out.append((name, stack[-1][2] if stack else None, frame))
        stack.append((a, b, name))
    return out


@pytest.mark.parametrize("pipeline", ["sorted", "unsorted"])
def test_profiled_frame_holds_the_spans_nested(pipeline, tmp_path):
    """Under torch.profiler (CPU activity) a frame's ranges are the
    vocabulary of render/timing.py, nested as it says: keys, prepare (the
    camera's three host transfers in it), the sort bounds' two reads, one
    bounce per bounce, restore and accumulate inside frame;
    in each bounce one uniforms, one walk_nearest and one shade; on the
    sorted pipeline bounces 1.. also one sort, one ladder read and one
    walk_shadow (the deferred shadow query), on the unsorted one each bounce
    its own walk_shadow; the frame's sync inside it."""
    r = _renderer(**PIPELINES[pipeline], frames_in_flight=1)
    tree = _tree(_profiled(r, 2, str(tmp_path)))
    assert {n for n, _, _ in tree} <= set(SPANS)
    frames = [[(n, p) for n, p, f in tree if f == k] for k in range(2)]
    for spans in frames:
        top = Counter(n for n, p in spans if p == "frame")
        sort = pipeline == "sorted"
        # restore twice: the wavefront's scatter, then its add to the frame's sum
        assert top == Counter({"keys": 1, "prepare": 1, "bounce": DEPTH, "restore": 2,
                               "accumulate": 1, "sync": 1, "host_read": 2 * sort})
        assert [n for n, p in spans if p is None] == ["frame"]
        inner = Counter(n for n, p in spans if p == "bounce")
        reads = DEPTH - 1 if sort else 0
        assert inner == Counter({"uniforms": DEPTH, "walk_nearest": DEPTH, "shade": DEPTH,
                                 "sort": reads, "host_read": reads,
                                 "walk_shadow": DEPTH - 1 if sort else DEPTH})
        assert Counter(n for n, p in spans if p == "prepare") == Counter({"host_read": 3})
        assert not [n for n, p in spans if p not in ("frame", "bounce", "prepare", None)]


@pytest.mark.parametrize("pipeline", ["sorted", "unsorted"])
def test_tracing_leaves_the_image_bit_equal(pipeline, tmp_path):
    """The same frames untraced, profiled and timed give the same image bit
    for bit."""
    images = []
    for how in ("off", "profiler", "timer"):
        r = _renderer(**PIPELINES[pipeline])
        if how == "profiler":
            _profiled(r, 2, str(tmp_path))
        else:
            for _ in range(2):
                r.step(**({"timer": SpanLog()} if how == "timer" else {}))
        images.append(r.image())
        assert len(r.frame_records) == (0 if how == "off" else 2)
    for img in images[1:]:
        np.testing.assert_array_equal(img.view(np.int32), images[0].view(np.int32))


def test_step_forwards_the_timer():
    """Renderer.step(timer=...) hands every span of the frame to the timer,
    the same spans the frame's record holds."""
    r = _renderer(**LADDER, frames_in_flight=1)
    timer = SpanLog()
    r.step(timer=timer)
    rec, = r.frame_records
    assert Counter(timer.names) == Counter(s[0] for s in rec["spans"])
    assert timer.names[0] == "frame" and {"sync", "shade", "host_read"} <= set(timer.names)
    assert rec["frame"] == 0 and rec["host_reads"] == 3 + 2 + DEPTH - 1
    assert all(s[1] <= s[2] for s in rec["spans"])


@pytest.mark.parametrize("kw", [{}, {"samples_per_frame": 2, "fuse_samples": 2},
                                {"samples_per_frame": 2, "fuse_samples": 1},
                                {"row_tiles": 2}],
                         ids=["1spp", "fused", "unfused", "row-tiles"])
def test_records_count_the_traced_rays(kw):
    """Each record's traced rays equal count_traced_rays_exact on the same
    frame, whatever the frame's wavefronts (fused samples, one a sample,
    row tiles)."""
    r = _renderer(**LADDER, **kw)
    r.step()
    for _ in range(2):
        r.step(timer=SpanLog())
    recs = r.frame_records
    assert [x["frame"] for x in recs] == [1, 2]
    for rec in recs:
        want = count_traced_rays_exact(r.scene, r.cfg, H, W, frame_indices=(rec["frame"],),
                                       intersect=r._intersect, camera=r.camera, seed=5)
        assert rec["traced_rays"] == want > 0


@pytest.mark.parametrize("pipeline", ["sorted", "prefix", "unsorted"])
def test_recorded_lanes_follow_the_ladder(pipeline):
    """Each shading launch's lanes are the ladder's width at the rung taken:
    on the sorted pipeline the rung of the live lanes it read after the
    sort, with prefix sorts the rung of the bounce before's (the sort runs
    at the trailing rung); bounce 0 and every unsorted bounce run the whole
    wavefront.  The live count is the ladder's read, bounce 0's every lane,
    and none where nothing was read; host reads are the camera's three
    transfers, the sort bounds' two and one a secondary bounce."""
    cfg = RenderConfig(**PIPELINES[pipeline])
    r = _renderer(**PIPELINES[pipeline])
    r.step(timer=SpanLog())
    rec, = r.frame_records
    n = H * W
    sizes = ladder_sizes(n, cfg)
    assert len(sizes) == 4
    launches = rec["launches"]
    assert [x["bounce"] for x in launches] == list(range(DEPTH))
    assert launches[0]["lanes"] == launches[0]["live"] == n
    rung = 0
    for x in launches[1:]:
        if pipeline == "unsorted":
            assert x["lanes"] == n and x["live"] is None
            continue
        if pipeline == "prefix":
            assert x["lanes"] == sizes[rung]
            rung = _rung(x["live"], sizes)
        else:
            assert x["lanes"] == sizes[_rung(x["live"], sizes)]
        assert 0 < x["live"] <= x["lanes"]
    assert any(x["lanes"] < n for x in launches) == (pipeline != "unsorted")
    for x in launches:
        assert (x["planes"], x["hero"], x["env"], x["kernel"]) == (3, False, False, False)
        assert x["inline"] == (pipeline == "unsorted")
        assert x["env_picks"] is x["env_misses"] is None
    assert rec["host_reads"] == 3 + (0 if pipeline == "unsorted" else 2 + DEPTH - 1)
    assert rec["host_read_s"] >= 0.0


def test_env_lit_records_count_picks_and_misses():
    """On an env-lit frame every shading launch's record holds the env's
    picks (lanes whose NEE picked it) and misses (live lanes whose ray
    missed), the counts the shading returns beside its path and shadow
    counts; the camera bounce's misses are the rays that left the box."""
    from tpu_pathtracer_torch.scene import attach_env, load_scene, scene_path

    img = np.random.default_rng(2).uniform(0.2, 2.0, (8, 16, 3)).astype(np.float32)
    scene = attach_env(load_scene(scene_path("cornellbox"), device="cpu"), img)
    r = Renderer(scene, W, H, RenderConfig(**LADDER), seed=5, device="cpu")
    r.step(timer=SpanLog())
    rec, = r.frame_records
    for x in rec["launches"]:
        assert x["env"] and 0 < x["env_picks"] < x["lanes"]
        assert 0 <= x["env_misses"] <= (x["live"] if x["live"] is not None else x["lanes"])
    assert rec["launches"][0]["env_misses"] > 0


def test_no_records_without_a_profiler_or_timer():
    """Frames stepped with no profiler recording and no timer leave no
    record; reset() clears the records a traced frame left."""
    r = _renderer(**LADDER)
    for _ in range(3):
        r.step()
    r.sync()
    assert r.frame_records == []
    r.step(timer=SpanLog())
    assert len(r.frame_records) == 1
    r.reset()
    assert r.frame_records == []


def test_profile_writes_the_frame_records(tmp_path):
    """Renderer.profile writes frames.json beside trace.json: the profiled
    frames' records, their counters read."""
    r = _renderer(**LADDER)
    r.step(timer=SpanLog())
    r.profile(str(tmp_path), frames=2)
    with open(tmp_path / "frames.json") as f:
        got = json.load(f)
    assert [x["frame"] for x in got] == [1, 2]
    assert got == json.loads(json.dumps(r.frame_records[1:]))
    assert all(x["traced_rays"] > 0 and x["host_reads"] == 3 + 2 + DEPTH - 1 for x in got)
    assert (tmp_path / "trace.json").exists()


def test_tracing_adds_no_torch_op():
    """A traced frame runs the same torch ops as an untraced one: counted by
    a dispatch mode over one frame each way, the spans' record_function
    ranges aside (the records' counters are read after the frame)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not str(func).startswith("profiler."):  # the spans' own ranges
                self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    counts = []
    for timer in (None, SpanLog()):
        r = _renderer(**LADDER, frames_in_flight=1)
        with Ops() as mode:
            r.step(timer=timer)
        counts.append(mode.ops)
    assert counts[0] == counts[1]
