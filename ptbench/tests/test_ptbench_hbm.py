"""The HBM route's cell: the readers of the device activities that the
program's ``resolve`` spans launch, by hand on a synthetic slice; nothing
to read without records or without such a span; the two metrics declared
for ``spd-tetra8.rgb`` alone; its configuration against the committed
scene; and the reference against the program's frames there (CPU)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from ptbench import check, reference, scenes
from ptbench.traces import SLICE, Trace

READERS = ("hbm_resolve_ms_per_frame", "hbm_resolve_launches_per_frame")
CELL = "spd-tetra8.rgb"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _trace():
    """A slice 100..200 us: the shading kernel launched at 150 us; an index
    kernel launched at 165 and a memset at 168 (inside the first resolve
    span), an elementwise kernel at 180 (outside), an index kernel at 185
    (inside the second)."""
    return Trace([
        _x("user_annotation", SLICE, 100.0, 100.0),
        _x("cuda_runtime", "cudaLaunchKernel", 150.0, 1.0, correlation=1),
        _x("kernel", "void (anonymous namespace)::shade_bounce_kernel<false, false, false>"
           "(ShadeParams)", 152.0, 10.0, tid=7, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 165.0, 1.0, correlation=2),
        _x("kernel", "void at::native::index_elementwise_kernel<128, 4>(int)", 166.0, 4.0,
           tid=7, correlation=2),
        _x("cuda_runtime", "cudaMemsetAsync", 168.0, 1.0, correlation=3),
        _x("gpu_memset", "Memset (Device)", 171.0, 2.0, tid=7, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 180.0, 1.0, correlation=4),
        _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 181.0, 5.0,
           tid=7, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 185.0, 1.0, correlation=5),
        _x("kernel", "void at::native::index_elementwise_kernel<128, 4>(int)", 187.0, 3.0,
           tid=7, correlation=5)])


def _records(first: int, resolve=True):
    """Two frames' records on a host clock 5 ms (in ns) past the trace's:
    the shade span 148-152 us brackets the shading launch (offset -5,000
    us), resolve spans 164-170 and 184-188 inside walk_shadow spans."""
    def ns(t):
        return int((t + 5000.0) * 1e3)

    spans0 = [["shade", ns(148.0), ns(152.0)], ["walk_shadow", ns(163.0), ns(171.0)]]
    spans1 = [["walk_shadow", ns(183.0), ns(189.0)]]
    if resolve:
        spans0.append(["resolve", ns(164.0), ns(170.0)])
        spans1.append(["resolve", ns(184.0), ns(188.0)])
    base = {"host_reads": 7, "host_read_s": 1e-5, "traced_rays": 10, "launches": [],
            "hbm_route": int(resolve), "hbm_walks": 15 if resolve else 0}
    return [dict(base, frame=first, spans=spans0), dict(base, frame=first + 1, spans=spans1)]


def _run(records, trace, first=40, cuda=True):
    renderer = SimpleNamespace()
    if records is not None:
        renderer.frame_records = records
    return SimpleNamespace(cuda=cuda, trace=trace, renderer=renderer, slice_first=first,
                           slice_frames=2)


def test_readers_by_hand(bench):
    """Launched inside the resolve spans: the index kernel (4 us) and the
    memset (2 us) of frame 0, the index kernel (3 us) of frame 1; the
    elementwise kernel at 180 us is outside both.  9 us over 2 frames =
    0.0045 ms; 3 activities over 2 frames = 1.5."""
    run = _run(_records(40), _trace())
    assert bench.reader("hbm_resolve_ms_per_frame")(run) == pytest.approx(0.0045)
    assert bench.reader("hbm_resolve_launches_per_frame")(run) == 1.5


def test_nothing_to_read_off_the_route(bench):
    """Records without a resolve span (the whole-table route, and a program
    before the span), no records, a slice not run on the card, a run
    without a trace and records that miss a slice frame give no reading."""
    tr = _trace()
    for run in (_run(_records(40, resolve=False), tr), _run(None, tr),
                _run(_records(40), tr, cuda=False), _run(_records(40), None),
                _run(_records(41), tr)):
        assert {m: bench.reader(m)(run) for m in READERS} == dict.fromkeys(READERS)


def test_metrics_declared_for_the_hbm_cell_alone(bench):
    """Both metrics move frame_ms and are read in spd-tetra8.rgb only: the
    water-plastic cells never take the HBM route.  Every other per-layer
    metric is read in the new cell too."""
    for m in READERS:
        entry = next(e for e in bench.doc["per_layer"] if e["name"] == m)
        assert entry["moves"] == "frame_ms" and entry["workloads"] == [CELL]
        assert os.path.exists(os.path.join(bench.here, "metrics", f"{m}.py"))
    for cell in ("water-plastic.rgb", "water-plastic.spectral-env",
                 "water-plastic.spp2-fuse2"):
        assert not {m["name"] for m in bench.metrics("per_layer", cell)} & set(READERS)
    names = {m["name"] for m in bench.metrics("per_layer", CELL)}
    assert names == {m["name"] for m in bench.doc["per_layer"]}


def test_the_configuration_is_the_committed_scene(bench):
    """The configuration names the committed scene at 1080p, depth 8, and
    the scene holds its triangles; the cell runs the rgb mix on one chip."""
    cfg = bench.config("spd-tetra8")
    assert (cfg["width"], cfg["height"], cfg["max_path_length"]) == (1920, 1080, 8)
    assert cfg["reduced"] == [] and cfg["size_factor"] == 8
    mesh = reference.parse_obj(scenes.obj_path(cfg["scene"]["obj"]))
    assert len(mesh["mat"]) == cfg["triangles"] == 4 ** 9 + 12
    cell = bench.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("spd-tetra8", "rgb", 1)
    limits = bench.limits(CELL)
    assert set(limits["limits"]) == {"rel_l1", "bad_px_share", "nonfinite_share"}


def test_reference_follows_the_program(bench, monkeypatch):
    """The program's frames of the cell at a test size (CPU: the kernels'
    plain versions, the HBM route) at the check's pixels against the
    reference: the same paths, to rounding."""
    from ptbench import harness

    monkeypatch.setattr(harness, "WARMUP_FRAMES", 2)
    run = harness.Run(bench, CELL, 2 ** 31 + 5, device="cpu", size=(8, 12))
    run.setup()
    assert run.renderer._intersect.hbm
    got = run.program_pixels()
    run.release()
    want = run.reference_pixels()
    values = check.numbers(got, want)
    assert values["rel_l1"] < 1e-5 and values["bad_px_share"] == 0.0, values
    assert np.abs(want).sum() > 0
