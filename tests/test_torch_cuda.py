"""tpu_pathtracer_torch's CUDA kernels on the card: each against its plain
torch version, and a whole frame against the CPU's.  Every test here needs
an NVIDIA GPU and skips without one.  The file imports no JAX, so it also
runs on a host without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.accel import build_layout
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.scene import load_scene, scene_path
from tpu_pathtracer_torch.scripts import experimental_sweep as es
from tpu_pathtracer_torch.scripts import perf_launch, perf_ophit_probe
from torch_parity import (assert_hits_agree, cuda_device, nee_shadow_rays,  # noqa: F401
                          random_rays)
from torch_terrain import terrain_scene

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["cornellbox", "CornellBox-Water-plastic"])
def test_kernels_match_plain_on_card(name, cuda_device):
    """Kernel == plain version on the same card: t bit-equal (both keep the
    same operation order and the kernels build with --fmad=false), ids
    equal except equal-t ties on >= 99.99% of the hits; the capped walk's
    four rows equal on every lane (its group latch is the sequential one)."""
    scene = load_scene(scene_path(name), device=cuda_device)
    lay, occl = build_layout(scene, 56), build_layout(scene, 8)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in random_rays(8192, seed=3))
    act = torch.arange(8192, device=cuda_device) % 9 != 4
    t_max = torch.full((8192,), torch.inf, device=cuda_device)
    n0 = ht.window_walk.launches
    tk, rk = ht.window_walk(o, d, act, t_max, lay)
    assert ht.window_walk.launches == n0 + 1
    tp, rp = ht.window_walk_plain(o, d, act, t_max, lay)
    assert_hits_agree(tk.cpu(), rk.cpu(), tp.cpu(), rp.cpu(), rtol=0, atol=0,
                      min_agree=0.9999)
    cap = torch.where(torch.isfinite(tk), tk * 1.25, 2.0)
    n0 = ht.capped_walk.launches
    outk = ht.capped_walk(o, d, act, cap, occl)
    assert ht.capped_walk.launches == n0 + 1
    outp = ht.capped_walk_plain(o, d, act, cap, occl)
    hit = lambda out: torch.where(out[0] < cap, out[0], torch.inf).cpu()  # noqa: E731
    assert_hits_agree(hit(outk), outk[3].cpu(), hit(outp), outp[3].cpu(),
                      rtol=0, atol=0, min_agree=1.0)
    assert torch.equal(outk, outp)


@pytest.mark.parametrize("name", ["cornellbox", "CornellBox-Water-plastic"])
def test_anyhit_matches_plain_on_card(name, cuda_device):
    """The any-hit kernel's clear mask == its plain version's on every lane
    (the same op order, built with --fmad=false), on NEE-shaped shadow
    queries with every fifth lane an environment sample."""
    rays = nee_shadow_rays(load_scene(scene_path(name), device="cpu"), 8192, seed=7)
    o, d, act, cap, tgt = (torch.from_numpy(a).to(cuda_device) for a in rays)
    occl = build_layout(load_scene(scene_path(name), device=cuda_device), 8)
    n0 = ht.anyhit_walk.launches
    ck = ht.anyhit_walk(o, d, act, cap, tgt, occl, 1e-4)
    assert ht.anyhit_walk.launches == n0 + 1
    cp = ht.anyhit_walk_plain(o, d, act, cap, tgt, occl, 1e-4)
    assert ck.dtype == torch.uint8 and torch.equal(ck, cp)
    assert 0 < int(ck.sum()) < int(act.sum())
    with pytest.raises(ValueError):
        ht.anyhit_walk(o, d, act, cap, tgt.long(), occl, 1e-4)


@pytest.mark.parametrize("kernel", ["minwalk", "sweep", "window_walk_orig",
                                    "window_walk_counts"])
@pytest.mark.parametrize("name", ["cornellbox", "CornellBox-Water-plastic"])
def test_bench_kernels_match_plain_on_card(name, kernel, cuda_device):
    """The bench's four kernels == their plain versions on the same card:
    t bit-equal, ids equal except equal-t ties on >= 99.99% of the hits;
    minwalk's payload to atol 1e-6 (rsqrt); the latched original id equal
    where the rows agree; the counting walk's useful rows exact and its
    warp-issued spent within the warp bounds, equal across each warp and,
    summed over a warp, never below its useful rows."""
    scene = load_scene(scene_path(name), device=cuda_device)
    lay = build_layout(scene, 56)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in random_rays(8192, seed=13))
    act = torch.arange(8192, device=cuda_device) % 9 != 4
    t_max = torch.where(torch.arange(8192, device=cuda_device) % 3 == 0, 1.5,
                        torch.inf).contiguous()
    fn = getattr(ht, kernel)
    n0 = fn.launches
    if kernel == "minwalk":
        outk = ht.minwalk(o, d, act, t_max, lay, prepass=32)
        outp = ht.minwalk_plain(o, d, act, t_max, lay, prepass=32)
        hit = lambda out: torch.where(out[0] < t_max, out[0], torch.inf).cpu()  # noqa: E731
        same = assert_hits_agree(hit(outk), outk[3].cpu(), hit(outp), outp[3].cpu(),
                                 rtol=0, atol=0, min_agree=0.9999)
        np.testing.assert_allclose(outk[6:].cpu().numpy()[:, same],
                                   outp[6:].cpu().numpy()[:, same], rtol=0, atol=1e-6)
    elif kernel == "sweep":
        tk, rk, ok_ = ht.sweep(o, d, act, t_max, lay, with_orig=True)
        tp, rp, op = ht.sweep_plain(o, d, act, t_max, lay, with_orig=True)
        assert torch.equal(tk, tp) and torch.equal(rk, rp) and torch.equal(ok_, op)
    elif kernel == "window_walk_orig":
        tk, rk, ok_ = ht.window_walk_orig(o, d, act, t_max, lay)
        tp, rp, op = ht.window_walk_orig_plain(o, d, act, t_max, lay)
        hit = lambda t: torch.where(t < t_max, t, torch.inf).cpu()  # noqa: E731
        same = assert_hits_agree(hit(tk), rk.cpu(), hit(tp), rp.cpu(), rtol=0,
                                 atol=0, min_agree=0.9999)
        assert torch.equal(ok_.cpu()[same], op.cpu()[same])
        assert (ok_.cpu()[~torch.isfinite(hit(tk))] == -1).all()
    else:
        tk, rk, useful, spent = ht.window_walk_counts(o, d, act, t_max, lay)
        tp, rp, up, lo, hi = ht.window_walk_counts_plain(o, d, act, t_max, lay)
        assert torch.equal(tk, tp) and torch.equal(rk, rp)
        assert torch.equal(useful, up)
        assert bool(((lo <= spent) & (spent <= hi)).all())
        assert bool((spent.view(-1, 32) == spent.view(-1, 32)[:, :1]).all())
        per_warp = lambda x: x.view(-1, 32).sum(1)  # noqa: E731
        assert int(useful.sum()) > 0 and bool((per_warp(useful) <= per_warp(spent)).all())
    assert fn.launches == n0 + 1


def test_kernel_wrappers_check_inputs(cuda_device):
    scene = load_scene(scene_path("cornellbox"), device=cuda_device)
    lay = build_layout(scene, 8)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in random_rays(64, seed=1))
    act = torch.ones(64, dtype=torch.bool, device=cuda_device)
    t = torch.full((64,), torch.inf, device=cuda_device)
    with pytest.raises(ValueError):
        ht.window_walk(o.double(), d, act, t, lay)
    with pytest.raises(ValueError):
        ht.window_walk(o.t().contiguous().t(), d, act, t, lay)
    with pytest.raises(ValueError):
        ht.capped_walk(o, d, act.float(), t, lay)
    with pytest.raises(ValueError):
        ht.capped_walk(o, d, act, t, build_layout(load_scene(
            scene_path("cornellbox"), device="cpu"), 8))


def test_renderer_on_card_matches_cpu(cuda_device):
    """A Water-plastic frame through the kernels == the same frame through
    the plain versions on the CPU, to atol 1e-4 (CUDA's sqrt/sin/cos round
    differently from the CPU's, and a bounce carries that forward)."""
    cfg = RenderConfig(max_path_length=4)
    gpu = Renderer("CornellBox-Water-plastic", 64, 48, cfg, device=cuda_device)
    cpu = Renderer("CornellBox-Water-plastic", 64, 48, cfg, device="cpu")
    n0 = (ht.window_walk.launches, ht.capped_walk.launches)
    gpu.run(2)
    cpu.run(2)
    assert ht.window_walk.launches > n0[0] and ht.capped_walk.launches > n0[1]
    img = gpu.image()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, cpu.image(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("form", ["window_walk", "window_walk_orig", "window_walk_counts",
                                  "sweep", "window_walk_hbm"])
@pytest.mark.parametrize("name", ["cornellbox", "CornellBox-Water-plastic"])
def test_mt_and_hbm_forms_match_plain_on_card(name, form, cuda_device):
    """The production-scale path's forms == their plain versions on the same
    card: each window-walk form and the sweep with tritest="mt", and the
    HBM route's wrapper with t_max caps; t and rows bit-equal, the latched
    original ids and useful rows equal, one launch counted."""
    scene = load_scene(scene_path(name), device=cuda_device)
    lay = build_layout(scene, 56)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in random_rays(8192, seed=17))
    act = torch.arange(8192, device=cuda_device) % 9 != 4
    t_max = torch.where(torch.arange(8192, device=cuda_device) % 3 == 0, 1.5,
                        torch.inf).contiguous()
    fn = getattr(ht, form)
    n0 = fn.launches
    kw = {} if form == "window_walk_hbm" else {"tritest": "mt"}
    if form == "sweep":
        kw["with_orig"] = True
    outk = fn(o, d, act, t_max, lay, **kw)
    outp = getattr(ht, f"{form}_plain")(o, d, act, t_max, lay, **kw)
    assert fn.launches == n0 + 1
    assert torch.equal(outk[0], outp[0]) and torch.equal(outk[1], outp[1])
    if form in ("window_walk_orig", "sweep"):
        assert torch.equal(outk[2], outp[2])
    if form == "window_walk_counts":
        assert torch.equal(outk[2], outp[2])
        assert bool(((outp[3] <= outk[3]) & (outk[3] <= outp[4])).all())
    assert bool(torch.isfinite(torch.where(outk[0] < t_max, outk[0], torch.inf)).any())


def test_terrain_route_and_lbvh_on_card(cuda_device):
    """A GRID 256 terrain through build_scene on the card takes the HBM
    route under the default config, launches only the HBM window walk, and
    its LBVH layout equals the CPU build."""
    scene = terrain_scene(256, device=cuda_device)
    r = Renderer(scene, 64, 48, RenderConfig(max_path_length=3), device=cuda_device)
    assert r._intersect.hbm
    n0 = {k: getattr(ht, k).launches for k in ("window_walk_hbm", "capped_walk",
                                                "anyhit_walk", "window_walk")}
    r.run(1)
    grew = {k: getattr(ht, k).launches - v for k, v in n0.items()}
    assert grew["window_walk_hbm"] > 0 and grew["capped_walk"] == grew["anyhit_walk"] == 0
    assert grew["window_walk"] == 0 and np.isfinite(r.image()).all()
    gpu = build_layout(scene, 56, builder="lbvh")
    cpu = build_layout(terrain_scene(256, device="cpu"), 56, builder="lbvh")
    for k in ("nodes", "nodes_meta", "tris", "tris8", "tris8bw", "sorted_to_orig"):
        assert torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)), k


@pytest.mark.parametrize("leaf", [56, 8])
@pytest.mark.parametrize("name", ["cornellbox", "CornellBox-Water-plastic"])
def test_candidate_sweep_matches_plain_on_card(name, leaf, cuda_device):
    """The candidate-sweep pair == its plain versions on the same card, every
    output bit-equal (counts, first leaves, t, u, v, row, orig), one launch
    counted each; and the split property on the kernels: the targeted result
    == the MT window walk on every lane with at most one candidate."""
    scene = load_scene(scene_path(name), device=cuda_device)
    lay = build_layout(scene, leaf)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in random_rays(8192, seed=19))
    act = torch.arange(8192, device=cuda_device) % 9 != 4
    n0 = (es.sweep_count.launches, es.intersect_sweep1.launches)
    ck, fk = es.sweep_count(o, d, lay, active=act)
    cp, fp = es.sweep_count_plain(o, d, lay, active=act)
    assert torch.equal(ck, cp) and torch.equal(fk, fp)
    assert int(ck.max()) > 1 or lay.num_leaves == 1  # cornellbox at leaf 56: one leaf
    sel = act & (ck <= 1)
    t_max = torch.where(torch.arange(8192, device=cuda_device) % 3 == 0, 1.5, torch.inf)
    rk, _ = es.intersect_sweep1(o, d, lay, active=sel, t_max=t_max)
    rp, _ = es.intersect_sweep1_plain(o, d, lay, active=sel, t_max=t_max)
    for a, b in zip(rk, rp):
        assert torch.equal(a, b)
    raw, tmax = es.intersect_sweep1(o, d, lay, active=sel)
    assert (es.sweep_count.launches, es.intersect_sweep1.launches) == (
        n0[0] + 1, n0[1] + 2 * es.SWEEP1_LAUNCHES)
    tw, rw = ht.window_walk(o, d, act, tmax, lay, prepass=ht.window_prepass(lay, 32),
                            tritest="mt")
    assert torch.equal(raw.t[sel], tw[sel]) and torch.equal(raw.row[sel], rw[sel])
    assert bool(torch.isfinite(raw.t[sel]).any()) and float(sel.float().mean()) > 0.05
    with pytest.raises(ValueError):
        es.sweep_count(o.double(), d, lay)
    with pytest.raises(ValueError):
        es.intersect_sweep1(o, d, build_layout(load_scene(scene_path(name), device="cpu"),
                                               leaf))


def test_probes_match_plain_on_card(cuda_device):
    """The no-op and the six row-test probe variants == their plain versions
    on the same card, exactly: ragged last tiles, 0 and 3 table pointers,
    two block sizes of the latch; launches counted; bad shapes raise."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rays = torch.randn((8, 10000), generator=gen, device=cuda_device)
    tables = [torch.zeros((7, 8), device=cuda_device) for _ in range(3)]
    n0 = perf_launch.noop.launches
    for tile in (768, 6144):
        for tbl in ([], tables):
            out = perf_launch.noop(rays, tbl, tile)
            assert torch.equal(out, perf_launch.noop_plain(rays, tbl, tile))
            assert float(perf_launch.run_noop(rays, tbl, tile)) == float(
                perf_launch.run_noop_plain(rays, tbl, tile))
    assert perf_launch.noop.launches == n0 + 8
    with pytest.raises(ValueError):
        perf_launch.noop(rays[:7].contiguous(), [], 768)
    rays, tris = perf_ophit_probe.probe_inputs(4096, 200, cuda_device, seed=7)
    n0 = perf_ophit_probe.rowtest_probe.launches
    for variant in perf_ophit_probe.VARIANTS:
        for mtblock, tile in ((16, 768), (7, 96)):
            tk, ik = perf_ophit_probe.rowtest_probe(variant, rays, tris, tile, mtblock)
            tp, ip = perf_ophit_probe.rowtest_probe_plain(variant, rays, tris, mtblock)
            assert torch.equal(tk, tp) and torch.equal(ik, ip), (variant, mtblock)
            assert bool(torch.isfinite(tk).any())
    assert perf_ophit_probe.rowtest_probe.launches == n0 + 12
    with pytest.raises(ValueError):
        perf_ophit_probe.rowtest_probe("full-bw", rays, tris, tile=100)


@pytest.mark.parametrize("leaf", [56, 16, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 65537])
def test_redesigned_walks_edge_shapes_on_card(n, leaf, cuda_device):
    """The warp-cooperative walks on lane counts around a warp, with every
    lane live, every lane dead and one live lane a warp, prepass 0 and 32,
    on the leaf-56, leaf-16 and leaf-8 layouts: every form of the window walk
    and minwalk bit-equal to its plain version (minwalk's position and normal
    to atol 1e-6: rsqrt), spent within its warp bounds, and the default form
    equal to the per-thread yardsticks on every lane."""
    scene = load_scene(scene_path("CornellBox-Water-plastic"), device=cuda_device)
    lay = build_layout(scene, leaf)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in random_rays(n, seed=23))
    lanes = torch.arange(n, device=cuda_device)
    t_max = torch.where(lanes % 3 == 0, 1.5, torch.inf).contiguous()
    masks = (torch.ones(n, dtype=torch.bool, device=cuda_device),
             torch.zeros(n, dtype=torch.bool, device=cuda_device), lanes % 32 == 7)
    for act, prepass, tritest in ((masks[0], 32, "bw"), (masks[0], 0, "mt"),
                                  (masks[1], 32, "bw"), (masks[2], 32, "mt"),
                                  (masks[2], 0, "bw")):
        args = (o, d, act, t_max, lay)
        kw = dict(prepass=prepass, tritest=tritest)
        want = ht.window_walk_plain(*args, **kw)
        for got in (ht.window_walk(*args, **kw), ht.window_walk_v1(*args, **kw),
                    ht.window_walk_orig(*args, **kw)[:2]):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(ht.window_walk_orig(*args, **kw)[2],
                           ht.window_walk_orig_plain(*args, **kw)[2])
        tk, rk, useful, spent = ht.window_walk_counts(*args, **kw)
        _, _, up, lo, hi = ht.window_walk_counts_plain(*args, **kw)
        assert torch.equal(tk, want[0]) and torch.equal(rk, want[1])
        assert torch.equal(useful, up) and bool(((lo <= spent) & (spent <= hi)).all())
        if tritest == "mt":
            mk = ht.minwalk(*args, prepass=prepass)
            mp = ht.minwalk_plain(*args, prepass=prepass)
            assert torch.equal(mk[:6], mp[:6])
            assert torch.equal(mk, ht.minwalk_v1(*args, prepass=prepass))
            np.testing.assert_allclose(mk[6:].cpu().numpy(), mp[6:].cpu().numpy(),
                                       rtol=0, atol=1e-6)
    assert bool((want[1][~act] == lay.num_tris).all())


@pytest.mark.parametrize("tritest", ["bw", "mt"])
def test_walk_steps_match_yardstick_on_card(tritest, cuda_device):
    """Every step of the walk's design (node table staged or not, leaves
    cooperative or per lane, blocks persistent or one a tile, 64 to 1024
    threads) gives the per-thread yardstick's t and row on every lane; each
    launch counted on its own wrapper; a block shape the kernel cannot take
    raises."""
    scene = load_scene(scene_path("CornellBox-Water-plastic"), device=cuda_device)
    lay = build_layout(scene, 56)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in random_rays(40000, seed=29))
    act = torch.arange(40000, device=cuda_device) % 9 != 4
    t_max = torch.full((40000,), torch.inf, device=cuda_device)
    n0 = (ht.window_walk_v1.launches, ht.window_walk_steps.launches, ht.window_walk.launches)
    want = ht.window_walk_v1(o, d, act, t_max, lay, tritest=tritest)
    shapes = [(s, c, p, t) for s in (False, True) for c in (False, True)
              for p in (False, True) for t in (64, 128, 1024)]
    for stage, coop, persist, threads in shapes:
        got = ht.window_walk_steps(o, d, act, t_max, lay, tritest=tritest, stage=stage,
                                   coop=coop, persist=persist, threads=threads)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (ht.window_walk_v1.launches, ht.window_walk_steps.launches,
            ht.window_walk.launches) == (n0[0] + 1, n0[1] + len(shapes), n0[2])
    with pytest.raises(RuntimeError):
        ht.window_walk_steps(o, d, act, t_max, lay, stage=False, coop=True, persist=False,
                             threads=100)


@pytest.mark.parametrize("leaf", [56, 16, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 65537])
def test_shadow_walks_edge_shapes_on_card(n, leaf, cuda_device):
    """The redesigned capped and any-hit walks on lane counts around a warp,
    with every lane live, every lane dead and one live lane a warp, on the
    leaf-56, leaf-16 and leaf-8 layouts, with the
    NEE caps (environment lanes: target -1, cap 1e30) and with infinite caps:
    bit-equal to their plain versions and to the per-thread yardsticks on
    every lane."""
    name = "CornellBox-Water-plastic"
    lay = build_layout(load_scene(scene_path(name), device=cuda_device), leaf)
    rays = nee_shadow_rays(load_scene(scene_path(name), device="cpu"), n, seed=31)
    o, d, act, cap, tgt = (torch.from_numpy(a).to(cuda_device) for a in rays)
    lanes = torch.arange(n, device=cuda_device)
    masks = (torch.ones_like(act), torch.zeros_like(act), lanes % 32 == 7)
    for live in masks:
        for c in (cap, torch.full_like(cap, torch.inf)):
            want = ht.capped_walk_plain(o, d, live, c, lay)
            for got in (ht.capped_walk(o, d, live, c, lay),
                        ht.capped_walk_v1(o, d, live, c, lay)):
                assert torch.equal(got, want)
            want = ht.anyhit_walk_plain(o, d, live, c, tgt, lay, 1e-4)
            for got in (ht.anyhit_walk(o, d, live, c, tgt, lay, 1e-4),
                        ht.anyhit_walk_v1(o, d, live, c, tgt, lay, 1e-4)):
                assert torch.equal(got, want)
            assert not bool(want[~live].any())
    assert bool((ht.capped_walk(o, d, masks[1], cap, lay)[0] == cap).all())


@pytest.mark.parametrize("leaf", [56, 8])
def test_shadow_steps_match_yardstick_on_card(leaf, cuda_device):
    """Both leaf services of the shadow walks (per-lane only, and the kept
    one that serves a leaf over the warp where that takes fewer slots) give
    the per-thread yardstick's outputs on every lane of NEE-shaped shadow
    queries; each launch counted on its own wrapper."""
    name = "CornellBox-Water-plastic"
    lay = build_layout(load_scene(scene_path(name), device=cuda_device), leaf)
    rays = nee_shadow_rays(load_scene(scene_path(name), device="cpu"), 40000, seed=37)
    o, d, act, cap, tgt = (torch.from_numpy(a).to(cuda_device) for a in rays)
    names = ("capped_walk", "capped_walk_v1", "capped_walk_steps", "anyhit_walk",
             "anyhit_walk_v1", "anyhit_walk_steps")
    n0 = [getattr(ht, k).launches for k in names]
    want_c = ht.capped_walk_v1(o, d, act, cap, lay)
    want_a = ht.anyhit_walk_v1(o, d, act, cap, tgt, lay, 1e-4)
    assert 0 < int(want_a.sum()) < int(act.sum())
    steps = [dict(coop=False), dict(coop=True)]
    for kw in steps:
        assert torch.equal(ht.capped_walk_steps(o, d, act, cap, lay, **kw), want_c)
        assert torch.equal(ht.anyhit_walk_steps(o, d, act, cap, tgt, lay, 1e-4, **kw),
                           want_a)
    grew = [getattr(ht, k).launches - v for k, v in zip(names, n0)]
    assert grew == [0, 1, len(steps), 0, 1, len(steps)]


EDGE_LANES = (1, 31, 33, 65537)


@pytest.mark.parametrize("n", EDGE_LANES)
def test_rowtest_probe_edge_shapes_on_card(n, cuda_device):
    """The redesigned row-test probe (row tiles in shared memory, two lanes
    a thread) on lane counts around a warp and a block: every variant, on
    tiles of 96 and 768 lanes, with mtblock 7 (the generic
    instance) and 16 (the unrolled one), on a table that is staged whole
    (200 rows) and one that is tiled (7,112 rows), bit-equal to its plain
    version and to the first port's kernel on every lane; and a table whose
    rows put the reciprocal off its fast path (a plane or an edge scaled to
    denormal, past 2^126 or to zero), where the kernel takes 1 / x exactly."""
    for rows in (200, 7112, "extreme"):
        rays, tris = perf_ophit_probe.probe_inputs(n, 200 if rows == "extreme" else rows,
                                                   cuda_device, seed=n)
        if rows == "extreme":
            tris[1::4, 0:6] *= 1e-39
            tris[2::4, 0:6] *= 1e38
            tris[3::8, 0:6] = 0.0
        for variant in perf_ophit_probe.VARIANTS:
            for mtblock in (7, 16):
                tp, ip = perf_ophit_probe.rowtest_probe_plain(variant, rays, tris, mtblock)
                tv, iv = perf_ophit_probe.rowtest_probe_v1(variant, rays, tris, 96, mtblock)
                assert torch.equal(tv, tp) and torch.equal(iv, ip), (variant, mtblock, rows)
                for tile in (96, 768):
                    tk, ik = perf_ophit_probe.rowtest_probe(variant, rays, tris, tile,
                                                            mtblock)
                    assert torch.equal(tk, tp) and torch.equal(ik, ip), (
                        variant, mtblock, rows, tile)


@pytest.fixture(scope="module")
def count_layouts():
    """The count's tables on the card: Water-plastic at leaf 56 (184 boxes)
    and leaf 8 (1,209: one tile each), the GRID 256 terrain at leaf 8 (many
    tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    scene = load_scene(scene_path("CornellBox-Water-plastic"), device="cuda")
    return {"leaf 56": build_layout(scene, 56), "leaf 8": build_layout(scene, 8),
            "grid 256 leaf 8": build_layout(terrain_scene(256), 8)}


@pytest.mark.parametrize("which", ["leaf 56", "leaf 8", "grid 256 leaf 8"])
@pytest.mark.parametrize("n", EDGE_LANES)
def test_sweep_count_edge_shapes_on_card(which, n, count_layouts):
    """The redesigned count (prepass and leaf boxes in shared memory, four
    lanes a thread) on lane counts around a warp and a block, with every
    lane live, every lane dead and one live lane a warp, prepass 32 and 0:
    bit-equal to its plain version and to the first port's kernel
    on every lane; and with prepass rows whose edges put the reciprocal off
    its fast path (scaled to denormal, past 2^126 or to zero)."""
    base = count_layouts[which]
    pre = base.prepass.clone()
    pre[1::4, 3:6] *= 1e-39
    pre[2::4, 3:6] *= 1e38
    pre[3::8, 3:6] = 0.0
    o, d = (torch.from_numpy(a).cuda() for a in random_rays(n, seed=41 + n))
    lanes = torch.arange(n, device="cuda")
    masks = (torch.ones(n, dtype=torch.bool, device="cuda"),
             torch.zeros(n, dtype=torch.bool, device="cuda"), lanes % 32 == 7)
    for act in masks:
        for prepass, lay in ((32, base), (0, base), (32, base._replace(prepass=pre))):
            want = es.sweep_count_plain(o, d, lay, active=act, prepass=prepass)
            got = es.sweep_count_v1(o, d, lay, active=act, prepass=prepass)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            got = es.sweep_count(o, d, lay, active=act, prepass=prepass)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), prepass
            assert bool((want[0][~act] == 0).all() and (want[1][~act] == lay.num_leaves).all())
    assert n < 65537 or int(want[0].max()) > 0


@pytest.fixture(scope="module")
def sweep1_layouts(count_layouts):
    """The count's tables and cornellbox at leaf 56 (a single leaf)."""
    one = build_layout(load_scene(scene_path("cornellbox"), device="cuda"), 56)
    assert one.num_leaves == 1
    return {**count_layouts, "cornellbox leaf 56": one}


@pytest.mark.parametrize("which", ["leaf 56", "leaf 8", "grid 256 leaf 8",
                                   "cornellbox leaf 56"])
@pytest.mark.parametrize("n", EDGE_LANES)
def test_sweep1_edge_shapes_on_card(which, n, sweep1_layouts):
    """The redesigned targeted kernel (the active lanes listed on the card,
    only those marched on the count's dense march, the warp serving each
    lane's leaf) on lane counts around a warp and a block,
    with every lane active, none, one a warp and 19% (a seeded draw), t_max
    unbounded and capped (1.5 on every third lane), prepass 32 and 0, and
    prepass rows whose edges put the reciprocal off its fast path (scaled to
    denormal, past 2^126 or to zero): t, u, v, row and orig bit-equal to its
    plain version and to the first port's kernel on every lane."""
    base = sweep1_layouts[which]
    pre = base.prepass.clone()
    pre[1::4, 3:6] *= 1e-39
    pre[2::4, 3:6] *= 1e38
    pre[3::8, 3:6] = 0.0
    o, d = (torch.from_numpy(a).cuda() for a in random_rays(n, seed=43 + n))
    lanes = torch.arange(n, device="cuda")
    some = torch.from_numpy(np.random.default_rng(n).random(n) < 0.19).cuda()
    masks = (torch.ones(n, dtype=torch.bool, device="cuda"),
             torch.zeros(n, dtype=torch.bool, device="cuda"), lanes % 32 == 7, some)
    caps = (None, torch.where(lanes % 3 == 0, 1.5, torch.inf))
    n0 = (es.intersect_sweep1.launches, es.intersect_sweep1_v1.launches)
    for act in masks:
        for t_max in caps:
            for prepass, lay in ((32, base), (0, base), (32, base._replace(prepass=pre))):
                kw = dict(active=act, prepass=prepass, t_max=t_max)
                want, _ = es.intersect_sweep1_plain(o, d, lay, **kw)
                v1, _ = es.intersect_sweep1_v1(o, d, lay, **kw)
                got, _ = es.intersect_sweep1(o, d, lay, **kw)
                for g, y, w in zip(got, v1, want):
                    assert torch.equal(y, w), (prepass, t_max is None)
                    assert torch.equal(g, w), (prepass, t_max is None)
                assert bool((want.row[~act] == lay.num_tris).all())
    assert (es.intersect_sweep1.launches - n0[0], es.intersect_sweep1_v1.launches - n0[1]) \
        == (24 * es.SWEEP1_LAUNCHES, 24)
    assert n < 65537 or bool(torch.isfinite(want.t[act]).any())
