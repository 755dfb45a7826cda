"""tpu_pathtracer_torch's CUDA kernels on the card: each against its plain
torch version, and a whole frame against the CPU's.  Every test here needs
an NVIDIA GPU and skips without one.  The file imports no JAX, so it also
runs on a host without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.accel import build_layout
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.ops import rng as trng
from tpu_pathtracer_torch.ops import shade as tshade
from tpu_pathtracer_torch.ops import wavefront_sort as tsort
from tpu_pathtracer_torch.ops.intersect import HitShade
from tpu_pathtracer_torch.render import wavefront as twf
from tpu_pathtracer_torch.scene import load_scene, scene_path
from tpu_pathtracer_torch.scripts import experimental_sweep as es
from tpu_pathtracer_torch.scripts import perf_launch, perf_ophit_probe
from torch_parity import (assert_hits_agree, cuda_device, nee_shadow_rays,  # noqa: F401
                          random_rays, shading_inputs, sort_inputs, spd_generator)
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
    frame = (ht.window_walk_resolve, ht.capped_walk, trng.uniforms)
    n0 = [k.launches for k in frame]
    gpu.run(2)
    cpu.run(2)
    assert all(k.launches > n for k, n in zip(frame, n0))
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
    to atol 1e-6: rsqrt) and spent within its warp bounds."""
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
        for got in (ht.window_walk(*args, **kw), ht.window_walk_orig(*args, **kw)[:2]):
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
            np.testing.assert_allclose(mk[6:].cpu().numpy(), mp[6:].cpu().numpy(),
                                       rtol=0, atol=1e-6)
    assert bool((want[1][~act] == lay.num_tris).all())


@pytest.mark.parametrize("form", ["uniforms", "uniforms_r2"])
def test_uniforms_match_plain_on_card(form, cuda_device):
    """csrc/rng.cu == the plain int64 versions bit for bit: every count the
    frame draws (the r2 form at 4, 6 and 10), lane counts around a warp and
    none, 1080p virtual ids of a second fused sample (past 2^31), frames,
    salts and bounces that wrap (the top bit set, negative bounce)."""
    fn, plain = getattr(trng, form), getattr(trng, f"{form}_plain")
    counts = range(1, 11) if form == "uniforms" else (4, 6, 10)
    gen = np.random.default_rng(3)
    pids = [torch.from_numpy(gen.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64))
            for n in (0, 1, 31, 33, 65537)]
    pids.append(torch.arange(1920 * 1080, dtype=torch.int64) + 1920 * 1080 * 1100)
    n0 = fn.launches
    for pid in pids:
        pid = pid.to(cuda_device)
        for count in counts:
            for frame, bounce, salt in ((0, 0, 0), (7, -1, 0x80000001),
                                        (2**32 - 1, 5, 2**32 - 1)):
                got = fn(pid, frame, bounce, salt, count)
                assert torch.equal(got, plain(pid, frame, bounce, salt, count))
    assert fn.launches == n0 + len(pids) * len(counts) * 3
    with pytest.raises(ValueError):
        fn(pids[-1].to(cuda_device), 0, 0, 0, trng.MAX_COUNT + 1)


@pytest.mark.parametrize("tritest", ["bw", "mt"])
@pytest.mark.parametrize("name", ["cornellbox", "CornellBox-Water-plastic"])
def test_window_walk_resolve_matches_plain_on_card(name, tritest, cuda_device):
    """The window walk's payload epilogue == its plain version on every
    output row, bit for bit, and == the window walk kernel plus the torch
    payload rows; the HBM route's wrapper with resolve=True the same; lane
    counts around a warp with every lane live, none and one a warp, caps
    shorter than the hits included."""
    lay = build_layout(load_scene(scene_path(name), device=cuda_device), 56)
    pp = ht.window_prepass(lay, ht.DEFAULT_PREPASS)
    for n in (1, 33, 8192):
        o, d = (torch.from_numpy(a).to(cuda_device) for a in random_rays(n, seed=31 + n))
        lanes = torch.arange(n, device=cuda_device)
        t_max = torch.where(lanes % 3 == 0, 1.5,
                            torch.where(lanes % 5 == 1, 0.05, torch.inf)).contiguous()
        for act in (lanes % 9 != 4, lanes < 0, lanes % 32 == 7):
            args = (o, d, act.contiguous(), t_max, lay)
            kw = dict(prepass=pp, tritest=tritest)
            n0 = (ht.window_walk_resolve.launches, ht.window_walk_hbm.launches_resolve)
            got = ht.window_walk_resolve(*args, **kw)
            assert torch.equal(got, ht.window_walk_resolve_plain(*args, **kw))
            assert torch.equal(got, ht.window_walk_hbm(*args, **kw, resolve=True))
            assert torch.equal(got, ht.window_payload_rows(
                lay, *ht.window_walk(*args, **kw), t_max, o, d))
            assert (ht.window_walk_resolve.launches,
                    ht.window_walk_hbm.launches_resolve) == (n0[0] + 1, n0[1] + 1)


@pytest.fixture(scope="module")
def tetra3_obj(tmp_path_factory):
    """The SPD tetra at size factor 3 (268 triangles with the box)."""
    obj, _ = spd_generator().write(3, str(tmp_path_factory.mktemp("spd") / "spd-tetra3"))
    return obj


@pytest.mark.parametrize("tritest", ["bw", "mt"])
@pytest.mark.parametrize("name", ["tetra3", "CornellBox-Water-plastic"])
def test_window_walk_capped_matches_plain_on_card(name, tritest, tetra3_obj, cuda_device):
    """The HBM route's capped epilogue (window_walk_hbm(..., capped=True)) ==
    its plain version on all 4 rows, bit for bit, and == the HBM walk's (t,
    row) plus the torch rows (window_capped_rows); lane counts around a warp
    with every lane live, none and one a warp, dead lanes, finite caps
    shorter and longer than the hits and infinite caps; one launch counted
    in launches and in launches_capped a call."""
    path = tetra3_obj if name == "tetra3" else scene_path(name)
    lay = build_layout(load_scene(path, device=cuda_device), 56)
    pp = ht.window_prepass(lay, ht.DEFAULT_PREPASS)
    f = ht.window_walk_hbm
    for n in (1, 33, 8192):
        o, d = (torch.from_numpy(a).to(cuda_device) for a in random_rays(n, seed=37 + n))
        lanes = torch.arange(n, device=cuda_device)
        t_max = torch.where(lanes % 3 == 0, 1.5,
                            torch.where(lanes % 5 == 1, 0.05, torch.inf)).contiguous()
        for act in (lanes % 9 != 4, lanes < 0, lanes % 32 == 7):
            args = (o, d, act.contiguous(), t_max, lay)
            kw = dict(prepass=pp, tritest=tritest)
            n0 = (f.launches, f.launches_capped, f.launches_resolve)
            got = f(*args, **kw, capped=True)
            assert (f.launches, f.launches_capped, f.launches_resolve) == (
                n0[0] + 1, n0[1] + 1, n0[2])
            assert got.shape == (4, n)
            assert torch.equal(got, ht.window_walk_hbm_plain(*args, **kw, capped=True))
            assert torch.equal(got, ht.window_capped_rows(lay, *f(*args, **kw), t_max, o, d))


def test_hbm_frame_launches_the_capped_form_on_card(tetra3_obj, cuda_device):
    """A depth-8 frame on the HBM route launches the capped epilogue once a
    shadow query (7) and the payload epilogue once a nearest query (8), and
    the (t, row) form of the HBM walk never; on the whole-table route it
    launches neither."""
    scene = load_scene(tetra3_obj, device=cuda_device)
    f = ht.window_walk_hbm
    for hbm in ("on", "off"):
        r = Renderer(scene, 64, 48, RenderConfig(max_path_length=8, hbm_tables=hbm),
                     device=cuda_device)
        assert r._intersect.hbm == (hbm == "on")
        r.run(1)
        r.sync()
        n0 = (f.launches, f.launches_resolve, f.launches_capped)
        r.run(1)
        r.sync()
        grew = tuple(a - b for a, b in zip((f.launches, f.launches_resolve,
                                            f.launches_capped), n0))
        assert grew == ((15, 8, 7) if hbm == "on" else (0, 0, 0))
        assert np.isfinite(r.image()).all()


@pytest.mark.parametrize("leaf", [56, 16, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 65537])
def test_shadow_walks_edge_shapes_on_card(n, leaf, cuda_device):
    """The redesigned capped and any-hit walks on lane counts around a warp,
    with every lane live, every lane dead and one live lane a warp, on the
    leaf-56, leaf-16 and leaf-8 layouts, with the
    NEE caps (environment lanes: target -1, cap 1e30) and with infinite caps:
    bit-equal to their plain versions on every lane."""
    name = "CornellBox-Water-plastic"
    lay = build_layout(load_scene(scene_path(name), device=cuda_device), leaf)
    rays = nee_shadow_rays(load_scene(scene_path(name), device="cpu"), n, seed=31)
    o, d, act, cap, tgt = (torch.from_numpy(a).to(cuda_device) for a in rays)
    lanes = torch.arange(n, device=cuda_device)
    masks = (torch.ones_like(act), torch.zeros_like(act), lanes % 32 == 7)
    for live in masks:
        for c in (cap, torch.full_like(cap, torch.inf)):
            assert torch.equal(ht.capped_walk(o, d, live, c, lay),
                               ht.capped_walk_plain(o, d, live, c, lay))
            want = ht.anyhit_walk_plain(o, d, live, c, tgt, lay, 1e-4)
            assert torch.equal(ht.anyhit_walk(o, d, live, c, tgt, lay, 1e-4), want)
            assert not bool(want[~live].any())
    assert bool((ht.capped_walk(o, d, masks[1], cap, lay)[0] == cap).all())


EDGE_LANES = (1, 31, 33, 65537)


@pytest.mark.parametrize("n", EDGE_LANES)
def test_rowtest_probe_edge_shapes_on_card(n, cuda_device):
    """The redesigned row-test probe (row tiles in shared memory, two lanes
    a thread) on lane counts around a warp and a block: every variant, on
    tiles of 96 and 768 lanes, with mtblock 7 (the generic
    instance) and 16 (the unrolled one), on a table that is staged whole
    (200 rows) and one that is tiled (7,112 rows), bit-equal to its plain
    version on every lane; and a table whose
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
    bit-equal to its plain version on every lane; and with prepass rows whose
    edges put the reciprocal off its fast path (scaled to denormal, past
    2^126 or to zero)."""
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
    plain version on every lane."""
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
    n0 = es.intersect_sweep1.launches
    for act in masks:
        for t_max in caps:
            for prepass, lay in ((32, base), (0, base), (32, base._replace(prepass=pre))):
                kw = dict(active=act, prepass=prepass, t_max=t_max)
                want, _ = es.intersect_sweep1_plain(o, d, lay, **kw)
                got, _ = es.intersect_sweep1(o, d, lay, **kw)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (prepass, t_max is None)
                assert bool((want.row[~act] == lay.num_tris).all())
    assert es.intersect_sweep1.launches - n0 == 24 * es.SWEEP1_LAUNCHES
    assert n < 65537 or bool(torch.isfinite(want.t[act]).any())


# ---------------------------------------------------------------------------
# the shading and the wavefront sort (csrc/shade.cu, csrc/wavefront_sort.cu)
# ---------------------------------------------------------------------------

SHADE_LANES = (1, 31, 65537)
ENV_MAP = (12, 20)  # the small seeded map's (Eh, Ew)
# (config fields, inline form, the uniform rows' layout, the scene's
# extensions: "env" a seeded map of (Eh, Ew) texels, "dispersion" Cauchy IoR
# bins); hero_wavelengths takes effect at S = 16 (render_sample's rule)
SHADE_CASES = {
    "default": ({}, False, "prng", {}),
    "inline": ({}, True, "prng", {}),
    "no-quirks-r2": ({"reference_quirks": False}, False, "r2", {}),
    "refract-tiled": ({"refract_dielectric": True}, True, "tiled", {}),
    "refract-no-quirks-cull": ({"refract_dielectric": True, "reference_quirks": False,
                                "cull_zero_nee": True, "pdf_floor": 1e-3}, False, "prng", {}),
    "last-bounce-cull": ({"cull_zero_nee": True, "max_path_length": 3}, True, "prng", {}),
    "env": ({}, False, "prng", {"env": ENV_MAP}),
    "env-inline-tiled": ({}, True, "tiled", {"env": ENV_MAP}),
    "env-no-quirks-cull-r2": ({"reference_quirks": False, "cull_zero_nee": True}, False,
                              "r2", {"env": ENV_MAP}),
    "hero": ({"hero_wavelengths": 4}, False, "prng", {}),
    "dispersion": ({}, True, "prng", {"dispersion": True}),
    "env-hero-dispersion": ({"hero_wavelengths": 2}, False, "prng",
                            {"env": (16, 32), "dispersion": True}),
}


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so that NaNs compare by payload."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(got, want, what: str) -> None:
    if got is None or want is None:
        assert got is None and want is None, what
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(_bits(got), _bits(want)), (
        what, int((_bits(got) != _bits(want)).sum()))


def _with_materials(scene, materials: str):
    """``scene`` with the materials of the kernel's kMaterials instances:
    "ggx" the seven types in turn over its materials and a drawn roughness
    table, "tex" a drawn (2, 12, 20, 3) texture stack on every other
    material (the rest untextured) and drawn texcoords from -1.5 to 2.5 (so
    that they wrap both ways), "ggx+tex" both."""
    gen = np.random.default_rng(11)
    m, t = scene.mat_type.shape[0], scene.p0.shape[1]
    if "ggx" in materials:
        scene = scene._replace(
            mat_type=torch.arange(m) % 7,
            mat_roughness=torch.from_numpy(gen.uniform(0.05, 0.95, m).astype(np.float32)))
    if "tex" in materials:
        scene = scene._replace(
            textures=torch.from_numpy(gen.random((2, 12, 20, 3), dtype=np.float32)),
            mat_tex=torch.tensor([k % 3 - 1 for k in range(m)]),
            tri_uv=torch.from_numpy(gen.uniform(-1.5, 2.5, (6, t)).astype(np.float32)))
    return scene


def _cpu_shading(n: int, spectrum: int, env=None, dispersion: bool = False, hero: int = 0,
                 materials: str = ""):
    """:func:`_cpu_shading_parity` with ``materials`` (:func:`_with_materials`)
    on the same inputs."""
    scene, inp = _cpu_shading_parity(n, spectrum, env, dispersion, hero)
    return _with_materials(scene, materials), inp


@functools.lru_cache(maxsize=None)
def _cpu_shading_parity(n: int, spectrum: int, env=None, dispersion: bool = False,
                        hero: int = 0):
    """A Water-plastic scene on the CPU with the four parity types in turn
    over its materials, a seeded (Eh, Ew) = ``env`` environment map and
    Cauchy IoR bins (``dispersion``) where asked, and its shading_inputs
    (``hero`` carried bins)."""
    from tpu_pathtracer_torch.scene import attach_dispersion, attach_env

    scene = load_scene(scene_path("CornellBox-Water-plastic"), samples=spectrum,
                       device="cpu")
    scene = scene._replace(mat_type=torch.arange(scene.mat_type.shape[0]) % 4)
    if env is not None:
        img = np.random.default_rng(env[0] * env[1]).uniform(0.2, 2.0, (*env, 3))
        img[1, 2] = (40.0, 30.0, 20.0)
        scene = attach_env(scene, img.astype(np.float32))
    if dispersion:
        scene = attach_dispersion(scene, 0.0042)
    return scene, shading_inputs(scene, n, seed=n + spectrum, hero=hero)


def _to(x, dev):
    """Tensors, and the tensors inside NamedTuples (the env light), on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        return type(x)(*(_to(v, dev) for v in x))
    return x


def _card_shading(n: int, spectrum: int, form: str, dev, env=None, dispersion=False,
                  hero: int = 0, materials: str = ""):
    """:func:`_cpu_shading` on the card -> (scene, state, hit, uniforms); the
    uniform rows as the frame lays them out: row views of one (6, N) block,
    (10, N) with an env (PRNG, r2), or TILED's stacked rows and the env's
    own (4, N) block."""
    scene, inp = _cpu_shading(n, spectrum, env, dispersion, hero, materials)
    scene = _to(scene, dev)
    st = twf.PathState(**{k: torch.from_numpy(v).to(dev) for k, v in inp["state"].items()})
    hit = HitShade(**{k: torch.from_numpy(v).to(dev) for k, v in inp["hit"].items()})
    u = torch.from_numpy(inp["u"]).to(dev)
    if form == "prng":
        uni = {"light_select": u[0], "light_bary": u[1:3], "lobe": u[3], "bounce_dir": u[4:6]}
        if env is not None:
            uni.update(env_select=u[6], env_alias=u[7], env_jit=u[8:10])
    elif form == "r2":
        uni = {"light_bary": u[0:2], "bounce_dir": u[2:4], "light_select": u[4], "lobe": u[5]}
        if env is not None:
            uni.update(env_jit=u[6:8], env_select=u[8], env_alias=u[9])
    else:
        sx, sy, sz, sw = u[:4].contiguous()
        uni = {"light_select": sz, "light_bary": torch.stack([sw, sx]), "lobe": sy,
               "bounce_dir": torch.stack([sz, sw])}
        if env is not None:
            ue = u[6:10].clone()
            uni.update(env_select=ue[0], env_alias=ue[1], env_jit=ue[2:4])
    return scene, st, hit, uni


@pytest.mark.parametrize("case", list(SHADE_CASES))
@pytest.mark.parametrize("spectrum", [3, 16])
@pytest.mark.parametrize("n", SHADE_LANES)
def test_shade_bounce_matches_plain_on_card(n, spectrum, case, cuda_device):
    """csrc/shade.cu == render/wavefront.py:_shade_plain bit for bit on every
    output (the new state, the shadow pack, the inline form's shadow origin,
    the two counts), lane counts around a warp and past 65,536, S = 3 and
    16, quirks, refraction, zero-NEE culling, the last bounce's gate and a
    raised pdf floor, the uniform rows of PRNG, r2 and TILED noise; the
    environment light (both NEE arms, the last alias slot, the poles, the
    BSDF arm's misses), hero bins (C = 4, and C = 2 with env and
    dispersion at S = 16) and dispersion."""
    kw, inline, form, ext = SHADE_CASES[case]
    cfg = RenderConfig(spectrum_samples=spectrum, **kw)
    hero = cfg.hero_wavelengths if spectrum > 3 else 0
    scene, st, hit, uni = _card_shading(n, spectrum, form, cuda_device, ext.get("env"),
                                        ext.get("dispersion", False), hero)
    assert tshade.shade_kernel_covers(cfg, scene)
    bounce = 2
    n0 = tshade.shade_bounce.launches
    got = tshade.shade_bounce(scene, cfg, bounce, st, uni, hit, inline)
    assert tshade.shade_bounce.launches == n0 + 1
    want = tshade.shade_bounce_plain(scene, cfg, bounce, st, uni, hit, inline)
    for f, a, b in zip(twf.PathState._fields, got[0], want[0]):
        _same(a, b, f"state.{f}")
    assert got[0].pixel is st.pixel and got[0].bins is st.bins
    for f, a, b in zip(twf.ShadowPack._fields, got[1], want[1]):
        _same(a, b, f"pack.{f}")
    _same(got[2], want[2], "shadow origin")
    assert [int(x) for x in got[3]] == [int(x) for x in want[3]]
    if cfg.max_path_length == bounce + 1:
        assert not bool(got[1].ok.any())
    if "env" in ext and n > 1000:
        env_lanes = got[1].target == -1
        assert 0 < int(env_lanes.sum()) < n and bool(got[1].ok[env_lanes].any())


# the kMaterials instances' cases: (config fields, inline form, the uniform
# rows' layout, the scene's extensions), each over every combination of the
# GGX types and textures; hero_wavelengths takes effect at S = 16
MATERIAL_CASES = {
    "parity": ({}, False, "prng", {}),
    "inline-no-quirks-r2": ({"reference_quirks": False}, True, "r2", {}),
    "refract-cull": ({"refract_dielectric": True, "cull_zero_nee": True, "pdf_floor": 1e-3},
                     False, "prng", {}),
    "last-bounce": ({"max_path_length": 3}, True, "prng", {}),
    "env": ({}, False, "prng", {"env": ENV_MAP}),
    "hero": ({"hero_wavelengths": 4}, False, "prng", {}),
    "hero-env": ({"hero_wavelengths": 4}, True, "prng", {"env": ENV_MAP}),
    "dispersion": ({}, False, "prng", {"dispersion": True}),
    "env-hero-dispersion": ({"hero_wavelengths": 2}, False, "prng",
                            {"env": (16, 32), "dispersion": True}),
}


@pytest.mark.parametrize("materials", ["ggx", "tex", "ggx+tex"])
@pytest.mark.parametrize("case", list(MATERIAL_CASES))
@pytest.mark.parametrize("spectrum", [3, 16])
@pytest.mark.parametrize("n", SHADE_LANES)
def test_shade_bounce_materials_match_plain_on_card(n, spectrum, case, materials,
                                                    cuda_device):
    """The kMaterials instances of csrc/shade.cu == render/wavefront.py:
    _shade_plain bit for bit on every output and count: the seven material
    types over the scene's materials with a drawn roughness table (the GGX
    lobes' evaluation and VNDF sample, the rough conductor's Schlick albedo
    on both arms, the scalar-Fresnel lobe choice of rough plastic and
    dielectric, the per-lobe emitter-hit flag, the conventional emitter-hit
    weight), a drawn texture stack on some materials with texcoords that
    wrap (the bilinear taps, the texel lifted to S = 16's bands and to hero
    bins), and both together; with the parity form, the env light, hero
    bins, hero bins with the env, dispersion and all three, quirks off,
    refraction, culling and the last bounce.  The counts go on with the
    lanes that hit a GGX type and those that hit a textured material."""
    kw, inline, form, ext = MATERIAL_CASES[case]
    cfg = RenderConfig(spectrum_samples=spectrum, **kw)
    hero = cfg.hero_wavelengths if spectrum > 3 else 0
    scene, st, hit, uni = _card_shading(n, spectrum, form, cuda_device, ext.get("env"),
                                        ext.get("dispersion", False), hero, materials)
    assert tshade.shade_kernel_covers(cfg, scene) and tshade.has_materials(scene)
    got = tshade.shade_bounce(scene, cfg, 2, st, uni, hit, inline)
    want = tshade.shade_bounce_plain(scene, cfg, 2, st, uni, hit, inline)
    for f, a, b in zip(twf.PathState._fields, got[0], want[0]):
        _same(a, b, f"state.{f}")
    for f, a, b in zip(twf.ShadowPack._fields, got[1], want[1]):
        _same(a, b, f"pack.{f}")
    _same(got[2], want[2], "shadow origin")
    counts = [int(x) for x in got[3]]
    assert counts == [int(x) for x in want[3]]
    assert len(counts) == (6 if "env" in ext else 4)
    ggx_lanes, tex_lanes = counts[-2:]
    if n > 1000:
        assert (ggx_lanes > 0) == ("ggx" in materials) and (tex_lanes > 0) == ("tex" in materials)
        assert max(ggx_lanes, tex_lanes) < counts[0]


@pytest.mark.parametrize("texel", ["clean", "nan", "+inf", "negative", "-0"])
@pytest.mark.parametrize("n", SHADE_LANES)
def test_shade_bounce_env_texel_rule_on_card(n, texel, cuda_device):
    """The env-lit kernel reads the env's texel off the misses only where the
    map is clean (EnvLight.radiance_max) and radiance_max * throughput is
    finite: bit-equal to the plain version with throughputs of +-0, the
    float maximum, +-inf and NaN on lanes that hit, on a clean map and on
    maps whose most-seen texel is NaN, +inf, negative or -0 (the
    every-lane path)."""
    from tpu_pathtracer_torch.models.envlight import TABLES, env_to, texel_index

    scene, st, hit, uni = _card_shading(n, 3, "prng", cuda_device, ENV_MAP)
    thr = st.throughput.clone()
    special = torch.tensor([0.0, -0.0, 3.4028234663852886e38, -3.4028234663852886e38,
                            float("inf"), float("-inf"), float("nan"), 1e30],
                           device=cuda_device)
    thr[:, ::3] = special[torch.arange(thr[:, ::3].numel(), device=cuda_device)
                          % special.numel()].view(thr[:, ::3].shape)
    st = st._replace(throughput=thr)
    env = scene.env
    if texel != "clean":
        hits = st.alive & torch.isfinite(hit.t)
        idx = texel_index(env, st.direction)[hits]
        common = int(torch.mode(idx).values) if idx.numel() else 0
        rad = env.radiance.cpu().numpy().copy()
        rad.reshape(rad.shape[0], -1)[:, common] = {"nan": np.nan, "+inf": np.inf,
                                                    "negative": -0.5, "-0": -0.0}[texel]
        # env_to derives the records and radiance_max anew from the tables
        env = env_to({**{k: getattr(env, k).cpu().numpy() for k in TABLES},
                      "radiance": rad}, cuda_device)
        scene = scene._replace(env=env)
    assert (env.radiance_max is None) == (texel != "clean")
    cfg = RenderConfig()
    got = tshade.shade_bounce(scene, cfg, 1, st, uni, hit, False)
    want = tshade.shade_bounce_plain(scene, cfg, 1, st, uni, hit, False)
    for f, a, b in zip(twf.PathState._fields, got[0], want[0]):
        _same(a, b, f"state.{f}")
    for f, a, b in zip(twf.ShadowPack._fields, got[1], want[1]):
        _same(a, b, f"pack.{f}")


@pytest.mark.parametrize("spectrum,hero", [(3, 0), (16, 4)])
@pytest.mark.parametrize("n", SHADE_LANES)
def test_shade_bounce_env_alias_picks_on_card(n, spectrum, hero, cuda_device):
    """A sharply peaked map (one texel 1e5 times the rest), so that most of
    the lanes whose NEE picks the env take their slot's alias: the kernel
    reading the env records (models/envlight.py:env_records), S = 3 and
    hero C = 4 of S = 16, bit-equal to the plain version."""
    from tpu_pathtracer_torch.models.envlight import TABLES, env_to
    from tpu_pathtracer_torch.scene import attach_env

    scene, st, hit, uni = _card_shading(n, spectrum, "prng", cuda_device, ENV_MAP, hero=hero)
    img = np.full((*ENV_MAP, 3), 0.01, np.float32)
    img[4, 7] = 1e3
    peak = attach_env(load_scene(scene_path("CornellBox-Water-plastic"), samples=spectrum,
                                 device="cpu"), img).env
    env = env_to({k: getattr(peak, k).numpy() for k in TABLES}, cuda_device)
    scene = scene._replace(env=env)
    k = env.pdf_sa.numel()
    x = uni["env_alias"] * float(np.float32(k))
    slot = x.to(torch.int32).clamp(0, k - 1).long()
    picks = uni["env_select"] < env.select_p
    take = (x - slot.float() >= env.alias_p[slot]) & picks
    if n > 1000:
        assert int(take.sum()) > 0.9 * int(picks.sum()) > 0
    cfg = RenderConfig(spectrum_samples=spectrum, hero_wavelengths=hero)
    got = tshade.shade_bounce(scene, cfg, 1, st, uni, hit, False)
    want = tshade.shade_bounce_plain(scene, cfg, 1, st, uni, hit, False)
    for f, a, b in zip(twf.PathState._fields, got[0], want[0]):
        _same(a, b, f"state.{f}")
    for f, a, b in zip(twf.ShadowPack._fields, got[1], want[1]):
        _same(a, b, f"pack.{f}")
    assert [int(x) for x in got[3]] == [int(x) for x in want[3]]


def test_shade_bounce_checks_inputs(cuda_device):
    """The wrapper raises on what the kernel does not take: a frame it does
    not cover (more than 16 carried planes: S = 17, or hero C = 17), a
    roughness table of another dtype, a texture stack of another shape,
    refraction with dispersion (NotImplementedError,
    as the plain version), a non-contiguous plane, a wrong dtype, an env
    light of another spectrum than the frame's (S = 16 at S = 3, S = 3 at S
    = 4: its records would be read as another layout); it copies
    nothing."""
    from tpu_pathtracer_torch.models.envlight import build_env

    scene, st, hit, uni = _card_shading(64, 3, "prng", cuda_device)
    cfg = RenderConfig()
    n0 = tshade.shade_bounce.launches
    sky = np.random.default_rng(8).uniform(0.0, 4.0, (*ENV_MAP, 3)).astype(np.float32)
    for s, other in ((3, 16), (4, 3)):
        env_scene, env_st, env_hit, env_uni = _card_shading(64, s, "prng", cuda_device, ENV_MAP)
        env_scene = env_scene._replace(env=build_env(sky, samples=other, device=cuda_device))
        with pytest.raises(ValueError):
            tshade.shade_bounce(env_scene, RenderConfig(spectrum_samples=s), 0, env_st,
                                env_uni, env_hit, False)
    for bad_scene, bad_cfg in (
            (scene._replace(mat_roughness=torch.zeros_like(scene.mat_ior).double()), cfg),
            (scene._replace(textures=scene.mat_diffuse, mat_tex=scene.mat_type,
                            tri_uv=scene.p0), cfg),
            (scene, RenderConfig(spectrum_samples=17)),
            (scene, RenderConfig(spectrum_samples=32, hero_wavelengths=17))):
        with pytest.raises(ValueError):
            tshade.shade_bounce(bad_scene, bad_cfg, 0, st, uni, hit, False)
    with pytest.raises(NotImplementedError):
        tshade.shade_bounce(scene._replace(mat_ior_bins=scene.mat_diffuse),
                            RenderConfig(refract_dielectric=True), 0, st, uni, hit, False)
    with pytest.raises(ValueError):
        tshade.shade_bounce(scene, cfg, 0, st._replace(origin=st.origin.t().contiguous().t()),
                            uni, hit, False)
    with pytest.raises(ValueError):
        tshade.shade_bounce(scene, cfg, 0, st, uni, hit._replace(tri=hit.tri.int()), False)
    assert tshade.shade_bounce.launches == n0


def _sort_state(n: int, dev, hero: bool):
    """torch_parity.sort_inputs on the card with drawn planes beside them, a
    shadow pack, and (4, N) hero bins when ``hero``."""
    o, d, alive, pixel = sort_inputs(n, seed=n)
    gen = np.random.default_rng(n + 1)
    f = lambda *shape: torch.from_numpy(gen.random(shape, dtype=np.float32)).to(dev)  # noqa: E731
    st = twf.PathState(
        origin=torch.from_numpy(o).to(dev), direction=torch.from_numpy(d).to(dev),
        throughput=f(3, n), radiance=f(3, n), pdf=f(n), prev_diffuse=f(n), ior=f(n),
        alive=torch.from_numpy(alive).to(dev), pixel=torch.from_numpy(pixel).to(dev),
        bins=(torch.from_numpy(gen.integers(0, 16, (4, n))).to(dev) if hero else None))
    pack = twf.ShadowPack(to_light=f(3, n), cap=f(n),
                          target=torch.from_numpy(gen.integers(-1, 36, n)).to(dev),
                          contrib=f(3, n), ok=torch.from_numpy(gen.random(n) < 0.5).to(dev))
    return st, pack


@pytest.mark.parametrize("hero", [False, True])
@pytest.mark.parametrize("n", SHADE_LANES)
def test_wavefront_sort_matches_plain_on_card(n, hero, cuda_device):
    """csrc/wavefront_sort.cu == the plain key and index_selects bit for
    bit: the int64 key on every lane (zero components, back-facing
    directions, origins past the box's clamps, dead lanes), every plane of
    the state and pack gathered by the permutation, with and without hero
    bins; sort_wavefront on the card == its plain route."""
    st, pack = _sort_state(n, cuda_device, hero)
    wmin, winv = (-1.0, 0.0, -1.0), (0.5, 0.5, 0.5)
    k0, g0 = tsort.sort_key.launches, tsort.gather_planes.launches
    key = tsort.sort_key(st.origin, st.direction, st.alive, st.pixel, wmin, winv)
    assert torch.equal(key, tsort.sort_key_plain(st.origin, st.direction, st.alive,
                                                 st.pixel, wmin, winv))
    perm = torch.sort(key, stable=True).indices
    planes = [*st, *pack]
    got = tsort.gather_planes(planes, perm)
    for a, b in zip(got, tsort.gather_planes_plain(planes, perm)):
        _same(a, b, "plane")
    assert (tsort.sort_key.launches, tsort.gather_planes.launches) == (k0 + 1, g0 + 1)
    sst, spk = twf.sort_wavefront(st, wmin, winv, pack)
    assert (tsort.sort_key.launches, tsort.gather_planes.launches) == (k0 + 2, g0 + 2)
    for a, b in zip([*sst, *spk], got):
        _same(a, b, "sort_wavefront")
    with pytest.raises(ValueError):
        tsort.gather_planes([st.origin.t()], perm)


@pytest.mark.parametrize("pass_bytes", [1, 4 << 10, 24 << 20])
@pytest.mark.parametrize("planes", ["s3", "hero", "s16"])
@pytest.mark.parametrize("n", SHADE_LANES)
def test_gather_planes_from_key_matches_plain_on_card(n, planes, pass_bytes, cuda_device,
                                                      monkeypatch):
    """The gather in passes (one row a pass at pass_bytes 1, a few at 4 KiB,
    the default) with pixel and alive read from the sorted key == the plain
    index_selects bit for bit, on the S = 3 plane set, with (4, N) hero bins
    and with S = 16 planes (65 rows); the key's pixel ids reach 2^32 - 1."""
    st, pack = _sort_state(n, cuda_device, planes == "hero")
    if planes == "s16":
        gen = torch.Generator(device=cuda_device).manual_seed(n)
        wide = lambda: torch.rand(16, n, generator=gen, device=cuda_device)  # noqa: E731
        st = st._replace(throughput=wide(), radiance=wide())
        pack = pack._replace(contrib=wide())
    monkeypatch.setattr(tsort, "PASS_BYTES", pass_bytes)
    key = tsort.sort_key(st.origin, st.direction, st.alive, st.pixel, (-1.0, 0.0, -1.0),
                         (0.5, 0.5, 0.5))
    skey, perm = torch.sort(key, stable=True)
    items = [*st, *pack]
    at = {"pixel": twf.PathState._fields.index("pixel"),
          "alive": twf.PathState._fields.index("alive")}
    g0 = tsort.gather_planes.launches
    got = tsort.gather_planes(items, perm, skey, **at)
    assert tsort.gather_planes.launches == g0 + 1
    want = tsort.gather_planes_plain(items, perm)
    for k, (a, b) in enumerate(zip(got, want)):
        _same(a, b, f"plane {k}")
    for k, (a, b) in enumerate(zip(tsort.gather_planes(items, perm), want)):
        _same(a, b, f"plane {k} without the key")
    with pytest.raises(ValueError):  # a pixel plane that is not int64 (N,)
        tsort.gather_planes(items, perm, skey, pixel=at["alive"])


@pytest.mark.parametrize("kw", [{}, {"sort_rays": False}, {"fuse_shadow_walk": True},
                                {"prefix_sort": True, "secondary_tile": 64},
                                {"env": True}, {"spectral": True},
                                {"spectral": True, "env": True}, {"ggx": True},
                                {"ggx": True, "spectral": True, "env": True}],
                         ids=("sorted", "unsorted", "fused", "prefix", "env-lit", "spectral",
                              "spectral-env", "ggx-textured", "ggx-textured-spectral-env"))
def test_frame_kernels_match_plain_stages_on_card(kw, cuda_device, monkeypatch):
    """A Water-plastic frame (96x64, depth 8) through the shading and sort
    kernels == the same frame with their plain versions put back, bit for
    bit; the kernels launch 8 shadings and, on the sorted pipeline, 7 keys
    and gathers a frame.  Also env-lit (a seeded 16x32 map) and the
    spectral CLI configuration (S = 16, hero 4, dispersion 0.0042), without
    and with the env; and the GGX and textured box (water-ggx-textured, the
    kMaterials instances), alone and in the spectral CLI configuration with
    the env."""
    from tpu_pathtracer_torch.scene import attach_dispersion, attach_env

    kw = dict(kw)
    env, spectral, ggx = kw.pop("env", False), kw.pop("spectral", False), kw.pop("ggx", False)
    cfg = RenderConfig(**kw, **({"spectrum_samples": 16, "hero_wavelengths": 4}
                                if spectral else {}))
    scene = load_scene(scene_path("water-ggx-textured" if ggx else "CornellBox-Water-plastic"),
                       device=cuda_device, samples=cfg.spectrum_samples, rough_materials=ggx)
    assert tshade.has_materials(scene) == ggx
    if spectral:
        scene = attach_dispersion(scene, 0.0042)
    if env:
        img = np.random.default_rng(7).uniform(0.2, 2.0, (16, 32, 3)).astype(np.float32)
        scene = attach_env(scene, img)
    frames = 2
    counts = (tshade.shade_bounce, tsort.sort_key, tsort.gather_planes)
    r = Renderer(scene, 96, 64, cfg, device=cuda_device)
    n0 = [c.launches for c in counts]
    r.run(frames)
    got = [c.launches - n for c, n in zip(counts, n0)]
    sorts = 0 if kw.get("sort_rays") is False else 7 * frames
    assert got == [8 * frames, sorts, sorts]
    img = r.image()
    monkeypatch.setattr(tshade, "shade_bounce", tshade.shade_bounce_plain)
    monkeypatch.setattr(tsort, "sort_key", tsort.sort_key_plain)
    monkeypatch.setattr(tsort, "gather_planes", lambda planes, perm, *key, out=None, **at:
                        tsort.gather_planes_plain(planes, perm, out=out))
    if ggx:
        # the plain texel lift at S > 3 copies its band masks from the host,
        # which a graph capture refuses: the plain stages run eagerly (the
        # program captures a chain only where the kernel shades it)
        r._capture = None
    r.reset()
    r.run(frames)
    assert np.isfinite(img).all() and np.array_equal(img, r.image())


# the frames of the tracing tests: the main path, the spectral CLI path with
# the env (hero bins, dispersion, the env's records) and the GGX and
# textured box (the kMaterials instances); 270x480 on the default ladder
# (129,600 lanes: four rungs)
TRACED_FRAMES = {"main": {}, "spectral-env": {"spectral": True, "env": True},
                 "ggx-textured": {"ggx": True}}


def _traced_renderer(kind: str, dev):
    from tpu_pathtracer_torch.scene import attach_dispersion, attach_env

    spectral = TRACED_FRAMES[kind].get("spectral", False)
    ggx = TRACED_FRAMES[kind].get("ggx", False)
    cfg = RenderConfig(frames_in_flight=8, **({"spectrum_samples": 16, "hero_wavelengths": 4}
                                              if spectral else {}))
    scene = load_scene(scene_path("water-ggx-textured" if ggx else "CornellBox-Water-plastic"),
                       device=dev, samples=cfg.spectrum_samples, rough_materials=ggx)
    if spectral:
        scene = attach_dispersion(scene, 0.0042)
    if TRACED_FRAMES[kind].get("env"):
        img = np.random.default_rng(7).uniform(0.2, 2.0, (16, 32, 3)).astype(np.float32)
        scene = attach_env(scene, img)
    return Renderer(scene, 480, 270, cfg, seed=3, device=dev)


def _syncs(step) -> list[str]:
    """The synchronising CUDA operations ``step()`` makes, as the sync debug
    mode warns of them (the mode is switched on once before, so that a
    notice torch gives the first time is not counted)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}: {w.message}" for w in seen
            if "synchronizing" in str(w.message)]


def _steady(r, frames: int = 12) -> None:
    """Step ``r`` until a frame captures no bounce chain (render/graphs.py):
    every key its ladder meets has been met before."""
    graphs = [g for g, _ in r._plans._graphs.values()]
    for _ in range(frames):
        before = sum(g.captures for g in graphs)
        r.step()
        if sum(g.captures for g in graphs) == before:
            return
    raise AssertionError(f"no frame of {frames} captured nothing")


@pytest.mark.parametrize("kind", list(TRACED_FRAMES))
def test_host_reads_are_the_frames_syncs_on_card(kind, cuda_device):
    """A traced frame's host_reads equal the synchronising operations that
    torch.cuda.set_sync_debug_mode reports over the same frame, and an
    untraced frame makes as many (tracing adds no host read): one ladder
    read a secondary bounce (the renderer's wavefront plan, built at reset,
    holds the camera's basis and the sort bounds), whether the bounces
    replay as graphs (untraced, and under the profiler) or run from Python
    (a StageTimer's frame)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.render.timing import StageTimer

    r = _traced_renderer(kind, cuda_device)
    _steady(r)
    r.sync()
    untraced = _syncs(r.step)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        replayed = _syncs(r.step)
    rec = r.frame_records[-1]
    timed = _syncs(lambda: r.step(timer=StageTimer()))
    eager = r.frame_records[-1]
    assert rec["graph_replays"] + rec["graph_captures"] == 8
    assert (eager["graph_replays"], eager["graph_captures"]) == (0, 0)
    assert (rec["host_reads"] == eager["host_reads"] == len(replayed) == len(timed)
            == len(untraced) == 7), (replayed, timed, untraced)


@pytest.mark.parametrize("kind", list(TRACED_FRAMES))
def test_plan_frames_are_planless_frames_on_card(kind, cuda_device):
    """On the card, three frames of a Renderer (made from its wavefront
    plans) equal, bit for bit, the same frames made by render_frame with no
    plans (each wavefront builds its own), and no frame writes into a
    plan's tensors."""
    from tpu_pathtracer_torch.render.state import render_frame

    r = _traced_renderer(kind, cuda_device)
    plans = [t for _, _, plan in r._plans._held.values() for t in (plan.pids, *plan.camera)]
    before = [t.clone() for t in plans]
    state = r.state
    for _ in range(3):
        r.step()
        state = render_frame(state, r.scene, r.cfg, r.camera, r._intersect)
    r.sync()
    assert torch.equal(r.state.accum.view(torch.int32), state.accum.view(torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(plans, before))


@pytest.mark.parametrize("spectrum,hero", [(3, 0), (16, 4)])
def test_shade_env_counts_on_card(spectrum, hero, cuda_device):
    """The env-lit shading kernel's env picks and misses equal the torch
    reductions chip_smoke.shade_bound prices (NEE picked the env; the lane
    is live and its ray missed) on one wavefront, as the plain version's
    do; without an env the kernel gives the two counts alone."""
    cfg = RenderConfig(spectrum_samples=spectrum, hero_wavelengths=hero)
    scene, st, hit, uni = _card_shading(65537, spectrum, "prng", cuda_device, ENV_MAP,
                                        hero=hero)
    got = tshade.shade_bounce(scene, cfg, 1, st, uni, hit, False)[3]
    want = tshade.shade_bounce_plain(scene, cfg, 1, st, uni, hit, False)[3]
    picks = int((uni["env_select"] < scene.env.select_p).sum())
    misses = int((st.alive & ~torch.isfinite(hit.t)).sum())
    assert [int(x) for x in got] == [int(x) for x in want]
    assert [int(x) for x in got[2:]] == [picks, misses]
    assert 0 < picks < 65537 and 0 < misses < 65537
    plain, pst, phit, puni = _card_shading(4097, spectrum, "prng", cuda_device, None,
                                           hero=hero)
    assert len(tshade.shade_bounce(plain, cfg, 1, pst, puni, phit, False)[3]) == 2


def _device_activities(r, traced: bool, monkeypatch) -> list[tuple]:
    """Two more frames of ``r`` under torch.profiler, with their spans and
    counters or with tracing forced off -> their device activities
    (kernels, copies, sets) in order, each (name, launched by a CUDA graph's
    replay)."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.render import timing

    with monkeypatch.context() as m:
        if not traced:
            m.setattr(timing, "profiling", lambda: False)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r.step()
            r.step()
            r.sync()
    assert len(r.frame_records) == 2 * traced
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
    graph = {e["args"]["correlation"] for e in ev
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "GraphLaunch" in e.get("name", "") and "correlation" in e.get("args", {})}
    dev = sorted((float(e["ts"]), e["name"], e.get("args", {}).get("correlation") in graph)
                 for e in ev if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return [(n, g) for _, n, g in dev]


@pytest.mark.parametrize("kind", list(TRACED_FRAMES))
def test_tracing_launches_the_same_kernels_on_card(kind, cuda_device, monkeypatch):
    """Under torch.profiler frames with their spans and counters and the
    same frames with tracing forced off launch the same device activities
    (kernels, copies, sets), name for name and in order, on the eager loop
    (a renderer without a capturer: render/graphs.py).  Two frames are
    profiled and their activities compared from the end, over at least one
    and a half frames: a profile can come back without its first few
    activities."""

    def activities(traced: bool) -> list[str]:
        r = _traced_renderer(kind, cuda_device)
        r._capture = None
        r.reset()
        r.step()
        r.sync()
        return [n for n, _ in _device_activities(r, traced, monkeypatch)]

    on, off = activities(True), activities(False)
    m = min(len(on), len(off))
    assert m >= 0.75 * max(len(on), len(off)) and m > 200
    assert on[-m:] == off[-m:]


def _graph_node(name: str, in_graph: bool) -> str:
    """An activity's name, with the two names the trace gives one set node
    of a replayed graph taken as one: across replays of one graph CUPTI
    names the same node a ``Memset`` or a ``Memcpy DtoD``, and a memset's
    memory ``Device`` or ``Unknown``."""
    if in_graph and (name.startswith("Memset") or name.startswith("Memcpy DtoD")):
        return "graph set node"
    return name


@pytest.mark.parametrize("kind", list(TRACED_FRAMES))
def test_tracing_launches_the_same_kernels_with_graphs_on_card(kind, cuda_device,
                                                               monkeypatch):
    """As test_tracing_launches_the_same_kernels_on_card for frames whose
    bounces replay as CUDA graphs: the same device activities name for name
    and in order, a set or copy node inside a replay named either way
    (:func:`_graph_node`), every other activity -- the launches from Python
    between the replays, the sorts among them -- by its own name.  Both
    renderers step until a frame meets no new ladder width, and capture
    after a profiler session has run in the process: a graph instantiated
    before the process's first session reports its set and copy nodes as
    kernels (``memset32``, ``memcpy32_post``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=cuda_device)

    def activities(traced: bool) -> list[tuple]:
        r = _traced_renderer(kind, cuda_device)
        _steady(r)
        r.sync()
        got = _device_activities(r, traced, monkeypatch)
        assert all(rec["graph_replays"] == 8 for rec in r.frame_records)
        assert any(g for _, g in got) and not all(g for _, g in got)
        return [(_graph_node(n, g), g) for n, g in got]

    on, off = activities(True), activities(False)
    m = min(len(on), len(off))
    assert m >= 0.75 * max(len(on), len(off)) and m > 200
    assert on[-m:] == off[-m:]


@pytest.mark.parametrize("kind", list(TRACED_FRAMES))
def test_graph_frames_equal_eager_frames_on_card(kind, cuda_device):
    """Five frames whose bounces replay as CUDA graphs (render/graphs.py)
    equal, bit for bit, the same five frames of the eager loop (the same
    renderer without a capturer), frame by frame; the graph renderer
    replayed chains in the later frames."""
    r = _traced_renderer(kind, cuda_device)
    eager = _traced_renderer(kind, cuda_device)
    eager._capture = None
    eager.reset()
    assert r._plans._graphs and not eager._plans._graphs
    for _ in range(5):
        r.step()
        eager.step()
        assert np.array_equal(r.image(), eager.image())
    g, = [g for g, _ in r._plans._graphs.values()]
    assert g.replays > 0 and g.captures + g.replays == 5 * 8


@pytest.mark.parametrize("kind", list(TRACED_FRAMES))
def test_steady_graph_frame_replays_a_chain_a_bounce_on_card(kind, cuda_device):
    """A steady frame (every ladder width met before) captures nothing and
    replays 8 chains, one a bounce; its record holds the eager frame's
    shading launches (lanes, the ladder's live reads, planes, hero, env,
    kernel, env picks and misses are read), one shade span a replay and the
    7 sorts' spans between them; the wrappers' launch counters grow as the
    eager loop's do (8 shadings and 8 payload walks a frame, counted from
    the captures: ops/launch_count.py; 7 sort keys and gathers, launched
    from Python)."""
    from torch.profiler import ProfilerActivity, profile

    counted = (tshade.shade_bounce, tsort.sort_key, tsort.gather_planes,
               ht.window_walk_resolve)
    r = _traced_renderer(kind, cuda_device)
    _steady(r)
    r.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(5):  # until a profiled frame meets no new width too
            n0 = [f.launches for f in counted]
            r.step()
            r.sync()
            rec = r.frame_records[-1]
            if not rec["graph_captures"]:
                break
    grew = [f.launches - n for f, n in zip(counted, n0)]
    assert (rec["graph_captures"], rec["graph_replays"]) == (0, 8)
    assert grew == [8, 7, 7, 8]
    names = [x[0] for x in rec["spans"]]
    assert (names.count("shade"), names.count("sort"), names.count("host_read")) == (8, 7, 7)
    launches = rec["launches"]
    assert [x["bounce"] for x in launches] == list(range(8))
    assert launches[0]["live"] == launches[0]["lanes"] == 480 * 270
    assert all(x["kernel"] and x["live"] <= x["lanes"] for x in launches)
    assert rec["traced_rays"] > 480 * 270
    if TRACED_FRAMES[kind].get("env"):
        assert all(x["env_picks"] is not None and x["env_misses"] is not None
                   for x in launches)
    if TRACED_FRAMES[kind].get("ggx"):
        # the kMaterials counts, read from the replays' copies
        assert all(x["rough"] and x["textured"] and x["ggx_lanes"] is not None
                   and x["tex_lanes"] is not None for x in launches)
        assert all(0 < x["ggx_lanes"] < x["live"] and 0 < x["tex_lanes"] < x["live"]
                   for x in launches[:2])
