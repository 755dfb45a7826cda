"""The forms of the window walk and the sweep this port adds for the
production-scale path -- the Moller-Trumbore rows (tritest="mt") and the
HBM route -- against the reference's Pallas kernels in interpret mode on the
reference's own layout tables (cornellbox and Water-plastic at leaf 56 with
the 32-row prepass).

Tolerances, each with its reason:
  * t to rtol 1e-6 or atol 1e-6, triangle ids equal except equal-t ties
    (torch_parity.assert_hits_agree: XLA contracts multiply-adds into FMAs
    in interpret mode, torch does not); the latched original ids equal
    where the rows agree; the useful rows never above the reference's row 7
    (a per-thread walk enters a subset of the TPU tile walk's leaves);
  * the HBM route's triangle ids exact.
On CPU tensors no kernel launches.  Whole frames through these forms are
in tests/test_torch_frame_scale.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer.accel import build_layout
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.scene import load_scene, scene_path
from tpu_pathtracer_torch import interop
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from torch_parity import arrays, assert_hits_agree, random_rays

KERNELS = ("window_walk", "window_walk_orig", "window_walk_counts", "window_walk_hbm",
           "sweep", "capped_walk", "anyhit_walk", "minwalk")


@pytest.fixture(scope="module", params=["cornellbox", "CornellBox-Water-plastic"])
def setup(request):
    """(reference scene, leaf-56 and leaf-8 layouts, port copies)."""
    scene = load_scene(scene_path(request.param))
    lay, occl = build_layout(scene, leaf_size=56), build_layout(scene, leaf_size=8)
    return {"scene": scene, "lay": lay, "occl": occl,
            "tscene": interop.scene_from_arrays(arrays(scene)),
            "tlay": interop.layout_from_arrays(arrays(lay)),
            "tocc": interop.layout_from_arrays(arrays(occl))}


def _launches():
    return tuple(getattr(ht, k).launches for k in KERNELS)


def _rays(seed, n=256):
    """Seeded rays with every 7th lane inactive and every 3rd capped at 1.5."""
    o, d = random_rays(n, seed)
    active = np.arange(n) % 7 != 3
    t_max = np.where(np.arange(n) % 3 == 0, 1.5, np.inf).astype(np.float32)
    return o, d, active, t_max


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.mark.parametrize("latch", ["rows", "argmin"])
def test_window_walk_mt_matches_pallas(setup, latch):
    """Kernel 5's plain version and its orig and counts forms ==
    _window_kernel(tritest="mt") with both latches: t and rows, the latched
    original id, and useful <= row 7."""
    o, d, active, t_max = _rays(61)
    with pltpu.force_tpu_interpret_mode():
        raw, _ = pt.intersect_bvh_window(
            jnp.asarray(o), jnp.asarray(d), setup["lay"], tile=128, raw=True,
            tritest="mt", latch=latch, prepass=32, with_orig=True, with_counts=True,
            active=jnp.asarray(active), t_max=jnp.asarray(t_max))
    raw = np.asarray(raw)
    args = (*_t(o, d, active, t_max), setup["tlay"])
    before = _launches()
    t, row = ht.window_walk(*args, prepass=32, tritest="mt")
    t_o, row_o, orig = ht.window_walk_orig(*args, prepass=32, tritest="mt")
    t_c, row_c, useful, spent = ht.window_walk_counts(*args, prepass=32, tritest="mt")
    assert _launches() == before
    for a, b in ((t, t_o), (t, t_c), (row, row_o), (row, row_c)):
        assert torch.equal(a, b)
    hit = lambda x: np.where(x < t_max, x, np.inf)  # noqa: E731
    same = assert_hits_agree(hit(raw[0]), raw[1].astype(np.int32), hit(t.numpy()),
                             row.numpy())
    assert np.isfinite(hit(t.numpy())).any()
    assert (row.numpy()[~active] == setup["tlay"].num_tris).all()
    np.testing.assert_array_equal(orig.numpy()[same], raw[2][same].astype(np.int32))
    assert (orig.numpy()[~np.isfinite(hit(t.numpy()))] == -1).all()
    useful = useful.numpy()
    assert useful.sum() > 0 and (useful[~active] == 0).all()
    assert (useful <= raw[7]).all()
    # spent is per warp (prepass + row-test slots of 32 lanes each): summed
    # over a warp's lanes it covers the prepass and every useful row
    per_warp = lambda x: x.reshape(-1, 32).sum(1)  # noqa: E731
    assert (per_warp(spent.numpy()) >= 32 * 32 + per_warp(useful)).all()


def test_window_walk_mt_rows_differ_from_bw(setup):
    """The MT form reads tris8 and prepass, not the BW planes: same hits as
    the BW form on the same rays, and a layout whose MT rows are zeroed
    hits nothing (the prepass rows zeroed too)."""
    o, d, active, t_max = _rays(67)
    args = (*_t(o, d, active, t_max),)
    tb, rb = ht.window_walk(*args, setup["tlay"], prepass=32, tritest="bw")
    tm, rm = ht.window_walk(*args, setup["tlay"], prepass=32, tritest="mt")
    assert_hits_agree(tb, rb, tm, rm, rtol=1e-5, atol=1e-5)
    blank = setup["tlay"]._replace(tris8=torch.zeros_like(setup["tlay"].tris8),
                                   prepass=torch.zeros_like(setup["tlay"].prepass))
    t0, _ = ht.window_walk(*args, blank, prepass=32, tritest="mt")
    assert torch.equal(t0, torch.from_numpy(t_max))
    with pytest.raises(ValueError, match="tritest"):
        ht.window_walk(*args, setup["tlay"], tritest="nope")


def test_sweep_mt_matches_pallas(setup):
    """Kernel 9's MT form == _sweep_kernel(tritest="mt", with_orig=True)
    raw: t, the winning row and the latched original id; without the latch
    the same t and rows."""
    o, d, active, t_max = _rays(71)
    with pltpu.force_tpu_interpret_mode():
        raw, _ = pt.intersect_bvh_sweep(
            jnp.asarray(o), jnp.asarray(d), setup["lay"], tile=128, mtblock=56,
            active=jnp.asarray(active), t_max=jnp.asarray(t_max), raw=True,
            tritest="mt", with_orig=True)
    raw = np.asarray(raw)
    args = (*_t(o, d, active, t_max), setup["tlay"])
    before = _launches()
    t, row, orig = ht.sweep(*args, with_orig=True, tritest="mt")
    t2, row2 = ht.sweep(*args, tritest="mt")
    assert _launches() == before
    assert torch.equal(t, t2) and torch.equal(row, row2)
    hit = lambda x: np.where(x < t_max, x, np.inf)  # noqa: E731
    same = assert_hits_agree(hit(raw[0]), raw[1].astype(np.int32), hit(t.numpy()),
                             row.numpy())
    np.testing.assert_array_equal(orig.numpy()[same], raw[2][same].astype(np.int32))


@pytest.mark.parametrize("tritest", ["bw", "mt"])
def test_hbm_route_matches_pallas(setup, tritest):
    """make_cuda_intersector(hbm=True) == make_pallas_intersector(hbm=True)
    in interpret mode: incoherent nearest hits (the resolved payload) and
    t_max-capped shadow queries (resolve=False: tri from col 9, the fill
    values), ids exact; no any-hit hook on either; only the HBM wrapper's
    plain version runs."""
    o, d, active, t_max = _rays(73)
    cap = np.where(np.isfinite(t_max), t_max, 2.0).astype(np.float32)
    jfn = pt.make_pallas_intersector(
        setup["lay"], lay_occl=setup["occl"], tile=128, occlusion_tile=128,
        secondary_tile=128, prepass=32, hbm=True, tritest=tritest)
    fn = ht.make_cuda_intersector(setup["tlay"], setup["tocc"], prepass=32, hbm=True,
                                  tritest=tritest, anyhit=True)
    assert fn.hbm and not hasattr(fn, "occlusion") and not hasattr(jfn, "occlusion")
    j = [jnp.asarray(x) for x in (o, d, active, cap)]
    with pltpu.force_tpu_interpret_mode():
        jnear = jfn(j[0], j[1], j[2])
        jcap = jfn(j[0], j[1], j[2], t_max=j[3])
    calls = []
    plain = ht.window_walk_hbm_plain
    ht.window_walk_hbm_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        before = _launches()
        near = fn(*_t(o, d, active))
        capped = fn(*_t(o, d, active, cap)[:3], t_max=torch.from_numpy(cap))
        assert _launches() == before
    finally:
        ht.window_walk_hbm_plain = plain
    assert len(calls) == 2
    for got, ref in ((near, jnear), (capped, jcap)):
        assert_hits_agree(ref.t, ref.tri, got.t, got.tri, min_agree=1.0)
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(ref.tri))
    same = np.isfinite(near.t.numpy())
    np.testing.assert_allclose(near.pos.numpy()[:, same], np.asarray(jnear.pos)[:, same],
                               atol=1e-5)
    np.testing.assert_array_equal(near.mat.numpy(), np.asarray(jnear.mat))
    assert np.isfinite(capped.t.numpy()).any()
    assert (capped.t.numpy()[np.isfinite(capped.t.numpy())] < cap[np.isfinite(
        capped.t.numpy())]).all()
    for name in ("mat", "light", "pos", "normal"):
        np.testing.assert_array_equal(getattr(capped, name).numpy(),
                                      np.asarray(getattr(jcap, name)), err_msg=name)
