"""The window walk's payload epilogue (csrc/window_walk.cu,
``tpupt_window_walk_resolve``) on the CPU, through its plain version.

- ``window_walk_resolve_plain``'s 12 rows, through the shared rows-to-HitShade
  conversion (``payload_hit``), against the window walk's plain version plus
  the port's torch resolve (``resolve_window_payload``): bit-equal, both are
  torch on the CPU.  BW and MT rows, misses, t_max caps shorter than the
  hit and inactive lanes (the sentinel row) included; the HBM route's
  wrapper with ``resolve=True`` the same.
- The same HitShade against the reference's ``intersect_bvh_window`` (its
  ``_window_kernel`` in interpret mode, then its ``resolve_window_payload``)
  at the FMA band of the other walk tests (``torch_parity.assert_hits_agree``;
  u, v, position and normal to atol 1e-5 where the ids agree; material and
  light exact).
- ``intersect_bvh_minwalk``, which shares the conversion, against the
  reference's ``intersect_bvh_pallas(resolve=True)``.

256 rays on the reference's own leaf-56 layouts of cornellbox and
Water-plastic.  The kernel runs only on the card (tests/test_torch_cuda.py
and chip_smoke.py's RNG and epilogue phase).
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
from torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    arrays, assert_hits_agree, random_rays, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LANES = 256


@pytest.fixture(scope="module", params=["cornellbox", "CornellBox-Water-plastic"])
def setup(request):
    """(reference leaf-56 layout, the port's copy)."""
    lay = build_layout(load_scene(scene_path(request.param)), leaf_size=56)
    return {"lay": lay, "tlay": interop.layout_from_arrays(arrays(lay))}


def _rays(seed: int):
    """Seeded rays: every 7th lane inactive, every 3rd capped at 1.5, every
    5th at 0.05 (shorter than most hits: the cap wins)."""
    o, d = random_rays(LANES, seed)
    lanes = np.arange(LANES)
    active = lanes % 7 != 3
    t_max = np.where(lanes % 3 == 0, 1.5, np.where(lanes % 5 == 1, 0.05, np.inf))
    return o, d, active, t_max.astype(np.float32)


def _hits_equal(got, want) -> None:
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("tritest", ["bw", "mt"])
def test_resolve_rows_equal_torch_resolve(setup, tritest):
    """payload_hit(window_walk_resolve_plain) == resolve_window_payload on
    window_walk_plain's (t, row), every field bit for bit; the wrappers and
    intersect_bvh_window on CPU tensors (both routes) give the same, with no
    launch.  Misses and inactive lanes resolve the sentinel row: t inf, u =
    v = 0, triangle and material 0, light -1, position and normal 0."""
    lay = setup["tlay"]
    o, d, active, t_max = (torch.from_numpy(x) for x in _rays(17))
    pp = ht.window_prepass(lay, ht.DEFAULT_PREPASS)
    rows = ht.window_walk_resolve_plain(o, d, active, t_max, lay, prepass=pp,
                                        tritest=tritest)
    assert rows.shape == (12, LANES) and rows.dtype == torch.float32
    got = ht.payload_hit(rows, t_max)
    t, row = ht.window_walk_plain(o, d, active, t_max, lay, prepass=pp, tritest=tritest)
    want = ht.resolve_window_payload(lay, t, row, t_max, o, d)
    _hits_equal(got, want)
    assert torch.equal(rows[0], t)

    before = (ht.window_walk_resolve.launches, ht.window_walk_hbm.launches)
    assert torch.equal(ht.window_walk_resolve(o, d, active, t_max, lay, prepass=pp,
                                              tritest=tritest), rows)
    assert torch.equal(ht.window_walk_hbm(o, d, active, t_max, lay, prepass=pp,
                                          tritest=tritest, resolve=True), rows)
    for hbm in (False, True):
        _hits_equal(ht.intersect_bvh_window(o, d, lay, active=active, t_max=t_max,
                                            tritest=tritest, hbm=hbm), want)
    assert (ht.window_walk_resolve.launches, ht.window_walk_hbm.launches) == before

    hit = torch.isfinite(got.t)
    assert hit.any() and (~hit).any() and not hit[~active].any()
    capped = torch.isfinite(t_max) & ~hit & active
    assert capped.any()  # lanes whose cap beat every hit
    miss = ~hit
    assert (got.u[miss] == 0).all() and (got.v[miss] == 0).all()
    assert (got.tri[miss] == 0).all() and (got.mat[miss] == 0).all()
    assert (got.light[miss] == -1).all()
    assert (got.pos[:, miss] == 0).all() and (got.normal[:, miss] == 0).all()
    assert (got.u[hit] >= 0).all() and (got.v[hit] <= 1).all()


@pytest.mark.parametrize("tritest", ["bw", "mt"])
def test_resolve_hitshade_matches_reference(setup, tritest):
    """The epilogue form's HitShade (plain version on the CPU) ==
    the reference's intersect_bvh_window + resolve_window_payload with the
    same prepass, caps and mask, at the FMA band."""
    o, d, active, t_max = _rays(29)
    with pltpu.force_tpu_interpret_mode():
        ref = pt.intersect_bvh_window(jnp.asarray(o), jnp.asarray(d), setup["lay"],
                                      tile=128, active=jnp.asarray(active),
                                      t_max=jnp.asarray(t_max), tritest=tritest)
    lay = setup["tlay"]
    pp = ht.window_prepass(lay, ht.DEFAULT_PREPASS)
    ot, dt, at, tt = (torch.from_numpy(x) for x in (o, d, active, t_max))
    got = ht.payload_hit(ht.window_walk_resolve(ot, dt, at, tt, lay, prepass=pp,
                                                tritest=tritest), tt)
    same = assert_hits_agree(ref.t, ref.tri, got.t, got.tri)
    assert same.any() and not np.isfinite(got.t.numpy()[~active]).any()
    for name in ("u", "v", "pos", "normal"):
        np.testing.assert_allclose(getattr(got, name).numpy()[..., same],
                                   np.asarray(getattr(ref, name))[..., same],
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("mat", "light"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[same],
                                      np.asarray(getattr(ref, name))[same])


def test_minwalk_keeps_matching_reference(setup):
    """intersect_bvh_minwalk through the shared payload_hit == the
    reference's intersect_bvh_pallas(resolve=True) with the 32-row prepass,
    caps and mask: hits at the FMA band, u, v, position and normal to atol
    1e-5 where the ids agree, material and light exact; no launch."""
    o, d, active, t_max = _rays(41)
    with pltpu.force_tpu_interpret_mode():
        ref = pt.intersect_bvh_pallas(jnp.asarray(o), jnp.asarray(d), setup["lay"],
                                      tile=128, active=jnp.asarray(active),
                                      t_max=jnp.asarray(t_max), prepass=32)
    n0 = ht.minwalk.launches
    got = ht.intersect_bvh_minwalk(*(torch.from_numpy(x) for x in (o, d)), setup["tlay"],
                                   active=torch.from_numpy(active),
                                   t_max=torch.from_numpy(t_max), prepass=32)
    assert ht.minwalk.launches == n0
    same = assert_hits_agree(ref.t, ref.tri, got.t, got.tri)
    assert same.any() and not np.isfinite(got.t.numpy()[~active]).any()
    for name in ("u", "v", "pos", "normal"):
        np.testing.assert_allclose(getattr(got, name).numpy()[..., same],
                                   np.asarray(getattr(ref, name))[..., same],
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("mat", "light"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[same],
                                      np.asarray(getattr(ref, name))[same])
