"""The plain torch versions of tpu_pathtracer_torch's two CUDA kernels
against the reference's Pallas kernels (interpret mode on the CPU, as
tests/test_accel.py runs them), on the reference's own layout tables.

Tolerances: t to rtol 1e-6 or atol 1e-6 (the same test order, but XLA
contracts multiply-adds into FMAs and torch does not; see
torch_parity.assert_hits_agree); triangle ids equal except equal-t ties,
>= 99.9% of the hits; the resolved payload (position, normal) to atol
1e-5 where the ids agree, material and light ids exact.  On CPU tensors no
kernel launches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer.accel import build_layout
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.ops.intersect import intersect_brute as jbrute
from tpu_pathtracer.scene import load_scene, scene_path
from tpu_pathtracer_torch import interop
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.ops.intersect import intersect_brute, shade_from_scene
from torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    arrays, assert_hits_agree, random_rays, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", params=["cornellbox", "CornellBox-Water-plastic"])
def setup(request):
    """(reference scene, reference layouts at leaf 56 and 8, port copies)."""
    scene = load_scene(scene_path(request.param))
    lay56 = build_layout(scene, leaf_size=56)
    lay8 = build_layout(scene, leaf_size=8)
    return {
        "scene": scene, "lay56": lay56, "lay8": lay8,
        "tscene": interop.scene_from_arrays(arrays(scene)),
        "t56": interop.layout_from_arrays(arrays(lay56)),
        "t8": interop.layout_from_arrays(arrays(lay8)),
    }


def _counts():
    return ht.window_walk.launches, ht.capped_walk.launches


def test_window_walk_matches_pallas(setup):
    """Kernel A's plain version == _window_kernel (bw, argmin latch) with
    the 32-row prepass, plus resolve_window_payload, on the leaf-56 layout."""
    o, d = random_rays(512, seed=5)
    active = np.arange(512) % 7 != 3
    with pltpu.force_tpu_interpret_mode():
        ref = pt.intersect_bvh_window(jnp.asarray(o), jnp.asarray(d), setup["lay56"],
                                      tile=128, active=jnp.asarray(active))
    before = _counts()
    got = ht.intersect_bvh_window(torch.from_numpy(o), torch.from_numpy(d),
                                  setup["t56"], active=torch.from_numpy(active))
    assert _counts() == before
    same = assert_hits_agree(ref.t, ref.tri, got.t, got.tri)
    assert not np.isfinite(got.t.numpy()[~active]).any()
    np.testing.assert_allclose(got.pos.numpy()[:, same], np.asarray(ref.pos)[:, same],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.normal.numpy()[:, same],
                               np.asarray(ref.normal)[:, same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(ref.u)[same], atol=1e-5)
    np.testing.assert_array_equal(got.mat.numpy()[same], np.asarray(ref.mat)[same])
    np.testing.assert_array_equal(got.light.numpy()[same], np.asarray(ref.light)[same])


def test_capped_walk_matches_pallas(setup):
    """Kernel B's plain version == _traverse_kernel(resolve=False,
    prepass=0) with per-ray caps, on the leaf-8 layout."""
    o, d = random_rays(256, seed=11)
    hb = jbrute(jnp.asarray(o), jnp.asarray(d), setup["scene"].p0,
                setup["scene"].p1, setup["scene"].p2)
    tb = np.asarray(hb.t)
    # caps past the nearest hit on even lanes, short of it on odd lanes
    cap = np.where(np.isfinite(tb), tb * np.where(np.arange(256) % 2, 0.75, 1.25),
                   2.0).astype(np.float32)
    active = np.arange(256) % 5 != 0
    with pltpu.force_tpu_interpret_mode():
        ref = pt.intersect_bvh_pallas(
            jnp.asarray(o), jnp.asarray(d), setup["lay8"], tile=128,
            t_max=jnp.asarray(cap), active=jnp.asarray(active),
            resolve=False, prepass=0)
    before = _counts()
    got = ht.intersect_bvh_capped(torch.from_numpy(o), torch.from_numpy(d),
                                  setup["t8"], torch.from_numpy(active),
                                  torch.from_numpy(cap))
    assert _counts() == before
    fin = np.isfinite(got.t.numpy())
    assert fin.any() and not fin[~active].any() and (got.t.numpy()[fin] < cap[fin]).all()
    same = assert_hits_agree(ref.t, ref.tri, got.t, got.tri)
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(ref.u)[same], atol=1e-5)
    np.testing.assert_allclose(got.v.numpy()[same], np.asarray(ref.v)[same], atol=1e-5)


def test_kernels_match_brute_oracle(setup):
    """Both walks find the brute-force nearest hit, and the port's brute
    oracle agrees with the reference's."""
    o, d = random_rays(512, seed=29)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    sc = setup["tscene"]
    ref = jbrute(jnp.asarray(o), jnp.asarray(d), setup["scene"].p0,
                 setup["scene"].p1, setup["scene"].p2)
    brute = intersect_brute(ot, dt, sc.p0, sc.p1, sc.p2)
    same = assert_hits_agree(ref.t, ref.tri, brute.t, brute.tri)
    np.testing.assert_allclose(brute.u.numpy()[same], np.asarray(ref.u)[same], atol=1e-5)
    win = ht.intersect_bvh_window(ot, dt, setup["t56"])
    same = assert_hits_agree(brute.t, brute.tri, win.t, win.tri, rtol=1e-4,
                             min_agree=0.98)
    # the walk's payload resolve == the oracle's scene gathers
    shade = shade_from_scene(sc, brute)
    np.testing.assert_allclose(win.pos.numpy()[:, same], shade.pos.numpy()[:, same],
                               atol=1e-5)
    np.testing.assert_allclose(win.normal.numpy()[:, same],
                               shade.normal.numpy()[:, same], atol=1e-5)
    np.testing.assert_array_equal(win.mat.numpy()[same], shade.mat.numpy()[same])
    np.testing.assert_array_equal(win.light.numpy()[same], shade.light.numpy()[same])
    cap = torch.where(torch.isfinite(brute.t), brute.t * 1.5, 2.0)
    capped = ht.intersect_bvh_capped(ot, dt, setup["t8"],
                                     torch.ones(512, dtype=torch.bool), cap)
    assert_hits_agree(brute.t, brute.tri, capped.t, capped.tri, rtol=1e-4,
                      min_agree=0.98)
