"""The pieces of the redesigned shadow walks (csrc/capped_walk.cu and
csrc/anyhit_walk.cu on the shared walk of csrc/walk_common.cuh) that run
without a card:

  * an emulation of the any-hit walk's warp service (per leaf, an occluder
    and a target-hit flag voted over all its rows, lane k on rows k and
    k + 32, with early death) equals the per-row loop that stops at the
    first occluder, target rows, equal t and environment lanes included
    (the capped walk's latch is the nearest-hit walks' one, which
    tests/test_torch_walk_redesign.py holds);
  * the yardstick wrappers, and the step wrappers with either leaf service,
    take the plain versions on CPU tensors and agree with the reference's
    Pallas kernels in interpret mode as the wrappers they stand beside do
    (t to rtol/atol 1e-6, ids equal except equal-t ties: XLA contracts
    multiply-adds into FMAs, torch does not; clear masks equal on >= 99.8%
    of the active lanes, the same band), on the leaf-8 and leaf-16 layouts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer.accel import build_layout as jbuild_layout
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.ops.intersect import intersect_brute as jbrute
from tpu_pathtracer.scene import load_scene as jload_scene, scene_path
from tpu_pathtracer_torch import interop
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from torch_parity import arrays, assert_hits_agree, nee_shadow_rays, random_rays

EPS = 1e-4


def _anyhit_flags(leaves, cap, target, eps):
    """walk_anyhit's cooperative service for one lane, emulated: per leaf
    the warp's occluder and target-hit flags over all its rows (lane k on
    rows k and k + 32), ORed into the lane's; the lane leaves the walk after
    a leaf that occludes it.  ``leaves``: [(tt, accepted, orig)] in DFS
    order.  Returns clear."""
    thresh = np.float32(cap) - np.float32(4.0 * eps)
    occ = tgt = False
    for tt, acc, orig in leaves:
        o_hit = t_hit = False
        for k in range(32):
            for r in range(k, len(tt), 32):
                if acc[r]:
                    is_tgt = int(orig[r]) == target
                    o_hit |= (not is_tgt) and tt[r] < thresh
                    t_hit |= is_tgt and np.float32(eps) <= tt[r] < cap
        occ, tgt = occ or o_hit, tgt or t_hit
        if occ:
            break
    return (tgt and not occ) if target >= 0 else not occ


def _anyhit_rows(leaves, cap, target, eps):
    """The per-thread walk (csrc/walk_v1.cu's any-hit walk): rows one after
    another, the walk ends at the first occluder."""
    thresh = np.float32(cap) - np.float32(4.0 * eps)
    occ = tgt = False
    for tt, acc, orig in leaves:
        for r in range(len(tt)):
            if not acc[r]:
                continue
            is_tgt = int(orig[r]) == target
            if not is_tgt and tt[r] < thresh:
                occ = True
                break
            if is_tgt and np.float32(eps) <= tt[r] < cap:
                tgt = True
        if occ:
            break
    return (tgt and not occ) if target >= 0 else not occ


@pytest.mark.parametrize("seed", [8, 16, 32])
def test_anyhit_group_flags_equal_row_loop(seed):
    """Random leaf sequences (counts 1..63) whose t sit on the rule's edges
    (cap - 4*eps, eps, cap) or at equal values, target rows among them, and
    every fourth lane an environment lane (target -1, cap 1e30): the warp's
    flags with early death give the per-row loop's clear on every lane."""
    rng = np.random.default_rng(seed)
    clear = []
    for lane in range(400):
        env = lane % 4 == 0
        cap = np.float32(1e30) if env else np.float32(rng.uniform(0.5, 3.0))
        target = -1 if env else int(rng.integers(0, 3))
        edges = np.float32([cap - np.float32(4.0 * EPS), EPS, cap, 0.25, 0.25,
                            np.nextafter(EPS, 0, dtype=np.float32)])
        leaves = []
        for _ in range(int(rng.integers(1, 4))):
            c = int(rng.choice([1, 3, 8, 9, 17, 40, 63]))
            tt = np.where(rng.random(c) < 0.5, edges[rng.integers(0, 6, c)],
                          np.float32(rng.uniform(0.0, 4.0, c))).astype(np.float32)
            acc = rng.random(c) < 2.0 / c
            orig = rng.integers(0, 3, c).astype(np.float32)
            leaves.append((tt, acc, orig))
        want = _anyhit_rows(leaves, cap, target, EPS)
        assert _anyhit_flags(leaves, cap, target, EPS) == want
        clear.append(want)
    assert 20 < sum(clear) < 380  # both outcomes occur


@pytest.fixture(scope="module", params=[8, 16])
def cornell(request):
    scene = jload_scene(scene_path("cornellbox"))
    lay = jbuild_layout(scene, leaf_size=request.param)
    return {"scene": scene, "lay": lay, "tlay": interop.layout_from_arrays(arrays(lay)),
            "tscene": interop.scene_from_arrays(arrays(scene))}


# a yardstick wrapper and its keywords
YARDSTICKS = {"v1": {}, "steps, per-lane": {"coop": False}, "steps, coop": {"coop": True}}


@pytest.mark.parametrize("wrapper", list(YARDSTICKS))
def test_capped_yardsticks_match_pallas(cornell, wrapper):
    """On CPU tensors a capped-walk yardstick is the capped walk's plain
    version: equal to it exactly, no launch counted, and in agreement with
    _traverse_kernel(resolve=False, prepass=0) in interpret mode; caps past
    the nearest hit on even lanes, short of it on odd lanes."""
    n = 128
    o, d = random_rays(n, seed=11)
    sc = cornell["scene"]
    tb = np.asarray(jbrute(jnp.asarray(o), jnp.asarray(d), sc.p0, sc.p1, sc.p2).t)
    cap = np.where(np.isfinite(tb), tb * np.where(np.arange(n) % 2, 0.75, 1.25),
                   2.0).astype(np.float32)
    active = np.arange(n) % 5 != 0
    with pltpu.force_tpu_interpret_mode():
        ref = pt.intersect_bvh_pallas(jnp.asarray(o), jnp.asarray(d), cornell["lay"],
                                      tile=128, t_max=jnp.asarray(cap),
                                      active=jnp.asarray(active), resolve=False, prepass=0)
    args = tuple(torch.from_numpy(x) for x in (o, d, active, cap)) + (cornell["tlay"],)
    fn = getattr(ht, "capped_walk_" + wrapper.split(",")[0])
    kw = YARDSTICKS[wrapper]
    n0 = fn.launches
    out = fn(*args, **kw)
    assert fn.launches == n0
    assert torch.equal(out, ht.capped_walk_plain(*args))
    t = np.where(out[0].numpy() < cap, out[0].numpy(), np.inf)
    assert np.isfinite(t).any() and not np.isfinite(t[~active]).any()
    same = assert_hits_agree(ref.t, ref.tri, t, out[3].numpy().astype(np.int64))
    np.testing.assert_allclose(out[1].numpy()[same], np.asarray(ref.u)[same], atol=1e-5)


@pytest.mark.parametrize("wrapper", list(YARDSTICKS))
def test_anyhit_yardsticks_match_pallas(cornell, wrapper):
    """On CPU tensors an any-hit yardstick is the any-hit walk's plain
    version: equal to it exactly, no launch counted, and its clear mask
    agrees with the reference's occlusion_clear_anyhit in interpret mode on
    NEE-shaped shadow rays with every fifth lane an environment sample."""
    o, d, act, cap, tgt = nee_shadow_rays(cornell["tscene"], 256, seed=17)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pt.occlusion_clear_anyhit(
            jnp.asarray(o), jnp.asarray(d), cornell["lay"], jnp.asarray(act),
            jnp.asarray(cap), jnp.asarray(tgt), eps=EPS, tile=128)) & act
    args = tuple(torch.from_numpy(x) for x in (o, d, act, cap, tgt)) + (cornell["tlay"],
                                                                         EPS)
    fn = getattr(ht, "anyhit_walk_" + wrapper.split(",")[0])
    kw = YARDSTICKS[wrapper]
    n0 = fn.launches
    got = fn(*args, **kw)
    assert fn.launches == n0
    assert got.dtype == torch.uint8 and torch.equal(got, ht.anyhit_walk_plain(*args))
    got = got.numpy().astype(bool)
    assert not got[~act].any() and 0 < got.sum() < act.sum()
    assert (got != ref)[act].mean() <= 2e-3
