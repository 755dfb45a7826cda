"""The pieces of the redesigned shadow walks (csrc/capped_walk.cu and
csrc/anyhit_walk.cu on the shared walk of csrc/walk_common.cuh) that run
without a card:

  * an emulation of the any-hit walk's warp service (per leaf, an occluder
    and a target-hit flag voted over all its rows, lane k on rows k and
    k + 32, with early death) equals the per-row loop that stops at the
    first occluder, target rows, equal t and environment lanes included
    (the capped walk's latch is the nearest-hit walks' one, which
    tests/test_torch_walk_redesign.py holds);
  * each form of the capped query (the capped walk, and the HBM route's
    window walk with its capped epilogue, BW and MT rows) and each way a
    frame answers a shadow query (the any-hit walk, the capped walk under
    render/wavefront.py:occlusion_clear, the fused walk's clear) takes its
    plain version on CPU tensors with no launch counted and agrees with the
    reference's Pallas kernels in interpret mode (t to rtol/atol 1e-6, ids
    equal except equal-t ties: XLA contracts multiply-adds into FMAs, torch
    does not; u to atol 1e-5 where the ids agree; clear masks equal on >=
    99.8% of the active lanes), on the leaf-8 and leaf-16 layouts.
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
from tpu_pathtracer_torch.render.wavefront import occlusion_clear
from torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    arrays, assert_hits_agree, nee_shadow_rays, random_rays, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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
    """The one-thread-per-ray walk: rows one after another, the walk ends at
    the first occluder."""
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


CAPPED_FORMS = ("capped_walk", "window_walk_hbm bw", "window_walk_hbm mt")


def _capped_query(form: str, o, d, active, cap, lay):
    """A capped query through ``form`` -> ((4, N) rows [t, u, v, orig], the
    wrapper whose launches it counts)."""
    if form == "capped_walk":
        return ht.capped_walk(o, d, active, cap, lay), ht.capped_walk
    pp = ht.window_prepass(lay, ht.DEFAULT_PREPASS)
    return ht.window_walk_hbm(o, d, active, cap, lay, prepass=pp, tritest=form[-2:],
                              capped=True), ht.window_walk_hbm


@pytest.mark.parametrize("form", CAPPED_FORMS)
def test_capped_query_forms_match_pallas(cornell, form):
    """The capped query's forms on CPU tensors: each its plain version, no
    launch counted, and in agreement with _traverse_kernel(resolve=False,
    prepass=0) in interpret mode on t, u and the original id; caps past the
    nearest hit on even lanes, short of it on odd lanes."""
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
    lay = cornell["tlay"]
    args = tuple(torch.from_numpy(x) for x in (o, d, active, cap)) + (lay,)
    counts = lambda: (ht.capped_walk.launches, ht.window_walk_hbm.launches)  # noqa: E731
    n0 = counts()
    out, fn = _capped_query(form, *args)
    assert counts() == n0
    if fn is ht.capped_walk:
        want = ht.capped_walk_plain(*args)
    else:
        pp = ht.window_prepass(lay, ht.DEFAULT_PREPASS)
        want = ht.window_walk_hbm_plain(*args, prepass=pp, tritest=form[-2:], capped=True)
    assert out.shape == (4, n) and torch.equal(out, want)
    t = np.where(out[0].numpy() < cap, out[0].numpy(), np.inf)
    assert np.isfinite(t).any() and not np.isfinite(t[~active]).any()
    same = assert_hits_agree(ref.t, ref.tri, t, out[3].numpy().astype(np.int64))
    np.testing.assert_allclose(out[1].numpy()[same], np.asarray(ref.u)[same], atol=1e-5)


def _clear(form: str, o, d, act, cap, tgt, lay):
    """The (N,) bool clear mask of a shadow query through ``form``."""
    if form == "anyhit_walk":
        return ht.anyhit_walk(o, d, act, cap, tgt, lay, EPS).to(torch.bool)
    if form == "occlusion_clear":  # an intersector without the any-hit hook
        fn = ht.make_cuda_intersector(lay, lay, eps=EPS)
        assert not hasattr(fn, "occlusion")
        return occlusion_clear(fn, o, d, act, cap, tgt, EPS)
    # the fused walk: [path | shadow] lanes from the same origins, one walk
    # with the original-id latch, then the shadow half's rule
    n = o.shape[1]
    path = torch.from_numpy(random_rays(n, seed=19)[1])
    t2, _, orig2 = ht.window_walk_orig(
        torch.cat([o, o], dim=1), torch.cat([path, d], dim=1), torch.cat([act, act]),
        torch.cat([torch.full((n,), torch.inf), cap]), lay,
        prepass=ht.window_prepass(lay, ht.DEFAULT_PREPASS))
    return ht.fused_clear(t2[n:], orig2[n:], act, cap, tgt, EPS)


@pytest.mark.parametrize("form", ["anyhit_walk", "occlusion_clear", "fused_clear"])
def test_shadow_clear_forms_match_pallas(cornell, form):
    """Each way a frame answers a shadow query, on CPU tensors with no
    launch counted: its clear mask agrees with the reference's
    occlusion_clear_anyhit in interpret mode on NEE-shaped shadow rays with
    every fifth lane an environment sample (equal on >= 99.8% of the active
    lanes, both outcomes present); the any-hit walk's mask is its plain
    version's."""
    o, d, act, cap, tgt = nee_shadow_rays(cornell["tscene"], 256, seed=17)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pt.occlusion_clear_anyhit(
            jnp.asarray(o), jnp.asarray(d), cornell["lay"], jnp.asarray(act),
            jnp.asarray(cap), jnp.asarray(tgt), eps=EPS, tile=128)) & act
    args = tuple(torch.from_numpy(x) for x in (o, d, act, cap, tgt)) + (cornell["tlay"],)
    fns = (ht.anyhit_walk, ht.capped_walk, ht.window_walk_orig)
    n0 = [f.launches for f in fns]
    got = _clear(form, *args)
    assert [f.launches for f in fns] == n0
    if form == "anyhit_walk":
        assert torch.equal(got, ht.anyhit_walk_plain(*args, EPS).to(torch.bool))
    got = got.numpy()
    assert got.dtype == bool and not got[~act].any() and 0 < got.sum() < act.sum()
    assert (got != ref)[act].mean() <= 2e-3
