"""The pieces of the redesigned nearest-hit walks (csrc/walk_common.cuh) that
run without a card: the packed node table, the cooperative leaf reduction,
the counting walk's new warp bounds, and the yardstick wrappers.

  * the packed table unpacks to the reference's ``nodes`` and ``nodes_meta``
    exactly (integers' bits in float columns: no tolerance);
  * a plain-torch emulation of the warp's leaf reduction (each lane rows k
    and k + 32, the minimum of an order-preserving key, the lowest row among
    equal t, then strict < against best_t) equals ``ops/traverse.py:latch``,
    the sequential strict-< latch, exactly, with forced ties;
  * the yardstick wrappers take the plain versions on CPU tensors and agree
    with the reference's Pallas kernels in interpret mode as the wrappers
    they stand beside do (t to rtol/atol 1e-6, ids equal except equal-t ties:
    XLA contracts multiply-adds into FMAs, torch does not).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer.accel import build_layout as jbuild_layout
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.scene import SCENE_NAMES, load_scene as jload_scene, scene_path
from tpu_pathtracer_torch import interop
from tpu_pathtracer_torch.accel import build_layout
from tpu_pathtracer_torch.accel.layout import pack_nodes, unpack_nodes
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.ops.traverse import latch
from tpu_pathtracer_torch.scene import load_scene
from torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    arrays, assert_hits_agree, random_rays, one_torch_thread)
from torch_terrain import terrain_scene

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tpu_pathtracer_torch")


@pytest.mark.parametrize("leaf", [56, 16, 8])
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_packed_nodes_unpack_to_reference_tables(name, leaf):
    """nodes_packed -> (nodes, nodes_meta) of the reference's layout, bit for
    bit, and the record is the node row with the meta row's bits in its two
    pad columns."""
    ref = jbuild_layout(jload_scene(scene_path(name)), leaf_size=leaf)
    lay = build_layout(load_scene(scene_path(name), device="cpu"), leaf_size=leaf)
    assert lay.nodes_packed.shape == (lay.num_nodes, 8)
    assert lay.nodes_packed.dtype == torch.float32 and lay.nodes_packed.is_contiguous()
    nodes, meta = unpack_nodes(lay.nodes_packed)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(ref.nodes))
    np.testing.assert_array_equal(meta.numpy(), np.asarray(ref.nodes_meta))
    np.testing.assert_array_equal(lay.nodes_packed[:, :6].numpy(), np.asarray(ref.nodes)[:, :6])
    bits = lay.nodes_packed.view(torch.int32)[:, 6:8].numpy()
    np.testing.assert_array_equal(bits[:, 0], np.asarray(ref.nodes_meta)[:, 0])
    np.testing.assert_array_equal(bits[:, 1] & 63, np.asarray(ref.nodes_meta)[:, 1] & 63)
    # the interop bridge derives the same packed table from the reference's arrays
    carried = interop.layout_from_arrays(arrays(ref))
    assert torch.equal(carried.nodes_packed.view(torch.int32),
                       lay.nodes_packed.view(torch.int32))


def test_packed_nodes_of_an_lbvh_terrain():
    """The LBVH-built terrain's packed table round-trips too, and packing is
    a pure function of the two tables."""
    lay = build_layout(terrain_scene(24, device="cpu"), leaf_size=56, builder="lbvh")
    nodes, meta = unpack_nodes(lay.nodes_packed)
    assert torch.equal(nodes, lay.nodes) and torch.equal(meta, lay.nodes_meta)
    assert torch.equal(pack_nodes(lay.nodes, lay.nodes_meta).view(torch.int32),
                       lay.nodes_packed.view(torch.int32))
    assert int(meta[:, 0].max()) == lay.num_nodes  # the last miss link is the sentinel


def _t_key(t):
    """csrc/walk_common.cuh:t_key on a float32 tensor, as int64."""
    b = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def _cooperative_latch(tt, ok, count, best_t, best_row, first):
    """The warp's service of one leaf per lane-of-L (walk_nearest's
    cooperative branch), emulated: 32 lanes, rows k and k + 32 each."""
    lanes = torch.arange(32)
    inf = torch.tensor(torch.inf)
    out_t, out_row = best_t.clone(), best_row.clone()
    for owner in range(tt.shape[0]):
        c = int(count[owner])
        acc = torch.where(ok[owner] & (torch.arange(64) < c), tt[owner], inf)
        tl, kl = acc[:32].clone(), lanes.clone()
        second = acc[32:] < tl          # strict <: the lower row keeps a tie
        tl = torch.where(second, acc[32:], tl)
        kl = torch.where(second, lanes + 32, kl)
        key = _t_key(tl)
        kmin = key.min()
        kwin = int(torch.where(key == kmin, kl, 1 << 40).min())
        tw = tl[key == kmin][0]
        if tw < out_t[owner]:
            out_t[owner] = tw
            out_row[owner] = first[owner] + kwin
    return out_t, out_row


@pytest.mark.parametrize("seed,t_lo", [(0, 0.0), (1, 0.0), (2, 0.0), (3, -2.0), (4, -2.0)])
def test_cooperative_leaf_reduction_equals_sequential_latch(seed, t_lo):
    """Random accepted t with forced ties (values drawn from 12 levels, so
    most leaves hold several equal minima) and counts 1..63: the cooperative
    reduction latches what the sequential strict-< latch latches; t_lo < 0
    also orders negative t through the key."""
    rng = np.random.default_rng(seed)
    owners = 64
    levels = np.float32(rng.uniform(t_lo, 4.0, 12))
    tt = torch.from_numpy(levels[rng.integers(0, 12, (owners, 64))])
    ok = torch.from_numpy(rng.random((owners, 64)) < 0.4)
    count = torch.from_numpy(rng.integers(1, 64, owners))
    count[:4] = torch.tensor([1, 32, 33, 63])
    first = torch.from_numpy(rng.integers(0, 1000, owners))
    best_t = torch.from_numpy(np.float32(rng.choice(np.append(levels, np.inf), owners)))
    best_row = torch.full((owners,), 9999)
    valid = torch.arange(64)[None] < count[:, None]
    rows = first[:, None] + torch.arange(64)[None]
    want_t, want_row, _, _ = latch(tt, ok & valid, best_t, best_row, rows)
    got_t, got_row = _cooperative_latch(tt, ok, count, best_t, best_row, first)
    assert torch.equal(got_t, want_t) and torch.equal(got_row, want_row)
    assert int((got_row != 9999).sum()) > 8  # latches happened


def test_t_key_preserves_float_order():
    t = torch.tensor([-torch.inf, -3.5, -1e-30, 0.0, 1e-30, 0.5, 1.0, 3e38, torch.inf])
    key = _t_key(t)
    assert bool((key[1:] > key[:-1]).all())


@pytest.mark.parametrize("useful,prepass,lo,hi", [
    ([0] * 32, 8, [8] * 32, [8] * 32),
    ([56] + [0] * 31, 32, [34] * 32, [88] * 32),
    ([1] * 32, 0, [1] * 32, [32] * 32),
    ([56] * 32 + [3] * 5, 32, [88] * 32 + [33] * 5, [32 + 1792] * 32 + [47] * 5),
], ids=["idle", "one-leaf", "one-row-each", "ragged"])
def test_warp_spent_bounds_hand_made(useful, prepass, lo, hi):
    """spent per warp of 32 lanes: prepass + ceil(U / 32) .. prepass + U, U
    the warp's useful rows; a ragged last warp counts its own lanes."""
    got_lo, got_hi = ht.warp_spent_bounds(torch.tensor(useful, dtype=torch.int32), prepass)
    assert got_lo.dtype == got_hi.dtype == torch.int32
    assert got_lo.tolist() == lo and got_hi.tolist() == hi


def test_yardsticks_are_reached_only_from_hopper_traverse():
    """No module of the package other than ops/hopper_traverse.py (and no
    frame path inside it: the intersector, the nearest-hit and shadow
    queries and the shadow walks' own wrappers) names the wrappers of the
    per-thread or step yardsticks (ops/cuda_build.py lists their C entry
    points, tpupt_*)."""
    pattern = re.compile(r"(?<!tpupt_)\b(window_walk_v1|minwalk_v1|window_walk_steps"
                         r"|capped_walk_v1|anyhit_walk_v1|capped_walk_steps"
                         r"|anyhit_walk_steps)")
    named = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if pattern.search(fh.read()):
                        named.append(os.path.relpath(os.path.join(root, f), PKG))
    assert named == [os.path.join("ops", "hopper_traverse.py")]
    with open(os.path.join(PKG, "ops", "hopper_traverse.py")) as fh:
        src = fh.read()
    frame_paths = src[src.index("def make_cuda_intersector"):]
    for fn in ("intersect_bvh_window", "intersect_bvh_minwalk", "intersect_bvh_capped",
               "occlusion_clear_anyhit", "capped_walk", "anyhit_walk"):
        start = src.index(f"def {fn}(")
        frame_paths += src[start:src.index("\ndef ", start + 1)]
    assert not pattern.search(frame_paths)


@pytest.fixture(scope="module")
def cornell():
    scene = jload_scene(scene_path("cornellbox"))
    lay = jbuild_layout(scene, leaf_size=4)
    return {"lay": lay, "tlay": interop.layout_from_arrays(arrays(lay))}


def _rays(seed, n=256):
    o, d = random_rays(n, seed)
    active = np.arange(n) % 7 != 3
    t_max = np.where(np.arange(n) % 3 == 0, 1.5, np.inf).astype(np.float32)
    return o, d, active, t_max


@pytest.mark.parametrize("wrapper", ["window_walk_v1", "window_walk_steps"])
@pytest.mark.parametrize("tritest", ["bw", "mt"])
def test_window_yardsticks_match_pallas(cornell, wrapper, tritest):
    """On CPU tensors a yardstick is the window walk's plain version: equal
    to it exactly, no launch counted, and in agreement with _window_kernel in
    interpret mode."""
    o, d, active, t_max = _rays(71)
    with pltpu.force_tpu_interpret_mode():
        raw, _ = pt.intersect_bvh_window(
            jnp.asarray(o), jnp.asarray(d), cornell["lay"], tile=128, raw=True,
            tritest=tritest, prepass=8, active=jnp.asarray(active),
            t_max=jnp.asarray(t_max))
    raw = np.asarray(raw)
    args = tuple(torch.from_numpy(x) for x in (o, d, active, t_max)) + (cornell["tlay"],)
    fn = getattr(ht, wrapper)
    kw = dict(stage=True, coop=True, persist=False, threads=128) if "steps" in wrapper else {}
    n0 = fn.launches
    t, row = fn(*args, prepass=8, tritest=tritest, **kw)
    assert fn.launches == n0
    tp, rp = ht.window_walk_plain(*args, prepass=8, tritest=tritest)
    assert torch.equal(t, tp) and torch.equal(row, rp)
    hit = lambda x: np.where(x < t_max, x, np.inf)  # noqa: E731
    assert_hits_agree(hit(raw[0]), raw[1].astype(np.int32), hit(t.numpy()), row.numpy())
    assert np.isfinite(hit(t.numpy())).any()


def test_minwalk_yardstick_matches_pallas(cornell):
    """minwalk_v1 on CPU tensors is minwalk's plain version, and agrees with
    _traverse_kernel(resolve=True) in interpret mode."""
    o, d, active, t_max = _rays(73)
    with pltpu.force_tpu_interpret_mode():
        ref = pt.intersect_bvh_pallas(jnp.asarray(o), jnp.asarray(d), cornell["lay"],
                                      tile=128, active=jnp.asarray(active),
                                      t_max=jnp.asarray(t_max), prepass=8)
    args = tuple(torch.from_numpy(x) for x in (o, d, active, t_max)) + (cornell["tlay"],)
    n0 = ht.minwalk_v1.launches
    out = ht.minwalk_v1(*args, prepass=8)
    assert ht.minwalk_v1.launches == n0
    assert torch.equal(out, ht.minwalk_plain(*args, prepass=8))
    t = np.where(out[0].numpy() < t_max, out[0].numpy(), np.inf)
    same = assert_hits_agree(ref.t, ref.tri, t, out[3].numpy().astype(np.int64))
    np.testing.assert_allclose(out[6:9].numpy()[:, same], np.asarray(ref.pos)[:, same],
                               rtol=0, atol=1e-5)
