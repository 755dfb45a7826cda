"""The pieces of the redesigned nearest-hit walks (csrc/walk_common.cuh) that
run without a card: the packed node table, the cooperative leaf reduction,
the counting walk's new warp bounds, and the wrappers of every nearest-hit
form.

  * the packed table unpacks to the reference's ``nodes`` and ``nodes_meta``
    exactly (integers' bits in float columns: no tolerance);
  * a plain-torch emulation of the warp's leaf reduction (each lane rows k
    and k + 32, the minimum of an order-preserving key, the lowest row among
    equal t, then strict < against best_t) equals ``ops/traverse.py:latch``,
    the sequential strict-< latch, exactly, with forced ties;
  * every form of the window walk (the (t, row) form, the original-id and
    counting forms, the payload and capped epilogues) and minwalk take their
    plain versions on CPU tensors with no launch counted, and agree with the
    reference's Pallas kernels in interpret mode on the leaf-4 Cornell
    layout with t_max caps (t to rtol/atol 1e-6, ids equal except equal-t
    ties: XLA contracts multiply-adds into FMAs, torch does not; u, v,
    position and normal to atol 1e-5 where the ids agree);
  * every C entry point of ``csrc/*.cu`` has a signature in
    ``ops/cuda_build.py`` and a caller in the package.
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
from tpu_pathtracer_torch.ops import cuda_build, hopper_traverse as ht
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


def _named(key: str, src: str) -> bool:
    """Whether a module's source names the C entry point ``key``: as the
    symbol itself, or as the suffix a ``tpupt_{...}`` f-string completes."""
    return bool(re.search(rf"\b{key}\b", src)) or (
        'f"tpupt_{' in src and f'"{key[len("tpupt_"):]}"' in src)


def test_every_entry_point_is_wrapped():
    """Every ``extern "C" int tpupt_*`` of csrc/*.cu has a ctypes signature in
    ops/cuda_build.py:_SIGNATURES, and every signature's entry point is named
    by a module of the package other than cuda_build.py: no entry point is
    built that nothing launches."""
    exported = set()
    for f in os.listdir(os.path.join(PKG, "csrc")):
        if f.endswith(".cu"):
            with open(os.path.join(PKG, "csrc", f)) as fh:
                exported |= set(re.findall(r'extern "C" int (tpupt_\w+)\s*\(', fh.read()))
    assert exported and exported == set(cuda_build._SIGNATURES)
    sources = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and f != "cuda_build.py":
                with open(os.path.join(root, f)) as fh:
                    sources.append(fh.read())
    unnamed = [k for k in cuda_build._SIGNATURES if not any(_named(k, s) for s in sources)]
    assert not unnamed


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


def _pallas_window(cornell, rays, tritest: str, **kw):
    """The reference's window walk in interpret mode on ``rays`` (o, d,
    active, t_max), tile 128, prepass 8."""
    o, d, active, t_max = (jnp.asarray(x) for x in rays)
    with pltpu.force_tpu_interpret_mode():
        return pt.intersect_bvh_window(o, d, cornell["lay"], tile=128, tritest=tritest,
                                       prepass=8, active=active, t_max=t_max, **kw)


@pytest.mark.parametrize("tritest", ["bw", "mt"])
@pytest.mark.parametrize("form", ["window_walk", "window_walk_orig", "window_walk_counts"])
def test_window_forms_match_pallas(cornell, form, tritest):
    """Each (t, row) form of the window walk on CPU tensors: t and row equal
    to the plain walk's, no launch counted, and in agreement with
    _window_kernel in interpret mode; the original-id form's id is the
    winning row's (-1 on a miss, the reference's where the rows agree); the
    counting form's useful rows are the plain walk's, its spent inside the
    warp bounds."""
    rays = _rays(71)
    raw, _ = _pallas_window(cornell, rays, tritest, raw=True,
                            with_orig=form == "window_walk_orig")
    raw = np.asarray(raw)
    lay = cornell["tlay"]
    args = tuple(torch.from_numpy(x) for x in rays) + (lay,)
    fn = getattr(ht, form)
    n0 = (fn.launches, fn.launches_mt)
    got = fn(*args, prepass=8, tritest=tritest)
    assert (fn.launches, fn.launches_mt) == n0
    t, row = got[:2]
    tp, rp = ht.window_walk_plain(*args, prepass=8, tritest=tritest)
    assert torch.equal(t, tp) and torch.equal(row, rp)
    t_max = rays[3]
    hit = lambda x: np.where(x < t_max, x, np.inf)  # noqa: E731
    same = assert_hits_agree(hit(raw[0]), raw[1].astype(np.int32), hit(t.numpy()),
                             row.numpy())
    assert np.isfinite(hit(t.numpy())).any() and not np.isfinite(hit(t.numpy()))[~rays[2]].any()
    if form == "window_walk_orig":
        won = row < lay.num_tris
        want = torch.where(won, lay.tris[row.to(torch.int64), 9].to(torch.int32), -1)
        assert got[2].dtype == torch.int32 and torch.equal(got[2], want)
        np.testing.assert_array_equal(got[2].numpy()[same], raw[2][same].astype(np.int32))
    if form == "window_walk_counts":
        useful, spent = got[2:]
        _, _, want, lo, hi = ht.window_walk_counts_plain(*args, prepass=8, tritest=tritest)
        assert torch.equal(useful, want) and int(useful.sum()) > 0
        assert bool(((lo <= spent) & (spent <= hi)).all())


@pytest.mark.parametrize("tritest", ["bw", "mt"])
@pytest.mark.parametrize("epilogue", ["resolve", "capped"])
def test_epilogue_forms_match_pallas(cornell, epilogue, tritest):
    """The window walk's epilogue forms on CPU tensors: window_walk_resolve's
    12 payload rows and window_walk_hbm(capped=True)'s 4 capped rows equal
    window_payload_rows / window_capped_rows over the plain walk, no launch
    counted, and agree with the reference's resolved hit in interpret mode:
    hit or miss, t and ids as assert_hits_agree, and where the ids agree u, v
    (and the payload's material, light, position and normal)."""
    rays = _rays(72)
    ref = _pallas_window(cornell, rays, tritest)
    lay = cornell["tlay"]
    args = tuple(torch.from_numpy(x) for x in rays) + (lay,)
    if epilogue == "resolve":
        fn, kw, rows_of, n_rows = ht.window_walk_resolve, {}, ht.window_payload_rows, 12
    else:
        fn, kw, rows_of, n_rows = ht.window_walk_hbm, {"capped": True}, ht.window_capped_rows, 4
    n0 = fn.launches
    got = fn(*args, prepass=8, tritest=tritest, **kw)
    assert fn.launches == n0
    want = rows_of(lay, *ht.window_walk_plain(*args, prepass=8, tritest=tritest), args[3],
                   args[0], args[1])
    assert got.shape == (n_rows, rays[0].shape[1]) and torch.equal(got, want)
    g = got.numpy()
    t = np.where(g[0] < rays[3], g[0], np.inf)
    same = assert_hits_agree(ref.t, ref.tri, t, g[3].astype(np.int64))
    assert same.any()
    np.testing.assert_allclose(g[1][same], np.asarray(ref.u)[same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g[2][same], np.asarray(ref.v)[same], rtol=0, atol=1e-5)
    if epilogue == "resolve":
        np.testing.assert_array_equal(g[4][same], np.asarray(ref.mat)[same])
        np.testing.assert_array_equal(g[5][same] - 1, np.asarray(ref.light)[same])
        np.testing.assert_allclose(g[6:9][:, same], np.asarray(ref.pos)[:, same], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(g[9:12][:, same], np.asarray(ref.normal)[:, same],
                                   rtol=0, atol=1e-5)


def test_minwalk_matches_pallas_with_caps(cornell):
    """minwalk on CPU tensors is its plain version, no launch counted, and
    agrees with _traverse_kernel(resolve=True) in interpret mode on rays with
    t_max caps."""
    o, d, active, t_max = _rays(73)
    with pltpu.force_tpu_interpret_mode():
        ref = pt.intersect_bvh_pallas(jnp.asarray(o), jnp.asarray(d), cornell["lay"],
                                      tile=128, active=jnp.asarray(active),
                                      t_max=jnp.asarray(t_max), prepass=8)
    args = tuple(torch.from_numpy(x) for x in (o, d, active, t_max)) + (cornell["tlay"],)
    n0 = ht.minwalk.launches
    out = ht.minwalk(*args, prepass=8)
    assert ht.minwalk.launches == n0
    assert torch.equal(out, ht.minwalk_plain(*args, prepass=8))
    t = np.where(out[0].numpy() < t_max, out[0].numpy(), np.inf)
    same = assert_hits_agree(ref.t, ref.tri, t, out[3].numpy().astype(np.int64))
    np.testing.assert_allclose(out[6:9].numpy()[:, same], np.asarray(ref.pos)[:, same],
                               rtol=0, atol=1e-5)
