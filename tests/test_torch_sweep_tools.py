"""tpu_pathtracer_torch's candidate-sweep pair (scripts/experimental_sweep.py)
against the reference's Pallas kernels of scripts/experimental_pallas_sweep.py
in interpret mode: 256 seeded rays, tile 128, prepass 8, leaf 4, cornellbox
and Water-plastic (the shape of tests/test_accel.py's
test_candidate_sweep_kernels), on the reference's own tables carried across
by interop and on the port's own build.

Tolerances, each with its reason:
  * counts and first leaves equal on >= 99.5% of the lanes and within 1 leaf
    of count elsewhere: XLA contracts the prime's multiply-adds into FMAs on
    the CPU and torch does not, so a prime t can differ in its last ulps and
    flip ``enter < best_t`` for a box the ray enters right at the primed hit
    (observed here: every lane equal on both scenes);
  * the targeted kernel's t to rtol 1e-6 or atol 1e-6 and its rows equal
    but for equal-t ties (torch_parity.assert_hits_agree), u/v to atol 1e-5,
    the original ids equal where the rows agree;
  * the split property (targeted result == MT window walk on every lane
    with at most one candidate) is exact inside the port: both sides run
    the same torch arithmetic in the same order.
On CPU tensors no kernel launches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer.accel import build_layout as jbuild_layout
from tpu_pathtracer.scene import load_scene as jload_scene, scene_path
from tpu_pathtracer_torch import interop
from tpu_pathtracer_torch.accel import build_layout
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.scene import load_scene
from tpu_pathtracer_torch.scripts import dense_march
from tpu_pathtracer_torch.scripts import experimental_sweep as es
from torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    arrays, assert_hits_agree, load_reference_script, random_rays, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, TILE, PREPASS, LEAF = 256, 128, 8, 4


@pytest.fixture(scope="module")
def ps():
    return load_reference_script("experimental_pallas_sweep")


@pytest.fixture(scope="module", params=["cornellbox", "CornellBox-Water-plastic"])
def setup(request):
    """(reference layout, the same tables carried into the port, the port's
    own build) at leaf 4."""
    path = scene_path(request.param)
    lay = jbuild_layout(jload_scene(path), leaf_size=LEAF)
    return {"lay": lay, "carried": interop.layout_from_arrays(arrays(lay)),
            "built": build_layout(load_scene(path, device="cpu"), leaf_size=LEAF)}


def _launches():
    return es.sweep_count.launches, es.intersect_sweep1.launches


def _rays(seed):
    o, d = random_rays(N, seed)
    return o, d, np.arange(N) % 7 != 3


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def test_sweep_count_matches_reference(ps, setup):
    """sweep_count_plain == _count_kernel: with and without an active mask;
    inactive lanes get (0, num_leaves); the wrapper on CPU tensors gives the
    plain version's answer without a launch."""
    o, d, active = _rays(21)
    lay = setup["lay"]
    for act in (None, active):
        with pltpu.force_tpu_interpret_mode():
            cnt, first = ps.sweep_count(jnp.asarray(o), jnp.asarray(d), lay, tile=TILE,
                                        prepass=PREPASS,
                                        active=None if act is None else jnp.asarray(act))
        cnt, first = np.asarray(cnt), np.asarray(first)
        targs = _t(o, d) + (setup["carried"],)
        tact = None if act is None else torch.from_numpy(act)
        before = _launches()
        got_c, got_f = es.sweep_count(*targs, active=tact, prepass=PREPASS)
        assert _launches() == before
        pc, pf = es.sweep_count_plain(*targs, active=tact, prepass=PREPASS)
        assert torch.equal(got_c, pc) and torch.equal(got_f, pf)
        assert got_c.dtype == got_f.dtype == torch.int32
        got_c, got_f = got_c.numpy(), got_f.numpy()
        same = (got_c == cnt) & (got_f == first)
        print(f"sweep_count: {same.mean():.4%} of lanes equal, mean count "
              f"{cnt.mean():.2f}, count<=1 on {(cnt <= 1).mean():.2%}")
        assert same.mean() >= 0.995
        assert (np.abs(got_c - cnt) <= 1).all()
        assert got_f.max() <= lay.num_leaves and cnt.max() > 1
        if act is not None:
            assert (got_c[~act] == 0).all() and (got_f[~act] == lay.num_leaves).all()


def test_sweep1_matches_reference(ps, setup):
    """intersect_sweep1_plain == _mt1_kernel's raw rows on the lanes the
    reference's count selects, unbounded and with t_max caps."""
    o, d, _ = _rays(21)
    lay = setup["lay"]
    caps = np.where(np.arange(N) % 3 == 0, 1.5, np.inf).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        cnt, _ = ps.sweep_count(jnp.asarray(o), jnp.asarray(d), lay, tile=TILE,
                                prepass=PREPASS)
    sel = np.asarray(cnt) <= 1
    assert sel.mean() > 0.05
    for t_max in (None, caps):
        with pltpu.force_tpu_interpret_mode():
            raw, tmax = ps.intersect_sweep1(
                jnp.asarray(o), jnp.asarray(d), lay, active=jnp.asarray(sel), tile=TILE,
                prepass=PREPASS, t_max=None if t_max is None else jnp.asarray(t_max))
        raw, tmax = np.asarray(raw), np.asarray(tmax)
        before = _launches()
        got, gmax = es.intersect_sweep1(
            *_t(o, d), setup["carried"], active=torch.from_numpy(sel), prepass=PREPASS,
            t_max=None if t_max is None else torch.from_numpy(t_max))
        assert _launches() == before
        np.testing.assert_array_equal(gmax.numpy(), tmax)
        assert got.row.dtype == got.orig.dtype == torch.int32
        hit = lambda t: np.where(t < tmax, t, np.inf)  # noqa: E731
        same = assert_hits_agree(hit(raw[0]), raw[3].astype(np.int32),
                                 hit(got.t.numpy()), got.row.numpy())
        assert same.sum() > 0
        np.testing.assert_allclose(got.u.numpy()[same], raw[1][same], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.v.numpy()[same], raw[2][same], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.orig.numpy()[same], raw[4][same].astype(np.int32))
        # inactive lanes keep the fresh record, as the reference's
        off = ~sel
        np.testing.assert_array_equal(got.t.numpy()[off], tmax[off])
        assert (got.row.numpy()[off] == lay.num_tris).all()
        np.testing.assert_array_equal(raw[3][off], np.float32(lay.num_tris))
        assert (got.orig.numpy()[off] == 0).all() and (got.u.numpy()[off] == 0).all()


@pytest.mark.parametrize("which", ["carried", "built"])
def test_split_equals_window_walk(setup, which):
    """The reference's own property on the port's plain versions: on every
    lane with at most one candidate leaf, the targeted kernel's resolved hit
    equals the full MT window walk's; a lane with no candidate is a miss or
    a prepass hit; a good share of the rays are such lanes."""
    lay = setup[which]
    o, d = _t(*random_rays(N, 21))
    cnt, first = es.sweep_count(o, d, lay, prepass=PREPASS)
    sel = cnt <= 1
    assert float(sel.float().mean()) > 0.05
    assert bool(((cnt == 0) == (first == lay.num_leaves)).all())
    raw, tmax = es.intersect_sweep1(o, d, lay, active=sel, prepass=PREPASS)
    hs = ht.resolve_window_payload(lay, raw[0], raw[3], tmax, o, d)
    hw = ht.intersect_bvh_window(o, d, lay, prepass=PREPASS, tritest="mt")
    assert torch.equal(hs.t[sel], hw.t[sel])
    assert torch.equal(hs.tri[sel], hw.tri[sel])
    assert bool(torch.isfinite(hs.t[sel]).any())
    hit = sel & torch.isfinite(hs.t)
    assert torch.equal(raw.orig[hit].to(torch.int64), hw.tri[hit])
    np.testing.assert_allclose(raw.u[hit].numpy(), hw.u[hit].numpy(), rtol=0, atol=1e-6)
    pre_rows = lay.prepass[:ht.window_prepass(lay, PREPASS), 21].to(torch.int32)
    none = cnt == 0
    assert bool(((raw.row[none] == lay.num_tris)
                 | torch.isin(raw.row[none], pre_rows)).all())


def test_tally_counts_the_tested_leaf_rows(setup):
    """intersect_sweep1_plain's tally: the rows of each lane's lowest
    candidate leaf, summed over the active lanes that have one."""
    from tpu_pathtracer_torch.ops.traverse import Tally

    lay = setup["built"]
    o, d = _t(*random_rays(N, 23))
    cnt, first = es.sweep_count_plain(o, d, lay, prepass=PREPASS)
    tally = Tally()
    es.intersect_sweep1_plain(o, d, lay, active=cnt <= 1, prepass=PREPASS, tally=tally)
    has = (cnt == 1).nonzero()[:, 0]
    assert tally.tests == int(lay.leafmeta[first[has].long(), 1].sum()) > 0


def test_tally_counts_the_boxes_up_to_the_lowest_candidate(setup):
    """intersect_sweep1_plain's tally: a sweep that ends at its lowest
    candidate tests first + 1 boxes on a lane that has one and every leaf
    on a lane that has none."""
    from tpu_pathtracer_torch.ops.traverse import Tally

    lay = setup["built"]
    o, d = _t(*random_rays(N, 23))
    cnt, first = es.sweep_count_plain(o, d, lay, prepass=PREPASS)
    sel = cnt <= 1
    tally = Tally()
    es.intersect_sweep1_plain(o, d, lay, active=sel, prepass=PREPASS, tally=tally)
    one, none = int((cnt == 1).sum()), int((cnt == 0).sum())
    want = int((first[cnt == 1].long() + 1).sum()) + none * lay.num_leaves
    assert one > 0 and none > 0
    assert tally.visits == want < int(sel.sum()) * lay.num_leaves


def test_sweep1_work_is_the_plain_tally(setup):
    """chip_smoke.sweep1_work prices the targeted kernel from the count's
    first leaves (whole wavefronts, no plain run over them): the same leaf
    row tests and box tests as intersect_sweep1_plain's tally."""
    import chip_smoke
    from tpu_pathtracer_torch.ops.traverse import Tally

    lay = setup["built"]
    o, d = _t(*random_rays(N, 27))
    cnt, first = es.sweep_count_plain(o, d, lay, prepass=PREPASS)
    sel = (cnt <= 1) & (torch.arange(N) % 5 != 2)
    tally = Tally()
    es.intersect_sweep1_plain(o, d, lay, active=sel, prepass=PREPASS, tally=tally)
    assert chip_smoke.sweep1_work(lay, sel, first) == (tally.tests, tally.visits)
    assert tally.tests > 0


@pytest.mark.parametrize("prepass", [0, 5, 8, 13, 32, 100])
def test_prepass_clamp_matches_reference(setup, prepass):
    """min(prepass, rows, num_tris) rounded down to whole 8-row blocks, and
    the kernels agree with prepass=0 (no prime) too."""
    lay = setup["built"]
    want = min(prepass, lay.prepass.shape[0], lay.num_tris)
    assert ht.window_prepass(lay, prepass) == want - want % 8
    if prepass in (0, 100):
        o, d = _t(*random_rays(64, 29))
        cnt, _ = es.sweep_count(o, d, lay, prepass=prepass)
        cnt8, _ = es.sweep_count(o, d, lay, prepass=PREPASS)
        # a longer prime can only shorten the segment
        assert bool((cnt <= cnt8).all()) if prepass else bool((cnt >= cnt8).all())


@pytest.fixture(scope="module")
def count_tables():
    """(leaf boxes, prepass rows) of the count's tables: Water-plastic at
    leaf 56 and leaf 8 (the port's own build), and a GRID 256 terrain at
    leaf 8 (130,052 triangles: at least 16,257 leaves)."""
    scene = load_scene(scene_path("CornellBox-Water-plastic"), device="cpu")
    tables = []
    for leaf in (56, 8):
        lay = build_layout(scene, leaf)
        tables.append((lay.num_leaves, ht.window_prepass(lay, ht.DEFAULT_PREPASS)))
    return tables + [(130052 // 8 + 1, ht.DEFAULT_PREPASS)]


@pytest.mark.parametrize("tile", [96, 768, 6144, es.COUNT_TILE])
@pytest.mark.parametrize("n", [1, 31, 33, 4096, 65537])
def test_count_launch_shape_covers_every_lane_once(count_tables, n, tile):
    """The count's launch shape (scripts/dense_march.py, which the kernel's
    lane mapping mirrors) covers every lane exactly once at the kernel's k:
    no lane twice, none left out; Water-plastic's 184 leaf-56 and 1,209
    leaf-8 boxes staged as one tile each, the terrain's in double-buffered
    tiles; the prepass block and the boxes within the card's shared
    memory."""
    assert [t[0] for t in count_tables[:2]] == [184, 1209]
    for leaves, pp in count_tables:
        shape = dense_march.march_shape(n, tile, es.K_LANES, leaves, es.BOX_BYTES,
                                        pp * es.PRE_BYTES)
        lanes = dense_march.march_lanes(shape, n, tile, es.K_LANES)
        assert torch.equal(lanes[lanes >= 0].sort().values, torch.arange(n))
        assert shape.smem <= dense_march.SHARED_LIMIT
        one_tile = leaves * es.BOX_BYTES <= dense_march.ONE_TILE_BYTES
        assert (shape.tile_rows == leaves) == one_tile == (leaves < 2000)
        assert shape.smem == pp * es.PRE_BYTES + (1 if one_tile else 2) * (
            shape.tile_rows * es.BOX_BYTES)


@pytest.mark.parametrize("share", [0.0, 0.19, 0.35, 1.0])
@pytest.mark.parametrize("n", [1, 31, 33, 4096, 65537])
def test_sweep1_list_marches_every_active_lane_once(count_tables, n, share):
    """The targeted kernel's list and march (scripts/dense_march.py:
    compact_shape and compact_lanes, which the kernels' list and lane mapping
    mirror) at active shares of none, 19% and 35% (the shares of
    Water-plastic's bounce-1 wavefront with <= 1 candidate at leaf 56 and
    leaf 8) and all, for a warp's passes (32 k entries: a table of one tile)
    and the block's: every active lane marched exactly once, no inactive
    lane marched, the list in ascending order and every pass but the last
    full; the list launches cover every lane; the prepass block and the
    boxes within the card's shared memory for 184, 1,209 and 20,872-odd
    boxes."""
    active = torch.from_numpy(np.random.default_rng(n).random(n) < share)
    for leaves, pp in count_tables:
        shape = dense_march.compact_shape(n, es.SWEEP1_THREADS, es.SWEEP1_K, leaves,
                                          es.BOX_BYTES, pp * es.PRE_BYTES)
        assert shape.blocks * dense_march.LIST_TILE >= n > (shape.blocks - 1) * (
            dense_march.LIST_TILE)
        assert shape.smem <= dense_march.SHARED_LIMIT
        one_tile = leaves * es.BOX_BYTES <= dense_march.ONE_TILE_BYTES
        assert shape.smem == pp * es.PRE_BYTES + (1 if one_tile else 2) * (
            shape.tile_rows * es.BOX_BYTES)
        for per_pass in (32 * es.SWEEP1_K, shape.threads * es.SWEEP1_K):
            lanes = dense_march.compact_lanes(active, per_pass, es.SWEEP1_K)
            assert lanes.shape[0] <= shape.passes * shape.threads * es.SWEEP1_K // per_pass
            flat = lanes.reshape(-1)
            live = flat >= 0
            assert torch.equal(flat[live], active.nonzero()[:, 0])  # once, ascending
            assert not bool(live[int(live.sum()):].any())  # only the last pass has a gap
            assert int((~live).sum()) < per_pass


def test_compact_shape_refuses_a_bad_block():
    """A march block that is not whole warps up to the kernels' cap is
    refused before a launch."""
    for threads in (100, 1024, 0):
        with pytest.raises(ValueError):
            dense_march.compact_shape(4096, threads, 2, 184, es.BOX_BYTES)


@pytest.mark.parametrize("leaves,bound_ms", [(184, 0.2699), (1209, 1.3964)])
def test_count_full_width_bound(leaves, bound_ms):
    """chip_smoke's bound of the count on a whole bounce-1 wavefront, by hand:
    1,363,526 live lanes of 2,073,600, each against 32 prepass rows (52
    operations a Moller-Trumbore test) and every leaf box (25 operations a
    box test, 1 for the first-leaf min, 1 for the count), 2 flops an
    operation over 67 TFLOP/s; the bytes (33 a lane, the boxes and the
    prepass block once) are below it."""
    import chip_smoke
    from types import SimpleNamespace

    lanes, live = 2073600, 1363526
    lay = SimpleNamespace(num_leaves=leaves, leafbox=torch.zeros(leaves, 8),
                          prepass=torch.zeros(32, 24), tris8=torch.zeros(8, 24),
                          leafmeta=torch.zeros(leaves, 4, dtype=torch.int32))
    act = torch.arange(lanes) < live
    first = torch.full((lanes,), leaves, dtype=torch.int32)
    bnd, _ = chip_smoke.sweep_bounds(lay, act, first, 32, 0, 0)
    ops = live * (32 * 52 + leaves * 27)
    assert bnd["bound_ops"] == ops and bnd["bound_by"] == "operations"
    assert bnd["bound_bytes"] == lanes * 33 + leaves * 32 + 32 * 96
    assert bnd["bound_ms"] == pytest.approx(ops * 2 / 67e12 * 1e3, rel=1e-12)
    assert round(bnd["bound_ms"], 4) == bound_ms
