"""tests/test_scale.py's contract on tpu_pathtracer_torch: the procedural
130,052-triangle terrain (GRID 256) built through ``build_scene``, both BVH
builders' layout invariants, the portable walker against the brute oracle
and against the reference's walker, and the route choice of
render/wavefront.py (the HBM route past the table budget) against the
reference's on the terrain and two bundled scenes.

Tolerances: scene fields and byte counts exact; walker t to rtol 1e-4
against brute (test_scale.py's) and to rtol/atol 1e-6 against the
reference's walker (torch_parity.assert_hits_agree: XLA contracts FMAs,
torch does not), ids equal or an equal-t tie."""

import jax
import numpy as np
import pytest
import torch

from test_scale import GRID, _terrain_mesh
from tpu_pathtracer.accel import build_layout as jbuild_layout
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.ops.traverse import intersect_bvh as jintersect_bvh
from tpu_pathtracer.render import wavefront as jwf
from tpu_pathtracer.scene import load_scene as jload_scene, scene_path
from tpu_pathtracer.scene.scene import build_scene as jbuild_scene
from tpu_pathtracer_torch import RenderConfig
from tpu_pathtracer_torch.accel import build_layout
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.ops.intersect import intersect_brute
from tpu_pathtracer_torch.ops.traverse import intersect_bvh
from tpu_pathtracer_torch.render import wavefront as twf
from tpu_pathtracer_torch.scene import build_scene, load_scene
from torch_parity import assert_hits_agree, one_torch_thread  # noqa: F401 (a fixture)
from torch_terrain import terrain_mesh

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the LBVH build is ~1,000 small ops
    on 130K-lane tensors, and intra-op threads of several test workers on
    one host's cores turn each op's barrier into a wait (measured: 67 s
    instead of 0.9 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def big():
    """The GRID 256 terrain in both packages, built once per module."""
    mesh = _terrain_mesh()
    return {"ref": jbuild_scene(mesh), "port": build_scene(mesh, device="cpu")}


def _rays_from_above(n, seed=7):
    """test_scale.py's ray cast with numpy noise: origins above the
    terrain, steep downward directions (most hit)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (3, n)).astype(np.float32)
    o[1] = 1.2 + 0.3 * (o[1] + 0.9) / 1.8
    d = (rng.normal(size=(3, n)) * 0.35).astype(np.float32)
    d[1] = -np.abs(d[1]) / 0.35 - 0.8
    return o, (d / np.linalg.norm(d, axis=0, keepdims=True)).astype(np.float32)


def test_terrain_scene_exact(big):
    """build_scene(mesh) == the reference's build_scene, field for field;
    torch_terrain.py's JAX-free copy of the terrain builds the same scene."""
    js, ts = big["ref"], big["port"]
    assert ts.num_triangles == 2 * (GRID - 1) ** 2 + 2 == 130_052
    for name in ts._fields:
        if name != "env":
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=name)
    small = build_scene(terrain_mesh(32), device="cpu")
    ref32 = jbuild_scene(_terrain_mesh(32))
    for name in ("p0", "p1", "p2", "n0", "material_id", "light_index", "mat_emissive"):
        np.testing.assert_array_equal(getattr(small, name).numpy(),
                                      np.asarray(getattr(ref32, name)), err_msg=name)


@pytest.mark.parametrize("builder", ["lbvh", "sah"])
def test_large_scene_layout_invariants(big, builder):
    """test_scale.py's packing invariants at 130K rows: forward miss links,
    the 6-bit count / shifted first-row word round-trips, leaves cover every
    triangle exactly once; and the MT rows tris8 carry tris and the leaf ids."""
    lay = build_layout(big["port"], leaf_size=16, builder=builder)
    meta = lay.nodes_meta.numpy()
    miss, word = meta[:, 0], meta[:, 1]
    m = lay.num_nodes
    assert (miss > np.arange(m)).all() and miss[0] == m
    counts, first = word & 63, word >> 6
    leaf = counts > 0
    assert counts[leaf].sum() == lay.num_tris == 130_052
    order = np.argsort(first[leaf])
    f_sorted, c_sorted = first[leaf][order], counts[leaf][order]
    assert f_sorted[0] == 0 and (f_sorted[1:] == f_sorted[:-1] + c_sorted[:-1]).all()
    assert np.bincount(lay.sorted_to_orig.numpy(), minlength=lay.num_tris).max() == 1
    tris8 = lay.tris8.numpy()
    np.testing.assert_array_equal(tris8[:lay.num_tris + 1], lay.tris.numpy())
    assert not tris8[lay.num_tris:].any() and tris8.shape[0] % 8 == 0
    ids = tris8[:lay.num_tris, 21].astype(np.int64)
    np.testing.assert_array_equal(np.repeat(np.flatnonzero(leaf), counts[leaf]), ids)


@pytest.mark.parametrize("builder", ["lbvh", "sah"])
def test_large_scene_traversal_matches_brute(big, builder):
    """The portable walker and the window walk's plain version (BW and MT)
    find the brute-force nearest hit at 128 rays, as test_scale.py holds
    the reference's walker."""
    ts = big["port"]
    o, d = (torch.from_numpy(x) for x in _rays_from_above(128))
    hb = intersect_brute(o, d, ts.p0, ts.p1, ts.p2)
    assert np.isfinite(hb.t.numpy()).mean() > 0.6  # the ray cast actually hits
    lay = build_layout(ts, leaf_size=16, builder=builder)
    assert_hits_agree(hb.t, hb.tri, intersect_bvh(o, d, lay).t,
                      intersect_bvh(o, d, lay).tri, rtol=1e-4, min_agree=0.98)
    for tritest in ("bw", "mt"):
        hw = ht.intersect_bvh_window(o, d, lay, tritest=tritest)
        assert_hits_agree(hb.t, hb.tri, hw.t, hw.tri, rtol=1e-4, min_agree=0.98)


def test_walker_matches_reference_walker(big):
    """ops/traverse.py:intersect_bvh == the reference's pure-JAX walker on
    the same SAH layout: t, u, v and original ids, inactive lanes missing."""
    lay = jbuild_layout(big["ref"], leaf_size=16)
    tlay = build_layout(big["port"], leaf_size=16)
    o, d = _rays_from_above(128, seed=11)
    active = np.arange(128) % 5 != 2
    ref = jintersect_bvh(jax.numpy.asarray(o), jax.numpy.asarray(d), lay,
                         active=jax.numpy.asarray(active))
    got = intersect_bvh(torch.from_numpy(o), torch.from_numpy(d), tlay,
                        active=torch.from_numpy(active))
    same = assert_hits_agree(ref.t, ref.tri, got.t, got.tri)
    assert not np.isfinite(got.t.numpy()[~active]).any()
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(ref.u)[same], atol=1e-5)
    np.testing.assert_allclose(got.v.numpy()[same], np.asarray(ref.v)[same], atol=1e-5)


def _ref_route(monkeypatch, jscene, cfg_kw, lay, occl):
    """The reference's choice on a TPU backend, with test_scale.py:173's
    monkeypatched backend and stubbed factory: "hbm", "tables" or "walker"
    (its pure-JAX fallback, which it announces with a RuntimeWarning)."""
    import warnings

    import tpu_pathtracer.ops.pallas_traverse as pt

    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(pt, "make_pallas_intersector",
                        lambda lay, **kw: calls.append(kw) or (lambda *a, **k: None))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jwf.make_intersector(jscene, JConfig(**cfg_kw), lay, occl)
    if not calls:
        return "walker"
    return "hbm" if calls[-1]["hbm"] else "tables"


@pytest.mark.parametrize("hbm_tables", ["auto", "on", "off"])
def test_tier_selection_matches_reference(big, monkeypatch, hbm_tables):
    """For each hbm_tables value on the GRID 256 terrain, cornellbox and
    Water-plastic (the Renderer's leaf-56 and leaf-8 layouts), the port
    takes the reference's route, from equal byte counts.  The stated
    divergence: where the reference drops to its pure-JAX walker (tables
    past the budget with "off"), the port keeps the whole-table kernels."""
    scenes = {"terrain": (big["ref"], big["port"])}
    for name in ("cornellbox", "CornellBox-Water-plastic"):
        scenes[name] = (jload_scene(scene_path(name)),
                        load_scene(scene_path(name), device="cpu"))
    want = {"auto": {"terrain": "hbm"}, "on": {}, "off": {"terrain": "walker"}}
    for name, (js, ts) in scenes.items():
        lay, occl = jbuild_layout(js, leaf_size=56), jbuild_layout(js, leaf_size=8)
        tlay, tocc = build_layout(ts, leaf_size=56), build_layout(ts, leaf_size=8)
        for a, b in ((lay, tlay), (occl, tocc)):
            assert twf.layout_vmem_bytes(b) == jwf.layout_vmem_bytes(a)
            assert twf.layout_hbm_vmem_bytes(b) == jwf.layout_hbm_vmem_bytes(a)
        cfg = {"hbm_tables": hbm_tables}
        assert twf.pallas_tables_fit(RenderConfig(**cfg), tlay, tocc) == \
            jwf.pallas_tables_fit(JConfig(**cfg), lay, occl)
        ref = _ref_route(monkeypatch, js, cfg, lay, occl)
        expect = want[hbm_tables].get(name, "hbm" if hbm_tables == "on" else "tables")
        assert ref == expect, (name, ref)
        fn = twf.make_intersector(ts, RenderConfig(**cfg), tlay, tocc)
        port = "hbm" if fn.hbm else "tables"
        assert port == ("tables" if ref == "walker" else ref), (name, hbm_tables)
        assert twf.hbm_route(RenderConfig(**cfg), tlay, tocc) == fn.hbm
        # the any-hit walk is off on the HBM route, as the reference's
        anyhit = twf.make_intersector(ts, RenderConfig(occlusion_anyhit="on", **cfg),
                                      tlay, tocc)
        assert hasattr(anyhit, "occlusion") == (not fn.hbm)
