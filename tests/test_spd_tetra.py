"""The SPD ``tetra`` scene (scripts/spd_tetra.py) and the HBM route it takes.

The generator's counts and normals; the committed ``spd-tetra8`` OBJ is its
output byte for byte and takes the HBM route under the default RenderConfig
(its tables pass the budget); at size factor 3 (256 gasket triangles, 268
with the box) the port's frames on the HBM route against the benchmark's
plain reference (ptbench/reference.py: its own OBJ parse and Morton BVH,
Moller-Trumbore rows) and against the port's own whole-table route; and the
frame record's ``hbm_route`` and ``hbm_walks`` and the ``resolve`` span.

Frames agree through tests/torch_parity.py:assert_frames_agree (atol 1e-5
on all but 3 pixels), the tolerance of the port's other frame tests against
a reference: the window walk tests Baldwin-Weber planes where the reference
tests Moller-Trumbore rows, so a path whose fate turns on rounding at a
triangle edge differs whole.  CPU only: the kernels' plain versions run.
"""

import hashlib
import os
from collections import Counter

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.render import wavefront as twf
from tpu_pathtracer_torch.renderer import build_intersector
from tpu_pathtracer_torch.scene import SCENE_NAMES, load_scene, scene_path
from tpu_pathtracer_torch.accel import build_layout
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from torch_parity import (SpanLog, assert_frames_agree, assert_hits_agree, random_rays,
                          spd_generator)
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, DEPTH, FRAMES = 24, 32, 4, 2


spd = spd_generator()


@pytest.fixture(scope="module")
def tetra3(tmp_path_factory):
    """The size-factor-3 scene's OBJ path."""
    obj, _ = spd.write(3, str(tmp_path_factory.mktemp("spd") / "spd-tetra3"))
    return obj


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_generator_counts(level):
    """4^L tetrahedra, 4^(L+1) triangles, 2 * 4^L + 2 shared vertices, 4
    shared normals; the OBJ adds the box's 12 triangles and 24 vertices."""
    lattice, faces, normal = spd.gasket(level)
    assert faces.shape == (4 ** (level + 1), 3) and normal.shape == (4 ** (level + 1),)
    assert len(lattice) == 2 * 4 ** level + 2 == len(np.unique(lattice, axis=0))
    assert sorted(np.unique(faces)) == list(range(len(lattice)))
    assert Counter(normal.tolist()) == dict.fromkeys(range(4), 4 ** level)
    text = spd.obj_text(level, "x.mtl").splitlines()
    kinds = Counter(line.split()[0] for line in text if line and not line.startswith("#"))
    assert kinds["f"] == 4 ** (level + 1) + spd.BOX_TRIANGLES
    assert kinds["v"] == 2 * 4 ** level + 2 + 24
    assert kinds["vn"] == 4 + 9


@pytest.mark.parametrize("level", [1, 3])
def test_normals_point_out_of_their_tetrahedron(level):
    """Each gasket face's vn and its winding's normal agree and point away
    from its tetrahedron's centroid; every tetrahedron is half its parent's
    size, so all of them are translated copies of the base one."""
    lattice, faces, normal = spd.gasket(level)
    p = spd.positions(lattice, level)
    tri = p[faces]                                            # (T, 3, 3)
    geo = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = -spd.CORNERS[normal] / np.sqrt(3.0)
    centroid = tri.reshape(-1, 4, 3, 3).mean(axis=(1, 2))     # the 4 faces' 12 corners
    away = tri.mean(axis=1) - np.repeat(centroid, 4, axis=0)
    assert (np.sum(vn * away, axis=1) > 0).all()
    assert (np.sum(geo * vn, axis=1) > 0).all()
    np.testing.assert_allclose(geo / np.linalg.norm(geo, axis=1, keepdims=True), vn,
                               atol=1e-12)
    edge = np.linalg.norm(tri[:, 1] - tri[:, 0], axis=1)
    np.testing.assert_allclose(edge, spd.SIZE * 2 * np.sqrt(2) / 2 ** level)


def test_committed_scene_is_the_generator_output(tmp_path):
    """assets/scenes/spd-tetra8.{obj,mtl} are the generator's output, byte
    for byte, and hold 262,156 triangles in 13.4 MB."""
    obj, mtl = spd.write(8, str(tmp_path / "spd-tetra8"))
    for made in (obj, mtl):
        with open(made, "rb") as f:
            want = hashlib.sha256(f.read()).hexdigest()
        with open(os.path.join(ROOT, "assets", "scenes", os.path.basename(made)), "rb") as f:
            got = f.read()
        assert hashlib.sha256(got).hexdigest() == want, made
    assert os.path.getsize(obj) < 14 * 10 ** 6
    assert "spd-tetra8" in SCENE_NAMES and scene_path("spd-tetra8").endswith("spd-tetra8.obj")


def test_size_factor_8_takes_the_hbm_route():
    """Under the default RenderConfig (hbm_tables "auto") the committed
    scene's tables pass the 12 MB budget and its node tables fit it, so the
    renderer's intersector takes the HBM route; whole-table at Water-plastic's
    size stays off it."""
    cfg = RenderConfig()
    scene = load_scene(scene_path("spd-tetra8"), device="cpu")
    assert scene.p0.shape[1] == 262156
    lay, occl, isect = build_intersector(scene, cfg)
    budget = cfg.vmem_table_budget_mb * 2 ** 20
    assert not twf.pallas_tables_fit(cfg, lay, occl)
    assert twf.layout_vmem_bytes(lay) > budget and twf.layout_vmem_bytes(occl) > budget
    assert twf.layout_hbm_vmem_bytes(lay) <= budget
    assert twf.hbm_route(cfg, lay, occl) and isect.hbm
    assert not hasattr(isect, "occlusion")
    small = load_scene(scene_path("CornellBox-Water-plastic"), device="cpu")
    assert not build_intersector(small, cfg)[2].hbm


def _renderer(obj, seed, **kw):
    return Renderer(load_scene(obj, device="cpu"), W, H,
                    RenderConfig(max_path_length=DEPTH, **kw), seed=seed, device="cpu")


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_hbm_route_frames_match_the_plain_reference(tetra3, seed):
    """Two frames on the HBM route (hbm_tables "on") against the plain
    reference's running means of every pixel, and against the port's
    whole-table route (hbm_tables "off": the capped walk on leaf 8) on the
    same frames."""
    from ptbench import reference

    r = _renderer(tetra3, seed, hbm_tables="on")
    assert r._intersect.hbm
    r.run(FRAMES)
    got = r.image()
    sc = reference.Scene(reference.parse_obj(tetra3), 3, "cpu")
    spec = dict(height=H, width=W, spp=1, depth=DEPTH, hero=0)
    want = reference.render_pixels(sc, spec, np.arange(H * W), FRAMES, seed)
    assert np.abs(want).sum() > 0
    assert_frames_agree(got, want.reshape(H, W, 3))
    tables = _renderer(tetra3, seed, hbm_tables="off")
    assert not tables._intersect.hbm
    tables.run(FRAMES)
    assert_frames_agree(got, tables.image())


def test_hbm_route_hits_match_the_whole_table_route(tetra3):
    """The same rays through both routes' intersectors: nearest hits (the
    window walk with its epilogue on both) and capped queries (the HBM
    route's window walk on leaf 56 and torch resolve; the whole-table
    route's capped walk on leaf 8) hit the same triangles at the same t."""
    scene = load_scene(tetra3, device="cpu")
    fns = {hbm: build_intersector(scene, RenderConfig(hbm_tables=hbm))[2]
           for hbm in ("on", "off")}
    assert fns["on"].hbm and not fns["off"].hbm
    o, d = (torch.from_numpy(x) for x in random_rays(3000, 11))
    active = torch.ones(o.shape[1], dtype=torch.bool)
    active[::9] = False
    cap = torch.from_numpy(np.random.default_rng(12).uniform(0.05, 2.5, o.shape[1])
                           .astype(np.float32))
    for t_max in (None, cap):
        a, b = (fns[k](o, d, active, t_max=t_max) for k in ("on", "off"))
        live = active.numpy()
        agree = assert_hits_agree(a.t.numpy()[live], a.tri.numpy()[live],
                                  b.t.numpy()[live], b.tri.numpy()[live])
        assert agree.sum() > 500
        assert np.isinf(a.t.numpy()[~live]).all() and np.isinf(b.t.numpy()[~live]).all()


@pytest.mark.parametrize("tritest", ["bw", "mt"])
@pytest.mark.parametrize("name", ["tetra3", "CornellBox-Water-plastic"])
def test_capped_rows_equal_the_torch_resolve(tetra3, name, tritest):
    """The HBM route's capped epilogue, plain version
    (window_walk_hbm_plain(capped=True), which the card's kernel is held to)
    == the torch resolve's first half on the plain walk's (t, row): t_raw,
    u, v and col 9 of the winning row of lay.tris, bit for bit, with dead
    lanes, finite caps shorter and longer than the hits and infinite caps;
    the capped query's HitShade (intersect_bvh_window, hbm=True,
    resolve=False) == the one the torch resolve built, fill values included.
    No launch on the CPU; one epilogue a launch; resolve=False is the HBM
    route's alone."""
    lay = build_layout(load_scene(tetra3 if name == "tetra3" else scene_path(name),
                                  device="cpu"), 56)
    n = 2000
    o, d = (torch.from_numpy(x) for x in random_rays(n, 13))
    lanes = torch.arange(n)
    active = lanes % 9 != 4
    t_max = torch.where(lanes % 3 == 0, 1.5,
                        torch.where(lanes % 5 == 1, 0.05, torch.inf)).to(torch.float32)
    pp = ht.window_prepass(lay, ht.DEFAULT_PREPASS)
    kw = dict(prepass=pp, tritest=tritest)
    before = (ht.window_walk_hbm.launches, ht.window_walk_hbm.launches_capped)
    got = ht.window_walk_hbm(o, d, active, t_max, lay, **kw, capped=True)
    assert (ht.window_walk_hbm.launches, ht.window_walk_hbm.launches_capped) == before
    t, row = ht.window_walk_plain(o, d, active, t_max, lay, **kw)
    t_hit, rows, u, v = ht._resolved_uv(lay, t, row, t_max, o, d)
    assert got.shape == (4, n) and got.dtype == torch.float32
    assert torch.equal(got, torch.stack([t, u, v, rows[:, 9]]))
    assert torch.equal(got, ht.window_walk_hbm_plain(o, d, active, t_max, lay, **kw,
                                                     capped=True))
    hit = torch.isfinite(t_hit)
    assert hit.any() and (~hit & active & torch.isfinite(t_max)).any()
    assert not hit[~active].any() and torch.equal(got[0][~active], t_max[~active])
    assert (got[1:][:, ~hit] == 0).all()

    shade = ht.intersect_bvh_window(o, d, lay, active=active, t_max=t_max, prepass=pp,
                                    tritest=tritest, hbm=True, resolve=False)
    zeros = torch.zeros(n, dtype=torch.int64)
    want = dict(t=t_hit, u=u, v=v, tri=rows[:, 9].to(torch.int64), mat=zeros,
                light=zeros - 1, pos=torch.zeros((3, n)), normal=torch.zeros((3, n)))
    for field, value in want.items():
        assert torch.equal(getattr(shade, field), value), field
    with pytest.raises(ValueError):
        ht.window_walk_hbm(o, d, active, t_max, lay, resolve=True, capped=True)
    with pytest.raises(ValueError):
        ht.intersect_bvh_window(o, d, lay, active=active, t_max=t_max, resolve=False)


def test_records_count_the_hbm_walks(tetra3):
    """A traced frame on the HBM route records hbm_route 1 and one HBM-route
    query for the camera and two for each later bounce (the deferred shadow
    query, then the nearest hit), and one resolve span (inside walk_shadow)
    for each shadow query; on the whole-table route both read 0 and no
    resolve span is recorded.  The image is the untraced one, bit for bit."""
    images = {}
    for hbm in ("on", "off"):
        r = _renderer(tetra3, 5, hbm_tables=hbm)
        r.step(timer=SpanLog())
        r.step()
        rec, = r.frame_records
        names = Counter(s[0] for s in rec["spans"])
        on = hbm == "on"
        assert rec["hbm_route"] == int(on)
        assert rec["hbm_walks"] == (1 + 2 * (DEPTH - 1) if on else 0)
        assert names["resolve"] == (DEPTH - 1 if on else 0)
        assert names["walk_shadow"] == DEPTH - 1
        walks = sorted((a, b) for n, a, b in rec["spans"] if n == "walk_shadow")
        for _, a, b in (s for s in rec["spans"] if s[0] == "resolve"):
            assert any(wa <= a <= b <= wb for wa, wb in walks)
        plain = _renderer(tetra3, 5, hbm_tables=hbm)
        plain.run(2)
        np.testing.assert_array_equal(r.image().view(np.int32), plain.image().view(np.int32))
        images[hbm] = r.image()
    assert_frames_agree(images["on"], images["off"])
