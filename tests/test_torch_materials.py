"""The material extensions of tpu_pathtracer_torch against the reference's, on
the CPU: the GGX rough materials, Snell refraction, map_Kd textures, the
nearest-hit resolve on the material scenes, the inert bake_materials field,
and the reference scene's extension arrays carried across.

Tolerances, each with its reason:
  * classification, texture resampling and the scene's extension arrays:
    bit-equal (the same numpy arithmetic, or copies);
  * Schlick, sample_bounce with refraction, bilinear texels and their
    modulation, the resolve's geometry: rtol/atol 1e-6 (torch_parity.py's
    band: XLA contracts multiply-adds and its sin/cos/sqrt round
    differently by an ulp); the resolve's ids bit-equal;
  * the GGX lobes (and sample_bounce / eval_material with roughness),
    per lane of roughness alpha: weights, cosines and Fresnel in the band;
    the densities D*G/(4 cos) (pdf, fcos) at rtol 1e-6/alpha^2, because D's
    denominator c^2 (a^2 - 1) + 1 cancels as the microfacet normal nears n
    and magnifies an ulp by up to ~1/a^2 (measured: at most 4.5e-7/a^2 on
    200,000 lanes, alpha 0.0025-0.9); the sampled direction at atol 1e-6 +
    5e-6/alpha (measured: at most 2.1e-6/alpha; the unstretch divides by
    the microfacet's length); on lanes the lobe rejects (a view below the
    surface: weight 0 in both) the sampled direction is not compared -- the
    stretch of a below-horizon view magnifies an ulp without bound there,
    and the lane carries no throughput;
  * frames: atol 1e-5 on every pixel but 3 (torch_parity.py:
    assert_frames_agree), 2 frames; a bake_materials frame equals the
    unbaked one bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.accel import build_layout as jbuild_layout
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.models import bsdf as jbsdf
from tpu_pathtracer.models import ggx as jggx
from tpu_pathtracer.models import texture as jtex
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.render import init_state as jinit_state
from tpu_pathtracer.render import render_frame_jit as jrender_frame_jit
from tpu_pathtracer.scene import attach_dispersion as jattach_dispersion
from tpu_pathtracer.scene import load_scene as jload_scene
from tpu_pathtracer.scene import scene_path
from tpu_pathtracer.scene.materials import classify as jclassify
from tpu_pathtracer.scene.objmtl import parse_mtl as jparse_mtl
from tpu_pathtracer_torch import Renderer, RenderConfig, interop
from tpu_pathtracer_torch.accel import build_layout
from tpu_pathtracer_torch.io.png import write_png
from tpu_pathtracer_torch.models import bsdf as tbsdf
from tpu_pathtracer_torch.models import ggx as tggx
from tpu_pathtracer_torch.models import texture as ttex
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.scene import attach_dispersion, load_scene
from tpu_pathtracer_torch.scene.materials import classify
from tpu_pathtracer_torch.scene.objmtl import parse_mtl
from torch_parity import arrays, assert_frames_agree, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
H, W = 24, 32
BAND = dict(rtol=1e-6, atol=1e-6)


def ggx_close(got, want, alpha, what: str) -> None:
    """``got`` against ``want`` per lane (the trailing axis) with the GGX
    tolerances of the docstring for ``what`` ("density" or "direction");
    lanes with alpha None (not GGX) in the band."""
    got, want = np.asarray(got), np.asarray(want)
    a = np.where(np.isnan(alpha), 1.0, alpha)
    if what == "density":
        bound = 1e-6 + (1e-6 / (a * a)) * np.abs(want)
    else:
        bound = 1e-6 + 5e-6 / a + 1e-6 * np.abs(want)
    bound = np.where(np.isnan(alpha), 1e-6 + 1e-6 * np.abs(want), bound)
    bad = ~(np.abs(got - want) <= bound)
    assert not bad.any(), (what, int(bad.sum()), float(np.abs(got - want).max()))

# the scenes of the reference's own tests, written out here: the GGX floor
# under a big light (tests/test_rough_materials.py), the textured floor
# (tests/test_texture.py) and the tilted glass pane over a lit floor
# (tests/test_bsdf.py:test_refract_scene_renders_finite_and_differs)
QUAD_OBJ = """mtllib scene.mtl
v -2 0 -2
v  2 0 -2
v  2 0  2
v -2 0  2
v -2 1.5 -2
v  2 1.5 -2
v  2 1.5  2
v -2 1.5  2
vn 0 1 0
vn 0 -1 0
usemtl floor
f 1//1 2//1 3//1
f 1//1 3//1 4//1
usemtl lamp
f 5//2 7//2 6//2
f 5//2 8//2 7//2
"""
ROUGH_MTL = """newmtl floor
Kd 0.9 0.6 0.3
Ka 0 0 0
Ks {ks}
newmtl lamp
Kd 0 0 0
Ka 1 1 1
Ks 1 0 0
"""
TEX_OBJ = """mtllib scene.mtl
v -2 0 -2
v  2 0 -2
v  2 0  2
v -2 0  2
v -1 3 -1
v  1 3 -1
v  1 3  1
v -1 3  1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
vn 0 -1 0
usemtl floor
f 1/1/1 2/2/1 3/3/1
f 1/1/1 3/3/1 4/4/1
usemtl lamp
f 5/1/2 7/3/2 6/2/2
f 5/1/2 8/4/2 7/3/2
"""
TEX_MTL = """newmtl floor
Kd 1 1 1
Ka 0 0 0
Ks {ks}
map_Kd {tex}
newmtl lamp
Kd 0 0 0
Ka 8 8 8
Ks 1 0 0
"""
GLASS_OBJ = """mtllib scene.mtl
v -3 0 -3
v  3 0 -3
v  3 0  3
v -3 0  3
v -2 0.2 1.4
v  2 0.2 1.4
v  2 2.2 0.4
v -2 2.2 0.4
v -2 3.2 -2
v  2 3.2 -2
v  2 3.2  0
v -2 3.2  0
vn 0 1 0
vn 0 0.4472 0.8944
vn 0 -1 0
usemtl floor
f 1//1 2//1 3//1
f 1//1 3//1 4//1
usemtl glass
f 5//2 6//2 7//2
f 5//2 7//2 8//2
usemtl lamp
f 9//3 11//3 10//3
f 9//3 12//3 11//3
"""
GLASS_MTL = """newmtl floor
Kd 0.8 0.2 0.1
Ka 0 0 0
Ks 1 0 0
newmtl glass
Kd 1 1 1
Ka 0 0 0
Ks 0 0 1.5
newmtl lamp
Kd 0 0 0
Ka 3 3 3
Ks 1 0 0
"""


def write_scene(d, obj: str, mtl: str) -> str:
    with open(os.path.join(d, "scene.obj"), "w") as fh:
        fh.write(obj)
    with open(os.path.join(d, "scene.mtl"), "w") as fh:
        fh.write(mtl)
    return os.path.join(d, "scene.obj")


def textured(d, ks="1 0 0", tex="tex.png", seed=3) -> str:
    """The textured floor with a seeded 8x6 map (written as an sRGB PNG)."""
    img = np.random.default_rng(seed).uniform(0.0, 1.0, (8, 6, 3)).astype(np.float32)
    write_png(os.path.join(d, "tex.png"), img)
    return write_scene(d, TEX_OBJ, TEX_MTL.format(ks=ks, tex=tex))


def _t(a):
    return torch.from_numpy(np.array(a))


def _views(n, seed):
    """(3, n) unit directions into a surface (front and back facing),
    unit normals, and uniforms."""
    rng = np.random.default_rng(seed)
    w_i = rng.normal(size=(3, n)).astype(np.float32)
    w_i /= np.linalg.norm(w_i, axis=0, keepdims=True)
    nrm = rng.normal(size=(3, n)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    u = rng.random((2, n)).astype(np.float32)
    return w_i, nrm, u, rng


def test_classify_rough_matches_reference(tmp_path):
    """classify(rough_materials=True and False) equals the reference's
    table, field by field, over every branch of the decision tree."""
    ks = ["0 1 0", "0.5 1 0", "1 1 0", "1.5 1 0", "1 0 0", "0 0 -1.49", "0.3 0 -1.49",
          "0 0 1.5", "0.2 0 1.5", "0.99 0 1.3", "0.01 0 -1.2"]
    path = str(tmp_path / "m.mtl")
    with open(path, "w") as fh:
        for i, k in enumerate(ks):
            fh.write(f"newmtl m{i}\nKd 0.{i} 0.5 0.2\nKa 0 0.{i} 0\nKs {k}\n")
    for rough in (False, True):
        want = jclassify(list(jparse_mtl(path).values()), rough_materials=rough)
        got = classify(list(parse_mtl(path).values()), rough_materials=rough)
        for f in ("diffuse", "emissive", "ior", "mtype", "roughness"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert (got.mtype >= tbsdf.MATERIAL_ROUGH_CONDUCTOR).any() == rough


def test_resample_nearest_and_scene_arrays_match_reference(tmp_path):
    """resample_nearest, and each extension array of a loaded scene --
    tri_uv, mat_tex and textures (two maps of different sizes, one missing),
    mat_roughness, mat_ior_bins -- bit-equal to the reference's."""
    img = np.random.default_rng(0).uniform(0, 1, (5, 7, 3)).astype(np.float32)
    for th, tw in ((5, 7), (8, 3), (2, 11)):
        np.testing.assert_array_equal(ttex.resample_nearest(img, th, tw),
                                      jtex.resample_nearest(img, th, tw))
    write_png(str(tmp_path / "a.png"), img)
    write_png(str(tmp_path / "b.png"), img[:3, :4])
    mtl = (TEX_MTL.format(ks="0.3 0 -1.49", tex="a.png")
           + "newmtl wall\nKd 0.5 0.5 0.5\nKs 0.4 1 0\nmap_Kd b.png\n"
           + "newmtl gone\nKd 0.5 0.5 0.5\nKs 1 0 0\nmap_Kd missing.png\n")
    obj = TEX_OBJ + "usemtl wall\nf 1/1/1 2/2/1 5/3/1\nusemtl gone\nf 2/1/1 3/2/1 6/3/1\n"
    path = write_scene(str(tmp_path), obj, mtl)
    for s in (3, 8):
        jscene = jattach_dispersion(jload_scene(path, samples=s, rough_materials=True),
                                    0.0042)
        scene = attach_dispersion(load_scene(path, samples=s, rough_materials=True,
                                             device="cpu"), 0.0042)
        for f in ("tri_uv", "mat_tex", "textures", "mat_ior_bins", "mat_roughness",
                  "mat_diffuse", "mat_type"):
            np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                          np.asarray(getattr(jscene, f)), err_msg=f)
    assert load_scene(scene_path("cornellbox"), device="cpu").mat_roughness is None


def test_ggx_lobes_match_reference():
    """eval_lobe, sample_lobe and schlick against the reference's, per-lane
    alpha over [0.0025, 0.9] (the tolerances above)."""
    n = 512
    w_i, nrm, u, rng = _views(n, 11)
    w_o = rng.normal(size=(3, n)).astype(np.float32)
    w_o /= np.linalg.norm(w_o, axis=0, keepdims=True)
    alpha = (rng.uniform(0.05, 0.95, n) ** 2).astype(np.float32)
    want = jggx.eval_lobe(jnp.asarray(w_i), jnp.asarray(w_o), jnp.asarray(nrm),
                          jnp.asarray(alpha))
    got = tggx.eval_lobe(_t(w_i), _t(w_o), _t(nrm), _t(alpha))
    ggx_close(got[0], want[0], alpha, "density")
    ggx_close(got[1], want[1], alpha, "density")
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **BAND)
    want = [np.asarray(x) for x in jggx.sample_lobe(
        jnp.asarray(w_i), jnp.asarray(nrm), jnp.asarray(alpha), jnp.asarray(u))]
    got = [x.numpy() for x in tggx.sample_lobe(_t(w_i), _t(nrm), _t(alpha), _t(u))]
    ok = want[1] > 0
    assert 0.3 < ok.mean() < 0.7  # about half the views face the surface
    np.testing.assert_array_equal(got[1] > 0, ok)
    ggx_close(got[0][:, ok], want[0][:, ok], alpha[ok], "direction")
    np.testing.assert_allclose(got[1], want[1], **BAND)
    ggx_close(got[2], want[2], alpha, "density")
    np.testing.assert_allclose(got[3], want[3], **BAND)
    f0 = rng.uniform(0, 1, (8, n)).astype(np.float32)
    cvm = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    np.testing.assert_allclose(tggx.schlick(_t(f0), _t(cvm)).numpy(),
                               np.asarray(jggx.schlick(jnp.asarray(f0), jnp.asarray(cvm))),
                               **BAND)
    np.testing.assert_allclose(tggx.schlick(_t(f0[0]), _t(cvm)).numpy(),
                               np.asarray(jggx.schlick(jnp.asarray(f0[0]), jnp.asarray(cvm))),
                               **BAND)


@pytest.mark.parametrize("refract,rough,quirks", [
    (True, False, True), (True, False, False), (False, True, True), (True, True, False),
], ids=("refract", "refract-noquirks", "rough", "refract+rough-noquirks"))
def test_sample_bounce_and_eval_match_reference(refract, rough, quirks):
    """sample_bounce with Snell refraction and/or GGX roughness, over every
    material type, entering and leaving lanes, in air and in glass; and
    eval_material with roughness (the tolerances above)."""
    n = 512
    w_i, nrm, dir_u, rng = _views(n, 21 + 2 * refract + rough)
    mtype = rng.integers(0, 7 if rough else 4, n).astype(np.int32)
    ior = rng.uniform(1.2, 1.7, n).astype(np.float32)
    cur = np.where(rng.random(n) < 0.5, np.float32(1.00029), ior).astype(np.float32)
    lobe = rng.random(n).astype(np.float32)
    r = rng.uniform(0.05, 0.95, n).astype(np.float32) if rough else None
    want = jbsdf.sample_bounce(jnp.asarray(mtype), jnp.asarray(ior), jnp.asarray(w_i),
                               jnp.asarray(nrm), jnp.asarray(lobe), jnp.asarray(dir_u),
                               jnp.asarray(cur), quirks=quirks,
                               roughness=None if r is None else jnp.asarray(r),
                               refract=refract)
    got = tbsdf.sample_bounce(_t(mtype.astype(np.int64)), _t(ior), _t(w_i), _t(nrm),
                              _t(lobe), _t(dir_u), _t(cur), quirks=quirks,
                              roughness=None if r is None else _t(r), refract=refract)
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    # a GGX lane whose lobe rejects its sample carries no throughput
    ggx = mtype >= tbsdf.MATERIAL_ROUGH_CONDUCTOR
    live = ~(ggx & (want[1] == 0))
    alpha = np.where(ggx, r * r if rough else np.nan, np.nan)
    np.testing.assert_array_equal(got[1] == 0, want[1] == 0)
    ggx_close(got[0][:, live], want[0][:, live], alpha[live], "direction")
    ggx_close(got[1], want[1], alpha, "density")
    ggx_close(got[2], want[2], alpha, "density")
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    if rough:
        w_o = want[0]
        want = jbsdf.eval_material(jnp.asarray(mtype), jnp.asarray(ior), jnp.asarray(w_i),
                                   jnp.asarray(w_o), jnp.asarray(nrm), jnp.asarray(lobe),
                                   1e-4, roughness=jnp.asarray(r))
        got = tbsdf.eval_material(_t(mtype.astype(np.int64)), _t(ior), _t(w_i), _t(w_o),
                                  _t(nrm), _t(lobe), 1e-4, roughness=_t(r))
        for g, w in zip(got, want):
            ggx_close(g, w, alpha, "density")


def test_texture_sampling_matches_reference(tmp_path):
    """sample_bilinear (wrapped uv, untextured lanes white) and
    diffuse_modulation at S = 3 and at S = 8 through hero bins: rtol/atol
    1e-6."""
    rng = np.random.default_rng(4)
    tex = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    idx = rng.integers(-1, 2, 300).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (2, 300)).astype(np.float32)
    np.testing.assert_allclose(
        ttex.sample_bilinear(_t(tex), _t(idx.astype(np.int64)), _t(uv)).numpy(),
        np.asarray(jtex.sample_bilinear(jnp.asarray(tex), jnp.asarray(idx),
                                        jnp.asarray(uv))), **BAND)
    path = textured(str(tmp_path))
    n = 256
    tri = rng.integers(0, 4, n)
    u = rng.uniform(0, 0.5, n).astype(np.float32)
    v = rng.uniform(0, 0.5, n).astype(np.float32)
    for s, hero in ((3, 0), (8, 4)):
        jscene = jload_scene(path, samples=s)
        scene = load_scene(path, samples=s, device="cpu")
        mat = np.asarray(jscene.material_id)[tri]
        bins = rng.integers(0, s, (hero, n)) if hero else None
        want = jtex.diffuse_modulation(jscene, jnp.asarray(tri, jnp.int32), jnp.asarray(u),
                                       jnp.asarray(v), jnp.asarray(mat),
                                       None if bins is None else jnp.asarray(bins, jnp.int32),
                                       s)
        got = ttex.diffuse_modulation(scene, _t(tri), _t(u), _t(v), _t(mat.astype(np.int64)),
                                      None if bins is None else _t(bins), s)
        assert got.shape == ((hero or s), n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAND)


def _raw_rows(num_tris, n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_tris + 1, n), np.full(n, 1.25, np.float32)


@pytest.mark.parametrize("which", ["water-plastic", "rough"])
def test_resolve_matches_reference(which, tmp_path):
    """resolve_window_payload on the material scenes against the reference's
    on random rows (the sentinel miss row included): geometry rtol/atol
    1e-6, the triangle, material and light ids bit-equal."""
    if which == "rough":
        path = write_scene(str(tmp_path), QUAD_OBJ, ROUGH_MTL.format(ks="0.3 0 -1.49"))
        jscene = jload_scene(path, rough_materials=True)
        scene = load_scene(path, rough_materials=True, device="cpu")
    else:
        jscene = jload_scene(scene_path("CornellBox-Water-plastic"))
        scene = load_scene(scene_path("CornellBox-Water-plastic"), device="cpu")
    jlay = jbuild_layout(jscene, leaf_size=8)
    lay = build_layout(scene, leaf_size=8)

    n = 512
    rows, t = _raw_rows(jlay.num_tris, n)
    out = np.zeros((8, n), np.float32)
    out[0], out[1] = np.where(rows < jlay.num_tris, t, np.inf), rows
    t_max = np.full(n, 1e30, np.float32)
    o = np.zeros((3, n), np.float32)
    o[1] = 1.0
    d = np.zeros((3, n), np.float32)
    d[2] = -1.0
    want = pt.resolve_window_payload(jlay, jnp.asarray(out), jnp.asarray(t_max),
                                     jnp.asarray(o), jnp.asarray(d))
    got = ht.resolve_window_payload(lay, _t(out[0]), _t(rows.astype(np.int32)), _t(t_max),
                                    _t(o), _t(d))
    for f in ("t", "u", "v", "pos", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f, **BAND)
    for f in ("tri", "mat", "light"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def _reference(scene, kw, frames=2, h=H, w=W):
    state = jinit_state(h, w, 0, kw.get("spectrum_samples", 3))
    for _ in range(frames):
        state = jrender_frame_jit(state, scene, JConfig(**kw))
    return np.asarray(state.accum)


def _port(scene, kw, frames=2, h=H, w=W):
    before = (ht.window_walk.launches, ht.capped_walk.launches)
    r = Renderer(scene, w, h, RenderConfig(**kw), device="cpu")
    r.run(frames)
    assert (ht.window_walk.launches, ht.capped_walk.launches) == before
    return r.image()


@pytest.mark.parametrize("ks,quirks", [
    ("0.5 1 0", True), ("0.3 0 -1.49", True), ("0.2 0 1.5", True),
    ("0.5 1 0", False), ("0.35 0 -1.49", False), ("0.1 1 0", True),
])
def test_rough_frame_matches_reference(ks, quirks, tmp_path):
    """The GGX floor (rough conductor, plastic, dielectric) under a big
    light, depth 4, with and without the reference's quirks (a rough scene
    drops the x-pdf emitter quirk for every lane)."""
    path = write_scene(str(tmp_path), QUAD_OBJ, ROUGH_MTL.format(ks=ks))
    kw = {"max_path_length": 4, "reference_quirks": quirks}
    got = _port(load_scene(path, rough_materials=True, device="cpu"), kw)
    assert_frames_agree(got, _reference(jload_scene(path, rough_materials=True), kw))
    assert got.mean() > 0.01


@pytest.mark.parametrize("kw", [
    {}, {"spectrum_samples": 8, "hero_wavelengths": 3},
], ids=("S3", "S8-hero3"))
def test_textured_frame_matches_reference(kw, tmp_path):
    """The textured floor (map_Kd modulating Kd at the hit's texcoords),
    depth 3, at S = 3 and through hero bins at S = 8."""
    path = textured(str(tmp_path))
    kw = {"max_path_length": 3, **kw}
    s = kw.get("spectrum_samples", 3)
    scene = load_scene(path, samples=s, device="cpu")
    assert scene.textures is not None
    assert_frames_agree(_port(scene, kw), _reference(jload_scene(path, samples=s), kw))


def test_missing_texture_falls_back_untextured(tmp_path):
    """A map_Kd that is missing or not a PNG warns and leaves the scene
    untextured, as the reference's; the frame equals the reference's."""
    path = textured(str(tmp_path), tex="does_not_exist.png")
    assert load_scene(path, device="cpu").textures is None
    with open(tmp_path / "bad.png", "wb") as fh:
        fh.write(b"not a png at all")
    path = write_scene(str(tmp_path), TEX_OBJ, TEX_MTL.format(ks="1 0 0", tex="bad.png"))
    scene = load_scene(path, device="cpu")
    jscene = jload_scene(path)
    assert scene.textures is None and scene.mat_tex is None and scene.tri_uv is None
    assert jscene.textures is None
    kw = {"max_path_length": 3}
    assert_frames_agree(_port(scene, kw), _reference(jscene, kw))


@pytest.mark.parametrize("quirks", [True, False])
def test_refract_frame_matches_reference(quirks, tmp_path):
    """The glass pane with refract_dielectric (Snell bend, far-side origin
    offset), depth 4, differing from the straight-through frame."""
    path = write_scene(str(tmp_path), GLASS_OBJ, GLASS_MTL)
    kw = {"max_path_length": 4, "refract_dielectric": True, "reference_quirks": quirks}
    scene = load_scene(path, device="cpu")
    got = _port(scene, kw)
    assert_frames_agree(got, _reference(jload_scene(path), kw))
    straight = _port(scene, {**kw, "refract_dielectric": False})
    assert np.abs(got - straight).max() > 1e-3


@pytest.mark.parametrize("scene_kw,kw", [
    ({}, {"max_path_length": 4}),
    ({"samples": 8, "rough": "0.3 0 -1.49"},
     {"max_path_length": 4, "spectrum_samples": 8, "hero_wavelengths": 4}),
], ids=("water-plastic", "rough-S8-hero4"))
def test_baked_frame_equals_unbaked(scene_kw, kw, tmp_path):
    """bake_materials is accepted and inert on the port (the reference bakes
    copies of the material constants into its resolve rows, so its frame
    does not change either): the frame equals the unbaked one bit for bit
    (the rough case with roughness and hero bins), and the reference's."""
    if "rough" in scene_kw:
        path = write_scene(str(tmp_path), QUAD_OBJ, ROUGH_MTL.format(ks=scene_kw["rough"]))
        s = scene_kw["samples"]
        scene = load_scene(path, samples=s, rough_materials=True, device="cpu")
        jscene = jload_scene(path, samples=s, rough_materials=True)
    else:
        scene = load_scene(scene_path("CornellBox-Water-plastic"), device="cpu")
        jscene = jload_scene(scene_path("CornellBox-Water-plastic"))
    baked = Renderer(scene, W, H, RenderConfig(**kw, bake_materials=True), device="cpu")
    baked.run(2)
    plain = _port(scene, kw)
    np.testing.assert_array_equal(baked.image(), plain)
    assert_frames_agree(baked.image(), _reference(jscene, kw))


def test_scene_from_arrays_carries_every_extension(tmp_path):
    """interop.scene_from_arrays takes a reference scene with textures, GGX
    roughness and dispersion bins across as they are, and the port renders
    the reference's frame from it (S = 8, hero 4)."""
    path = textured(str(tmp_path), ks="0.3 0 -1.49")
    jscene = jattach_dispersion(jload_scene(path, samples=8, rough_materials=True), 0.0042)
    scene = interop.scene_from_arrays(arrays(jscene))
    for f in ("tri_uv", "mat_tex", "textures", "mat_ior_bins", "mat_roughness"):
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(jscene, f)), err_msg=f)
    assert scene.mat_tex.dtype == torch.int64
    kw = {"max_path_length": 3, "spectrum_samples": 8, "hero_wavelengths": 4}
    assert_frames_agree(_port(scene, kw), _reference(jscene, kw))
