"""The shading of one bounce as a hand kernel (``csrc/shade.cu``).

``shade_bounce`` launches ``tpupt_shade_bounce``: everything
render/wavefront.py:trace_bounce does after its intersect -- NEE with the
power heuristic, the BSDF-arm MIS on emitter hits, the next bounce's BSDF
sample, the throughput update and the shadow pack -- one thread a lane, in
one launch a bounce, bit-equal on the card to the plain version
``shade_bounce_plain`` (render/wavefront.py:_shade_plain).  It counts its
launches in ``.launches`` and raises on CPU tensors and on any dtype or
layout the kernel does not take; it never copies an input.

``shade_kernel_covers`` is the one rule for which frames take the kernel:
every frame of at most MAX_SPECTRUM carried planes (C under hero sampling, S
otherwise); the environment light, hero bins, dispersion, the GGX types (a
roughness table) and map_Kd textures are covered, the last two in the
kernel's ``kMaterials`` instances.  render/wavefront.py:trace_bounce routes
every other frame, and every CPU tensor, to the plain version.  The kernel
reads the environment light through the records ``EnvLight.texel_rec`` and
``alias_rec``, which models/envlight.py:env_to derives once a map (the same
floats as the reference's tables, one record a texel and one an alias slot).
With a map that is clean (``EnvLight.radiance_max``: every entry finite with
its sign bit clear) it reads the env's texel only on the lanes whose ray
missed, and on a lane whose throughput times that maximum overflows; with
any other map, on every lane, as the plain version does.

``folded_constants``: torch folds ``4.0 * eps``, ``1.0 / PI`` and ``PI *
2.0`` in double from Python scalars and rounds the result (and ``eps``,
``angle_epsilon``, ``pdf_floor``, the env's ``PI`` -- numpy's pi, where
config.py's is 3.1415926 -- its ``1e30`` shadow cap, the dispersion weights'
``1e-6`` floor, models/ggx.py's ``math.pi``, ``2.0 * math.pi``, ``_EPS`` and
``_EPS * _EPS``, the conductor albedo's ``1e-12`` floor and the texture
stack's width and height) to float32 where it meets a float32 tensor; on
CUDA a float32 tensor divided by a Python scalar is ATen's multiply by the
scalar's float32 reciprocal (``/ (2.0 * PI)``, ``/ PI``, ``/ eh``, ``/ ew``
in models/envlight.py).  The host rounds them the same way, so the kernel
gets the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..config import PI, RenderConfig
from ..core.spectrum import bin_wavelengths
from ..models.envlight import ALIAS_WORDS, record_layout
from ..models.envlight import PI as ENV_PI
from ..models.ggx import _EPS as GGX_EPS
from . import launch_count
from .cuda_build import load_library, plane_address

MAX_SPECTRUM = 16  # the most spectral planes the kernel takes (csrc/shade.cu:kMaxSpectrum)
MAX_LANES = 2 ** 31 - 1


def shade_kernel_covers(cfg: RenderConfig, scene) -> bool:
    """Whether frames of ``cfg`` on ``scene`` shade in the kernel on the card:
    at most MAX_SPECTRUM carried planes, the C hero bins under hero sampling
    (S > 3 with hero_wavelengths > 0, render_sample's rule), else the S
    spectral planes.  The environment light, hero bins, dispersion, a
    roughness table (the GGX types) and textures are covered."""
    del scene  # every scene's materials and lights are covered
    hero = cfg.spectrum_samples > 3 and cfg.hero_wavelengths > 0
    planes = cfg.hero_wavelengths if hero else cfg.spectrum_samples
    return planes <= MAX_SPECTRUM


def has_materials(scene) -> bool:
    """Whether ``scene`` shades in the kernel's ``kMaterials`` instances: it
    has a roughness table (the GGX types) or map_Kd textures."""
    return scene.mat_roughness is not None or scene.textures is not None


@functools.lru_cache(maxsize=None)
def texel_bands(samples: int) -> tuple[int, int]:
    """(the first green bin, the first red bin) of an S-bin table, where
    core/spectrum.py:from_rgb lifts a texel's blue, green and red channels
    to the bins of their bands; (-1, -1) at S = 3, where bin c is channel
    c."""
    if samples == 3:
        return -1, -1
    lam = bin_wavelengths(samples)
    return int((lam < 490.0).sum()), int((lam < 580.0).sum())


def folded_constants(cfg: RenderConfig, env_shape: tuple[int, int] = (1, 1),
                     tex_shape: tuple[int, int] = (1, 1)) -> dict:
    """The float32 values of the Python constants the shading applies to
    float32 tensors, rounded as torch rounds them; ``env_shape`` (Eh, Ew) of
    the environment light's map gives its texel constants, ``tex_shape``
    (TH, TW) of the texture stack its scales."""
    f32 = np.float32
    eh, ew = env_shape
    th, tw = tex_shape
    consts = {"eps": f32(cfg.distance_epsilon), "aeps": f32(cfg.angle_epsilon),
              "four_eps": f32(4.0 * cfg.distance_epsilon), "inv_pi": f32(1.0 / PI),
              "two_pi": f32(PI * 2.0), "pdf_floor": f32(cfg.pdf_floor),
              # models/envlight.py's PI (numpy's pi) in the env's arithmetic;
              # x / (2.0 * PI), x / PI, x / eh and x / ew on CUDA tensors
              "env_pi": f32(ENV_PI), "env_two_pi": f32(2.0 * ENV_PI),
              "env_inv_two_pi": f32(1.0) / f32(2.0 * ENV_PI),
              "env_pi_recip": f32(1.0) / f32(ENV_PI),
              "inv_env_h": f32(1.0) / f32(eh), "inv_env_w": f32(1.0) / f32(ew),
              "env_cap": f32(1e30), "disp_floor": f32(1e-6), "env_hf": f32(eh),
              "env_wf": f32(ew), "env_kf": f32(eh * ew),
              # models/ggx.py (math.pi in ndf, 2.0 * math.pi in sample_lobe),
              # render/wavefront.py:_conductor_albedo and
              # models/texture.py:sample_bilinear's u * tw, (1 - v) * th
              "ggx_eps": f32(GGX_EPS), "ggx_eps2": f32(GGX_EPS * GGX_EPS),
              "ggx_pi": f32(math.pi), "ggx_two_pi": f32(2.0 * math.pi),
              "albedo_floor": f32(1e-12), "tex_wf": f32(tw), "tex_hf": f32(th)}
    return {k: float(v) for k, v in consts.items()}


def shade_bounce_plain(scene, cfg: RenderConfig, bounce: int, state, uniforms: dict, hit,
                       inline: bool):
    """The plain version of :func:`shade_bounce`: render/wavefront.py:
    _shade_plain (imported at call time: render/wavefront.py imports this
    module)."""
    from ..render.wavefront import _shade_plain

    return _shade_plain(scene, cfg, bounce, state, uniforms, hit, inline)


_P = ctypes.c_void_p


class _ShadeParams(ctypes.Structure):
    # csrc/shade.cu:ShadeParams, field for field
    _fields_ = [(name, _P) for name in (
        "origin", "direction", "throughput", "radiance", "pdf", "prev_diffuse", "ior",
        "alive", "t", "tri", "mat", "light", "pos", "normal", "light_select",
        "light_bary0", "light_bary1", "lobe", "bounce_dir0", "bounce_dir1",
        "mat_diffuse", "mat_emissive", "mat_ior", "mat_type", "light_cdf", "light_p",
        "light_n", "light_pdf", "light_area", "light_tri", "light_emissive",
        "env_texel_rec", "env_alias_rec", "env_pdf", "env_select_p", "env_rotation",
        "env_select", "env_alias", "env_jit0", "env_jit1", "bins", "mat_ior_bins",
        "out_origin", "out_direction", "out_throughput", "out_radiance", "out_pdf",
        "out_prev_diffuse", "out_ior", "out_alive", "to_light", "cap", "target",
        "contrib", "ok", "shadow_origin", "stats")] + [
        (name, ctypes.c_int) for name in ("n", "s", "m", "num_lights", "env_h", "env_w",
                                          "env_texel_stride", "env_pdf_col")] + [
        (name, ctypes.c_float) for name in (
            "eps", "aeps", "four_eps", "inv_pi", "two_pi", "pdf_floor", "env_pi",
            "env_two_pi", "env_inv_two_pi", "env_pi_recip", "env_cap", "disp_floor",
            "inv_env_h", "inv_env_w", "env_hf", "env_wf", "env_kf")] + [
        (name, ctypes.c_int) for name in (
            "last_bounce", "quirks", "refract", "cull_zero_nee", "env", "hero",
            "dispersion")] + [("env_radiance_max", ctypes.c_float)] + [
        (name, _P) for name in ("mat_roughness", "hit_u", "hit_v", "tri_uv", "mat_tex",
                                "textures")] + [
        (name, ctypes.c_int) for name in ("num_tris", "tex_h", "tex_w", "tex_band0",
                                          "tex_band1", "materials")] + [
        (name, ctypes.c_float) for name in ("ggx_eps", "ggx_eps2", "ggx_pi", "ggx_two_pi",
                                            "albedo_floor", "tex_wf", "tex_hf")]


def shade_bounce(scene, cfg: RenderConfig, bounce: int, state, uniforms: dict, hit,
                 inline: bool):
    """Shade bounce ``bounce`` of the wavefront ``state`` at its nearest hit
    ``hit`` with the bounce's ``uniforms`` in one launch -> (new state,
    shadow pack, the shadow origin ``hp + hn * eps`` when ``inline`` else
    None, (live path lanes, live shadow lanes) as int64 tensors), as
    :func:`shade_bounce_plain` returns them; with an environment light the
    counts go on with its picks (lanes whose NEE picked it) and misses (live
    lanes whose ray missed), then in a scene with materials
    (:func:`has_materials`) with the lanes that hit a GGX type and those
    that hit a textured material.  ``pixel`` and ``bins`` pass
    through.  CUDA tensors only, and only where :func:`shade_kernel_covers`
    holds; refract_dielectric with dispersion raises NotImplementedError, as
    the plain version does."""
    from ..render.wavefront import PathState, ShadowPack

    dev = state.alive.device
    if dev.type != "cuda":
        raise ValueError("shade_bounce: CUDA tensors only (the CPU takes "
                         "render/wavefront.py:_shade_plain)")
    if not shade_kernel_covers(cfg, scene):
        raise ValueError("shade_bounce: this configuration is not covered by the kernel "
                         "(ops/shade.py:shade_kernel_covers)")
    if cfg.refract_dielectric and scene.mat_ior_bins is not None:
        raise NotImplementedError(
            "refract_dielectric + attach_dispersion: the per-bin lobe "
            "reweighting is exact only for straight-through transmission")
    n = state.alive.shape[0]
    s = state.throughput.shape[0]       # carried planes: C under hero sampling, else S
    s_table = scene.mat_diffuse.shape[0]
    m = scene.mat_ior.shape[0]
    rows = scene.light_area.shape[0]
    hero = state.bins is not None
    if n > MAX_LANES or not 1 <= s <= MAX_SPECTRUM or (not hero and s_table != s):
        raise ValueError(f"shade_bounce: {n} lanes and {s} carried planes against a "
                         f"scene of {s_table}: expected at most {MAX_LANES} lanes and "
                         f"1 .. {MAX_SPECTRUM} planes, {s_table} without hero bins")
    f32, i64, b8 = torch.float32, torch.int64, torch.bool
    planes = [
        ("origin", state.origin, f32, (3, n)), ("direction", state.direction, f32, (3, n)),
        ("throughput", state.throughput, f32, (s, n)),
        ("radiance", state.radiance, f32, (s, n)), ("pdf", state.pdf, f32, (n,)),
        ("prev_diffuse", state.prev_diffuse, f32, (n,)), ("ior", state.ior, f32, (n,)),
        ("alive", state.alive, b8, (n,)), ("t", hit.t, f32, (n,)),
        ("tri", hit.tri, i64, (n,)), ("mat", hit.mat, i64, (n,)),
        ("light", hit.light, i64, (n,)), ("pos", hit.pos, f32, (3, n)),
        ("normal", hit.normal, f32, (3, n)),
        ("light_select", uniforms["light_select"], f32, (n,)),
        ("light_bary0", uniforms["light_bary"][0], f32, (n,)),
        ("light_bary1", uniforms["light_bary"][1], f32, (n,)),
        ("lobe", uniforms["lobe"], f32, (n,)),
        ("bounce_dir0", uniforms["bounce_dir"][0], f32, (n,)),
        ("bounce_dir1", uniforms["bounce_dir"][1], f32, (n,)),
        ("mat_diffuse", scene.mat_diffuse, f32, (s_table, m)),
        ("mat_emissive", scene.mat_emissive, f32, (s_table, m)),
        ("mat_ior", scene.mat_ior, f32, (m,)), ("mat_type", scene.mat_type, i64, (m,)),
        ("light_cdf", scene.light_cdf, f32, (rows,)),
        ("light_p", scene.light_p, f32, (3, 3, rows)),
        ("light_n", scene.light_n, f32, (3, 3, rows)),
        ("light_pdf", scene.light_pdf, f32, (rows,)),
        ("light_area", scene.light_area, f32, (rows,)),
        ("light_tri", scene.light_tri, i64, (rows,)),
        ("light_emissive", scene.light_emissive, f32, (s_table, rows))]
    env = scene.env
    eh, ew = env.pdf_sa.shape if env is not None else (1, 1)
    texel_stride = pdf_col = 0
    if env is not None:
        # the records models/envlight.py:env_to derived once the map was made
        texel_stride, pdf_col = record_layout(env, s_table)
        k = eh * ew
        if k > MAX_LANES:
            raise ValueError(f"shade_bounce: an env map of {k} texels (the kernel's texel "
                             f"indices are 32-bit)")
        planes += [
            ("env_texel_rec", env.texel_rec, f32, (k, texel_stride)),
            ("env_alias_rec", env.alias_rec, torch.int32, (k, ALIAS_WORDS)),
            ("env_pdf", env.pdf_sa, f32, (eh, ew)),
            ("env_select_p", env.select_p, f32, ()), ("env_rotation", env.rotation, f32, ()),
            ("env_select", uniforms["env_select"], f32, (n,)),
            ("env_alias", uniforms["env_alias"], f32, (n,)),
            ("env_jit0", uniforms["env_jit"][0], f32, (n,)),
            ("env_jit1", uniforms["env_jit"][1], f32, (n,))]
    if hero:
        planes.append(("bins", state.bins, i64, (s, n)))
    if scene.mat_ior_bins is not None:
        planes.append(("mat_ior_bins", scene.mat_ior_bins, f32, (s_table, m)))
    materials = has_materials(scene)
    if scene.mat_roughness is not None:
        planes.append(("mat_roughness", scene.mat_roughness, f32, (m,)))
    th = tw = 1
    if scene.textures is not None:
        k, th, tw, _ = scene.textures.shape
        t = scene.tri_uv.shape[1]
        planes += [("hit_u", hit.u, f32, (n,)), ("hit_v", hit.v, f32, (n,)),
                   ("tri_uv", scene.tri_uv, f32, (6, t)),
                   ("mat_tex", scene.mat_tex, i64, (m,)),
                   ("textures", scene.textures, f32, (k, th, tw, 3))]
    p = _ShadeParams()
    for name, t, dtype, shape in planes:
        setattr(p, name, plane_address(f"shade_bounce {name}", t, dtype, shape, dev))

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    new = PathState(origin=empty(3, n), direction=empty(3, n), throughput=empty(s, n),
                    radiance=empty(s, n), pdf=empty(n), prev_diffuse=empty(n), ior=empty(n),
                    alive=empty(n, dtype=b8), pixel=state.pixel, bins=state.bins)
    pack = ShadowPack(to_light=empty(3, n), cap=empty(n), target=empty(n, dtype=i64),
                      contrib=empty(s, n), ok=empty(n, dtype=b8))
    shadow_origin = empty(3, n) if inline else None
    stats = empty(6, dtype=i64)
    for name, t in (("out_origin", new.origin), ("out_direction", new.direction),
                    ("out_throughput", new.throughput), ("out_radiance", new.radiance),
                    ("out_pdf", new.pdf), ("out_prev_diffuse", new.prev_diffuse),
                    ("out_ior", new.ior), ("out_alive", new.alive), *zip(pack._fields, pack),
                    ("stats", stats)):
        setattr(p, name, t.data_ptr())
    p.shadow_origin = shadow_origin.data_ptr() if inline else None
    p.n, p.s, p.m, p.num_lights, p.env_h, p.env_w = n, s, m, rows - 1, eh, ew
    p.env_texel_stride, p.env_pdf_col = texel_stride, pdf_col
    for name, v in folded_constants(cfg, (eh, ew), (th, tw)).items():
        setattr(p, name, v)
    p.last_bounce = int(bounce + 1 >= cfg.max_path_length)
    p.quirks = int(cfg.reference_quirks)
    p.refract = int(cfg.refract_dielectric)
    p.cull_zero_nee = int(cfg.cull_zero_nee)
    p.env, p.hero, p.dispersion = int(env is not None), int(hero), int(
        scene.mat_ior_bins is not None)
    # the map's check, made once when it reached the device
    # (models/envlight.py:radiance_max): no texel read off the misses
    clean = env is not None and env.radiance_max is not None
    p.env_radiance_max = env.radiance_max if clean else float("inf")
    p.materials = int(materials)
    if scene.textures is not None:
        p.num_tris, p.tex_h, p.tex_w = scene.tri_uv.shape[1], th, tw
        p.tex_band0, p.tex_band1 = texel_bands(s_table)
    rc = load_library().tpupt_shade_bounce(ctypes.addressof(p),
                                           torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"shade_bounce kernel launch failed: cudaError {rc}")
    launch_count.count(shade_bounce)
    counts = stats.unbind()
    counts = (counts[:4] if env is not None else counts[:2]) + (counts[4:] if materials else ())
    return new, pack, shadow_origin, counts


shade_bounce.launches = 0
