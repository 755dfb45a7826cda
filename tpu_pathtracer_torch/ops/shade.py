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
the parity materials with no environment light, textures, roughness table,
dispersion or hero bins, at most MAX_SPECTRUM spectral planes.
render/wavefront.py:trace_bounce routes every other frame, and every CPU
tensor, to the plain version.

``folded_constants``: torch folds ``4.0 * eps``, ``1.0 / PI`` and ``PI *
2.0`` in double from Python scalars and rounds the result (and ``eps``,
``angle_epsilon``, ``pdf_floor``) to float32 where it meets a float32
tensor; the host rounds them the same way, so the kernel gets the same bits.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import PI, RenderConfig
from .cuda_build import load_library, plane_address

MAX_SPECTRUM = 16  # the most spectral planes the kernel takes (csrc/shade.cu:kMaxSpectrum)
MAX_LANES = 2 ** 31 - 1


def shade_kernel_covers(cfg: RenderConfig, scene) -> bool:
    """Whether frames of ``cfg`` on ``scene`` shade in the kernel on the card:
    no environment light, textures, roughness table (GGX types) or
    dispersion, no hero sampling, and at most MAX_SPECTRUM spectral planes."""
    hero = cfg.spectrum_samples > 3 and cfg.hero_wavelengths > 0
    return (scene.env is None and scene.textures is None and scene.mat_roughness is None
            and scene.mat_ior_bins is None and not hero
            and cfg.spectrum_samples <= MAX_SPECTRUM)


def folded_constants(cfg: RenderConfig) -> dict:
    """The float32 values of the Python constants the shading applies to
    float32 tensors, rounded as torch rounds them."""
    def f32(x: float) -> float:
        return float(np.float32(x))

    return {"eps": f32(cfg.distance_epsilon), "aeps": f32(cfg.angle_epsilon),
            "four_eps": f32(4.0 * cfg.distance_epsilon), "inv_pi": f32(1.0 / PI),
            "two_pi": f32(PI * 2.0), "pdf_floor": f32(cfg.pdf_floor)}


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
        "out_origin", "out_direction", "out_throughput", "out_radiance", "out_pdf",
        "out_prev_diffuse", "out_ior", "out_alive", "to_light", "cap", "target",
        "contrib", "ok", "shadow_origin", "stats")] + [
        (name, ctypes.c_int) for name in ("n", "s", "m", "num_lights")] + [
        (name, ctypes.c_float) for name in (
            "eps", "aeps", "four_eps", "inv_pi", "two_pi", "pdf_floor")] + [
        (name, ctypes.c_int) for name in (
            "last_bounce", "quirks", "refract", "cull_zero_nee")]


def shade_bounce(scene, cfg: RenderConfig, bounce: int, state, uniforms: dict, hit,
                 inline: bool):
    """Shade bounce ``bounce`` of the wavefront ``state`` at its nearest hit
    ``hit`` with the bounce's ``uniforms`` in one launch -> (new state,
    shadow pack, the shadow origin ``hp + hn * eps`` when ``inline`` else
    None, (live path lanes, live shadow lanes) as int64 tensors), as
    :func:`shade_bounce_plain` returns them.  ``pixel`` and ``bins`` pass
    through.  CUDA tensors only, and only where :func:`shade_kernel_covers`
    holds."""
    from ..render.wavefront import PathState, ShadowPack

    dev = state.alive.device
    if dev.type != "cuda":
        raise ValueError("shade_bounce: CUDA tensors only (the CPU takes "
                         "render/wavefront.py:_shade_plain)")
    if not shade_kernel_covers(cfg, scene):
        raise ValueError("shade_bounce: this configuration is not covered by the kernel "
                         "(ops/shade.py:shade_kernel_covers)")
    n = state.alive.shape[0]
    s = state.throughput.shape[0]
    m = scene.mat_ior.shape[0]
    rows = scene.light_area.shape[0]
    if n > MAX_LANES or not 1 <= s <= MAX_SPECTRUM or scene.mat_diffuse.shape[0] != s:
        raise ValueError(f"shade_bounce: {n} lanes and {s} spectral planes against a "
                         f"scene of {scene.mat_diffuse.shape[0]}: expected at most "
                         f"{MAX_LANES} lanes and 1 .. {MAX_SPECTRUM} planes")
    f32, i64, b8 = torch.float32, torch.int64, torch.bool
    p = _ShadeParams()
    for name, t, dtype, shape in (
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
            ("mat_diffuse", scene.mat_diffuse, f32, (s, m)),
            ("mat_emissive", scene.mat_emissive, f32, (s, m)),
            ("mat_ior", scene.mat_ior, f32, (m,)), ("mat_type", scene.mat_type, i64, (m,)),
            ("light_cdf", scene.light_cdf, f32, (rows,)),
            ("light_p", scene.light_p, f32, (3, 3, rows)),
            ("light_n", scene.light_n, f32, (3, 3, rows)),
            ("light_pdf", scene.light_pdf, f32, (rows,)),
            ("light_area", scene.light_area, f32, (rows,)),
            ("light_tri", scene.light_tri, i64, (rows,)),
            ("light_emissive", scene.light_emissive, f32, (s, rows))):
        setattr(p, name, plane_address(f"shade_bounce {name}", t, dtype, shape, dev))

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    new = PathState(origin=empty(3, n), direction=empty(3, n), throughput=empty(s, n),
                    radiance=empty(s, n), pdf=empty(n), prev_diffuse=empty(n), ior=empty(n),
                    alive=empty(n, dtype=b8), pixel=state.pixel, bins=state.bins)
    pack = ShadowPack(to_light=empty(3, n), cap=empty(n), target=empty(n, dtype=i64),
                      contrib=empty(s, n), ok=empty(n, dtype=b8))
    shadow_origin = empty(3, n) if inline else None
    stats = empty(2, dtype=i64)
    for name, t in (("out_origin", new.origin), ("out_direction", new.direction),
                    ("out_throughput", new.throughput), ("out_radiance", new.radiance),
                    ("out_pdf", new.pdf), ("out_prev_diffuse", new.prev_diffuse),
                    ("out_ior", new.ior), ("out_alive", new.alive), *zip(pack._fields, pack),
                    ("stats", stats)):
        setattr(p, name, t.data_ptr())
    p.shadow_origin = shadow_origin.data_ptr() if inline else None
    p.n, p.s, p.m, p.num_lights = n, s, m, rows - 1
    for name, v in folded_constants(cfg).items():
        setattr(p, name, v)
    p.last_bounce = int(bounce + 1 >= cfg.max_path_length)
    p.quirks = int(cfg.reference_quirks)
    p.refract = int(cfg.refract_dielectric)
    p.cull_zero_nee = int(cfg.cull_zero_nee)
    rc = load_library().tpupt_shade_bounce(ctypes.addressof(p),
                                           torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"shade_bounce kernel launch failed: cudaError {rc}")
    shade_bounce.launches += 1
    return new, pack, shadow_origin, (stats[0], stats[1])


shade_bounce.launches = 0
