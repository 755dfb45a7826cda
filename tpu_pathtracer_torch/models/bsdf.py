"""BSDF library: diffuse, mirror, smooth plastic, smooth dielectric.

The port of ``tpu_pathtracer/models/bsdf.py`` for the four parity materials
(reference: renderer/KernelHelpers.h:56-179).  Every lane computes all four
material responses and selects, in the reference's operation order.

Reference quirks preserved (``RenderConfig.reference_quirks``):
  * the smooth dielectric transmits straight through (wO = wI, no bend) and
    its NEE eval returns bsdf = pdf = 0 (reference: KernelHelpers.h:151-166,
    89-104);
  * NEE eval uses fresnel(eta_out=1.0) while bounce generation uses the
    ray's tracked IoR (reference: KernelHelpers.h:74 vs :137);
  * for the diffuse lobe, bsdf and pdf are the same number cos(theta)/pi;
  * with quirks, a perfect mirror bounce weights throughput by cos(theta)
    (reference: KernelHelpers.h:131,146,163).

The GGX extension types (rough conductor/plastic/dielectric), Snell
refraction and dispersion weights are not ported yet (ROADMAP.md queue 1
item 10); the constants are here because scene classification needs them.
"""

from __future__ import annotations

import torch

from ..config import PI
from ..core.math3d import dot, reflect
from ..core.sampling import generate_diffuse_bounce

# Material type enum (reference: renderer/Raytracing.h:35-43)
MATERIAL_DIFFUSE = 0
MATERIAL_MIRROR = 1
MATERIAL_SMOOTH_PLASTIC = 2
MATERIAL_SMOOTH_DIELECTRIC = 3
# Extension types of tpu_pathtracer (GGX); classified only with
# rough_materials=True, which the port does not support yet.
MATERIAL_ROUGH_CONDUCTOR = 4
MATERIAL_ROUGH_PLASTIC = 5
MATERIAL_ROUGH_DIELECTRIC = 6
MATERIAL_COUNT = 7

MATERIAL_NAMES = (
    "diffuse", "mirror", "smooth plastic", "smooth dielectric",
    "rough conductor", "rough plastic", "rough dielectric",
)


def fresnel(n, i, eta_out, eta_in):
    """Unpolarized Fresnel reflectance; 1.0 under total internal reflection
    (reference: renderer/KernelHelpers.h:7-21).  ``i`` points away from the
    surface."""
    eta_scale = eta_out / eta_in
    cos_theta_i = torch.clamp(dot(n, i), -1.0, 1.0)
    sin_theta_t_sq = (eta_scale * eta_scale) * (1.0 - cos_theta_i * cos_theta_i)
    cos_theta_t = torch.sqrt(torch.clamp(1.0 - sin_theta_t_sq, min=0.0))
    r_s = (eta_in * cos_theta_i - eta_out * cos_theta_t) / (
        eta_in * cos_theta_i + eta_out * cos_theta_t
    )
    r_p = (eta_in * cos_theta_t - eta_out * cos_theta_i) / (
        eta_in * cos_theta_t + eta_out * cos_theta_i
    )
    return torch.where(sin_theta_t_sq < 1.0, 0.5 * (r_s * r_s + r_p * r_p), 1.0)


def _select4(mtype, v_diffuse, v_mirror, v_plastic, v_dielectric):
    return torch.where(
        mtype == MATERIAL_DIFFUSE, v_diffuse,
        torch.where(
            mtype == MATERIAL_MIRROR, v_mirror,
            torch.where(mtype == MATERIAL_SMOOTH_PLASTIC, v_plastic, v_dielectric),
        ),
    )


def eval_material(mtype, ior, w_i, w_o, n, lobe_u, angle_epsilon):
    """NEE-side material evaluation -> (bsdf, pdf), each (N,); ``w_i``,
    ``w_o`` and ``n`` are (3, N) (reference: KernelHelpers.h:56-114).
    ``lobe_u`` must be the uniform later fed to :func:`sample_bounce`."""
    cos_theta = dot(w_o, n)
    is_mirror_dir = torch.abs(dot(reflect(w_i, n), w_o) - 1.0) < angle_epsilon
    mirror_bsdf = torch.where(is_mirror_dir, cos_theta, 0.0)

    diffuse_val = (1.0 / PI) * cos_theta  # bsdf == pdf for the diffuse lobe

    f_i = fresnel(n, -w_i, 1.0, ior)
    take_second_lobe = f_i < lobe_u  # diffuse (plastic) / transmit (dielectric)

    plastic_bsdf = torch.where(take_second_lobe, diffuse_val, mirror_bsdf)
    plastic_pdf = torch.where(take_second_lobe, diffuse_val, 1.0)
    dielectric_bsdf = torch.where(take_second_lobe, 0.0, mirror_bsdf)
    dielectric_pdf = torch.where(take_second_lobe, 0.0, 1.0)

    bsdf = _select4(mtype, diffuse_val, mirror_bsdf, plastic_bsdf, dielectric_bsdf)
    pdf = _select4(mtype, diffuse_val, torch.ones_like(diffuse_val),
                   plastic_pdf, dielectric_pdf)
    return bsdf, pdf


def sample_bounce(mtype, ior, w_i, n, lobe_u, dir_u, current_ior,
                  quirks: bool = True):
    """Sample the next bounce -> (w_o (3, N), bsdf, pdf, new_ior,
    finite_pdf) (reference: KernelHelpers.h:116-179).  ``dir_u`` (2, N) is
    the cosine-hemisphere warp's uniform pair; ``finite_pdf`` is the
    emitter-hit MIS flag (the reference's params.y, mtype == DIFFUSE)."""
    mirror_dir = reflect(w_i, n)
    diffuse_dir = generate_diffuse_bounce(dir_u, n)

    mirror_cos = dot(mirror_dir, n)
    if not quirks:
        mirror_cos = torch.ones_like(mirror_cos)
    diffuse_val = (1.0 / PI) * dot(diffuse_dir, n)

    f_i = fresnel(n, -w_i, current_ior, ior)
    take_second_lobe = f_i < lobe_u

    tsl3 = take_second_lobe[None]
    plastic_dir = torch.where(tsl3, diffuse_dir, mirror_dir)
    plastic_bsdf = torch.where(take_second_lobe, diffuse_val, mirror_cos)
    plastic_pdf = torch.where(take_second_lobe, diffuse_val, 1.0)

    # straight-through transmission (reference: KernelHelpers.h:151-166)
    dielectric_dir = torch.where(tsl3, w_i, mirror_dir)
    dielectric_bsdf = torch.where(take_second_lobe, 1.0, mirror_cos)
    dielectric_ior = torch.where(take_second_lobe, ior, current_ior)

    one = torch.ones_like(diffuse_val)
    w_o = _select4(mtype[None], diffuse_dir, mirror_dir, plastic_dir, dielectric_dir)
    bsdf = _select4(mtype, diffuse_val, mirror_cos, plastic_bsdf, dielectric_bsdf)
    pdf = _select4(mtype, diffuse_val, one, plastic_pdf, one)
    new_ior = _select4(mtype, current_ior, current_ior, current_ior, dielectric_ior)
    finite_pdf = (mtype == MATERIAL_DIFFUSE).to(torch.float32)
    return w_o, bsdf, pdf, new_ior, finite_pdf
