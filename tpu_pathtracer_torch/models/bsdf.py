"""BSDF library: diffuse, mirror, smooth plastic, smooth dielectric, and
the GGX extension types.

The port of ``tpu_pathtracer/models/bsdf.py``: the four parity materials
(reference: renderer/KernelHelpers.h:56-179), the three GGX types the
reference leaves as TODO (rough conductor / plastic / dielectric, backed by
models/ggx.py), Snell refraction for the smooth dielectric
(cfg.refract_dielectric) and the dispersive per-bin lobe weights
(:func:`dispersion_weights`).  Every lane computes every material response
and selects, in the reference's operation order.

Reference quirks preserved (``RenderConfig.reference_quirks``):
  * the smooth dielectric transmits straight through (wO = wI, no bend) and
    its NEE eval returns bsdf = pdf = 0 (reference: KernelHelpers.h:151-166,
    89-104);
  * NEE eval uses fresnel(eta_out=1.0) while bounce generation uses the
    ray's tracked IoR (reference: KernelHelpers.h:74 vs :137);
  * for the diffuse lobe, bsdf and pdf are the same number cos(theta)/pi;
  * with quirks, a perfect mirror bounce weights throughput by cos(theta)
    (reference: KernelHelpers.h:131,146,163).
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
# Extension types: the reference's TODO materials (reference:
# renderer/Renderer.mm:305,315,319), GGX-backed (models/ggx.py); classified
# only with load_scene(..., rough_materials=True).
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


def _select_rough(mtype, v_parity, v_conductor, v_rplastic, v_rdielectric):
    """Layer the GGX extension types over the parity _select4 result."""
    return torch.where(
        mtype == MATERIAL_ROUGH_CONDUCTOR, v_conductor,
        torch.where(
            mtype == MATERIAL_ROUGH_PLASTIC, v_rplastic,
            torch.where(mtype == MATERIAL_ROUGH_DIELECTRIC, v_rdielectric, v_parity),
        ),
    )


def eval_material(mtype, ior, w_i, w_o, n, lobe_u, angle_epsilon, roughness=None):
    """NEE-side material evaluation -> (bsdf, pdf), each (N,); ``w_i``,
    ``w_o`` and ``n`` are (3, N) (reference: KernelHelpers.h:56-114).
    ``lobe_u`` must be the uniform later fed to :func:`sample_bounce`.
    ``roughness`` (N,) (scenes with GGX types) adds the rough lobes: scalar
    F = 1, and rough plastic / dielectric keep the smooth models' scalar
    Fresnel lobe choice with the GGX lobe as the specular arm."""
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
    if roughness is None:
        return bsdf, pdf
    from . import ggx

    gfcos, gpdf, _ = ggx.eval_lobe(w_i, w_o, n, roughness * roughness)
    r_pl_bsdf = torch.where(take_second_lobe, diffuse_val, gfcos)
    r_pl_pdf = torch.where(take_second_lobe, diffuse_val, gpdf)
    r_di_bsdf = torch.where(take_second_lobe, 0.0, gfcos)
    r_di_pdf = torch.where(take_second_lobe, 0.0, gpdf)
    bsdf = _select_rough(mtype, bsdf, gfcos, r_pl_bsdf, r_di_bsdf)
    pdf = _select_rough(mtype, pdf, gpdf, r_pl_pdf, r_di_pdf)
    return bsdf, pdf


def sample_bounce(mtype, ior, w_i, n, lobe_u, dir_u, current_ior,
                  quirks: bool = True, roughness=None, refract: bool = False):
    """Sample the next bounce -> (w_o (3, N), bsdf, pdf, new_ior,
    finite_pdf) (reference: KernelHelpers.h:116-179).  ``dir_u`` (2, N) is
    the cosine-hemisphere warp's uniform pair; ``finite_pdf`` is the
    emitter-hit MIS flag (the reference's params.y: mtype == DIFFUSE for
    the parity materials, per lobe for the GGX types).

    ``refract`` (cfg.refract_dielectric) replaces the straight-through
    smooth-dielectric transmission with Snell-bent refraction: two-sided
    normals, air (IoR 1.0) outside, TIR through the oriented Fresnel, and
    the camera-path radiance scale (eta_i/eta_t)^2.  The rough dielectric
    transmits straight through either way.  ``roughness`` (N,) adds the
    GGX lobes (VNDF-sampled)."""
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

    one = torch.ones_like(diffuse_val)
    if not refract:
        # straight-through transmission (reference: KernelHelpers.h:151-166)
        dielectric_dir = torch.where(tsl3, w_i, mirror_dir)
        dielectric_bsdf = torch.where(take_second_lobe, 1.0, mirror_cos)
        dielectric_ior = torch.where(take_second_lobe, ior, current_ior)
    else:
        # Snell-bent transmission with two-sided normals and air outside;
        # TIR is the oriented Fresnel returning 1 (the reflection arm)
        entering = dot(w_i, n) < 0.0
        n_f = torch.where(entering[None], n, -n)
        eta_t = torch.where(entering, ior, 1.0)
        f_r = fresnel(n_f, -w_i, current_ior, eta_t)
        eta = current_ior / torch.clamp(eta_t, min=1e-6)
        cos_i = -dot(w_i, n_f)
        sin_t_sq = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
        cos_t = torch.sqrt(torch.clamp(1.0 - sin_t_sq, min=0.0))
        refr_dir = eta[None] * w_i + (eta * cos_i - cos_t)[None] * n_f
        # dielectric lanes re-choose their lobe with the oriented Fresnel
        # (same lobe_u); plastic keeps the reference's f_i choice
        dsl = f_r < lobe_u
        refl_dir = reflect(w_i, n_f)
        refl_w = dot(refl_dir, n_f) if quirks else one
        dielectric_dir = torch.where(dsl[None], refr_dir, refl_dir)
        # camera-path radiance: transmission scales by (eta_i/eta_t)^2
        dielectric_bsdf = torch.where(dsl, eta * eta, refl_w)
        dielectric_ior = torch.where(dsl, eta_t, current_ior)

    w_o = _select4(mtype[None], diffuse_dir, mirror_dir, plastic_dir, dielectric_dir)
    bsdf = _select4(mtype, diffuse_val, mirror_cos, plastic_bsdf, dielectric_bsdf)
    pdf = _select4(mtype, diffuse_val, one, plastic_pdf, one)
    new_ior = _select4(mtype, current_ior, current_ior, current_ior, dielectric_ior)
    finite_pdf = (mtype == MATERIAL_DIFFUSE).to(torch.float32)
    if roughness is None:
        return w_o, bsdf, pdf, new_ior, finite_pdf
    from . import ggx

    g_dir, g_wgt, g_pdf, _ = ggx.sample_lobe(w_i, n, roughness * roughness, dir_u)
    # bsdf = f*cos and pdf = the sampling density, as for the diffuse lobe:
    # f*cos = weight * pdf (F = 1)
    g_fcos = g_wgt * g_pdf
    r_pl_dir = torch.where(tsl3, diffuse_dir, g_dir)
    r_pl_bsdf = torch.where(take_second_lobe, diffuse_val, g_fcos)
    r_pl_pdf = torch.where(take_second_lobe, diffuse_val, g_pdf)
    r_di_dir = torch.where(tsl3, w_i, g_dir)
    r_di_bsdf = torch.where(take_second_lobe, 1.0, g_fcos)
    r_di_pdf = torch.where(take_second_lobe, 1.0, g_pdf)
    # the rough dielectric keys its own IoR update on take_second_lobe
    r_di_ior = torch.where(take_second_lobe, ior, current_ior)

    w_o = _select_rough(mtype[None], w_o, g_dir, r_pl_dir, r_di_dir)
    bsdf = _select_rough(mtype, bsdf, g_fcos, r_pl_bsdf, r_di_bsdf)
    pdf = _select_rough(mtype, pdf, g_pdf, r_pl_pdf, r_di_pdf)
    new_ior = _select_rough(mtype, new_ior, current_ior, current_ior, r_di_ior)
    finite = _select_rough(mtype, finite_pdf, torch.ones_like(finite_pdf),
                           torch.ones_like(finite_pdf),
                           torch.where(take_second_lobe, 0.0, 1.0))
    return w_o, bsdf, pdf, new_ior, finite


def dispersion_weights(mtype, ior, ior_bins, w_i, n, lobe_u, eta_out):
    """Per-wavelength-bin lobe reweighting of dispersive materials -> (S|C,
    N), multiplied into the bin throughputs.  The lobe choice stays with
    the scalar (d-line) Fresnel ``f_h`` and the same ``lobe_u``; each bin
    reweights its arm so its expectation is exact: specular F_b/F_h, second
    lobe (1-F_b)/(1-F_h).  Diffuse and mirror lanes get weight 1.
    ``ior_bins`` (S|C, N): the lane's per-bin material IoR; ``eta_out``:
    the tracked ray IoR for the bounce arm, 1.0 for NEE (the reference's
    eta quirk, KernelHelpers.h:74 vs :137)."""
    f_h = fresnel(n, -w_i, eta_out, ior)                       # (N,)
    f_b = fresnel(n, -w_i, eta_out, ior_bins)                  # (S|C, N)
    take_second = (f_h < lobe_u)[None]
    w_spec = f_b / torch.clamp(f_h, min=1e-6)[None]
    w_sec = (1.0 - f_b) / torch.clamp(1.0 - f_h, min=1e-6)[None]
    w = torch.where(take_second, w_sec, w_spec)
    has_fresnel_lobe = ((mtype == MATERIAL_SMOOTH_PLASTIC)
                        | (mtype == MATERIAL_SMOOTH_DIELECTRIC)
                        | (mtype == MATERIAL_ROUGH_PLASTIC)
                        | (mtype == MATERIAL_ROUGH_DIELECTRIC))[None]
    return torch.where(has_fresnel_lobe, w, 1.0)
