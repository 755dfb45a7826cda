"""GGX microfacet lobe (Smith height-correlated, VNDF sampling).

The port of ``tpu_pathtracer/models/ggx.py``.  It backs the three material
models the reference stubs as TODO (reference: renderer/Renderer.mm:305,
315,319 -- rough conductor / rough plastic / rough dielectric leave
``materialType`` unset); a scene opts in with ``load_scene(...,
rough_materials=True)``, and the parity default keeps the reference's
diffuse fallback.

Conventions of the port: ``w_i`` is the ray direction INTO the surface,
``v = -w_i`` the view vector, ``n`` the shading normal, all (3, N);
``alpha = roughness**2``.  The lobe is scalar (F = 1); the spectral
conductor Fresnel is a throughput factor of the wavefront
(render/wavefront.py:_conductor_albedo).

Formulas: Heitz, "Sampling the GGX Distribution of Visible Normals"
(2018), and Heitz 2014 for the height-correlated Smith G2.
"""

from __future__ import annotations

import math

import torch

from ..core.math3d import dot, reflect
from ..core.sampling import build_orthonormal_basis

_EPS = 1e-7


def _lambda(cos_t, alpha):
    """Smith Lambda for GGX: (-1 + sqrt(1 + a^2 tan^2)) / 2."""
    c2 = torch.clamp(cos_t * cos_t, _EPS, 1.0)
    tan2 = (1.0 - c2) / c2
    return 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))


def ndf(cos_m, alpha):
    """GGX normal distribution D(m), m in the upper hemisphere."""
    c2 = cos_m * cos_m
    a2 = alpha * alpha
    denom = c2 * (a2 - 1.0) + 1.0
    return torch.where(cos_m > 0.0,
                       a2 / torch.clamp(math.pi * denom * denom, min=_EPS), 0.0)


def g1(cos_v, alpha):
    return 1.0 / (1.0 + _lambda(cos_v, alpha))


def g2(cos_v, cos_l, alpha):
    """Height-correlated Smith masking-shadowing."""
    return 1.0 / (1.0 + _lambda(cos_v, alpha) + _lambda(cos_l, alpha))


def eval_lobe(w_i, w_o, n, alpha):
    """Scalar GGX reflection lobe at (v = -w_i, l = w_o) -> (fcos, pdf,
    cos_vm): ``fcos`` = f*cos_l with F = 1 = D*G2 / (4 cos_v), ``pdf`` the
    VNDF density of w_o = D*G1 / (4 cos_v), ``cos_vm`` = v.m for the
    caller's Fresnel.  Lanes with v or l below the surface return zeros."""
    v = -w_i
    cos_v = dot(v, n)
    cos_l = dot(w_o, n)
    h = v + w_o
    hlen = torch.sqrt(torch.clamp(dot(h, h), min=_EPS * _EPS))
    m = h / hlen[None]
    cos_m = dot(m, n)
    cos_vm = dot(v, m)
    d = ndf(cos_m, alpha)
    ok = (cos_v > _EPS) & (cos_l > _EPS) & (cos_vm > _EPS)
    inv4cv = 1.0 / torch.clamp(4.0 * cos_v, min=_EPS)
    fcos = torch.where(ok, d * g2(cos_v, cos_l, alpha) * inv4cv, 0.0)
    pdf = torch.where(ok, d * g1(cos_v, alpha) * inv4cv, 0.0)
    return fcos, pdf, torch.where(ok, cos_vm, 0.0)


def sample_lobe(w_i, n, alpha, u):
    """VNDF-sample a GGX reflection -> (w_o, weight, pdf, cos_vm).
    ``weight`` = f*cos/pdf with F = 1, which for VNDF sampling is G2/G1;
    ``u`` is (2, N).  A sampled w_o below the surface gets weight 0
    (single-scatter GGX)."""
    v = -w_i
    t1, t2 = build_orthonormal_basis(n)
    vx = dot(v, t1)
    vy = dot(v, t2)
    vz = dot(v, n)
    # stretch to the hemisphere of the alpha = 1 VNDF
    sx, sy, sz = alpha * vx, alpha * vy, vz
    slen = torch.sqrt(torch.clamp(sx * sx + sy * sy + sz * sz, min=_EPS * _EPS))
    vhx, vhy, vhz = sx / slen, sy / slen, sz / slen
    # orthonormal frame around vh
    lensq = vhx * vhx + vhy * vhy
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=_EPS * _EPS))
    t1x = torch.where(lensq > _EPS, -vhy * inv, 1.0)
    t1y = torch.where(lensq > _EPS, vhx * inv, 0.0)
    # T2 = cross(vh, T1)
    t2x = vhy * 0.0 - vhz * t1y
    t2y = vhz * t1x - vhx * 0.0
    t2z = vhx * t1y - vhy * t1x
    # disk sample, warped toward the hemisphere top
    r = torch.sqrt(u[0])
    phi = 2.0 * math.pi * u[1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vhz)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nhx = p1 * t1x + p2 * t2x + pz * vhx
    nhy = p1 * t1y + p2 * t2y + pz * vhy
    nhz = p1 * 0.0 + p2 * t2z + pz * vhz
    # unstretch
    mx, my, mz = alpha * nhx, alpha * nhy, torch.clamp(nhz, min=0.0)
    mlen = torch.sqrt(torch.clamp(mx * mx + my * my + mz * mz, min=_EPS * _EPS))
    mx, my, mz = mx / mlen, my / mlen, mz / mlen
    m = mx[None] * t1 + my[None] * t2 + mz[None] * n
    w_o = reflect(w_i, m)
    cos_v = vz
    cos_l = dot(w_o, n)
    cos_vm = dot(v, m)
    ok = (cos_v > _EPS) & (cos_l > _EPS) & (cos_vm > _EPS)
    weight = torch.where(ok, g2(cos_v, cos_l, alpha) * (1.0 + _lambda(cos_v, alpha)), 0.0)
    d = ndf(mz, alpha)
    pdf = torch.where(ok, d * g1(cos_v, alpha) / torch.clamp(4.0 * cos_v, min=_EPS), 0.0)
    return w_o, weight, pdf, torch.where(ok, cos_vm, 0.0)


def schlick(f0, cos_vm):
    """Schlick Fresnel; ``f0`` may be spectral (S, N) against (N,) cos."""
    w = (1.0 - torch.clamp(cos_vm, 0.0, 1.0)) ** 5
    return f0 + (1.0 - f0) * w[None] if f0.ndim == 2 else f0 + (1.0 - f0) * w
