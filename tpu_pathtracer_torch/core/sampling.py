"""Sampling warps used by the frame path (reference: renderer/Raytracing.h:
168-228), as torch ops in the operation order of ``tpu_pathtracer``'s
``core/sampling.py``."""

from __future__ import annotations

import torch

from ..config import PI


def balance_heuristic(f_pdf: torch.Tensor, g_pdf: torch.Tensor) -> torch.Tensor:
    """MIS weight; despite its reference name, the power heuristic (beta=2)
    (reference: renderer/Raytracing.h:173-178).  0/0 gives weight 0."""
    f2 = f_pdf * f_pdf
    g2 = g_pdf * g_pdf
    d = f2 + g2
    pos = d > 0.0
    return torch.where(pos, f2 / torch.where(pos, d, 1.0), 0.0)


def barycentric(smp: torch.Tensor) -> torch.Tensor:
    """Uniform triangle warp: (2, N) samples -> (3, N) barycentric weights
    (reference: renderer/Raytracing.h:182-187)."""
    r1 = torch.sqrt(smp[0])
    r2 = smp[1]
    return torch.stack([1.0 - r1, r1 * (1.0 - r2), r1 * r2])


def build_orthonormal_basis(n: torch.Tensor):
    """Branchless pixar-style ONB on (3, N) normals, matching the reference's
    two-branch variant (reference: renderer/Raytracing.h:189-205)."""
    nx, ny, nz = n[0], n[1], n[2]
    neg = nz < 0.0
    a = 1.0 / torch.where(neg, 1.0 - nz, 1.0 + nz)
    b = nx * ny * a
    u = torch.stack([1.0 - nx * nx * a, -b, torch.where(neg, nx, -nx)])
    v = torch.stack([
        torch.where(neg, b, -b),
        torch.where(neg, ny * ny * a - 1.0, 1.0 - ny * ny * a),
        -ny,
    ])
    return u, v


def align_with_normal(n, cos_theta, phi) -> torch.Tensor:
    """Spherical-to-world around (3, N) normals
    (reference: renderer/Raytracing.h:207-216)."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    u, v = build_orthonormal_basis(n)
    return (u * torch.cos(phi)[None] + v * torch.sin(phi)[None]) * sin_theta[None] + (
        n * cos_theta[None]
    )


def generate_diffuse_bounce(smp: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Cosine-hemisphere bounce (reference: renderer/Raytracing.h:218-223);
    ``smp`` (2, N): smp[1] -> cos(theta), smp[0] -> phi."""
    cos_theta = torch.sqrt(smp[1])
    phi = smp[0] * (PI * 2.0)
    return align_with_normal(n, cos_theta, phi)


def select_light_index(xi: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """CDF inversion for light-triangle selection: the count of
    exclusive-prefix entries ``cdf[1:]`` at or below ``xi`` (reference:
    renderer/KernelHelpers.h:49-54), as one binary search."""
    return torch.searchsorted(cdf[1:].contiguous(), xi, right=True)
