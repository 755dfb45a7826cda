"""Ray-triangle intersection records and the brute-force oracle.

The port of ``tpu_pathtracer/ops/intersect.py``: the hit records the shading
core reads, Moller-Trumbore on component planes, and ``intersect_brute`` —
dense nearest-hit over every triangle, the ground truth the traversal
kernels are tested against.

Hit convention: barycentric (u, v) weight vertices 1 and 2; position =
(1-u-v)*p0 + u*p1 + v*p2.  Misses have t = +inf.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.geometry import interpolate


class Hit(NamedTuple):
    t: torch.Tensor     # (N,) float32, +inf on miss
    tri: torch.Tensor   # (N,) int64, 0 on miss
    u: torch.Tensor     # (N,) float32 weight on p1
    v: torch.Tensor     # (N,) float32 weight on p2

    @property
    def uvw(self) -> torch.Tensor:
        return torch.stack([1.0 - self.u - self.v, self.u, self.v])

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.t)


class HitShade(NamedTuple):
    """A hit plus what the shading core needs (the reference's
    ``Intersection`` + the TriangleReference/vertex/material fetches at the
    top of ``intersectionHandler``, renderer/Shaders.metal:121-140).

    Range-capped (shadow) queries resolve only t, u, v and tri; their mat,
    light, pos and normal are None."""

    t: torch.Tensor       # (N,) float32, +inf on miss
    u: torch.Tensor       # (N,)
    v: torch.Tensor       # (N,)
    tri: torch.Tensor     # (N,) int64 ORIGINAL triangle index
    mat: torch.Tensor | None     # (N,) int64 material id, 0 on miss
    light: torch.Tensor | None   # (N,) int64 light-table index, -1 if none
    pos: torch.Tensor | None     # (3, N) interpolated hit position
    normal: torch.Tensor | None  # (3, N) interpolated unit shading normal

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.t)


def shade_from_scene(scene, hit: Hit) -> HitShade:
    """Expand a bare Hit into a HitShade with gathers from the scene SoA."""
    tri = torch.where(hit.valid, hit.tri, 0)
    pos, nrm = interpolate(
        scene.p0[:, tri], scene.p1[:, tri], scene.p2[:, tri],
        scene.n0[:, tri], scene.n1[:, tri], scene.n2[:, tri],
        hit.uvw,
    )
    return HitShade(
        t=hit.t, u=hit.u, v=hit.v, tri=tri,
        mat=scene.material_id[tri],
        light=torch.where(hit.valid, scene.light_index[tri], -1),
        pos=pos, normal=nrm,
    )


def moller_trumbore_planes(o, d, tri_planes, t_min: float = 0.0):
    """Moller-Trumbore on broadcastable component planes.

    ``o``/``d``: three ray component tensors each; ``tri_planes``: nine
    triangle component tensors (p0.xyz, e1.xyz, e2.xyz).  Returns (t, u, v)
    with t = +inf where there is no hit.  Double-sided (the reference
    configures MPS with no culling, renderer/Renderer.mm:465)."""
    ox, oy, oz = o
    dx, dy, dz = d
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri_planes
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    nz = det != 0.0
    inv_det = torch.where(nz, 1.0 / det, 0.0)
    tx = ox - p0x
    ty = oy - p0y
    tz = oz - p0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = nz & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return torch.where(ok, t, torch.inf), u, v


def intersect_brute(o, d, p0, p1, p2, t_min: float = 0.0, chunk: int = 256) -> Hit:
    """Nearest hit over all triangles (the test oracle), in triangle chunks.
    ``o``/``d``: (3, N) rays; ``p0``/``p1``/``p2``: (3, T) vertices."""
    e1 = p1 - p0
    e2 = p2 - p0
    ov = tuple(c[:, None] for c in o)
    dv = tuple(c[:, None] for c in d)
    best_t = torch.full((o.shape[1],), torch.inf, device=o.device)
    best_i = torch.zeros(o.shape[1], dtype=torch.int64, device=o.device)
    for c0 in range(0, p0.shape[1], chunk):
        tp = tuple(c[None, c0:c0 + chunk] for arr in (p0, e1, e2) for c in arr)
        t, _, _ = moller_trumbore_planes(ov, dv, tp, t_min)
        ct, local = torch.min(t, dim=1)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, c0 + local, best_i)
    tp = tuple(c[best_i][:, None] for arr in (p0, e1, e2) for c in arr)
    _, u, v = moller_trumbore_planes(ov, dv, tp, t_min)
    return Hit(t=best_t, tri=best_i, u=u[:, 0], v=v[:, 0])
