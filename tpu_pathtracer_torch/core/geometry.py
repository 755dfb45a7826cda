"""Barycentric interpolation (reference: renderer/KernelHelpers.h:23-37)."""

from __future__ import annotations

from .math3d import normalize


def interpolate(p0, p1, p2, n0, n1, n2, uvw):
    """(3, N) vertex positions/normals and (3, N) weights -> (position,
    re-normalized normal), both (3, N)."""
    w0, w1, w2 = uvw[0][None], uvw[1][None], uvw[2][None]
    pos = p0 * w0 + p1 * w1 + p2 * w2
    nrm = normalize(n0 * w0 + n1 * w1 + n2 * w2)
    return pos, nrm
