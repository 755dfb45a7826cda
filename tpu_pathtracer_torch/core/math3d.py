"""Component-major 3-vector helpers on torch tensors.

The layout rule of ``tpu_pathtracer`` is kept at every public function:
vectors are ``(3, N)`` tensors and spectra ``(S, N)`` — components in the
leading axis, the batch in the trailing one — so the two packages can be
compared like with like.  Each helper keeps the reference's operation order.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(3, N) . (3, N) -> (N,)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    return a * torch.rsqrt(dot(a, a))[None]


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Metal-style reflect: i - 2*dot(n, i)*n (i points toward the surface)."""
    return i - (2.0 * dot(n, i))[None] * n


def where3(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Select on a (N,) mask between (3, N) (or (S, N)) arrays."""
    return torch.where(mask[None], a, b)
