"""Shared traversal arithmetic (the port of ``tpu_pathtracer/ops/traverse.py``
as far as the kernels' plain versions need it)."""

from __future__ import annotations

import torch

TINY = 1e-30


def safe_inverse(dx, dy, dz):
    """Component inverses, nudging |x| < 1e-30 to +-1e-30 so 0 * inf never
    makes NaNs in the slab test."""
    def inv(x):
        return 1.0 / torch.where(torch.abs(x) < TINY,
                                 torch.where(x < 0, -TINY, TINY), x)
    return inv(dx), inv(dy), inv(dz)
