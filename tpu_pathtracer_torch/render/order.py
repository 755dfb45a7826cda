"""Pixel traversal order: 2D block tiling for ray coherence.

Rays are generated block by block (``choose_block`` bounds each block's
direction spread).  The port keeps the reference's order so its camera
wavefront is lane-for-lane the reference's; the RNG keys on absolute pixel
ids, so the order never changes the image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PixelOrder(NamedTuple):
    rows: torch.Tensor   # (N,) int64 absolute image row per lane
    cols: torch.Tensor   # (N,) int64 absolute image column per lane
    height: int
    width: int
    row0: int
    block: tuple         # (bh, bw); (1, width) == row-major


def choose_block(height: int, width: int, target: int) -> tuple:
    """Pick (bh, bw) dividing (height, width) with bh*bw <= target, preferring
    large, square-ish blocks (pixels are square in angle)."""
    best = (1, width if width <= target else 1)
    best_score = -1.0
    for bh in range(1, height + 1):
        if height % bh:
            continue
        if bh > target:
            break
        for bw in range(1, width + 1):
            if width % bw or bh * bw > target:
                continue
            area = bh * bw
            aspect = min(bh, bw) / max(bh, bw)
            score = area * (0.5 + 0.5 * aspect)
            if score > best_score:
                best_score = score
                best = (bh, bw)
    return best


def make_order(height: int, width: int, row0: int = 0, tile: int | None = None,
               device="cuda") -> PixelOrder:
    """Build the lane -> pixel mapping.  ``tile=None`` keeps row-major order."""
    block = (1, width) if tile is None else choose_block(height, width, tile)
    bh, bw = block
    nbh, nbw = height // bh, width // bw
    r = torch.arange(height, dtype=torch.int64, device=device)
    c = torch.arange(width, dtype=torch.int64, device=device)
    rows2d = r[:, None].expand(height, width)
    cols2d = c[None, :].expand(height, width)

    def blockify(a):
        return a.reshape(nbh, bh, nbw, bw).permute(0, 2, 1, 3).reshape(-1)

    return PixelOrder(
        rows=row0 + blockify(rows2d),
        cols=blockify(cols2d),
        height=height,
        width=width,
        row0=row0,
        block=block,
    )
