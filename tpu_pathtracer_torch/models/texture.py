"""Texture sampling: bilinear lookups over a stacked texture array.

The port of ``tpu_pathtracer/models/texture.py`` (an extension: the
reference parses texcoords and drops them, renderer/Renderer.mm:365-369).
A ``usemtl`` material with a ``map_Kd`` gets a texture index; at a hit the
interpolated uv samples the material's texture bilinearly and modulates
its Kd (standard OBJ semantics: effective albedo = Kd * texel).

Storage: one (K, TH, TW, 3) stack, every texture resampled on the host to
the largest height and width (:func:`resample_nearest`); a lane's texel is
four row gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spectrum as spec


def resample_nearest(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Host-side nearest-neighbour resample of (H, W, C) to (th, tw, C)."""
    h, w = img.shape[:2]
    ri = (np.arange(th) * h // th).clip(0, h - 1)
    ci = (np.arange(tw) * w // tw).clip(0, w - 1)
    return img[ri][:, ci]


def sample_bilinear(textures: torch.Tensor, tex_idx: torch.Tensor,
                    uv: torch.Tensor) -> torch.Tensor:
    """textures (K, TH, TW, 3), tex_idx (N,) (-1 = none -> white), uv (2, N)
    with wrap addressing -> (3, N) texel colours.  OBJ convention: v = 0 is
    the bottom of the image (row TH-1)."""
    k, th, tw, _ = textures.shape
    flat = textures.reshape(k * th * tw, 3)
    u = uv[0] - torch.floor(uv[0])
    v = uv[1] - torch.floor(uv[1])
    x = u * tw - 0.5
    y = (1.0 - v) * th - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    ti = torch.clamp(tex_idx, min=0)

    def read(xi, yi):
        xi = torch.remainder(xi.to(torch.int64), tw)
        yi = torch.remainder(yi.to(torch.int64), th)
        return flat[(ti * th + yi) * tw + xi]  # (N, 3)

    c00 = read(x0, y0)
    c10 = read(x0 + 1, y0)
    c01 = read(x0, y0 + 1)
    c11 = read(x0 + 1, y0 + 1)
    top = c00 * (1.0 - fx)[:, None] + c10 * fx[:, None]
    bot = c01 * (1.0 - fx)[:, None] + c11 * fx[:, None]
    out = (top * (1.0 - fy)[:, None] + bot * fy[:, None]).T  # (3, N)
    return torch.where(tex_idx[None, :] >= 0, out, 1.0)


def diffuse_modulation(scene, tri, u, v, mat, bins, samples: int) -> torch.Tensor:
    """(S|C, N) spectral multiplier of the diffuse albedo at a hit: the
    bilinear map_Kd texel lifted to the render's spectral bins (1.0 where
    the material is untextured)."""
    uvr = scene.tri_uv[:, tri]                                 # (6, N)
    w0 = 1.0 - u - v
    uv = torch.stack([
        uvr[0] * w0 + uvr[2] * u + uvr[4] * v,
        uvr[1] * w0 + uvr[3] * u + uvr[5] * v,
    ])
    rgb = sample_bilinear(scene.textures, scene.mat_tex[mat], uv)  # (3, N)
    s = spec.from_rgb(rgb.T, samples).T                        # (S, N)
    return spec.apply_bins(s.contiguous(), bins)
