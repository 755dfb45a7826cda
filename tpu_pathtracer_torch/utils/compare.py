"""Golden-image comparison.

The reference compares against Mitsuba-rendered EXRs visually, via four blit
shader modes with a x10 gain (reference: renderer/Shaders.metal:53-66,
renderer/Raytracing.h:27-33).  This module provides those modes as array ops
plus the numeric pass/fail metrics the reference never had.

Caveat discovered while building: the bundled golden EXRs contain Mitsuba 0.5's
logo banner burned into the bottom-right corner (a patch of value exactly
1024.0, rows ~590-594, cols ~687-794 at 800x600).  :func:`golden_mask` excludes
it (scaled to the comparison resolution).
"""

from __future__ import annotations

import numpy as np

from ..config import ComparisonMode

# Banner bounds in the 800x600 goldens (fractional, so they scale).
_BANNER_Y0, _BANNER_X0 = 588.0 / 600.0, 685.0 / 800.0


def golden_mask(height: int, width: int) -> np.ndarray:
    """(H, W) bool mask: True where the golden pixel is trustworthy."""
    mask = np.ones((height, width), bool)
    mask[int(_BANNER_Y0 * height) :, int(_BANNER_X0 * width) :] = False
    return mask


def downsample(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resample (H0, W0, C) to (height, width, C).

    Integer shrink factors use an exact box mean; other shrink ratios
    bin-average (each output pixel averages its source bin).  An axis that
    GROWS uses nearest-neighbor index mapping instead — bin-averaging in
    that direction would leave empty output bins (0/0 -> NaN columns; the
    default 960x540 render vs the 800x600 goldens hit exactly that).
    """
    h0, w0 = img.shape[:2]
    if (h0, w0) == (height, width):
        return img
    if height > h0 or width > w0:
        rows = np.minimum((np.arange(height) * h0) // height, h0 - 1)
        cols = np.minimum((np.arange(width) * w0) // width, w0 - 1)
        # shrink the non-growing axis first (if any) via a recursive call
        if height > h0 and width <= w0:
            img = downsample(img, h0, width)
            return img[rows, :]
        if width > w0 and height <= h0:
            img = downsample(img, height, w0)
            return img[:, cols]
        return img[rows[:, None], cols[None, :]]
    if h0 % height == 0 and w0 % width == 0:
        return img.reshape(
            height, h0 // height, width, w0 // width, *img.shape[2:]
        ).mean(axis=(1, 3))
    # non-integer shrink: average source rows/cols binned by output index
    row_bin = np.minimum((np.arange(h0) * height) // h0, height - 1)
    col_bin = np.minimum((np.arange(w0) * width) // w0, width - 1)
    out = np.zeros((height, width, *img.shape[2:]), np.float64)
    cnt = np.zeros((height, width), np.int64)
    np.add.at(out, (row_bin[:, None], col_bin[None, :]), img)
    np.add.at(cnt, (row_bin[:, None], col_bin[None, :]), 1)
    cnt = cnt.reshape(height, width, *([1] * (img.ndim - 2)))
    return (out / cnt).astype(img.dtype)


def metrics(image: np.ndarray, golden: np.ndarray, mask: np.ndarray | None = None):
    """RMSE / relative-MSE / mean-ratio between (H, W, C) arrays."""
    image = np.asarray(image, np.float64)
    golden = np.asarray(golden, np.float64)
    if mask is None:
        mask = golden_mask(*image.shape[:2])
    m = mask[..., None] & np.isfinite(golden) & np.isfinite(image)
    diff = np.where(m, image - golden, 0.0)
    n = m.sum()
    mse = (diff**2).sum() / n
    # denominator must also be masked: 0 / NaN = NaN would leak a single
    # non-finite golden pixel into the total despite the mask
    gden = np.where(m, golden, 0.0)
    rel_mse = ((diff**2) / (gden**2 + 1e-2)).sum() / n
    mean_ratio = np.where(m, image, 0.0).sum() / max(np.where(m, golden, 0.0).sum(), 1e-12)
    return {
        "rmse": float(np.sqrt(mse)),
        "rel_mse": float(rel_mse),
        "mean_ratio": float(mean_ratio),
    }


def comparison_image(
    color: np.ndarray,
    reference: np.ndarray,
    mode: ComparisonMode,
    scale: float = 10.0,
) -> np.ndarray:
    """The blit shader's four diff modes (reference: renderer/Shaders.metal:53-66)."""
    if mode == ComparisonMode.DISABLED:
        return color
    if mode == ComparisonMode.ABSOLUTE_VALUE:
        return np.abs(color - reference) * scale
    if mode == ComparisonMode.REF_TO_COLOR:
        return np.maximum(0.0, reference - color) * scale
    if mode == ComparisonMode.COLOR_TO_REF:
        return np.maximum(0.0, color - reference) * scale
    if mode == ComparisonMode.LUMINANCE:
        lum_c = color[..., :3].mean(axis=-1)  # dot(c, 1/3) per the reference
        lum_r = reference[..., :3].mean(axis=-1)
        out = np.zeros((*color.shape[:2], 3), color.dtype)
        out[..., 0] = np.maximum(0.0, lum_c - lum_r) * scale
        out[..., 1] = np.maximum(0.0, lum_r - lum_c) * scale
        return out
    raise ValueError(f"unknown comparison mode {mode}")


def _srgb(v: np.ndarray) -> np.ndarray:
    """numpy linear -> sRGB with [0,1] clamp (reference: Raytracing.h:130-135)."""
    v = np.clip(v, 0.0, 1.0)
    return np.where(v < 0.0031308, 12.92 * v, 1.055 * np.power(v, 1.0 / 2.4) - 0.055)


def blit_display(
    color: np.ndarray,
    reference: np.ndarray | None = None,
    mode: ComparisonMode = ComparisonMode.DISABLED,
    scale: float = 10.0,
    tonemap: bool = False,
    manual_srgb: bool = False,
) -> np.ndarray:
    """The reference's full display pipeline, ordering included.

    Reference: renderer/Shaders.metal:38-66 (the blit fragment) plus
    renderer/Renderer.mm:88-94 (the framebuffer format choice MANUAL_SRGB
    selects).  Order matters: exposure tonemap, then — iff MANUAL_SRGB —
    an in-shader sRGB encode BEFORE the comparison diff; otherwise the
    hardware sRGB framebuffer encodes whatever the shader outputs, diff
    included.  The two orderings render identical pixels in normal display
    and visibly different diffs in the comparison modes, which is exactly
    the reference's observable behavior.

    ``color`` is the linear accumulated image; ``reference`` the raw linear
    golden (the reference samples it untransformed — quirk preserved).
    """
    c = np.asarray(color, np.float64)
    if tonemap:
        c = 1.0 - np.exp(-c)  # Shaders.metal:43-45
    if manual_srgb:
        c = _srgb(c)  # Shaders.metal:47-51
    if mode != ComparisonMode.DISABLED and reference is not None:
        c = comparison_image(c, np.asarray(reference, np.float64), mode, scale)
    if not manual_srgb:
        c = _srgb(c)  # BGRA8Unorm_sRGB framebuffer (Renderer.mm:93)
    return np.clip(c, 0.0, 1.0)
