"""Spectrum representation.

The port of ``tpu_pathtracer/core/spectrum.py``.  The reference carries
radiance as a ``Spectrum`` of SPECTRUM_SAMPLES values (reference:
renderer/Spectrum.h:3-21; 3, an RGB stand-in); a spectrum is the leading
``(S, N)`` axis of a tensor.  For S > 3 (true spectra) the S bins sit
uniformly in [400, 700] nm, RGB lifts to them by a box basis (B: 400-490,
G: 490-580, R: 580-700) and collapses back by band averages.  Under hero
sampling a lane reads only its C bins (:func:`apply_bins`).

:func:`from_rgb` takes numpy arrays (host tables: scenes, env maps) or
torch tensors (texels in a frame) and returns the same kind; :func:`to_rgb`
collapses host arrays (saved images, light powers).
"""

from __future__ import annotations

import numpy as np
import torch

SPECTRUM_SAMPLES = 3  # reference renderer/Spectrum.h:3

# wavelengths are sampled uniformly in [LAMBDA_MIN, LAMBDA_MAX] nm
LAMBDA_MIN = 400.0
LAMBDA_MAX = 700.0


def _linspace(samples: int) -> np.ndarray:
    """float32 ``jnp.linspace(LAMBDA_MIN, LAMBDA_MAX, samples)`` bit for bit:
    the arithmetic XLA's CPU compiler makes of it (the division by
    ``samples - 1`` folded into a reciprocal multiply, ``stop * step``
    reassociated and contracted into one fused multiply-add), so the band
    edges of :func:`from_rgb` fall on the same bins as the reference's (at
    S = 31 bin 9 is 490.0 exactly).  The fused multiply-add is exact in
    float64: both factors are float32."""
    f = np.float32
    div = samples - 1
    i = np.arange(div, dtype=f)
    c = f(1.0) / f(div)
    head = f(LAMBDA_MIN) * (f(1.0) - i * c)
    out = (i.astype(np.float64) * np.float64(f(LAMBDA_MAX) * c)
           + head.astype(np.float64)).astype(f)
    return np.concatenate([out, [f(LAMBDA_MAX)]]).astype(f)


def bin_wavelengths(samples: int = SPECTRUM_SAMPLES) -> np.ndarray:
    """(S,) float32 nm wavelength of each spectrum bin (uniform in [400,
    700]; for the RGB stand-in S == 3 these are the band centres)."""
    if samples == 3:
        return np.asarray([640.0, 535.0, 445.0], np.float32)  # R G B centres
    return _linspace(samples)


def _bands(samples: int):
    """(blue, green, red) bool masks of the S bins."""
    lam = _linspace(samples)
    return lam < 490.0, (lam >= 490.0) & (lam < 580.0), lam >= 580.0


def apply_bins(vals, bins):
    """(S, N) per-lane spectra -> (C, N) hero-wavelength view: each lane
    reads only its ``bins`` (C, N) wavelength bins; identity when bins is
    None.  The reference selects with a chain of S ``where``s; one gather is
    the same selection."""
    if bins is None:
        return vals
    return torch.gather(vals, 0, bins)


def from_rgb(rgb, samples: int = SPECTRUM_SAMPLES):
    """Lift (..., 3) RGB to an S-sample spectrum (..., S): the identity at
    S = 3; otherwise each bin takes the channel whose band it falls in,
    which :func:`to_rgb` inverts exactly for constant spectra."""
    if samples == 3:
        return rgb if isinstance(rgb, torch.Tensor) else np.asarray(rgb, np.float32)
    blue, green, _ = _bands(samples)
    if isinstance(rgb, torch.Tensor):
        blue = torch.from_numpy(blue).to(rgb.device)
        green = torch.from_numpy(green).to(rgb.device)
        r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
        return torch.where(blue, b, torch.where(green, g, r))
    rgb = np.asarray(rgb, np.float32)
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    return np.where(blue, b, np.where(green, g, r)).astype(np.float32)


def to_rgb(spec) -> np.ndarray:
    """Collapse (..., S) numpy spectra to (..., 3) RGB by band averages:
    the identity at S = 3."""
    spec = np.asarray(spec, np.float32)
    samples = spec.shape[-1]
    if samples == 3:
        return spec
    weights = np.stack([m.astype(np.float32) for m in _bands(samples)[::-1]])
    weights = weights / weights.sum(axis=1, keepdims=True)  # (3, S) R G B
    return (spec @ weights.T).astype(np.float32)


def cauchy_ior_bins(ior_d: float, b_um2: float,
                    samples: int = SPECTRUM_SAMPLES) -> np.ndarray:
    """(S,) float32 per-bin index of refraction from the two-term Cauchy
    model n(lambda) = A + B / lambda_um^2, with A chosen so n(589.3 nm) ==
    ior_d (the sodium d-line the scalar material IoR is quoted at).
    ``b_um2`` is the Cauchy B coefficient in um^2 (~0.00420 for BK7)."""
    lam_um = bin_wavelengths(samples) / np.float32(1000.0)
    a = np.float32(ior_d - b_um2 / (0.5893 ** 2))
    return (a + np.float32(b_um2) / (lam_um * lam_um)).astype(np.float32)
