"""Spectrum representation for the RGB stand-in (S = 3).

The reference carries radiance as a 3-sample ``Spectrum`` (reference:
renderer/Spectrum.h:3-21); a spectrum is the leading ``(S, N)`` axis of a
tensor.  For S = 3 the RGB lift is the identity, and ``apply_bins`` (hero
wavelengths) never runs; true spectra (S > 3) are not ported yet
(ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import numpy as np

SPECTRUM_SAMPLES = 3  # reference renderer/Spectrum.h:3


def from_rgb(rgb: np.ndarray, samples: int = SPECTRUM_SAMPLES) -> np.ndarray:
    """Lift (..., 3) RGB to an S-sample spectrum: the identity at S = 3."""
    if samples != SPECTRUM_SAMPLES:
        raise NotImplementedError(
            f"spectrum_samples={samples} (dispersion / true spectra) is not "
            "ported to tpu_pathtracer_torch yet (ROADMAP.md queue 1 item 10)")
    return np.asarray(rgb, np.float32)
