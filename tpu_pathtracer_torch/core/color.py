"""Color transfer functions and tonemapping, on numpy images.

The port of ``tpu_pathtracer/core/color.py`` (reference:
renderer/Raytracing.h:125-135 sRGB, renderer/Shaders.metal:43-51
display-path tonemap); its callers hold images as numpy arrays.
"""

from __future__ import annotations

import numpy as np


def to_linear(value: np.ndarray) -> np.ndarray:
    """sRGB -> linear (reference: renderer/Raytracing.h:125-128)."""
    return np.where(value < 0.04045, value / 12.92,
                    np.power(np.maximum((value + 0.055) / 1.055, 0.0), 2.4))


def to_srgb(value: np.ndarray) -> np.ndarray:
    """Linear -> sRGB with [0,1] clamp (reference: renderer/Raytracing.h:130-135)."""
    v = np.clip(value, 0.0, 1.0)
    return np.where(v < 0.0031308, 12.92 * v, 1.055 * np.power(v, 1.0 / 2.4) - 0.055)


def tonemap_exposure(color: np.ndarray) -> np.ndarray:
    """1 - exp(-c) exposure tonemap (reference: renderer/Shaders.metal:43-45)."""
    return 1.0 - np.exp(-color)
