"""The inputs a cell hands both sides: its scene's OBJ and its sky map.

``sky_map`` is a frozen copy of ``chip_smoke.py:sky_map`` as of commit
58fc869, so that a later change to the program cannot move the yardstick.
numpy only.
"""

from __future__ import annotations

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def obj_path(name: str) -> str:
    """A bundled scene's OBJ (the raw file both sides parse)."""
    return os.path.join(ROOT, "assets", "scenes", f"{name}.obj")


def sky_map(height: int, width: int, seed: int) -> np.ndarray:
    """A synthetic lat-long HDR map from a seed: a sky gradient over a dim
    ground, a small bright sun, and 5% texel noise -> (height, width, 3)
    float32."""
    rng = np.random.default_rng(seed)
    theta = np.pi * (np.arange(height) + 0.5) / height          # 0 = zenith
    phi = 2.0 * np.pi * (np.arange(width) + 0.5) / width - np.pi
    up = np.clip(np.cos(theta), 0.0, 1.0)[:, None, None]
    sky = np.asarray([0.35, 0.55, 0.95]) * (0.4 + 0.6 * up) + 0.1
    img = np.where(np.cos(theta)[:, None, None] > 0, sky, 0.12) * np.ones((1, width, 1))
    ts, ps = rng.uniform(0.3, 1.1), rng.uniform(-np.pi, np.pi)
    cos_g = (np.sin(theta)[:, None] * np.sin(ts) * np.cos(phi[None] - ps)
             + np.cos(theta)[:, None] * np.cos(ts))
    img[cos_g > np.cos(0.03)] = (800.0, 760.0, 700.0)
    img *= rng.uniform(0.95, 1.05, img.shape)
    return img.astype(np.float32)
