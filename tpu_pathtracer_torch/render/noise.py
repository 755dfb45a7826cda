"""Random-number supply for the integrator (PRNG mode).

Every uniform is a pure function of (absolute pixel id, frame, bounce,
purpose, seed) through the counter hash of ops/rng.py, so the image does not
depend on pixel enumeration order.  The port of the PRNG branch of
``tpu_pathtracer/render/noise.py``; the TILED parity noise and the r2
sampler are not ported yet (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

import torch

from ..ops import rng as rng_ops
from .order import PixelOrder

_CAMERA_SALT = 0x5CA1AB1E


def key_salt(key) -> int:
    """Collapse raw key data (uint32[2]) into a uint32 salt."""
    data = rng_ops.key_data(key).reshape(-1)
    return (int(data[0]) ^ (int(data[-1]) * 0x9E3779B9)) & 0xFFFFFFFF


def pids_from_order(order: PixelOrder, full_width: int) -> torch.Tensor:
    """(N,) absolute pixel ids (int64 holding uint32) for a PixelOrder."""
    return (order.rows.to(torch.int64) * full_width + order.cols) & 0xFFFFFFFF


def camera_jitter(key, frame: int, pids: torch.Tensor) -> torch.Tensor:
    """(4, N) uniforms: AA jitter rows 0-1 (reference:
    renderer/Shaders.metal:91) + thin-lens disk rows 2-3."""
    return rng_ops.uniforms(pids, frame, 0, key_salt(key) ^ _CAMERA_SALT, 4)


def bounce_uniforms(key, frame: int, bounce: int, pids: torch.Tensor,
                    with_env: bool = False) -> dict:
    """Per-bounce uniforms for one wavefront of N rays: ``light_select``
    (N,), ``light_bary`` (2, N), ``lobe`` (N,), ``bounce_dir`` (2, N); with
    ``with_env`` (the scene carries an environment light) also
    ``env_select`` (N,), ``env_alias`` (N,) and ``env_jit`` (2, N)."""
    u = rng_ops.uniforms(pids, frame, bounce, key_salt(key), 10 if with_env else 6)
    out = {
        "light_select": u[0],
        "light_bary": u[1:3],
        "lobe": u[3],
        "bounce_dir": u[4:6],
    }
    if with_env:
        out.update(env_select=u[6], env_alias=u[7], env_jit=u[8:10])
    return out
