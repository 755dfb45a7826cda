"""Counter-based per-pixel RNG and the host-side frame key schedule.

``pcg4d``/``uniforms``: the PCG4D mixer (Jarzynski & Olano, "Hash Functions
for GPU Rendering", JCGT 2020) of ``tpu_pathtracer/ops/rng.py``, bit-equal
to it.  The reference computes in wrapping uint32; torch has no full uint32
arithmetic, so every value here is an int64 tensor holding a uint32, and
each step masks with ``& 0xFFFFFFFF``.  Products are formed in 16-bit
halves (:func:`_mul32`) so no int64 product ever overflows.

``prng_key``/``fold_in``/``key_data``: a host-side threefry2x32, bit-equal
to ``jax.random.PRNGKey``/``fold_in``/``key_data`` under JAX's default
threefry implementation.  The frame's key schedule (render/state.py,
render/noise.py) runs a few scalar calls of it per frame.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 values held in int64 tensors (``b`` a
    tensor or Python int), without int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def pcg4d(a, b, c, d):
    """PCG4D mix of four uint32 streams (int64 tensors) -> four
    decorrelated uint32 streams."""
    mul, inc = 1664525, 1013904223
    v0 = (_mul32(a, mul) + inc) & _M32
    v1 = (_mul32(b, mul) + inc) & _M32
    v2 = (_mul32(c, mul) + inc) & _M32
    v3 = (_mul32(d, mul) + inc) & _M32
    for shift in (False, True):
        if shift:
            v0 = v0 ^ (v0 >> 16)
            v1 = v1 ^ (v1 >> 16)
            v2 = v2 ^ (v2 >> 16)
            v3 = v3 ^ (v3 >> 16)
        v0 = (v0 + _mul32(v1, v3)) & _M32
        v1 = (v1 + _mul32(v2, v0)) & _M32
        v2 = (v2 + _mul32(v0, v1)) & _M32
        v3 = (v3 + _mul32(v1, v2)) & _M32
    return v0, v1, v2, v3


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) from the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniforms(pixel_id: torch.Tensor, frame: int, bounce: int, salt: int,
             count: int) -> torch.Tensor:
    """(N,) int64 pixel ids -> (count, N) independent uniforms in [0, 1).

    ``salt`` folds the user seed in; ``frame``/``bounce`` are scalar
    counters.  Each group of 4 rows is one PCG4D evaluation re-keyed by the
    group index."""
    pid = pixel_id.to(torch.int64) & _M32
    full = lambda v: torch.full_like(pid, v & _M32)  # noqa: E731
    outs = []
    for group in range((count + 3) // 4):
        v = pcg4d(
            pid,
            full(frame + 0x9E3779B9 * group),
            full(bounce ^ ((salt << 1) & _M32)),
            full(salt + group * 0x85EBCA6B),
        )
        outs.extend(_to_unit_float(x) for x in v)
    return torch.stack(outs[:count])


# ---------------------------------------------------------------------------
# threefry2x32 key schedule (host side)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0: int, x1: int) -> tuple[int, int]:
    """20-round threefry2x32 of one counter pair under ``key`` (two
    uint32s), as ``jax.random``'s threefry2x32 primitive computes it."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.PRNGKey(seed))``: uint32[2].  JAX
    without 64-bit mode keeps the seed's low 32 bits and a zero high word."""
    return np.asarray([0, int(seed) & _M32], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in`` on raw key data: uint32[2]."""
    return np.asarray(_threefry2x32(key, 0, int(data) & _M32), np.uint32)


def key_data(key) -> np.ndarray:
    """The raw uint32[2] of a key (keys here are already raw data)."""
    return np.asarray(key, np.uint32)
