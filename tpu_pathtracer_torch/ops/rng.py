"""Counter-based per-pixel RNG and the host-side frame key schedule.

``pcg4d``/``uniforms``: the PCG4D mixer (Jarzynski & Olano, "Hash Functions
for GPU Rendering", JCGT 2020) of ``tpu_pathtracer/ops/rng.py``, bit-equal
to it.  The reference computes in wrapping uint32; torch has no full uint32
arithmetic, so every value here is an int64 tensor holding a uint32, and
each step masks with ``& 0xFFFFFFFF``.  Products are formed in 16-bit
halves (:func:`_mul32`) so no int64 product ever overflows.

``uniforms_r2``: the padded rank-1 Rd lattice sampler (cfg.sampler="r2"),
bit-equal to the reference's, in the same int64 form.

Those int64 forms are ``uniforms_plain`` and ``uniforms_r2_plain``.  The
wrappers ``uniforms`` and ``uniforms_r2`` take them only for CPU tensors;
for CUDA tensors they launch the kernels of ``csrc/rng.cu`` (native uint32,
one thread a lane, bit-equal; the host forms each group's keys with
:func:`uniform_keys` / :func:`uniform_r2_keys`) or raise, and count the
launches in ``.launches``.

``prng_key``/``fold_in``/``key_data``/``uniform``: a host-side threefry2x32,
bit-equal to ``jax.random.PRNGKey``/``fold_in``/``key_data``/``uniform``
under JAX's default threefry implementation (the partitionable counter
layout: element i of the flattened shape hashes the counter pair (0, i)).
The frame's key schedule (render/state.py, render/noise.py) runs a few
scalar calls of it per frame; TILED noise draws its 64x64 float4 tiles with
``uniform``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import launch_count
from .cuda_build import load_library

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


def uniforms_plain(pixel_id: torch.Tensor, frame: int, bounce: int, salt: int,
                   count: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of ``csrc/rng.cu:tpupt_uniforms``: (N,) int64
    pixel ids -> (count, N) independent uniforms in [0, 1), written into
    ``out`` where given (as the kernel's wrapper takes it).

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
    return torch.stack(outs[:count], out=out)


def _rd_alphas_u32(count: int) -> list[int]:
    """Rd rank-1 lattice generators as uint32 fixed point: alpha_i =
    phi_d^-(i+1), phi_d the positive root of x^(d+1) = x + 1 (Roberts 2018),
    scaled to 2^32 and made odd (full period mod 2^32)."""
    d = count
    x = 2.0
    for _ in range(64):
        x = x - (x ** (d + 1) - x - 1.0) / ((d + 1) * x ** d - 1.0)
    return [int((1.0 / x) ** i % 1.0 * 4294967296.0) | 1 for i in range(1, d + 1)]


def uniforms_r2_plain(pixel_id: torch.Tensor, frame: int, bounce: int, salt: int,
                      count: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of ``csrc/rng.cu:tpupt_uniforms_r2``: (N,) int64
    pixel ids -> (count, N) low-discrepancy uniforms (into ``out`` where
    given) over
    frames: Cranley-Patterson-rotated R2 lattices in blocks of two
    dimensions, each block with its own per-(pixel, bounce, block) rotation
    and XOR index scramble, ``u_i = (rot_i + (frame ^ c_b) * alpha_i) mod
    2^32 / 2^32`` (the reference's ``ops/rng.py:uniforms_r2``)."""
    pid = pixel_id.to(torch.int64) & _M32
    full = lambda v: torch.full_like(pid, v & _M32)  # noqa: E731
    n_blocks = (count + 1) // 2
    alphas2 = _rd_alphas_u32(2)
    mixed = full(bounce ^ ((salt << 1) & _M32))
    outs = []
    for pair in range((n_blocks + 1) // 2):
        rot = pcg4d(pid, full(0x52D00000 + 0x9E3779B9 * pair), mixed,
                    full(salt + pair * 0x85EBCA6B))
        scr = pcg4d(pid, full(0x5C4AB1E5 + 0x9E3779B9 * pair), mixed,
                    full(salt + pair * 0xC2B2AE35))
        for half in range(2):
            b = pair * 2 + half
            if b >= n_blocks:
                break
            idx = (frame & _M32) ^ scr[half]
            for lane in range(2):
                if b * 2 + lane >= count:
                    break
                bits = (rot[half * 2 + lane] + _mul32(idx, alphas2[lane])) & _M32
                outs.append(_to_unit_float(bits))
    return torch.stack(outs[:count], out=out)


# ---------------------------------------------------------------------------
# the kernels (csrc/rng.cu) and their wrappers
# ---------------------------------------------------------------------------

MAX_COUNT = 16  # the most rows one call draws (csrc/rng.cu:kMaxCount)
_GROUPS = MAX_COUNT // 4


def uniform_keys(frame: int, bounce: int, salt: int, count: int) -> list[int]:
    """The scalar keys of :func:`uniforms_plain`'s PCG4D groups, as it forms
    them with Python ints masked to 32 bits -> [b, c, d] of each group, zero
    padded to MAX_COUNT rows (``csrc/rng.cu:tpupt_uniforms``'s key block)."""
    mixed = (bounce ^ ((salt << 1) & _M32)) & _M32
    keys = []
    for group in range((count + 3) // 4):
        keys += [(frame + 0x9E3779B9 * group) & _M32, mixed,
                 (salt + group * 0x85EBCA6B) & _M32]
    return keys + [0] * (3 * _GROUPS - len(keys))


def uniform_r2_keys(frame: int, bounce: int, salt: int, count: int) -> list[int]:
    """The scalar keys of :func:`uniforms_r2_plain`'s PCG4D pairs -> [rot_b,
    rot_d, scr_b, scr_d] of each pair (zero padded to MAX_COUNT rows), then
    the shared c key, the frame and the two lattice generators
    (``csrc/rng.cu:tpupt_uniforms_r2``'s key block)."""
    keys = []
    for pair in range((count + 3) // 4):
        keys += [(0x52D00000 + 0x9E3779B9 * pair) & _M32, (salt + pair * 0x85EBCA6B) & _M32,
                 (0x5C4AB1E5 + 0x9E3779B9 * pair) & _M32, (salt + pair * 0xC2B2AE35) & _M32]
    keys += [0] * (4 * _GROUPS - len(keys))
    return keys + [(bounce ^ ((salt << 1) & _M32)) & _M32, frame & _M32,
                   *_rd_alphas_u32(2)]


def _launch_uniforms(symbol: str, pixel_id: torch.Tensor, keys: list[int],
                     count: int, out: torch.Tensor | None) -> torch.Tensor:
    """Launch ``tpupt_<symbol>`` -> (count, N) float32, ``out`` where given."""
    n = pixel_id.shape[0]
    if out is None:
        out = torch.empty((count, n), dtype=torch.float32, device=pixel_id.device)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (count, n)
          or not out.is_contiguous() or out.device != pixel_id.device):
        raise ValueError(f"out: expected a contiguous float32 {(count, n)} tensor on "
                         f"{pixel_id.device}, got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device} contiguous={out.is_contiguous()}")
    block = (ctypes.c_uint32 * len(keys))(*keys)
    rc = getattr(load_library(), f"tpupt_{symbol}")(
        pixel_id.data_ptr(), ctypes.addressof(block), count, n, out.data_ptr(),
        torch.cuda.current_stream(pixel_id.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError {rc}")
    return out


def _check_draw(pixel_id: torch.Tensor, count: int) -> None:
    if not 1 <= count <= MAX_COUNT:
        raise ValueError(f"count={count}: expected 1 .. {MAX_COUNT}")
    if pixel_id.dtype != torch.int64 or pixel_id.dim() != 1 or not pixel_id.is_contiguous():
        raise ValueError(f"pixel_id: expected a contiguous (N,) int64 tensor, got "
                         f"{pixel_id.dtype} {tuple(pixel_id.shape)} "
                         f"contiguous={pixel_id.is_contiguous()}")


def uniforms(pixel_id: torch.Tensor, frame: int, bounce: int, salt: int,
             count: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) int64 pixel ids -> (count, N) independent uniforms in [0, 1)
    (:func:`uniforms_plain`): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``count``: 1 .. MAX_COUNT; ``out``: a
    contiguous (count, N) float32 tensor to write them into."""
    _check_draw(pixel_id, count)
    if pixel_id.device.type == "cpu":
        return uniforms_plain(pixel_id, frame, bounce, salt, count, out)
    out = _launch_uniforms("uniforms", pixel_id, uniform_keys(frame, bounce, salt, count),
                           count, out)
    launch_count.count(uniforms)
    return out


uniforms.launches = 0


def uniforms_r2(pixel_id: torch.Tensor, frame: int, bounce: int, salt: int,
                count: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) int64 pixel ids -> (count, N) low-discrepancy uniforms
    (:func:`uniforms_r2_plain`): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  ``count``: 1 .. MAX_COUNT; ``out``: as
    :func:`uniforms` takes it."""
    _check_draw(pixel_id, count)
    if pixel_id.device.type == "cpu":
        return uniforms_r2_plain(pixel_id, frame, bounce, salt, count, out)
    out = _launch_uniforms("uniforms_r2", pixel_id,
                           uniform_r2_keys(frame, bounce, salt, count), count, out)
    launch_count.count(uniforms_r2)
    return out


uniforms_r2.launches = 0


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


def _threefry2x32_np(key, x0: np.ndarray, x1: np.ndarray):
    """:func:`_threefry2x32` over uint32 numpy arrays of counters."""
    k = np.asarray(key, np.uint32)
    ks = (k[0], k[1], k[0] ^ k[1] ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` on raw key data: the
    partitionable threefry layout, element i of the flattened shape =
    the XOR of threefry2x32(key, (0, i))."""
    n = int(np.prod(shape))
    if n >= 2 ** 32:
        raise ValueError(f"random_bits of {n} elements: the counter's high word is "
                         "not modelled")
    x0, x1 = _threefry2x32_np(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return (x0 ^ x1).reshape(shape)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32)`` on raw key data, bit for
    bit: the top 23 bits of :func:`random_bits` as the mantissa of a float
    in [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
