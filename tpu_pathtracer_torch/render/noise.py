"""Random-number supply for the integrator.

The port of ``tpu_pathtracer/render/noise.py``, both modes
(:class:`tpu_pathtracer_torch.config.NoiseMode`):

* **PRNG**: every uniform is a pure function of (absolute pixel id, frame,
  bounce, purpose, seed) through the counter hash of ops/rng.py (or its r2
  lattice sampler, cfg.sampler="r2"), so the image does not depend on pixel
  enumeration order, row tiles or sample fusion.
* **TILED**: the reference's parity mode, a 64x64 float4 tile per (frame,
  bounce) drawn with the host threefry ``ops/rng.py:uniform`` (bit-equal to
  ``jax.random.uniform``), indexed with the reference's offset formula
  (renderer/Shaders.metal:135-138) and read with its component swizzles.
"""

from __future__ import annotations

import torch

from ..config import NoiseMode, RenderConfig
from ..ops import rng as rng_ops
from .order import PixelOrder

_CAMERA_SALT = 0x5CA1AB1E
_HERO_SALT = 0x4E20
_ENV_SALT = 0xE57


def hero_bins(cfg: RenderConfig, key, frame: int, pids: torch.Tensor) -> torch.Tensor:
    """(C, N) int64 stratified-rotated wavelength bins of hero sampling: one
    uniform a path rotates a C-point equidistant set over the S bins, in
    the reference's float32 arithmetic (``%`` is a floored remainder)."""
    s = cfg.spectrum_samples
    c = cfg.hero_wavelengths
    hu = rng_ops.uniforms(pids, frame, 0, key_salt(key) ^ _HERO_SALT, 1)[0]    # (N,)
    offs = (torch.arange(c, dtype=torch.float32, device=pids.device) / c)[:, None]
    return torch.remainder(
        (torch.remainder(hu[None, :] + offs, 1.0) * s).to(torch.int64), s)


def key_salt(key) -> int:
    """Collapse raw key data (uint32[2]) into a uint32 salt."""
    data = rng_ops.key_data(key).reshape(-1)
    return (int(data[0]) ^ (int(data[-1]) * 0x9E3779B9)) & 0xFFFFFFFF


def pids_from_order(order: PixelOrder, full_width: int) -> torch.Tensor:
    """(N,) absolute pixel ids (int64 holding uint32) for a PixelOrder."""
    return (order.rows.to(torch.int64) * full_width + order.cols) & 0xFFFFFFFF


def _tile(cfg: RenderConfig, key, bounce: int, device) -> torch.Tensor:
    """(ND*ND, 4) float32 noise tile of one bounce (-1: the camera's)."""
    nd = cfg.noise_dimensions
    k = rng_ops.fold_in(rng_ops.fold_in(key, 0x7113D), bounce & 0xFFFF)
    return torch.from_numpy(rng_ops.uniform(k, (nd * nd, 4))).to(device)


def _tile_lookup(cfg: RenderConfig, tile, frame: int, bounce: int, rows, cols,
                 full_height: int) -> torch.Tensor:
    """noiseIndex = ((x + bounce + frame/3) % ND) + ((y + bounce + frame/5) %
    ND) * ND (reference: renderer/Shaders.metal:135-138); y counts rows
    bottom-up -> (N, 4)."""
    nd = cfg.noise_dimensions
    y = (full_height - 1) - rows
    ix = (cols + bounce + frame // 3) % nd
    iy = (y + bounce + frame // 5) % nd
    return tile[ix + iy * nd]


def _rows_cols(pids: torch.Tensor, full_width: int):
    return pids // full_width, pids % full_width


def camera_jitter(cfg: RenderConfig, key, frame: int, pids: torch.Tensor,
                  full_height: int, full_width: int) -> torch.Tensor:
    """(4, N) uniforms: AA jitter rows 0-1 (reference:
    renderer/Shaders.metal:91) + thin-lens disk rows 2-3."""
    if cfg.noise_mode == NoiseMode.TILED:
        nd = cfg.noise_dimensions
        tile = _tile(cfg, key, -1, pids.device)
        rows, cols = _rows_cols(pids, full_width)
        x = cols % nd
        y = ((full_height - 1) - rows) % nd
        return tile[x + y * nd].T  # xy = AA, zw = lens
    draw = rng_ops.uniforms_r2 if cfg.sampler == "r2" else rng_ops.uniforms
    return draw(pids, frame, 0, key_salt(key) ^ _CAMERA_SALT, 4)


def bounce_uniforms(cfg: RenderConfig, key, frame: int, bounce: int,
                    pids: torch.Tensor, full_height: int, full_width: int,
                    with_env: bool = False, out: torch.Tensor | None = None) -> dict:
    """Per-bounce uniforms for one wavefront of N rays: ``light_select``
    (N,), ``light_bary`` (2, N), ``lobe`` (N,), ``bounce_dir`` (2, N); with
    ``with_env`` (the scene carries an environment light) also
    ``env_select`` (N,), ``env_alias`` (N,) and ``env_jit`` (2, N), which
    TILED mode also draws from the counter hash.  ``out``: PRNG noise only,
    a contiguous (:func:`uniform_count`, N) float32 tensor the draw writes,
    whose rows the dict's are."""
    if cfg.noise_mode == NoiseMode.TILED:
        if out is not None:
            raise ValueError("bounce_uniforms: out takes PRNG noise")
        rows, cols = _rows_cols(pids, full_width)
        smp = _tile_lookup(cfg, _tile(cfg, key, bounce, pids.device), frame, bounce,
                           rows, cols, full_height)
        sx, sy, sz, sw = smp.T.contiguous()
        out = {
            "light_select": sz,                        # noiseSample.z
            "light_bary": torch.stack([sw, sx]),       # noiseSample.wx
            "lobe": sy,                                # noiseSample.y
            "bounce_dir": torch.stack([sz, sw]),       # noiseSample.zw
        }
        if with_env:
            ue = rng_ops.uniforms(pids, frame, bounce, key_salt(key) ^ _ENV_SALT, 4)
            out.update(env_select=ue[0], env_alias=ue[1], env_jit=ue[2:4])
        return out
    n = uniform_count(with_env)
    if cfg.sampler == "r2":
        # the semantic 2D pairs (barycentric warp, hemisphere warp, env
        # jitter) sit on whole lattice blocks
        u = rng_ops.uniforms_r2(pids, frame, bounce, key_salt(key), n, out=out)
        out = {"light_bary": u[0:2], "bounce_dir": u[2:4], "light_select": u[4],
               "lobe": u[5]}
        if with_env:
            out.update(env_jit=u[6:8], env_select=u[8], env_alias=u[9])
        return out
    u = rng_ops.uniforms(pids, frame, bounce, key_salt(key), n, out=out)
    out = {
        "light_select": u[0],
        "light_bary": u[1:3],
        "lobe": u[3],
        "bounce_dir": u[4:6],
    }
    if with_env:
        out.update(env_select=u[6], env_alias=u[7], env_jit=u[8:10])
    return out


def uniform_count(with_env: bool) -> int:
    """The rows a PRNG bounce draws: 6, 10 with an environment light."""
    return 10 if with_env else 6
