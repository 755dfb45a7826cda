"""Progressive render state and frame stepping.

The port of ``tpu_pathtracer/render/state.py``: the reference's
progressive RGBA32F texture plus host ``_frameIndex`` counter (reference:
renderer/Renderer.mm:640-657, renderer/Shaders.metal:233-249) as an
explicit (accum, frame_index, key) record.  The key schedule is the
reference's threefry one, computed host-side (ops/rng.py), so a frame of
the port draws the same samples as the same frame of ``tpu_pathtracer``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import NoiseMode, RenderConfig, check_supported
from ..models.camera import Camera
from ..ops.rng import fold_in, key_data, prng_key
from ..scene.scene import Scene
from .timing import frame_trace, span
from .wavefront import IntersectFn, WavefrontPlans, render_sample


class RenderState(NamedTuple):
    accum: torch.Tensor     # (H, W, S) running-mean radiance
    frame_index: int
    key: np.ndarray         # base key data, uint32[2] (folded per frame)

    @property
    def height(self) -> int:
        return self.accum.shape[0]

    @property
    def width(self) -> int:
        return self.accum.shape[1]


def init_state(height: int, width: int, seed: int = 0, samples: int = 3,
               device="cuda") -> RenderState:
    """Fresh progressive state (the reference's drawableSizeWillChange reset,
    renderer/Renderer.mm:640-657)."""
    return RenderState(
        accum=torch.zeros((height, width, samples), device=device),
        frame_index=0,
        key=prng_key(seed),
    )


def accumulate(accum, frame_index: int, color, accumulate_image: bool):
    """Running mean: mix(color, stored, frame/(frame+1)) in float32
    (reference: renderer/Shaders.metal:233-249)."""
    if not accumulate_image:
        return color
    f = np.float32(frame_index)
    factor = float(f / (f + np.float32(1.0))) if frame_index > 0 else 0.0
    return color + (accum - color) * factor


def frame_rng_key(cfg: RenderConfig, key, frame_index: int) -> np.ndarray:
    """The per-frame key: fold_in(key, frame), except with static TILED
    noise (the reference's ANIMATE_NOISE=0, renderer/Renderer.mm:485-497),
    where the tiles never re-roll and only their frame-offset lookup moves.
    One schedule for sample_sum and render/stats.count_traced_rays_exact."""
    if cfg.noise_mode == NoiseMode.TILED and not cfg.animate_noise:
        return key_data(key)
    return fold_in(key, frame_index)


def fuse_schedule(cfg: RenderConfig, sample_count: int):
    """(fuse, n_chunks, rem): chunk i traces ``fuse`` samples from sample0
    = i * fuse, then one ``rem``-sample tail.  Shared by sample_sum and
    render/stats.count_traced_rays_exact so that the exact counts follow
    the frames' RNG streams."""
    fuse = max(1, min(cfg.fuse_samples or 1, sample_count))
    n_chunks, rem = divmod(sample_count, fuse)
    return fuse, n_chunks, rem


def fused_chunks(cfg: RenderConfig, sample_count: int, sample0: int = 0):
    """fuse_schedule as the wavefronts it makes: [(samples, sample0), ...],
    the ``rem`` tail last.  The one chunk list of sample_sum and
    render/stats.count_traced_rays_exact."""
    fuse, n_chunks, rem = fuse_schedule(cfg, sample_count)
    chunks = [(fuse, sample0 + i * fuse) for i in range(n_chunks)]
    if rem:
        chunks.append((rem, sample0 + n_chunks * fuse))
    return chunks


def fused_wavefront_key(frame_key) -> np.ndarray:
    """The key of every fused wavefront: fold_in(.., 0), which the
    reference keeps so 1-spp frames draw the same streams at any fusion."""
    return fold_in(frame_key, 0)


def sample_sum(scene: Scene, cfg: RenderConfig, camera: Camera, height: int,
               width: int, key, frame_index: int, intersect: IntersectFn,
               row0: int = 0, full_height: int | None = None,
               full_width: int | None = None, sample0: int = 0,
               sample_count: int | None = None, timer=None,
               plans: WavefrontPlans | None = None) -> torch.Tensor:
    """Unnormalised radiance sum over the frame's samples for rows
    ``row0 .. row0 + height`` of a ``full_height`` x ``full_width`` image ->
    (height, width, S).

    PRNG noise fuses up to cfg.fuse_samples samples into one wavefront per
    render_sample call; each sample's lanes key on a virtual pixel id
    ``pixel + sample * npix`` (render/wavefront.py), so every grouping draws
    the same paths.  TILED noise decodes the pixel from the id, so it
    traces one sample a wavefront under a per-sample key fold, as the
    reference does.  ``timer``, ``plans``: as render_sample's (the keys span
    here)."""
    trace = frame_trace(timer)
    sample_count = cfg.samples_per_frame if sample_count is None else sample_count
    prng = cfg.noise_mode == NoiseMode.PRNG
    if prng:
        npix = (full_height or height) * (full_width or width)
        if cfg.samples_per_frame * npix > 2 ** 32:
            raise ValueError("samples_per_frame * pixels must fit in uint32 for the "
                             "virtual-pixel-id RNG schedule")
    with span(trace, "keys"):
        frame_key = frame_rng_key(cfg, key, frame_index)
        if prng:
            wkey = fused_wavefront_key(frame_key)
            waves = [(wkey, dict(samples=n, sample0=s0))
                     for n, s0 in fused_chunks(cfg, sample_count, sample0)]
        else:
            waves = [(fold_in(frame_key, sample0 + i), {}) for i in range(sample_count)]
    kw = dict(row0=row0, full_height=full_height, full_width=full_width, timer=trace,
              plans=plans)
    total = torch.zeros((height, width, cfg.spectrum_samples), device=scene.p0.device)
    for k, wave in waves:
        img = render_sample(scene, cfg, camera, height, width, k, frame_index, intersect,
                            **wave, **kw)
        with span(trace, "restore"):
            total = total + img
    return total


def render_frame(state: RenderState, scene: Scene, cfg: RenderConfig,
                 camera: Camera | None, intersect: IntersectFn,
                 timer=None, plans: WavefrontPlans | None = None) -> RenderState:
    """One progressive frame: trace cfg.samples_per_frame spp, in
    cfg.row_tiles sequential row tiles, and fold the mean into the
    accumulator.  The accumulator is a new tensor; ``state`` is left
    unchanged.  ``timer``: a StageTimer or the frame's FrameTrace
    (render/timing.py).  ``plans``: the wavefronts' plans
    (render/wavefront.py:WavefrontPlans, :func:`plan_frame`); without them
    each wavefront builds its own."""
    check_supported(cfg)
    trace = frame_trace(timer)
    camera = camera if camera is not None else Camera.reference_default()
    height, width = state.height, state.width
    tiles = max(1, cfg.row_tiles)
    if tiles > 1 and height % tiles:
        raise ValueError(f"row_tiles {tiles} must divide height {height}")
    if tiles == 1:
        total = sample_sum(scene, cfg, camera, height, width, state.key,
                           state.frame_index, intersect, timer=trace, plans=plans)
    else:
        # sequential row tiles bound a wavefront's lanes; the RNG keys on
        # absolute pixel ids, so the image is the untiled one up to the
        # order of float sums
        tile_h = height // tiles
        total = torch.cat([
            sample_sum(scene, cfg, camera, tile_h, width, state.key,
                       state.frame_index, intersect, row0=r * tile_h,
                       full_height=height, full_width=width, timer=trace, plans=plans)
            for r in range(tiles)])
    with span(trace, "accumulate"):
        color = total / cfg.samples_per_frame
        new_accum = accumulate(state.accum, state.frame_index, color,
                               cfg.accumulate_image)
    return RenderState(accum=new_accum, frame_index=state.frame_index + 1,
                       key=state.key)


def plan_frame(plans: WavefrontPlans, scene: Scene, cfg: RenderConfig, camera: Camera,
               height: int, width: int) -> None:
    """Build in ``plans`` the plan of every wavefront :func:`render_frame`
    traces at this size: one a row tile and fused chunk (one a row tile
    with TILED noise, whose samples share their ids)."""
    tiles = max(1, cfg.row_tiles)
    if height % tiles:
        return  # render_frame refuses the size
    tile_h = height // tiles
    waves = (fused_chunks(cfg, cfg.samples_per_frame) if cfg.noise_mode == NoiseMode.PRNG
             else [(1, 0)])
    for r in range(tiles):
        for samples, sample0 in waves:
            plans.get(scene, cfg, camera, tile_h, width, r * tile_h, height, width,
                      samples, sample0)
