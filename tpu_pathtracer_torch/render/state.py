"""Progressive render state and frame stepping.

The port of ``tpu_pathtracer/render/state.py`` for 1 spp per frame: the
reference's progressive RGBA32F texture plus host ``_frameIndex`` counter
(reference: renderer/Renderer.mm:640-657, renderer/Shaders.metal:233-249)
as an explicit (accum, frame_index, key) record.  The key schedule is the
reference's threefry one, computed host-side (ops/rng.py), so a frame of
the port draws the same samples as the same frame of ``tpu_pathtracer``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import RenderConfig, check_supported
from ..models.camera import Camera
from ..ops.rng import fold_in, prng_key
from ..scene.scene import Scene
from .wavefront import IntersectFn, render_sample


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


def frame_rng_key(key, frame_index: int) -> np.ndarray:
    """The per-frame key (PRNG noise always re-rolls per frame)."""
    return fold_in(key, frame_index)


def fused_wavefront_key(frame_key) -> np.ndarray:
    """The key of the frame's (single) wavefront: fold_in(.., 0), which the
    reference keeps so 1-spp frames draw the same streams at any fusion."""
    return fold_in(frame_key, 0)


def sample_sum(scene: Scene, cfg: RenderConfig, camera: Camera, height: int,
               width: int, key, frame_index: int, intersect: IntersectFn,
               **kw) -> torch.Tensor:
    """Radiance sum over the frame's samples -> (H, W, S); one sample per
    frame (samples_per_frame > 1 is not ported yet)."""
    wkey = fused_wavefront_key(frame_rng_key(key, frame_index))
    return render_sample(scene, cfg, camera, height, width, wkey, frame_index,
                         intersect, **kw)


def render_frame(state: RenderState, scene: Scene, cfg: RenderConfig,
                 camera: Camera | None, intersect: IntersectFn,
                 timer=None) -> RenderState:
    """One progressive frame: trace and fold the mean into the accumulator.
    The accumulator is a new tensor; ``state`` is left unchanged."""
    check_supported(cfg)
    camera = camera if camera is not None else Camera.reference_default()
    total = sample_sum(scene, cfg, camera, state.height, state.width, state.key,
                       state.frame_index, intersect, timer=timer)
    color = total / cfg.samples_per_frame
    new_accum = accumulate(state.accum, state.frame_index, color,
                           cfg.accumulate_image)
    return RenderState(accum=new_accum, frame_index=state.frame_index + 1,
                       key=state.key)
