"""Carry the reference's arrays into the port's objects.

Takes plain numpy dicts — ``tpu_pathtracer``'s ``Scene._asdict()`` and
``BVHLayout._asdict()`` with every array passed through ``np.asarray`` — so
the tests can feed the reference's exact tables to the port's kernels and
frame, which separates kernel faults from layout faults.  Imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel.layout import BVHLayout, layout_to
from .models.envlight import env_to
from .render.state import RenderState
from .scene.scene import Scene, scene_to

def scene_from_arrays(d: dict, device="cpu") -> Scene:
    """The reference's ``Scene._asdict()`` -> the port's :class:`Scene`,
    its extensions included: ``tri_uv``, ``mat_tex`` and ``textures``
    (map_Kd), ``mat_ior_bins`` (dispersion) and ``mat_roughness`` (GGX)
    carry across as they are, None where the reference has None, and
    ``env`` (the reference's ``EnvLight``, or a dict of its arrays) with its
    alias tables."""
    scene = scene_to(d, device)
    env = d.get("env")
    if env is not None:
        env = env_to(env if isinstance(env, dict) else env._asdict(), device)
        scene = scene._replace(env=env)
    return scene


def layout_from_arrays(d: dict, device="cpu") -> BVHLayout:
    """The reference's ``BVHLayout._asdict()`` -> the port's
    :class:`BVHLayout` (the tables the port reads, the candidate-sweep
    kernels' ``leafbox`` / ``leafmeta`` / ``num_leaves`` included)."""
    return layout_to(d, device)


def state_from_arrays(accum, frame_index, key_data, device="cpu") -> RenderState:
    """The reference's ``RenderState`` parts -> the port's: ``accum``
    (H, W, S), ``frame_index`` and ``jax.random.key_data(key)``.  A sharded
    reference state comes across the same way (``np.asarray`` of its
    accumulator is the whole image); ``parallel.tiles.shard_state`` then
    splits it over a port mesh."""
    return RenderState(
        accum=torch.tensor(np.asarray(accum, np.float32), device=device),
        frame_index=int(frame_index),
        key=np.asarray(key_data, np.uint32).reshape(2),
    )
