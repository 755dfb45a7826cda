"""Entry points of the port: the frame step and the multi-device dry run.

The counterparts of the root ``__graft_entry__.py``.  Nothing is compiled:
``entry`` hands back the frame step and its arguments, and
``dryrun_multichip`` renders one distributed step.
"""

from __future__ import annotations

import numpy as np
import torch

from .accel import build_layout
from .config import RenderConfig
from .parallel.multihost import gather_image
from .parallel.tiles import make_mesh, render_frame_distributed_jit, shard_state
from .render.state import init_state, render_frame
from .render.wavefront import make_intersector
from .renderer import build_intersector
from .scene import load_scene, scene_path


def entry(device="cuda"):
    """(fn, example_args): the progressive frame step on cornellbox at
    64x64, depth 8, 1 spp; ``fn(state, scene)`` renders one frame."""
    scene = load_scene(scene_path("cornellbox"), device=device)
    cfg = RenderConfig(samples_per_frame=1, max_path_length=8)
    _, _, intersect = build_intersector(scene, cfg)

    def fn(state, scene):
        return render_frame(state, scene, cfg, None, intersect)

    return fn, (init_state(64, 64, device=device), scene)


def dryrun_multichip(n_devices: int) -> None:
    """The distributed frame step over an ``n_devices`` mesh (pixel tiles x
    sample shards, the shard sums added over 'spp'), one step on tiny
    shapes.  The dry run is defined on a virtual CPU mesh, ``n_devices``
    entries of the CPU, and never touches a card; the BVH intersector (the
    portable walker, as the reference's dry run) runs inside each shard."""
    devices = [torch.device("cpu")] * n_devices
    n_spp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_tiles = n_devices // n_spp
    mesh = make_mesh(n_tiles, n_spp, devices=devices)
    scene = load_scene(scene_path("cornellbox"), device="cpu")
    cfg = RenderConfig(samples_per_frame=2 * n_spp, max_path_length=4, use_pallas=False)
    layout = build_layout(scene, leaf_size=cfg.leaf_size)

    def factory(scene_rep):
        return make_intersector(scene_rep, cfg, layout, None)

    state = shard_state(init_state(n_tiles * 8, 16, device="cpu"), mesh)
    step = render_frame_distributed_jit(mesh, cfg, intersect_factory=factory)
    state = step(state, scene)
    out = gather_image(state)
    assert out.shape == (n_tiles * 8, 16, 3)
    assert np.isfinite(out).all()
    assert state.frame_index == 1
