"""tpu_pathtracer_torch's multi-device split on a virtual CPU mesh (eight
entries of the CPU) against the port's single-device frame and against the
reference's distributed frame on its eight virtual CPU devices.

cornellbox, 32x64, depth 3, 4 spp, 2 frames.  Tolerances, each with its
reason:
  * tile-only meshes: bit-equal (the RNG keys on absolute pixel and sample
    ids, and a pixel's sums run in the same order);
  * sample splits: atol 2e-6, the reference's bound for the rounding of the
    sum over 'spp' (tests/test_parallel.py);
  * against the reference: atol 1e-5 on all but 3 pixels
    (torch_parity.assert_frames_agree: BW against MT rows, XLA's FMAs).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from tpu_pathtracer.accel import build_layout as jbuild_layout
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.parallel import tiles as jtiles
from tpu_pathtracer.render import init_state as jinit_state
from tpu_pathtracer.render.wavefront import make_intersector as jmake_intersector
from tpu_pathtracer.scene import load_scene as jload_scene
from tpu_pathtracer_torch import RenderConfig, interop
from tpu_pathtracer_torch.graft_entry import dryrun_multichip
from tpu_pathtracer_torch.parallel import tiles
from tpu_pathtracer_torch.parallel.multihost import (check_process_layout, gather_image,
                                                     make_multihost_mesh)
from tpu_pathtracer_torch.parallel.tiles import (make_mesh, render_frame_distributed,
                                                 render_frame_distributed_jit, shard_state)
from tpu_pathtracer_torch.render.state import init_state, render_frame
from tpu_pathtracer_torch.render.wavefront import make_intersector
from tpu_pathtracer_torch.renderer import build_intersector
from tpu_pathtracer_torch.scene import load_scene, scene_path
from torch_parity import assert_frames_agree, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 32, 64
CPU8 = [torch.device("cpu")] * 8
KW = {"samples_per_frame": 4, "max_path_length": 3}


@pytest.fixture(scope="module")
def scene():
    return load_scene(scene_path("cornellbox"), device="cpu")


def factory_for(cfg):
    """The Renderer's factory: the layouts built once, the intersector made
    on each replica's device."""
    def factory(s):
        lay, lay_occl, _ = build_intersector(s, cfg)
        return make_intersector(s, cfg, lay, lay_occl)
    return factory


def distributed_frames(scene, cfg, mesh, frames=2, factory=None):
    step = render_frame_distributed_jit(mesh, cfg, intersect_factory=factory or factory_for(cfg))
    state = shard_state(init_state(H, W, device="cpu"), mesh)
    for _ in range(frames):
        state = step(state, scene)
    assert state.frame_index == frames
    return state


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_equals_single_device(scene, shape):
    """The split frame == the port's single-device frame: a tile-only mesh
    bit for bit, a sample split within the rounding of the sum over spp."""
    cfg = RenderConfig(**KW)
    _, _, intersect = build_intersector(scene, cfg)
    ref = init_state(H, W, device="cpu")
    for _ in range(2):
        ref = render_frame(ref, scene, cfg, None, intersect)
    mesh = make_mesh(*shape, devices=CPU8)
    state = distributed_frames(scene, cfg, mesh)
    assert mesh.shape == {"tiles": shape[0], "spp": shape[1]}
    assert mesh.axis_names == ("tiles", "spp")
    assert state.accum.shape == (H, W, 3) and (state.height, state.width) == (H, W)
    assert [t.shape[0] for t in state.accum.tiles] == [H // shape[0]] * shape[0]
    got = gather_image(state)
    if shape[1] == 1:
        np.testing.assert_array_equal(got, ref.accum.numpy())
    else:
        np.testing.assert_allclose(got, ref.accum.numpy(), rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def reference_frames():
    """The reference's (4, 2) distributed frames on its 8 virtual CPU
    devices, the BVH walker in each shard -> (the frame-1 state as numpy
    arrays, the frame-2 image)."""
    cfg = JConfig(**KW, use_pallas=False)
    jscene = jload_scene(scene_path("cornellbox"))
    lay = jbuild_layout(jscene, leaf_size=cfg.leaf_size, bake_materials=cfg.bake_materials)
    mesh = jtiles.make_mesh(4, 2)
    step = jtiles.render_frame_distributed_jit(
        mesh, cfg, intersect_factory=lambda s: jmake_intersector(s, cfg, lay, None))
    state = step(jtiles.shard_state(jinit_state(H, W), mesh), jscene)
    frame1 = (np.asarray(state.accum), int(state.frame_index),
              np.asarray(jax.random.key_data(state.key)))
    state = step(state, jscene)
    return frame1, np.asarray(state.accum)


def test_mesh_matches_reference_distributed(scene, reference_frames):
    """The port's (4, 2) split == the reference's render_frame_distributed_jit
    on its (4, 2) mesh, the portable BVH walker in each shard."""
    cfg = RenderConfig(**KW, use_pallas=False)
    state = distributed_frames(scene, cfg, make_mesh(4, 2, devices=CPU8))
    assert_frames_agree(gather_image(state), reference_frames[1])


def test_reference_sharded_state_carries_across(scene, reference_frames):
    """The reference's sharded frame-1 state, as numpy arrays, carried into a
    port mesh (interop.state_from_arrays + shard_state): the port's frame 2
    == the reference's."""
    cfg = RenderConfig(**KW, use_pallas=False)
    mesh = make_mesh(4, 2, devices=CPU8)
    state = shard_state(interop.state_from_arrays(*reference_frames[0]), mesh)
    state = render_frame_distributed(state, scene, cfg, mesh,
                                     intersect_factory=factory_for(cfg))
    assert state.frame_index == 2
    assert_frames_agree(gather_image(state), reference_frames[1])


def test_distributed_step_errors(scene):
    """The reference's three ValueErrors: height over tiles (also when the
    state is sharded), spp over sample shards, and row_tiles over the
    per-tile height."""
    mesh = make_mesh(4, 2, devices=CPU8)
    with pytest.raises(ValueError, match="height 30 not divisible by 4 tiles"):
        shard_state(init_state(30, 8, device="cpu"), mesh)
    state = shard_state(init_state(H, 8, device="cpu"), mesh)
    with pytest.raises(ValueError, match="height 32 not divisible by 3 tiles"):
        render_frame_distributed(state, scene, RenderConfig(**KW),
                                 make_mesh(3, 1, devices=CPU8))
    with pytest.raises(ValueError, match="samples_per_frame 3 not divisible by 2 "
                                         "sample shards"):
        render_frame_distributed(state, scene, RenderConfig(**{**KW, "samples_per_frame": 3}),
                                 mesh)
    with pytest.raises(ValueError, match=r"row_tiles 3 must divide the per-tile height 8 "
                                         r"\(= height 32 / 4 tiles\)"):
        render_frame_distributed(state, scene, RenderConfig(**KW, row_tiles=3), mesh)


def test_make_mesh_errors_and_defaults(monkeypatch, caplog):
    """make_mesh's errors: axes >= 1, "needs N devices" saying how to build a
    virtual mesh, the warning for idle devices, and no silent CPU mesh when
    there is no card."""
    with pytest.raises(ValueError, match="must be >= 1"):
        make_mesh(0, 1, devices=CPU8)
    with pytest.raises(ValueError, match=r"needs 16 devices.*name a device more than once"):
        make_mesh(8, 2, devices=CPU8)
    with caplog.at_level(logging.WARNING):
        mesh = make_mesh(None, 3, devices=CPU8)
    assert mesh.shape == {"tiles": 2, "spp": 3} and "2 idle" in caplog.text
    assert mesh.ranks == ((0,) * 3,) * 2
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_multihost_mesh()


def test_multihost_mesh_single_process_and_gather(scene):
    """Outside a process group make_multihost_mesh is make_mesh over the
    local devices, gather_image the local tiles; its n_spp and
    process-contiguity errors say the sample sum stays within a process."""
    mesh = make_multihost_mesh(n_spp=2, devices=CPU8)
    assert mesh == make_mesh(4, 2, devices=CPU8)
    cfg = RenderConfig(samples_per_frame=2, max_path_length=2, intersector="brute")
    state = shard_state(init_state(16, 16, device="cpu"), mesh)
    state = render_frame_distributed(state, scene, cfg, mesh)
    np.testing.assert_array_equal(gather_image(state),
                                  torch.cat(state.accum.tiles).numpy())
    with pytest.raises(ValueError, match="within a process"):
        make_multihost_mesh(n_spp=3, devices=CPU8)
    with pytest.raises(ValueError, match="process-contiguous"):
        check_process_layout([0, 0, 1, 1, 0, 0], 2)
    check_process_layout([0, 0, 1, 1], 2)


def test_scene_replicated_once_per_distinct_device(scene):
    """A mesh naming one device eight times holds one replica and builds
    one intersector."""
    made = []
    cfg = RenderConfig(**KW)
    reps = tiles.replicate(scene, make_mesh(4, 2, devices=CPU8),
                           lambda s: made.append(s) or factory_for(cfg)(s))
    assert list(reps) == [torch.device("cpu")] and len(made) == 1


def test_dryrun_multichip():
    dryrun_multichip(8)
