"""tpu_pathtracer_torch's Renderer over a virtual CPU mesh and the
directory checkpoint form: the counterparts of tests/test_parallel.py's
renderer tests (bit-equal to the single-device Renderer, resharded on load,
with a turntable camera and row tiles), the directory form's round trip,
its temp-and-swap save, and its refusal of the Orbax backend.

Tolerances: a tile-only mesh is the single-device frame bit for bit, a
sample split within atol 2e-6 (the reference's bound for the rounding of
the sum over 'spp'), and a checkpoint holds the accumulator's float32
values as they are.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.io import checkpoint as jckpt
from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.io.checkpoint import load_checkpoint, save_checkpoint
from tpu_pathtracer_torch.models.camera import Camera
from tpu_pathtracer_torch.parallel.tiles import TiledAccum, make_mesh, shard_state
from tpu_pathtracer_torch.render.state import RenderState
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = RenderConfig(samples_per_frame=2, max_path_length=3)


def cpu_mesh(tiles, spp=1):
    return make_mesh(tiles, spp, devices=[torch.device("cpu")] * (tiles * spp))


@pytest.mark.parametrize("name", ["ck.npz", "ck_dir"])
def test_renderer_mesh_equals_single_device(name, tmp_path):
    """Renderer(mesh=) == the single-device Renderer bit for bit, and a
    checkpoint of either form from the mesh renderer resumes on a mesh of
    another shape, on no mesh, and (the npz form) in the reference."""
    a = Renderer("cornellbox", width=32, height=16, cfg=CFG, device="cpu")
    b = Renderer("cornellbox", width=32, height=16, cfg=CFG, mesh=cpu_mesh(4))
    a.run(2)
    b.run(2)
    np.testing.assert_array_equal(a.image(), b.image())
    assert isinstance(b.state.accum, TiledAccum) and len(b.state.accum.tiles) == 4
    assert b.frame_index == 2 and b.hud().startswith("Frame: 2")

    path = str(tmp_path / name)
    b.save_checkpoint(path)
    assert os.path.isdir(path) == (not name.endswith(".npz"))
    if name.endswith(".npz"):
        ref = jckpt.load_checkpoint(path)
        np.testing.assert_array_equal(np.asarray(ref.accum), a.image())
        assert int(ref.frame_index) == 2
    a.run(1)
    for mesh in (cpu_mesh(2, 2), None):
        c = Renderer("cornellbox", width=32, height=16, cfg=CFG, mesh=mesh, device="cpu")
        c.load_checkpoint(path)
        assert isinstance(c.state.accum, TiledAccum) == (mesh is not None)
        assert c.frame_index == 2
        c.run(1)
        if mesh is None:
            np.testing.assert_array_equal(c.image(), a.image())
        else:  # a sample split: the rounding of the sum over spp
            np.testing.assert_allclose(c.image(), a.image(), rtol=0, atol=2e-6)


def test_renderer_mesh_camera_and_row_tiles():
    """Mesh + a turntable camera + row_tiles=2 == the single-device Renderer
    with the same settings; row_tiles must divide the per-tile height, not
    the full height."""
    cam = Camera(t=0.5)
    cfg = RenderConfig(samples_per_frame=2, max_path_length=3, row_tiles=2)
    a = Renderer("cornellbox", width=32, height=16, cfg=cfg, camera=cam, device="cpu")
    b = Renderer("cornellbox", width=32, height=16, cfg=cfg, camera=cam, mesh=cpu_mesh(4))
    a.run(2)
    b.run(2)
    np.testing.assert_array_equal(a.image(), b.image())
    d = Renderer("cornellbox", width=32, height=16, cfg=CFG, device="cpu")
    d.run(2)
    assert not np.allclose(d.image(), b.image(), atol=1e-3)
    with pytest.raises(ValueError, match="per-tile height 4"):
        Renderer("cornellbox", width=32, height=16,
                 cfg=RenderConfig(samples_per_frame=2, max_path_length=3, row_tiles=3),
                 mesh=cpu_mesh(4)).run(1)


def test_renderer_mesh_device_and_scene_checks():
    """With a mesh the Renderer's device is the mesh's; a scene on another
    device type raises, as without one."""
    from tpu_pathtracer_torch.scene import load_scene, scene_path

    r = Renderer("cornellbox", 8, 8, mesh=cpu_mesh(2))  # device="cuda" is not consulted
    assert r.device == torch.device("cpu") and r.scene.p0.device.type == "cpu"
    scene = load_scene(scene_path("cornellbox"), device="cpu")
    meta = make_mesh(1, 1, devices=["meta"])
    with pytest.raises(ValueError, match="lies on"):
        Renderer(scene, 8, 8, mesh=meta)


def test_dir_checkpoint_round_trip_and_swap(tmp_path, monkeypatch):
    """The directory form: the manifest and one .npy per tile, written tile
    by tile without a full-image gather; an unsharded state saves as one
    shard; the save goes to path + ".tmp" and is swapped in, so a save that
    fails midway leaves the previous checkpoint whole; backend="orbax"
    raises, since the port's directory is not Orbax's format."""
    rng = np.random.default_rng(3)
    accum = rng.random((12, 5, 3)).astype(np.float32)
    key = np.asarray([123, 4567], np.uint32)
    state = shard_state(RenderState(torch.from_numpy(accum), 7, key), cpu_mesh(3))
    path = str(tmp_path / "state")

    import tpu_pathtracer_torch.parallel.multihost as mh

    def no_gather(_):
        raise AssertionError("the directory form gathered the image")

    monkeypatch.setattr(mh, "gather_image", no_gather)
    save_checkpoint(path, state)
    monkeypatch.undo()
    assert sorted(os.listdir(path)) == ["accum.0.npy", "accum.1.npy", "accum.2.npy",
                                        "manifest.json"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest == {"version": 1, "shape": [12, 5, 3], "dtype": "float32",
                        "frame_index": 7, "key_data": [123, 4567],
                        "shards": [{"file": f"accum.{k}.npy", "rows": [4 * k, 4 * k + 4]}
                                   for k in range(3)]}
    got = load_checkpoint(path)
    np.testing.assert_array_equal(got.accum.numpy(), accum)
    assert got.frame_index == 7 and np.array_equal(got.key, key)

    # an unsharded state: one shard; the previous checkpoint is replaced
    save_checkpoint(path, RenderState(torch.from_numpy(accum * 2), 8, key))
    assert sorted(os.listdir(path)) == ["accum.0.npy", "manifest.json"]
    np.testing.assert_array_equal(load_checkpoint(path).accum.numpy(), accum * 2)
    assert not os.path.exists(path + ".tmp")

    # a save that fails after its first tile leaves the last checkpoint whole
    saved, real_save = [], np.save

    def failing_save(file, arr):
        if saved:
            raise OSError("disk full")
        saved.append(file)
        real_save(file, arr)

    monkeypatch.setattr(np, "save", failing_save)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, state)
    monkeypatch.undo()
    assert os.path.isdir(path + ".tmp")
    got = load_checkpoint(path)
    np.testing.assert_array_equal(got.accum.numpy(), accum * 2)
    assert got.frame_index == 8
    save_checkpoint(path, state)  # a stale temp directory is cleared first
    assert load_checkpoint(path).frame_index == 7 and not os.path.exists(path + ".tmp")

    with pytest.raises(ValueError, match="not Orbax's on-disk format"):
        save_checkpoint(str(tmp_path / "o"), state, backend="orbax")
    with pytest.raises(ValueError, match="not Orbax's on-disk format"):
        load_checkpoint(path, backend="orbax")
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        save_checkpoint(path, state, backend="zarr")
    # backend= overrides the suffix either way
    save_checkpoint(str(tmp_path / "x.npz"), state, backend="dir")
    assert os.path.isdir(tmp_path / "x.npz")
    save_checkpoint(str(tmp_path / "y"), state, backend="npz")
    assert load_checkpoint(str(tmp_path / "y"), backend="npz").frame_index == 7


def test_reference_npz_resumes_on_a_mesh(tmp_path):
    """The npz form stays the cross-package form: a reference checkpoint
    resumes on the port's mesh, and the mesh renderer's next frame equals
    the single-device renderer's resumed from the same file."""
    from tpu_pathtracer.render.state import RenderState as JState

    rng = np.random.default_rng(5)
    accum = rng.random((16, 32, 3)).astype(np.float32)
    path = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(path, JState(jnp.asarray(accum), jnp.int32(3),
                                       jax.random.PRNGKey(9)))
    a = Renderer("cornellbox", width=32, height=16, cfg=CFG, device="cpu")
    b = Renderer("cornellbox", width=32, height=16, cfg=CFG, mesh=cpu_mesh(2))
    for r in (a, b):
        r.load_checkpoint(path)
        assert r.frame_index == 3
        r.run(1)
    np.testing.assert_array_equal(a.image(), b.image())
