"""Whole frames of tpu_pathtracer_torch against the reference's."""

import os

import jax
import numpy as np
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer import renderer as jrenderer
from tpu_pathtracer.accel import build_layout
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.models.camera import Camera as JCamera
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.render.state import init_state as jinit_state
from tpu_pathtracer.render.state import render_frame as jrender_frame
from tpu_pathtracer.scene import load_scene, scene_path
from tpu_pathtracer_torch import Renderer, RenderConfig, interop
from tpu_pathtracer_torch.io.exr import read_exr
from tpu_pathtracer_torch.models.camera import Camera
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.render.state import init_state, render_frame
from torch_parity import arrays

SCENE = "CornellBox-Water-plastic"


def test_frame_matches_pallas_interpret():
    """One cornellbox frame (24x32, depth 3) through the port's sorted
    wavefront and plain kernels == the reference's frame through its Pallas
    kernels in interpret mode, on the same leaf-4 layout.  atol 2e-5, the
    bound tests/test_accel.py holds the Pallas frame to against pure JAX."""
    scene = load_scene(scene_path("cornellbox"))
    lay = build_layout(scene, leaf_size=4)
    jcfg = JConfig(max_path_length=3, traversal_tile=128, occlusion_tile=128)
    isect = pt.make_pallas_intersector(lay, tile=128, occlusion_tile=128,
                                       secondary_tile=128)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrender_frame(jinit_state(24, 32), scene, jcfg,
                                       JCamera.reference_default(), isect).accum)
    tlay = interop.layout_from_arrays(arrays(lay))
    before = (ht.window_walk.launches, ht.capped_walk.launches)
    got = render_frame(init_state(24, 32, device="cpu"),
                       interop.scene_from_arrays(arrays(scene)),
                       RenderConfig(max_path_length=3, traversal_tile=128),
                       Camera(), ht.make_cuda_intersector(tlay)).accum.numpy()
    assert (ht.window_walk.launches, ht.capped_walk.launches) == before
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_renderer_matches_reference_default_path():
    """Renderer frames of Water-plastic (32x48, depth 4, 2 frames) == the
    reference's default CPU path (sorted wavefront, pure-JAX MT walker).
    Tolerance atol 1e-5 on radiance up to ~5: the port tests Baldwin-Weber
    planes where the reference walker tests Moller-Trumbore, and XLA
    contracts multiply-adds, so t and the shading differ by ulps (measured
    2.7e-6); no hit changes at this size.  Also carries the reference's
    frame-1 state into the port (interop.state_from_arrays): the port's
    frame 2 continues it to the same tolerance."""
    h, w, depth = 32, 48, 4
    jr = jrenderer.Renderer(SCENE, w, h, JConfig(max_path_length=depth))
    jr.run(1)
    st1 = jr.state
    carried = interop.state_from_arrays(
        np.asarray(st1.accum), int(st1.frame_index),
        np.asarray(jax.random.key_data(st1.key)))
    jr.run(1)
    ref = jr.image()

    cfg = RenderConfig(max_path_length=depth)
    r = Renderer(SCENE, w, h, cfg, device="cpu")
    r.run(2)
    assert r.frame_index == 2
    np.testing.assert_allclose(r.image(), ref, rtol=0, atol=1e-5)
    cont = render_frame(carried, r.scene, cfg, r.camera, r._intersect)
    assert cont.frame_index == 2
    np.testing.assert_allclose(cont.accum.numpy(), ref, rtol=0, atol=1e-5)


def test_live_ladder_is_exact(tmp_path):
    """The live-prefix ladder (RenderConfig.live_ladder) only skips dead
    lanes: the image and the exact traced-ray count equal the full-width
    run bit for bit.  secondary_tile=48 lets 1536 lanes take 3 halvings."""
    from tpu_pathtracer_torch.render.state import (frame_rng_key,
                                                   fused_wavefront_key)
    from tpu_pathtracer_torch.render.wavefront import ladder_sizes, render_sample

    out = {}
    for ladder in (0, 3):
        cfg = RenderConfig(max_path_length=5, secondary_tile=48, live_ladder=ladder)
        r = Renderer(SCENE, 48, 32, cfg, device="cpu")
        assert len(ladder_sizes(48 * 32, cfg)) == ladder + 1
        key = fused_wavefront_key(frame_rng_key(r.state.key, 0))
        out[ladder] = render_sample(r.scene, cfg, r.camera, 32, 48, key, 0,
                                    r._intersect, with_ray_count=True)
    np.testing.assert_array_equal(out[3][0].numpy(), out[0][0].numpy())
    assert int(out[3][1]) == int(out[0][1]) > 48 * 32

    # the EXR written by the renderer reads back as its image (half floats)
    r.run(1)
    path = os.path.join(tmp_path, "frame.exr")
    r.save_exr(path)
    img, channels = read_exr(path)
    assert img.shape == (32, 48, 3)
    np.testing.assert_allclose(img, r.image(), rtol=1e-3, atol=1e-4)
