"""Whole frames of tpu_pathtracer_torch through the production-scale
path's routes and backends against the reference's frames (24x32, depth 3):
the HBM route on a GRID 32 procedural terrain (1,924 triangles), tritest="mt"
on the whole-table route, the portable walker (use_pallas=False) and the
brute backend, each chosen by the port's render/wavefront.py:make_intersector
from the RenderConfig.

Tolerances: frames through the kernels' plain versions to atol 2e-5, the
bound tests/test_accel.py holds the Pallas frame to against pure JAX;
frames through the walker and brute to atol 1e-5, as
tests/test_torch_frame.py holds the pure-JAX path (the same hits, shading
rounded differently where XLA contracts multiply-adds).  No kernel launches
on CPU tensors.
"""

import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from test_scale import _terrain_mesh
from tpu_pathtracer.accel import build_layout
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.models.camera import Camera as JCamera
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.ops.traverse import make_bvh_intersector as jmake_bvh
from tpu_pathtracer.render.state import init_state as jinit_state
from tpu_pathtracer.render.state import render_frame as jrender_frame
from tpu_pathtracer.render.wavefront import make_brute_intersector as jmake_brute
from tpu_pathtracer.scene import load_scene, scene_path
from tpu_pathtracer.scene.scene import build_scene as jbuild_scene
from tpu_pathtracer_torch import RenderConfig, interop
from tpu_pathtracer_torch.models.camera import Camera
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.render import wavefront as twf
from tpu_pathtracer_torch.render.state import init_state, render_frame
from torch_parity import arrays, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KERNELS = ("window_walk", "window_walk_orig", "window_walk_counts", "window_walk_hbm",
           "sweep", "capped_walk", "anyhit_walk", "minwalk")


def _launches():
    return tuple(getattr(ht, k).launches for k in KERNELS)


def _frames(scene, tscene, lay, occl, jisect, cfg_kw, jcfg_kw=None):
    """(reference frame with ``jisect``, port frame through the port's
    make_intersector for the same RenderConfig fields)."""
    jcfg = JConfig(max_path_length=3, traversal_tile=128, occlusion_tile=128,
                   secondary_tile=128, **(jcfg_kw or cfg_kw))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrender_frame(jinit_state(24, 32), scene, jcfg,
                                       JCamera.reference_default(), jisect).accum)
    cfg = RenderConfig(max_path_length=3, traversal_tile=128, **cfg_kw)
    tlay = interop.layout_from_arrays(arrays(lay)) if lay is not None else None
    tocc = interop.layout_from_arrays(arrays(occl)) if occl is not None else None
    isect = twf.make_intersector(tscene, cfg, tlay, tocc)
    before = _launches()
    got = render_frame(init_state(24, 32, device="cpu"), tscene, cfg, Camera(),
                       isect).accum.numpy()
    assert _launches() == before
    assert np.isfinite(got).all() and got.max() > 0
    return ref, got, isect


def test_frame_hbm_route_terrain():
    """A GRID 32 terrain (1,924 triangles) frame with hbm_tables="on": the
    port's HBM route == the reference's make_pallas_intersector(hbm=True)."""
    mesh = _terrain_mesh(32)
    scene = jbuild_scene(mesh)
    tscene = interop.scene_from_arrays(arrays(scene))
    lay, occl = build_layout(scene, leaf_size=56), build_layout(scene, leaf_size=8)
    jisect = pt.make_pallas_intersector(lay, lay_occl=occl, tile=128, occlusion_tile=128,
                                        secondary_tile=128, hbm=True)
    ref, got, isect = _frames(scene, tscene, lay, occl, jisect, {"hbm_tables": "on"})
    assert isect.hbm
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def cornell():
    scene = load_scene(scene_path("cornellbox"))
    return {"scene": scene, "tscene": interop.scene_from_arrays(arrays(scene)),
            "lay": build_layout(scene, leaf_size=56), "occl": build_layout(scene, 8)}


def test_frame_tritest_mt(cornell):
    """tritest="mt" on the whole-table route == the reference's frame with
    make_pallas_intersector(tritest="mt")."""
    c = cornell
    jisect = pt.make_pallas_intersector(c["lay"], lay_occl=c["occl"], tile=128,
                                        occlusion_tile=128, secondary_tile=128,
                                        tritest="mt")
    ref, got, isect = _frames(c["scene"], c["tscene"], c["lay"], c["occl"], jisect,
                              {"tritest": "mt"})
    assert not isect.hbm
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("backend", ["walker", "brute"])
def test_frame_portable_backends(cornell, backend):
    """use_pallas=False (the portable torch walker) == the reference's
    pure-JAX walker, and intersector="brute" == the reference's brute
    backend; neither is a kernel intersector (no fused walk)."""
    c = cornell
    if backend == "walker":
        jisect, kw, lay = jmake_bvh(c["lay"], c["scene"]), {"use_pallas": False}, c["lay"]
    else:
        jisect, kw, lay = jmake_brute(c["scene"]), {"intersector": "brute"}, None
    ref, got, isect = _frames(c["scene"], c["tscene"], lay, None, jisect, kw)
    assert not hasattr(isect, "fused")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
