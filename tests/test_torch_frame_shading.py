"""Whole frames of tpu_pathtracer_torch against the reference's on the
configurations ROADMAP.md queue 3 item 1 had checked only by hand, shading
side: the ones whose bounces render/wavefront.py:_shade_plain (on the card
csrc/shade.cu) computes differently -- the mirror and plastic scenes, the
white box, 16 spectral planes without hero sampling, a raised pdf floor and
angle epsilon, the live ladder off with prefix sorts, and hero sampling
under an environment light.

Each case: the port's Renderer on the CPU against the reference's Renderer
on the CPU, 24x32, depth 3-4, 2 frames, through
tests/torch_parity.py:assert_frames_agree (atol 1e-5 on all but 3 pixels,
the one-lane band of ROADMAP.md queue 3)."""

import numpy as np
import pytest

from tpu_pathtracer.scene import attach_env, load_scene, scene_path
from tpu_pathtracer_torch import interop
from torch_parity import arrays, assert_frames_agree, frames_against_reference
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# case -> (scene, RenderConfig fields, depth)
CASES = {
    "water-mirror": ("CornellBox-Water-mirror", {}, 4),
    "white-box": ("white-box", {}, 4),
    "S16-no-hero": ("CornellBox-Water-plastic", {"spectrum_samples": 16}, 3),
    "pdf-floor-angle-eps": ("CornellBox-Water-plastic",
                            {"pdf_floor": 1e-3, "angle_epsilon": 1e-2}, 4),
    "ladder-0-prefix-sort": ("CornellBox-Water-plastic",
                             {"live_ladder": 0, "prefix_sort": True}, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_shading_config_frame_matches_reference(case):
    name, kw, depth = CASES[case]
    assert_frames_agree(*frames_against_reference(name, kw, {}, depth=depth))


def test_env_hero_frame_matches_reference():
    """S = 8 with hero 2 under a seeded environment map: the port's frame ==
    the reference's."""
    img = np.random.default_rng(4).uniform(0.2, 2.0, (16, 32, 3)).astype(np.float32)
    jscene = attach_env(load_scene(scene_path("CornellBox-Water-plastic"), samples=8), img)
    kw = {"spectrum_samples": 8, "hero_wavelengths": 2}
    assert_frames_agree(*frames_against_reference(
        jscene, kw, {}, depth=3, scene=interop.scene_from_arrays(arrays(jscene))))
