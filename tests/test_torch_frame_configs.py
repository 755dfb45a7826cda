"""Whole frames of tpu_pathtracer_torch against the reference's on the
configurations ROADMAP.md queue 3 item 1 had checked only by hand: on the
traversal side the LBVH builder, the leaf-8 layout, the MT test with the
fused walk, the any-hit walk without an environment, minwalk and the sweep;
then the thin lens, hbm_tables="on", the r2 sampler at 2 spp, the turntable
at t = 0.7 and still noise (animate_noise=False).

Each case: the port's Renderer on the CPU (the kernels' plain versions)
against the reference's Renderer on the CPU, Water-plastic, 24x32, depth 4,
2 frames, through tests/torch_parity.py:assert_frames_agree (atol 1e-5 on
all but 3 pixels: the one-lane band of queue 3, a NEE lane that flips at a
triangle boundary because the port tests Baldwin-Weber planes where the
reference tests Moller-Trumbore and XLA contracts multiply-adds)."""

import pytest

from torch_parity import assert_frames_agree, frames_against_reference
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SCENE = "CornellBox-Water-plastic"

# case -> (RenderConfig fields, Renderer arguments)
CASES = {
    "lbvh": ({}, {"builder": "lbvh"}),
    "leaf-8": ({}, {"leaf_size": 8}),
    "mt-fused": ({"tritest": "mt", "fuse_shadow_walk": True}, {}),
    "anyhit-no-env": ({"occlusion_anyhit": "on"}, {}),
    "minwalk": ({"traversal_kernel": "minwalk"}, {}),
    "sweep": ({"traversal_kernel": "sweep"}, {}),
    "thin-lens": ({}, {"camera": {"aperture": 0.05, "focus": 3.0}}),
    "hbm-tables-on": ({"hbm_tables": "on"}, {}),
    "r2-2spp": ({"sampler": "r2", "samples_per_frame": 2}, {}),
    "turntable": ({}, {"camera": {"t": 0.7}}),
    "still-noise": ({"animate_noise": False}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_traversal_config_frame_matches_reference(case):
    kw, renderer_kw = CASES[case]
    assert_frames_agree(*frames_against_reference(SCENE, kw, renderer_kw))
