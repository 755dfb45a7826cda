"""The wavefront plan (render/wavefront.py: ``WavefrontPlan``,
``plan_wavefront``, ``WavefrontPlans``) on the CPU: a plan's ids, camera
terms and sort bounds are those a wavefront builds for itself, a Renderer's
frames, made from its plans, are bit-equal to frames whose wavefronts build
their own and leave every plan tensor as it was, and a steady frame builds
no plan while a new camera angle rebuilds them."""

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.config import NoiseMode
from tpu_pathtracer_torch.models.camera import Camera, camera_rays, generate_rays_flat
from tpu_pathtracer_torch.render.noise import pids_from_order
from tpu_pathtracer_torch.render.order import make_order
from tpu_pathtracer_torch.render.state import render_frame
from tpu_pathtracer_torch.render.wavefront import plan_wavefront, scene_sort_bounds
from tpu_pathtracer_torch.scene import load_scene, scene_path
from torch_parity import SpanLog, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W, DEPTH = 48, 64, 4
# the live-prefix ladder engages at this size, so sorted frames splice
LADDER = dict(max_path_length=DEPTH, secondary_tile=16)

# (config, rows, row0, full height, samples, sample0) of one wavefront of a
# 24 x 32 image
PLANS = {
    "block": (dict(traversal_tile=64), 24, 0, 24, 1, 0),
    "row-major": (dict(use_pallas=False), 24, 0, 24, 1, 0),
    "row-tile": (dict(traversal_tile=64), 12, 12, 24, 1, 0),
    "fused": (dict(traversal_tile=64), 24, 0, 24, 2, 2),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plan_equals_a_fresh_build(case):
    """A plan's ids, camera rays and sort bounds equal, bit for bit, those
    built from a fresh make_order / pids_from_order / generate_rays_flat /
    scene_sort_bounds: the block order at the tile, row-major order (off
    the kernel path, no bounds), a row tile below row 0, and two fused
    samples from sample 2 (ids offset by the sample, the order repeated);
    the thin lens's rays too."""
    kw, h, row0, full_h, samples, sample0 = PLANS[case]
    cfg = RenderConfig(**kw)
    scene = load_scene(scene_path("cornellbox"), device="cpu")
    camera = Camera(t=0.4, aperture=0.05)
    plan = plan_wavefront(scene, cfg, camera, h, 32, row0, full_h, 32, samples, sample0)

    kernel_path = cfg.use_pallas
    order = make_order(h, 32, row0, 64 if kernel_path else None, device="cpu")
    assert (order.block != (1, 32)) == kernel_path
    ids = pids_from_order(order, 32)
    ids = torch.cat([(ids + (sample0 + s) * full_h * 32) & 0xFFFFFFFF
                     for s in range(samples)])
    rows, cols = order.rows.repeat(samples), order.cols.repeat(samples)
    assert torch.equal(plan.pids, ids)
    assert plan.pids.shape == (h * 32 * samples,)

    jitter = torch.rand((4, ids.shape[0]), generator=torch.Generator().manual_seed(3))
    want = generate_rays_flat(camera, rows, cols, jitter[0:2], full_h, 32,
                              lens_u=jitter[2:4])
    got = camera_rays(camera, plan.camera, jitter[0:2], full_h, 32, lens_u=jitter[2:4])
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert plan.bounds == (scene_sort_bounds(scene) if kernel_path else None)


FRAMES = {
    "sorted": LADDER,
    "unsorted": dict(LADDER, sort_rays=False),
    "prefix": dict(LADDER, prefix_sort=True),
    "hero": dict(LADDER, spectrum_samples=8, hero_wavelengths=4),
}


def _tensors(r) -> list[torch.Tensor]:
    """Every tensor of the renderer's plans."""
    return [t for _, _, plan in r._plans._held.values()
            for t in (plan.pids, *plan.camera)]


@pytest.mark.parametrize("kind", list(FRAMES))
def test_renderer_frames_equal_planless_frames(kind):
    """Three frames of a Renderer (made from its plans) equal, bit for bit,
    the same frames made by render_frame with no plans (each wavefront
    builds its own through render_sample), on the sorted pipeline with the
    ladder splicing, the unsorted one, prefix sorts and a hero spectral
    frame; after them every tensor of every plan is unchanged (no frame
    writes into a plan)."""
    cfg = RenderConfig(**FRAMES[kind])
    r = Renderer("cornellbox", W, H, cfg, seed=5, device="cpu")
    before = [t.clone() for t in _tensors(r)]
    assert before
    state = r.state
    for _ in range(3):
        r.step()
        state = render_frame(state, r.scene, cfg, r.camera, r._intersect)
    r.sync()
    assert torch.equal(r.state.accum.view(torch.int32), state.accum.view(torch.int32))
    after = _tensors(r)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw,slots,waves", [
    ({}, 1, 1), ({"row_tiles": 2}, 2, 2), ({"samples_per_frame": 3, "fuse_samples": 2}, 2, 2),
    ({"noise_mode": NoiseMode.TILED, "samples_per_frame": 2}, 1, 2)],
    ids=["1spp", "row-tiles", "fused-tail", "tiled"])
def test_steady_frames_build_no_plan(kw, slots, waves):
    """reset() builds one plan a row tile and fused chunk (one a row tile
    under TILED noise, whose samples trace one a wavefront), and the frames
    then build none: plan_builds reads 0 in every record, and a sorted
    frame's host reads are the ladder's alone, one a secondary bounce of
    each wavefront."""
    r = Renderer("cornellbox", W, H, RenderConfig(**LADDER, **kw), seed=5, device="cpu")
    assert len(r._plans._held) == slots
    for _ in range(2):
        r.step(timer=SpanLog())
    recs = r.frame_records
    assert [x["plan_builds"] for x in recs] == [0, 0]
    assert [x["host_reads"] for x in recs] == [(DEPTH - 1) * waves] * 2


def test_new_camera_rebuilds_the_plan():
    """Reassigning Renderer.camera rebuilds the plan in the next frame
    (plan_builds 1, its three camera copies and the bounds' two reads under
    prepare), and the frame after builds none; the image equals a fresh
    renderer's with that camera from the start."""
    cfg = RenderConfig(**LADDER, accumulate_image=False)
    r = Renderer("cornellbox", W, H, cfg, seed=5, device="cpu")
    r.step(timer=SpanLog())
    r.camera = Camera(t=0.3)
    for _ in range(2):
        r.step(timer=SpanLog())
    recs = r.frame_records
    assert [x["plan_builds"] for x in recs] == [0, 1, 0]
    assert [x["host_reads"] for x in recs] == [DEPTH - 1, 3 + 2 + DEPTH - 1, DEPTH - 1]
    spans = recs[1]["spans"]
    prepare = [(a, b) for name, a, b in spans if name == "prepare"]
    assert sum(name == "host_read" and any(p <= a and b <= q for p, q in prepare)
               for name, a, b in spans) == 3 + 2
    fresh = Renderer("cornellbox", W, H, cfg, seed=5, camera=Camera(t=0.3), device="cpu")
    fresh.run(3)
    got, want = r.image(), fresh.image()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    before = Renderer("cornellbox", W, H, cfg, seed=5, device="cpu")
    before.run(3)
    assert not np.array_equal(got, before.image())
