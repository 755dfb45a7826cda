"""tpu_pathtracer_torch.render.stats against tpu_pathtracer.render.stats on
the CPU: exact traced-ray counts, the first secondary wavefront and the
walk-utilization block (cornellbox, 24x32, depth 3).

Tolerances: ray counts and live-ray counts exact (integers); the sorted
wavefront's lane order (pixel ids), alive and target planes exact, its float
planes to atol 1e-5 (XLA contracts multiply-adds into FMAs and torch does
not, so hit points differ by ulps).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer.accel import build_layout
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.render import stats as jstats
from tpu_pathtracer.scene import load_scene, scene_path
from tpu_pathtracer_torch import RenderConfig, interop
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.render import stats
from torch_parity import arrays, random_rays

H, W, DEPTH = 24, 32, 3


@pytest.fixture(scope="module")
def cornell():
    scene = load_scene(scene_path("cornellbox"))
    lay = build_layout(scene, leaf_size=4)
    return {"scene": scene, "lay": lay,
            "tscene": interop.scene_from_arrays(arrays(scene)),
            "tlay": interop.layout_from_arrays(arrays(lay))}


@pytest.fixture(scope="module")
def ref_count(cornell):
    """The reference's exact count over frames 0 and 2 (its default
    brute-force intersector)."""
    return jstats.count_traced_rays_exact(cornell["scene"], JConfig(max_path_length=DEPTH),
                                          H, W, frame_indices=(0, 2), seed=0)


@pytest.mark.parametrize("kw", [{}, {"fuse_shadow_walk": True},
                                {"traversal_kernel": "minwalk"}],
                         ids=["window", "fused", "minwalk"])
def test_count_traced_rays_exact_matches_reference(cornell, ref_count, kw):
    """The exact count, averaged over frames 0 and 2, equals the
    reference's as an integer; the fused stage counts the same rays."""
    got = stats.count_traced_rays_exact(cornell["tscene"],
                                        RenderConfig(max_path_length=DEPTH, **kw),
                                        H, W, frame_indices=(0, 2), seed=0)
    assert got == ref_count and got > H * W


def test_first_secondary_wavefront_matches_reference(cornell):
    """The sorted bounce-1 wavefront and its shadow pack == the
    reference's (sort_wavefront under the "gather" lowering)."""
    jst, jpk = jstats.first_secondary_wavefront(cornell["scene"],
                                                JConfig(max_path_length=DEPTH), H, W)
    st, pk = stats.first_secondary_wavefront(cornell["tscene"],
                                             RenderConfig(max_path_length=DEPTH), H, W)
    np.testing.assert_array_equal(st.pixel.numpy(), np.asarray(jst.pixel))
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))
    np.testing.assert_array_equal(pk.ok.numpy(), np.asarray(jpk.ok))
    np.testing.assert_array_equal(pk.target.numpy(), np.asarray(jpk.target))
    for a, b in ((st.origin, jst.origin), (st.direction, jst.direction),
                 (st.throughput, jst.throughput)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    # a dead lane's pack is never traced: its values follow each package's
    # miss payload (the reference's default brute intersector, the port's
    # sentinel row), so the pack compares on its live lanes
    ok = pk.ok.numpy()
    for a, b in ((pk.to_light, jpk.to_light), (pk.cap, jpk.cap),
                 (pk.contrib, jpk.contrib)):
        np.testing.assert_allclose(a.numpy()[..., ok], np.asarray(b)[..., ok],
                                   rtol=0, atol=1e-5)
    assert st.alive.any() and not st.alive[int(st.alive.sum()):].any()


def test_utilization_report_invariants(cornell):
    """The bench's utilization block on the CPU (the counting walk's plain
    version, warp lower bound for spent): the invariants of
    tests/test_accel.py's report test without the TPU-only VPU field, the
    same live rays as the reference's report and no more useful rows per
    ray than the reference's tile walk tests."""
    cfg = RenderConfig(max_path_length=DEPTH, traversal_prepass=8)
    isect = ht.make_cuda_intersector(cornell["tlay"], prepass=8)
    n0 = ht.window_walk_counts.launches
    rep = stats.utilization_report(cornell["tscene"], cfg, cornell["tlay"], H, W, isect,
                                   traced_per_frame=3e3, frame_time_s=0.1)
    assert ht.window_walk_counts.launches == n0
    assert rep["live_rays"] > 0 and rep["lane_unit"] == "warp32"
    assert 0.0 < rep["mt_lane_utilization"] <= 1.0
    assert rep["useful_lane_ops_per_ray"] <= rep["spent_lane_ops_per_ray"]
    assert rep["est_hbm_gb_per_s_model"] > 0
    assert "est_vpu_peak_pct" not in rep

    jcfg = JConfig(max_path_length=DEPTH, traversal_tile=128, secondary_tile=128,
                   occlusion_tile=128, traversal_prepass=8)
    jisect = pt.make_pallas_intersector(cornell["lay"], tile=128, occlusion_tile=128,
                                        secondary_tile=128, prepass=8)
    with pltpu.force_tpu_interpret_mode():
        jrep = jstats.utilization_report(cornell["scene"], jcfg, cornell["lay"], H, W,
                                         jisect, traced_per_frame=3e3, frame_time_s=0.1)
    assert rep["live_rays"] == jrep["live_rays"]
    assert rep["useful_lane_ops_per_ray"] <= jrep["useful_lane_ops_per_ray"]
    assert rep["est_hbm_gb_per_s_model"] == jrep["est_hbm_gb_per_s_model"]
    with pytest.raises(NotImplementedError):
        stats.utilization_report(cornell["tscene"], cfg.replace(traversal_kernel="sweep"),
                                 cornell["tlay"], H, W, isect, 3e3, 0.1)


def test_walk_lane_ops_counts_rows(cornell):
    """walk_lane_ops sums the counting walk's rows: useful equals the plain
    version's per-lane count, spent its warp lower bound (prepass + ceil(the
    warp's useful rows / 32) on every lane), live the active lanes."""
    o, d = (torch.from_numpy(x) for x in random_rays(100, seed=3))
    act = torch.arange(100) % 4 != 0
    cfg = RenderConfig(traversal_prepass=8)
    spent, useful, live = stats.walk_lane_ops(cornell["tlay"], cfg, o, d, act)
    _, _, u, lo, _ = ht.window_walk_counts_plain(o, d, act, torch.full((100,), torch.inf),
                                                 cornell["tlay"], prepass=8)
    assert (spent, useful, live) == (float(lo.sum()), float(u.sum()), 75.0)
