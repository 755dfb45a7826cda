"""Render statistics: exact traced-ray counts and walk-utilization telemetry.

The port of ``tpu_pathtracer/render/stats.py``.  The reference HUD divides
dispatch size by frame time (reference: renderer/Renderer.mm:631-637), which
under-reports work by the bounce count and over-reports it by the dead-ray
fraction; :func:`count_traced_rays_exact` counts the rays the traversal
actually processes (live path rays per bounce + live shadow rays) on the
frames' own key schedule.  :func:`utilization_report` prices the frame's
first secondary wavefront in lane-ops with the counting window walk
(``window_walk_counts``).

The reference's scaled brute-force probe (``count_traced_rays``) is not
ported: the exact count replaces it.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig, check_supported
from ..models.camera import Camera, generate_rays_flat
from ..ops.hopper_traverse import window_prepass, window_walk_counts
from ..ops.rng import fold_in, prng_key
from ..scene.scene import Scene
from .noise import bounce_uniforms, camera_jitter, pids_from_order
from .order import make_order
from .state import frame_rng_key, fused_wavefront_key
from .wavefront import (initial_path_state, render_sample, scene_sort_bounds,
                        sort_wavefront, trace_bounce)


def _intersector(scene: Scene, cfg: RenderConfig, intersect):
    if intersect is not None:
        return intersect
    from ..renderer import build_intersector

    return build_intersector(scene, cfg)[2]


def count_traced_rays_exact(scene: Scene, cfg: RenderConfig, height: int, width: int,
                            frame_indices=(0,), intersect=None,
                            camera: Camera | None = None, seed: int = 0) -> float:
    """EXACT rays traced for the given frame indices, averaged per frame:
    each frame re-rendered with ``with_ray_count=True`` on the key schedule
    of render/state.py (``frame_rng_key``, ``fused_wavefront_key``) -- no
    resolution scaling, no estimator.  ``intersect`` None builds the
    Renderer's intersector for ``cfg``."""
    check_supported(cfg)
    camera = camera or Camera.reference_default()
    intersect = _intersector(scene, cfg, intersect)
    key = prng_key(seed)
    counts = []
    for fi in frame_indices:
        wkey = fused_wavefront_key(frame_rng_key(key, fi))
        _, n = render_sample(scene, cfg, camera, height, width, wkey, fi, intersect,
                             with_ray_count=True)
        counts.append(int(n))
    return sum(counts) / len(counts)


def first_secondary_wavefront(scene: Scene, cfg: RenderConfig, height: int,
                              width: int, intersect=None,
                              camera: Camera | None = None, seed: int = 0,
                              frame_index: int = 0):
    """The frame's FIRST secondary wavefront -> (state, pack): the bounce-1
    path rays and bounce 0's deferred NEE shadow pack, sorted exactly as
    render_sample sorts them (bounce 0 traced coherently, then one
    sort_wavefront -- argsort + gather, the reference's "gather" lowering).
    The canonical incoherent workload the traversal tuning targets."""
    camera = camera or Camera.reference_default()
    intersect = _intersector(scene, cfg, intersect)
    dev = scene.p0.device
    wkey = fused_wavefront_key(frame_rng_key(prng_key(seed), frame_index))
    order = make_order(height, width, 0, cfg.traversal_tile, device=dev)
    pids = pids_from_order(order, width)
    jitter = camera_jitter(fold_in(wkey, 0xC0FFEE), frame_index, pids)
    origins, directions = generate_rays_flat(camera, order.rows, order.cols,
                                             jitter[0:2], height, width,
                                             lens_u=jitter[2:4])
    state = initial_path_state(origins, directions, cfg.spectrum_samples, pids)
    uniforms = bounce_uniforms(wkey, frame_index, 0, pids,
                               with_env=scene.env is not None)
    state, pack, _ = trace_bounce(scene, cfg, intersect, 0, state, uniforms,
                                  coherent=True)
    wmin, winv = scene_sort_bounds(scene)
    return sort_wavefront(state, wmin, winv, pack)


def walk_lane_ops(lay, cfg: RenderConfig, o, d, active, t_max=None):
    """Kernel-measured lane-op accounting for one counting window walk over
    (o, d) -> (spent, useful, live_rays), summed in float64 on the host.

    ``spent``  = leaf-row test slots paid, summed over every lane: each lane
                 carries its 32-lane warp's slots plus the prepass rows
                 (csrc/window_walk.cu, kCounts; a slot is one row test on
                 every lane of the warp, whether the warp serves one leaf 32
                 rows wide or each pending lane's own next row) -- the SIMT
                 counterpart of the TPU's per-tile row count;
    ``useful`` = leaf rows each lane's own walk tested (the demand served).
    Box/navigation lane-ops are excluded, as in the reference.  The walk
    tests cfg.tritest's rows (reference stats.py:214)."""
    t_max = (torch.full((o.shape[1],), torch.inf, device=o.device) if t_max is None
             else t_max.to(torch.float32).contiguous())
    _, _, useful, spent = window_walk_counts(
        o.contiguous(), d.contiguous(), active.contiguous(), t_max, lay,
        prepass=window_prepass(lay, cfg.traversal_prepass), tritest=cfg.tritest)
    return (float(spent.double().sum()), float(useful.double().sum()),
            float(active.double().sum()))


def utilization_report(scene: Scene, cfg: RenderConfig, lay, height: int, width: int,
                       intersect, traced_per_frame: float, frame_time_s: float,
                       spectrum_planes: int | None = None) -> dict:
    """Machine-checkable walk-utilization block for the bench JSON.

    Lane-op numbers are MEASURED in-kernel (:func:`walk_lane_ops`) on the
    frame's first secondary wavefront: path rays and their NEE shadow
    queries.  The lockstep unit is the 32-lane warp (``lane_unit``): a
    lane's ``spent`` is what its warp issued.  ``est_hbm_gb_per_s_model`` is
    a MODEL, not a measurement: per-bounce full-width wavefront traffic (sort
    read+write of every payload plane + the resolve row gather), the
    reference's byte model.  The reference's ``est_vpu_peak_pct`` (the one
    use of ``traced_per_frame``, kept for the reference's signature) is
    left out: its peak and per-row op counts are TPU v5e constants.  On CPU
    tensors ``spent`` is the warp lower bound of the plain version
    (``spent_source`` says which).

    Shadow lanes are priced under the window walk on the nearest-hit
    layout; the frame's shadow queries take the cheaper capped walk on the
    leaf-8 layout, so the combined spent/ray is an upper bound
    (``shadow_pricing``).  Only the window walk is instrumented: other
    cfg.traversal_kernel values raise."""
    if cfg.traversal_kernel != "window":
        raise NotImplementedError(
            "utilization telemetry instruments the window walk only; "
            f"traversal_kernel={cfg.traversal_kernel!r} walks are unpriced")
    st, pk = first_secondary_wavefront(scene, cfg, height, width, intersect=intersect)
    sp_p, us_p, live_p = walk_lane_ops(lay, cfg, st.origin, st.direction, st.alive)
    sp_s, us_s, live_s = walk_lane_ops(lay, cfg, st.origin, pk.to_light, pk.ok,
                                       t_max=pk.cap)
    spent, useful = sp_p + sp_s, us_p + us_s
    rays = max(live_p + live_s, 1.0)
    n_lanes = height * width * cfg.samples_per_frame
    s = cfg.spectrum_samples if spectrum_planes is None else spectrum_planes
    planes = 13 + 3 * s + 2  # sort_wavefront's shadow-carrying operand count
    sort_bytes = planes * n_lanes * 4 * 2 * max(cfg.max_path_length - 1, 0)
    gather_bytes = (lay.tris.shape[1] * 4 + 8) * n_lanes * cfg.max_path_length
    return {
        "wavefront": "bounce-1 sorted secondary (path + NEE shadow)",
        "lane_unit": "warp32",
        "spent_source": ("measured in-kernel per warp" if st.origin.is_cuda else
                         "plain-version lower bound: prepass + ceil(useful rows "
                         "per warp / 32) (no warps on the CPU)"),
        "live_rays": int(rays),
        "spent_lane_ops_per_ray": round(spent / rays, 1),
        "useful_lane_ops_per_ray": round(useful / rays, 1),
        "mt_lane_utilization": round(useful / max(spent, 1.0), 4),
        "est_hbm_gb_per_s_model": round((sort_bytes + gather_bytes) / frame_time_s / 1e9, 2),
        "shadow_pricing": "window walk on the nearest-hit layout (the frame's "
                          "shadow queries take the cheaper capped walk on the "
                          "leaf-8 layout -- combined spent/ray is an upper bound)",
    }
