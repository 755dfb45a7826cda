"""Benchmark harness on PyTorch + CUDA: traced Mrays/s at 1080p, 1 spp, on
the Cornell box with the water mesh.

    python -m tpu_pathtracer_torch.bench                       # on the card
    python -m tpu_pathtracer_torch.bench --platform cpu --width 32 --height 24 \\
        --depth 3 --frames 1 --warmup 0                        # a CPU rehearsal

The port of the root ``bench.py``, with the same flags and defaults plus
``--platform``.  Prints ONE JSON line with the reference's fields
(``metric``, ``value`` in traced Mrays/s, ``rays_traced_per_frame``,
``ms_per_frame`` = the median of individually synchronised frames, ...),
plus ``package``.  ``device`` is the card's name and power limit as
``nvidia-smi`` prints them.  ``vs_baseline`` is left out: its 100 Mrays/s
is the TPU v5e north star.  With ``--utilization`` (the default) the line
carries the walk-utilization block of render/stats.py, measured by the
counting window walk on the card; ``--progressive`` adds the cornellbox
spp/s.

Headline metric: rays actually traced per second (primary + per-bounce path
and shadow rays the traversal processed, counted exactly over the measured
frame indices); ``hud_mrays_per_s`` is the reference HUD's W*H/frame_time
(reference: renderer/Renderer.mm:631-637).

Flags whose feature is not ported yet raise ``NotImplementedError`` naming
their ROADMAP.md item; ``--resolve-gather`` and ``--sort-lowering`` (TPU
lowering switches) are accepted and change nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .config import RenderConfig
from .device import device_for, device_label


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="CornellBox-Water-plastic",
                    help="bench scene (default: the Cornell-box-with-mesh)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--intersector", default="bvh")
    ap.add_argument("--spp", type=int, default=1,
                    help="samples per frame (fused into wavefronts of up to "
                         "--fuse samples)")
    ap.add_argument("--bake-materials", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="override cfg.bake_materials either way "
                         "(TPU-only, inert in the port)")
    ap.add_argument("--row-tiles", type=int, default=1,
                    help="sequential row tiles per frame (cfg.row_tiles)")
    ap.add_argument("--fuse", type=int, default=None,
                    help="override cfg.fuse_samples (max samples fused into "
                         "one wavefront)")
    ap.add_argument("--resolve-gather", choices=("rows", "cols", "percol"),
                    default=None, help="accepted and inert: the TPU package's "
                                       "resolve-gather lowering")
    ap.add_argument("--prefix-sort", action=argparse.BooleanOptionalAction,
                    default=None, help="cfg.prefix_sort (bounce sorts at the "
                                       "live ladder's rung width)")
    ap.add_argument("--sort-lowering", choices=("variadic", "gather"), default=None,
                    help="accepted and inert: the TPU package's sort lowering")
    ap.add_argument("--sort-skip", default=None, metavar="B1,B2",
                    help="cfg.sort_bounce_skip (bounce indices whose wavefront "
                         "sort is skipped)")
    ap.add_argument("--cull-zero-nee", action=argparse.BooleanOptionalAction,
                    default=None, help="cfg.cull_zero_nee (skip shadow rays "
                                       "with exactly zero contribution)")
    ap.add_argument("--fuse-shadow", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="cfg.fuse_shadow_walk: one 2N-lane walk per bounce "
                         "serving the path nearest hit AND the NEE shadow query")
    ap.add_argument("--kernel", choices=("window", "minwalk", "sweep"), default=None,
                    help="cfg.traversal_kernel (sweep = the navigation-free "
                         "dense march for secondary bounces)")
    ap.add_argument("--utilization", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="emit the kernel-measured walk-utilization block "
                         "(spent/useful lane-ops per ray, per 32-lane warp)")
    ap.add_argument("--mesh", default=None, metavar="TILESxSPP",
                    help="multi-device aggregate bench (not ported yet)")
    ap.add_argument("--progressive", action="store_true",
                    help="also measure progressive spp/s on the cornellbox scene "
                         "at the same resolution")
    ap.add_argument("--platform", choices=("auto", "gpu", "cpu"), default="auto",
                    help="'auto' and 'gpu' need a CUDA device and raise without "
                         "one; 'cpu' runs the kernels' plain torch versions")
    return ap


# Each flag whose feature is not ported yet: (set?, flag, ROADMAP.md item).
def _unported(args) -> list[tuple[bool, str, str]]:
    return [
        (args.mesh is not None, "--mesh", "queue 1: multi-device"),
    ]


def _frame_times(renderer, warmup: int, frames: int) -> list[float]:
    """Seconds of each of ``frames`` frames after ``warmup`` frames, each
    ended by a device synchronise."""
    for _ in range(warmup):
        renderer.step()
    renderer.sync()
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        renderer.step()
        renderer.sync()
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    for on, flag, item in _unported(args):
        if on:
            raise NotImplementedError(f"{flag} is not ported to tpu_pathtracer_torch "
                                      f"yet (ROADMAP.md {item})")
    device = device_for(args.platform)
    label = device_label(device)

    over = {}
    if args.bake_materials is not None:
        over["bake_materials"] = args.bake_materials
    if args.prefix_sort is not None:
        over["prefix_sort"] = args.prefix_sort
    if args.sort_skip is not None:
        over["sort_bounce_skip"] = args.sort_skip
    if args.cull_zero_nee is not None:
        over["cull_zero_nee"] = args.cull_zero_nee
    if args.fuse is not None:
        over["fuse_samples"] = args.fuse
    if args.resolve_gather is not None:
        over["resolve_gather"] = args.resolve_gather
    if args.sort_lowering is not None:
        over["sort_lowering"] = args.sort_lowering
    if args.fuse_shadow is not None:
        over["fuse_shadow_walk"] = args.fuse_shadow
    if args.kernel is not None:
        over["traversal_kernel"] = args.kernel
    cfg = RenderConfig(samples_per_frame=args.spp, max_path_length=args.depth,
                       intersector=args.intersector, row_tiles=args.row_tiles, **over)

    from .render.stats import count_traced_rays_exact, utilization_report
    from .renderer import Renderer

    r = Renderer(args.scene, width=args.width, height=args.height, cfg=cfg,
                 device=device)
    # individually synchronised frames: the median is the headline
    # denominator, the best the stall-free floor; all samples print
    times = _frame_times(r, args.warmup, args.frames)
    frame_time = float(np.median(times))
    best = min(times)
    hud_mrays = args.width * args.height / frame_time / 1e6

    # EXACT in-pipeline counters over the very frame indices measured above
    measured = tuple(range(args.warmup, args.warmup + args.frames))
    t_tr = time.perf_counter()
    traced = count_traced_rays_exact(r.scene, cfg, args.height, args.width,
                                     frame_indices=measured, intersect=r._intersect,
                                     camera=r.camera, seed=0)
    traced_count_s = time.perf_counter() - t_tr
    mrays = traced / frame_time / 1e6

    img = r.image()
    result = {
        "metric": f"traced_mrays_per_sec_per_chip_1080p_{args.spp}spp",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "hud_mrays_per_s": round(hud_mrays, 3),
        "rays_traced_per_frame": int(traced),
        "ms_per_frame": round(frame_time * 1e3, 3),
        "mean_ms_per_frame": round(float(np.mean(times)) * 1e3, 3),
        "best_ms_per_frame": round(best * 1e3, 3),
        "best_mrays_per_s": round(traced / best / 1e6, 3),
        "frame_times_ms": [round(t * 1e3, 1) for t in times],
        "spp_per_sec": round(args.spp / frame_time, 4),
        "scene": args.scene,
        "resolution": f"{args.width}x{args.height}",
        "path_depth": args.depth,
        "device": label,
        "mesh": args.mesh,
        "finite": bool(np.isfinite(img).all()),
        "image_mean": round(float(img.mean()), 5),
        "package": "tpu_pathtracer_torch",
    }
    # the utilization block prices the kernel walk: no layout (brute) or no
    # kernels (the portable walker) has none, as in the reference
    if args.utilization and r.layout is not None and cfg.use_pallas:
        if cfg.traversal_kernel != "window":
            # the reference prints the same error field: only the window
            # walk is instrumented
            result["utilization"] = {"error": "utilization telemetry instruments "
                                     "the window walk only"}
        else:
            t_ut = time.perf_counter()
            result["utilization"] = utilization_report(
                r.scene, cfg, r.layout, args.height, args.width, r._intersect,
                traced, frame_time)
            result["utilization"]["collect_s"] = round(time.perf_counter() - t_ut, 1)
    result["traced_count_s"] = round(traced_count_s, 1)

    if args.progressive:
        rc = Renderer("cornellbox", width=args.width, height=args.height, cfg=cfg,
                      device=device)
        ct = float(np.median(_frame_times(rc, args.warmup, args.frames)))
        result["cornellbox_spp_per_sec"] = round(args.spp / ct, 4)
        result["cornellbox_ms_per_frame"] = round(ct * 1e3, 3)

    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
