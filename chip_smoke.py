#!/usr/bin/env python3
"""Smoke test of tpu_pathtracer_torch on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels from tpu_pathtracer_torch/csrc, one
   nvcc per source, in parallel;
3. kernels: each kernel against its plain torch version on the card, on
   65,536 lanes of the real CornellBox-Water-plastic 1080p camera, bounce-1
   and shadow wavefronts (the any-hit walk on the shadow pack of the same
   frame lit by a synthetic 1024x2048 environment map); times both at that
   size and the kernel on the full wavefront, and the capped walk on the
   full env-lit pack beside the any-hit walk; every form of the window walk
   (original-id, counting, the payload epilogue; bw and mt rows) against the
   (t, row) form on every lane of the whole camera, bounce-1 and shadow
   wavefronts (t and row equal, the epilogue's 12 rows equal to the torch
   payload rows over them), and minwalk against the MT epilogue form there
   (t, id, material and light equal); the window walk, the capped walk,
   minwalk and the sweep
   also get their bound on the whole wavefront (the plain walk run over it in
   chunks under one tally) beside their time there, and the any-hit walk on
   the whole env-lit pack; the capped walk's four rows equal its plain
   version's on every lane; then the edge shapes: 1, 31, 33 and 65,537
   lanes, every lane dead, one live lane a warp, prepass 0 and 32, and the
   leaf-16 and leaf-8 layouts, each form bit-equal to its plain version; the
   two shadow walks the same on the shadow pack's lanes with environment
   lanes and infinite caps, on leaf 56, 16 and 8;
4. main path: Renderer("CornellBox-Water-plastic", 1920, 1080), default
   config, 2 warm-up + 3 timed frames; exact traced rays, a per-stage CUDA
   event breakdown, and each kernel's launch count in that run (9 uniforms,
   8 epilogue walks, 8 shadings and 7 sorts of a key and a gather a frame);
5. parity: 150x200, depth 8, 16 frames against the committed self-golden
   (rel_mse < 1e-3, 0.999 < mean_ratio < 1.001);
6. CLI env path: ``tpu_pathtracer_torch.cli.main`` at 1920x1080, depth 8,
   5 frames with ``--env`` (the map written as EXR), EXR + PNG +
   checkpoint, then a resumed 1-frame run; and a 150x200 thin-lens frame;
7. env parity: 150x200, depth 8, 16 frames with the map, any-hit walk
   against the capped walk (rel_mse < 1e-3, 0.999 < mean_ratio < 1.001);
8. bench: ``tpu_pathtracer_torch.bench.main`` at 1920x1080, depth 8, with
   the default flags (5 frames, with the utilization block), then
   ``--kernel minwalk``, ``--kernel sweep`` and ``--fuse-shadow`` (3 frames
   each); each JSON line echoed, each run's own kernel launched and no plain
   version run on a CUDA tensor;
9. variant parity: the self-golden gate of phase 5 for minwalk, sweep and
   the fused path+shadow walk, and for tritest="mt" alone, with the sweep
   and with the fused walk;
10. terrain kernels: the production-scale scenes, tests/test_scale.py's
    procedural terrain at GRID 256 (130,052 triangles) and GRID 724
    (1,045,460), built with ``build_scene``; on 65,536 lanes of each
    terrain's 1080p camera, bounce-1 and shadow wavefronts, the MT window
    walk and its original-id and counting forms, the HBM route's window
    walk (nearest and t_max-capped), and at GRID 256 the MT sweep, each
    against its plain version and timed there and on the full wavefront;
    every window-walk form (and the HBM route's wrapper, with both
    epilogues) against the (t, row) form on every lane of the whole camera,
    bounce-1 and capped shadow wavefronts, bw and mt; the MT walk's and the
    HBM route's
    bounds on the whole wavefronts, and at GRID 256 those of the MT fused
    walk, counting walk and sweep;
11. terrain path: Renderer(build_scene(terrain), 1920, 1080), default
    config, SAH: the route must be the HBM route, as the reference's
    selection gives; 2 warm-up + 3 timed frames, exact rays and spans, the
    HBM window walk launched and no other kernel; again with
    tritest="mt" (every launch the MT form; and its counting walk through
    the utilization block), and at GRID 724 with 2 timed frames; then the
    HBM route and the whole-table route (hbm_tables="off") in turns at both
    sizes, with each route's walk time per frame beside its frame time (the
    default camera sees the terrain in ~13% of its pixels, so the walks are
    a fifth to a third of a frame);
12. LBVH on the card: the GRID 256 layout built with builder="lbvh" on
    CUDA tensors equals the CPU build table for table;
13. terrain and backend parity (150x200, depth 8, 16 frames, the limits of
    phase 5): the terrain's HBM-route image against its whole-table-route
    image, the LBVH-built terrain against the SAH-built one, and cornellbox
    through the portable walker (use_pallas=False) and the brute backend
    against its kernel route;
14. candidate-sweep kernels: on 65,536 lanes of the Water-plastic 1080p
    camera and bounce-1 wavefronts, on the leaf-56 layout (prepass 32) and
    the leaf-8 layout, ``sweep_count`` and ``intersect_sweep1``
    (scripts/experimental_sweep.py) against their plain versions: counts
    and first leaves equal on every lane, t, u, v, row and orig equal; the
    count on the whole bounce-1 wavefront against its plain version on
    every lane, both layouts, and both kernels' bounds there; the device
    time of a call of the targeted kernel on Water-plastic's bounce-1 lanes
    with at most one candidate (its three launches, queued behind a spin
    kernel); then the GRID 256 terrain's whole bounce-1 wavefront on its
    leaf-8 layout (many tiles of boxes): the count equal to its plain
    version on every lane, both kernels timed beside their bounds;
15. candidate split at full width: on the whole 2,073,600-lane camera and
    bounce-1 wavefronts of Water-plastic (both layouts) and on the GRID 256
    terrain (65,536 live lanes on both layouts, the whole wavefronts on
    leaf 56): ``sweep_count``, then ``intersect_sweep1`` on the lanes with
    at most one candidate leaf, then the MT window walk with the same
    prepass on all lanes; on every such lane the resolved hit must equal the
    window walk's (hit or miss, triangle id, t bit for bit: both test the
    same rows in the same order with the same arithmetic), and a lane
    with no candidate must be a miss or a prepass hit; prints the share of
    lanes with 0, 1 and more candidates, the mean and p95 count, and the ms
    of the count kernel, the targeted kernel, the window walk on all lanes
    and the window walk on the lanes with more than one candidate;
16. launch probe: the no-op against its plain version at each tile, and
    against ``zeros`` + ``copy_`` in ten rounds of turns at 65,536 and
    2,073,600 lanes (median, quartiles and range of each);
    then ``scripts/perf_launch.main()`` at 1080p, its lines echoed; the
    no-op and the all-dead capped and window walks must have launched, and
    no plain version may have run on a CUDA tensor;
17. row-test probe: each of the six variants against its plain version on
    65,536 lanes and, launched on the tool's own inputs at its 1080p lanes,
    on every 32nd lane; then ``scripts/perf_ophit_probe.main()`` with the
    default flags (1080p lanes, 7112 rows), its ``ROW`` lines echoed, each
    variant's time beside its bound;
18. frame modes: the reference's Mitsuba gates (assets/reference/,
    cornellbox at depth 2 and 8 and white-box at depth 2; 75x100, 48 spp
    in one frame, fused two samples a wavefront; rel_mse < 0.05, 0.95 <
    mean_ratio < 1.05); at 1080p, depth 8, frame 0 of each mode against
    its partner: fuse 2 against fuse 1 at 2 spp (atol 1e-6, rtol 1e-5), 2
    row tiles against none (atol 2e-6), prefix_sort and
    sort_bounce_skip="1,4,5" against the default sorts (atol 2e-6, rtol
    1e-5), cull_zero_nee bit-equal, and the fused path+shadow walk at 2 spp
    (8,294,400 lanes) against separate walks (the gate of phase 5); the
    unsorted pipeline (sort_rays=False) against the self-golden (the gate
    of phase 5); TILED and r2 card frames against the port's own CPU
    frames (48x64, depth 4; atol 1e-5 on all but 3 pixels);
    ``bench --spp 2 --fuse 2`` and the CLI with ``--spp-per-frame 2
    --row-tiles 2 --noise tiled --env``, each run launching the kernels its
    path reaches; then fuse 2 against fuse 1 (2 spp) and sorted against
    unsorted frames in turns (1 warm-up + 2 timed frames, one staged, one
    profiled a turn): ms per frame and per sample, the walk and sort spans,
    device time and kernels a frame, and the launches a frame and a sample
    of the window and capped walks.
19. spectral and material path: the user's spectral command,
    ``cli.main`` at 1920x1080, depth 8, 5 frames with ``--spectrum 16
    --hero 4 --dispersion 0.0042`` (EXR + PNG; the EXR must read back
    finite, (1080, 1920, 3)), launching the window and capped walks and 8
    shadings a frame, and the same with ``--env`` launching the any-hit
    walk; card frames against the port's own CPU frames (48x64, depth 4, 2
    frames; atol 1e-5 on all but 3 pixels) for S = 8, S = 16 with hero 4 and
    dispersion, bake_materials on Water-plastic, the GGX floor with
    conductor and plastic Ks, the textured floor and the glass pane with
    refract_dielectric (the scenes of the reference's own tests, written
    to a temporary directory); at 1080p, depth 8, frame 0: hero (S = 16, C
    = 4) fuse 2 against fuse 1 at 2 spp (atol 1e-6, rtol 1e-5), hero with
    prefix_sort against the default sorts (atol 2e-6), bake_materials
    (inert on the card) against unbaked (bit-equal), and the GGX and
    textured scenes finite, each launching the window and capped walks;
    ``bench --bake-materials`` with its counting walk; then S = 3, S = 16
    with hero 4 and S = 16 in turns (1 warm-up + 2 timed frames, one
    staged, one profiled a turn);
20. multi-device: virtual meshes that name ``cuda:0`` more than once
    (Water-plastic, 1080p, depth 8): 1x1 (3 frames) bit-equal to
    Renderer() with the same launches a frame, 2x1 bit-equal, 1x2 and 2x2
    at 2 spp within 2e-6 of Renderer() at 2 spp, the env-lit 2x1 mesh
    bit-equal (the any-hit walk); the self-golden gate of phase 5 on 2x1,
    and its limits on 2x2 at 2 spp against Renderer() at 2 spp (the golden
    holds 1-spp frames, which a mesh of 2 sample shards cannot split); two
    processes on the card joined by gloo on 127.0.0.1, a 2x1 multihost mesh
    with a tile each (``multihost_worker``, under a 240 s timeout): each
    gathered image bit-equal to the single-process frame, and the directory
    checkpoint both wrote holding it; the 2x1 mesh's directory checkpoint
    resumed on 1x1 and on no mesh, the next frame bit-equal; ``bench --mesh
    1x1``; then no mesh, 1x1 and 2x1 in turns (1 warm-up + 2 timed frames
    and one profiled frame a turn): ms/frame, device ms and kernels a frame,
    walk launches a frame;
21. the XLA-fused stages as hand kernels: ``uniforms`` (counts 1-10) and
    ``uniforms_r2`` (counts 4, 6, 10) of csrc/rng.cu against their plain
    versions bit for bit on EDGE_LANES, 0 lanes and the frame's 2,073,600
    ids of a fused sample past 2^31, with frames, salts and bounces that
    wrap; the window walk's payload epilogue (``window_walk_resolve``)
    against its plain version on all 12 rows of 65,536 camera and bounce-1
    lanes, BW and MT (every lane of the whole wavefronts against the (t,
    row) walk plus the torch rows: phases 3 and 10, GRID 256 and 724 on the
    HBM route there too); each kernel's time at 65,536 and 2,073,600
    lanes beside its bound and its plain version's, the epilogue in turns
    with the window walk alone; then the main path and the env-lit path
    (1080p, depth 8) with the kernels and with the plain versions put back
    (``plain_stages``), in turns: ms/frame, walk_nearest, device ms and
    kernels a frame, every frame bit-equal; and the self-golden gate at the
    default path's rel_mse 1.5807e-8 or better;
22. the shading and the wavefront sort as hand kernels: ``shade_bounce``
    (csrc/shade.cu, both forms of the bounce) in its parity, env-lit, hero
    and hero-with-env forms (the main path; the env-lit path; S = 16, hero 4
    and dispersion 0.0042, without and with the env), ``sort_key`` and
    ``gather_planes`` (csrc/wavefront_sort.cu; pixel and alive read from
    the sorted key, as the frame calls it, and every plane gathered)
    against their plain versions bit for bit on every lane of the path's
    whole camera and bounce-1 wavefronts (the sorts after bounces 1 and 2
    of the main path, of the hero plane set and of S = 16) and on 65,536
    lanes drawn from them; the env forms also on a map with a NaN texel,
    which fails the map check and takes the every-lane path; their times
    (queued) beside their bounds, the plain versions', torch.sort's and
    ATen's index_select a plane (queued); the 32-byte sectors the gather's
    reads touch and its sector floor; the env-lit frame's lanes that miss,
    bounce by bounce; then the main path, the unsorted frame, the fused walk,
    prefix sorts, the env-lit path and the spectral CLI configuration
    without and with the env (1080p, depth 8) with the kernels and with the
    plain shading and sort put back (``plain_stages(SHADE_SORT_STAGES)``),
    in turns: ms/frame, device ms, kernels a frame, the sort and walk spans,
    every frame bit-equal, the launches a frame asserted (8 shadings on
    every one, as ops/shade.py:shade_kernel_covers holds; 7 keys and
    gathers on the sorted pipelines); and the self-golden gate again.

The main path's frame (phase 4) launches 9 ``uniforms``, 8
``window_walk_resolve``, 8 ``shade_bounce``, 7 ``sort_key`` and 7
``gather_planes`` a frame, the capped walk, and nothing else.

Phase 3 also holds the bench's four kernels against their plain versions
on 65,536 lanes of the same wavefronts: minwalk on camera and bounce-1
lanes (payload to atol 1e-6), the sweep on bounce-1, the window walk with
the original-id latch on bounce-1 paths plus their shadow pack (clear masks
equal), and the counting walk on bounce-1 and the shadow pack (useful rows
equal, spent within its warp bounds).

Every kernel's bound is the larger of the bytes it must move over
3.35 TB/s and the float32 operations its walk did on these lanes, as
FMA-equivalent flops, over 67 TFLOP/s (the H100 SXM data sheet's rates at
700 W).  That rate counts an FMA as 2 flops; the kernels (built with
--fmad=false) issue each add, mul, min, max and compare on its own, each
in an FMA's slot, so each counts 2.  Both count what these lanes need,
from the plain version's walk (ops/traverse.py:Tally): each ray read once,
each output written once, each distinct node and leaf row the walk read
moved once (the sweep: every row), the prepass block once; a box test per
node visit and a row test per row tested (a node is the 32 bytes of its
``nodes_packed`` row).  The targeted sweep ends at its
lowest candidate leaf, so its box tests are the ones up to that leaf (every
leaf on a lane with no candidate); the count kernel needs every leaf.
The uniforms move the int64 id in and ``count`` float32 rows out a lane,
their integer operations (32 a PCG4D call) each in an FMA's slot; the
epilogue form is the window walk's bound with 48 bytes of payload out, one
96-byte MT row read and the resolve's operations a lane.  The shading moves
(175 + 20 C) bytes a lane, C its carried planes (12 more in the inline form,
8 C of hero bins; with an env its four uniform rows, the alias slot and
sampled texel on the lanes whose NEE picks it and the eval's texel on the
live lanes that missed) and the scene tables once, its ~360 + 10 C
operations a lane (the env's and the dispersion's more) below that; the
sort's key 41 bytes a lane, the gather the permutation and each plane in and
out once.

The line before the last is the kernel table as JSON (launches: the run of
the path that drives each kernel -- the main path for the epilogue form
(``window_walk_resolve``), the uniforms, the capped walk, the shading and
the sort's two kernels, the CLI env path for the any-hit walk, the r2 card
frames of phase 18 for
``uniforms_r2``, the launch probe's run for ``window_walk`` (the form without
the epilogue, which no frame path launches: its all-dead lanes), the bench
runs for the bench's four, the terrain path for the HBM route and, with tritest="mt", for the MT window walk and its
counting form, the tritest="mt" gates for the MT fused walk and sweep,
which the terrain's HBM route does not run; the kernel-research tools are on
no frame's path: ``sweep_count`` and ``sweep1`` count the split runs of phase
15, ``noop`` the ``perf_launch.main()`` run and ``rowtest_probe`` the
``perf_ophit_probe.main()`` run, none of them the launches that compare a
kernel with its plain version or time it; the rows of the probe, the count
and the targeted kernel carry their ptxas registers and spills per instance
(``registers``), the count's and the targeted kernel's also their times on
the terrain's whole bounce-1 wavefront (``terrain_full_ms``); the epilogue form,
the capped walk, the fused walk, the shading and the sort's two kernels also
carry ``launches_per_sample_fuse2``, their launches a sample in a 2-spp frame
at fuse 2, from phase 18, and the epilogue form, the capped and any-hit walks,
the shading and the sort's kernels ``launches_per_frame_spectral``, their
launches a frame on phase 19's spectral CLI path, and
``launches_per_frame_mesh2x1``, their launches a frame on phase 20's 2x1
mesh, the any-hit walk's env-lit; the shading's row carries phase 22's
turns and its env-lit, hero and hero-with-env forms' readings (``forms``),
the gather's row ATen's index_select time as ``library_ms``, its sector
counts and its other plane sets' times); the last line is
{"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

SCENE = "CornellBox-Water-plastic"
WIDTH, HEIGHT = 1920, 1080
SAMPLE_LANES = 65536
ID_AGREE = 0.9999      # ids equal, or an equal-t tie, on at least this share
T_RTOL = 1e-6          # t agreement; bit-equal expected under --fmad=false
PARITY = (1e-3, 0.999, 1.001)  # rel_mse <, mean_ratio in (lo, hi)
PARITY_FRAMES = 16
KERNELS = ("window_walk", "capped_walk", "anyhit_walk", "minwalk", "sweep",
           "window_walk_orig", "window_walk_counts", "window_walk_hbm",
           "sweep_count", "sweep1", "noop", "rowtest_probe",
           "window_walk_resolve", "uniforms", "uniforms_r2",
           "shade_bounce", "sort_key", "gather_planes")
# the frame paths' nearest-hit wrapper (the window walk with its payload
# epilogue), and the kernels of the main path's frame: nearest hits, shadow
# rays, uniforms, the shading, the sort's key and gather
NEAREST = "window_walk_resolve"
SHADE_SORT = ("shade_bounce", "sort_key", "gather_planes")
MAIN_PATH = (NEAREST, "capped_walk", "uniforms", *SHADE_SORT)
# the kernels whose wrapper is not ops/hopper_traverse.<name>: module, wrapper,
# its plain version
KERNEL_HOMES = {
    "sweep_count": ("scripts.experimental_sweep", "sweep_count", "sweep_count_plain"),
    "sweep1": ("scripts.experimental_sweep", "intersect_sweep1", "intersect_sweep1_plain"),
    "noop": ("scripts.perf_launch", "noop", "noop_plain"),
    "rowtest_probe": ("scripts.perf_ophit_probe", "rowtest_probe", "rowtest_probe_plain"),
    "uniforms": ("ops.rng", "uniforms", "uniforms_plain"),
    "uniforms_r2": ("ops.rng", "uniforms_r2", "uniforms_r2_plain"),
    "shade_bounce": ("ops.shade", "shade_bounce", "shade_bounce_plain"),
    "sort_key": ("ops.wavefront_sort", "sort_key", "sort_key_plain"),
    "gather_planes": ("ops.wavefront_sort", "gather_planes", "gather_planes_plain")}
PAYLOAD_ATOL = 1e-6    # minwalk's position and normal, kernel vs plain (rsqrt)
VARIANTS = {           # the bench's kernel switches: config and the kernel each adds
    "minwalk": ({"traversal_kernel": "minwalk"}, "minwalk"),
    "sweep": ({"traversal_kernel": "sweep"}, "sweep"),
    "fused": ({"fuse_shadow_walk": True}, "window_walk_orig"),
}
MT_VARIANTS = {        # the self-golden gates of tritest="mt": config, kernel form
    "mt": ({"tritest": "mt"}, NEAREST),
    "mt+sweep": ({"tritest": "mt", "traversal_kernel": "sweep"}, "sweep"),
    "mt+fused": ({"tritest": "mt", "fuse_shadow_walk": True}, "window_walk_orig"),
}
TERRAIN_GRIDS = (256, 724)  # 130,052 and 1,045,460 triangles
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at 700 W
FP32_FLOPS_PER_S = 67e12    # the same sheet; an FMA counts 2 flops
FLOPS_PER_OP = 2            # a lone add, mul, min, max or compare takes an FMA's slot
# float32 operations of one test (each add, mul, div, min, max, compare 1):
OPS_BOX = 25   # slab: 6 sub, 6 mul, 10 min/max, 3 compares
OPS_ROW = {"bw": 38, "mt": 52}  # a Baldwin-Weber / Moller-Trumbore row test
FULL_STRIDE = 32  # the row-test probe's full-width check holds every 32nd lane
FULL_CHUNK = 524288  # lanes a plain walk takes at once when it prices a whole wavefront
PACKED_NODE_BYTES = 32  # a node of the walks: one nodes_packed row
EDGE_LANES = (1, 31, 33, 65537)
LAUNCH_ROUNDS = 10  # rounds of turns of the no-op against zeros + copy_
OPS_LEAF_BOX = OPS_BOX + 1  # a candidate sweep's box test and its first-leaf min
SRC = "tpu_pathtracer_torch/csrc/"
REF = "tpu_pathtracer/ops/pallas_traverse.py:"
REF_SCRIPTS = "scripts/"


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, stamped with the seconds since the
    script started."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` runs after one
    warm-up, from CUDA events (host gaps inside ``fn`` included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi


def phase_build() -> str:
    """Build the kernels -> the compiler's output (ptxas -v)."""
    from tpu_pathtracer_torch.ops import cuda_build

    path, seconds, compiler_log = cuda_build.build()
    log(f"build: {os.path.relpath(path)} in {seconds:.1f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    cuda_build.load_library()
    return compiler_log


def kernel_registers(compiler_log: str, symbol: str) -> dict:
    """ptxas's registers and spill bytes of each instance of the kernel
    ``symbol`` in the build output -> {its integer and bool template
    arguments joined by commas ("-" for none): {"registers": r,
    "spill_bytes": b}}."""
    out, cur = {}, None
    for line in compiler_log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            m = re.search(rf"\d{symbol}(I(?:L[a-z]+-?\d+E)+E)?", entry.group(1))
            cur = (",".join(re.findall(r"L[a-z]+(-?\d+)E", m.group(1) or "")) or "-") if m else None
            if cur:
                out[cur] = {"registers": None, "spill_bytes": 0}
        elif cur and "spill stores" in line:
            out[cur]["spill_bytes"] = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out[cur]["registers"] = int(m.group(1))
    return out


def sky_map(height: int = 1024, width: int = 2048, seed: int = 2026) -> np.ndarray:
    """A synthetic lat-long HDR map from a fixed seed: a sky gradient over a
    dim ground, a small bright sun, and 5% texel noise."""
    rng = np.random.default_rng(seed)
    theta = np.pi * (np.arange(height) + 0.5) / height          # 0 = zenith
    phi = 2.0 * np.pi * (np.arange(width) + 0.5) / width - np.pi
    up = np.clip(np.cos(theta), 0.0, 1.0)[:, None, None]
    sky = np.asarray([0.35, 0.55, 0.95]) * (0.4 + 0.6 * up) + 0.1
    img = np.where(np.cos(theta)[:, None, None] > 0, sky, 0.12) * np.ones((1, width, 1))
    ts, ps = rng.uniform(0.3, 1.1), rng.uniform(-np.pi, np.pi)
    cos_g = (np.sin(theta)[:, None] * np.sin(ts) * np.cos(phi[None] - ps)
             + np.cos(theta)[:, None] * np.cos(ts))
    img[cos_g > np.cos(0.03)] = (800.0, 760.0, 700.0)
    img *= rng.uniform(0.95, 1.05, img.shape)
    return img.astype(np.float32)


def wavefronts(scene, layout, layout_occl, cfg):
    """The port's own 1080p frame-0 wavefronts: camera rays, the sorted
    bounce-1 path rays, and bounce 0's shadow rays (after that sort)."""
    from tpu_pathtracer_torch.models.camera import Camera, generate_rays_flat
    from tpu_pathtracer_torch.ops.hopper_traverse import make_cuda_intersector
    from tpu_pathtracer_torch.ops.rng import fold_in, prng_key
    from tpu_pathtracer_torch.render import noise, state, wavefront
    from tpu_pathtracer_torch.render.order import make_order

    dev = scene.p0.device
    key = state.fused_wavefront_key(state.frame_rng_key(cfg, prng_key(0), 0))
    order = make_order(HEIGHT, WIDTH, 0, cfg.traversal_tile, device=dev)
    pids = noise.pids_from_order(order, WIDTH)
    jitter = noise.camera_jitter(cfg, fold_in(key, 0xC0FFEE), 0, pids, HEIGHT, WIDTH)
    o, d = generate_rays_flat(Camera(), order.rows, order.cols, jitter[0:2],
                              HEIGHT, WIDTH)
    st0 = wavefront.initial_path_state(o, d, cfg.spectrum_samples, pids)
    isect = make_cuda_intersector(layout, layout_occl, prepass=cfg.traversal_prepass)
    uniforms = noise.bounce_uniforms(cfg, key, 0, 0, pids, HEIGHT, WIDTH,
                                     with_env=scene.env is not None)
    st1, pack = wavefront.trace_bounce(scene, cfg, isect, 0, st0, uniforms,
                                       coherent=True, defer_shadow=True)
    wmin, winv = wavefront.scene_sort_bounds(scene)
    st1, pack = wavefront.sort_wavefront(st1, wmin, winv, pack)
    return {
        "camera": (o, d, st0.alive),
        "bounce1": (st1.origin.contiguous(), st1.direction.contiguous(), st1.alive),
        "shadow": (st1.origin.contiguous(), pack.to_light.contiguous(), pack.ok,
                   pack.cap.contiguous(), pack.target.to(torch.int32).contiguous()),
    }


def draw(arrays, n: int, gen: torch.Generator, live=None):
    """``n`` lanes of the wavefront ``arrays`` drawn at random (from the
    lanes where ``live`` is true, when given)."""
    pool = live.nonzero()[:, 0].cpu() if live is not None else None
    size = pool.shape[0] if pool is not None else arrays[0].shape[-1]
    idx = torch.randperm(size, generator=gen, device="cpu")[:n]
    if pool is not None:
        idx = pool[idx]
    idx = idx.to(arrays[0].device)
    return tuple(a.index_select(-1, idx).contiguous() for a in arrays)


def two_n(o, d, alive, sdir, sok, scap, tgt):
    """The fused walk's 2N lanes (o, d, active, t_max): the path lanes
    (uncapped), then their shadow lanes from the same origins."""
    return (torch.cat([o, o], 1).contiguous(), torch.cat([d, sdir], 1).contiguous(),
            torch.cat([alive, sok]).contiguous(),
            torch.cat([torch.full_like(scap, torch.inf), scap]).contiguous())


def agree(name, t_k, id_k, t_p, id_p):
    """Kernel vs plain: ids equal or an equal-t tie on >= ID_AGREE of the
    lanes, every mismatch a tie, t equal to T_RTOL.  Returns max |dt|."""
    fin_k, fin_p = torch.isfinite(t_k), torch.isfinite(t_p)
    if not torch.equal(fin_k, fin_p):
        raise AssertionError(f"{name}: hit/miss differs on "
                             f"{int((fin_k != fin_p).sum())} lanes")
    both = fin_k
    dt = (t_k - t_p).abs()[both]
    tol = T_RTOL * t_p.abs()[both]
    if bool((dt > tol).any()):
        raise AssertionError(f"{name}: t differs beyond rtol {T_RTOL} on "
                             f"{int((dt > tol).sum())} lanes (max {float(dt.max())})")
    mism = both & (id_k != id_p)
    if not torch.equal(t_k[mism], t_p[mism]):
        raise AssertionError(f"{name}: an id mismatch is not an equal-t tie")
    share = 1.0 - float(mism.sum()) / max(int(both.sum()), 1)
    if share < ID_AGREE:
        raise AssertionError(f"{name}: ids agree on {share:.6f} < {ID_AGREE}")
    bits = float((t_k[both] != t_p[both]).float().mean()) if bool(both.any()) else 0.0
    max_err = float(dt.max()) if dt.numel() else 0.0
    log(f"  {name}: {int(both.sum())} hits, id mismatches (ties) "
        f"{int(mism.sum())}, max |dt| {max_err:.3g}, t not bit-equal on "
        f"{bits:.4%} of hits")
    return max_err


class Work(NamedTuple):
    """What a walk does on its lanes (ops/traverse.py:Tally)."""
    visits: int   # node visits, summed over lanes
    tests: int    # leaf-row tests, summed over lanes
    nodes: int    # distinct nodes read
    rows: int     # distinct leaf rows read


def plain_work(fn, *args, **kw):
    """A plain version's output and the work of its walk on these inputs ->
    (out, :class:`Work`)."""
    from tpu_pathtracer_torch.ops.traverse import Tally

    tally = Tally()
    out = fn(*args, **kw, tally=tally)
    if tally.nodes is None:  # no lane walked
        return out, Work(0, 0, 0, 0)
    return out, Work(tally.visits, tally.tests, int(tally.nodes.sum()),
                     int(tally.rows.sum()))


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of bytes over its
    memory rate and float32 operations, as FMA-equivalent flops, over its
    peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops * FLOPS_PER_OP / FP32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops}


def row_bytes(table) -> int:
    return table.shape[1] * table.element_size()


RAY_BYTES = 12 + 12 + 1 + 4  # o, d, active, t_max (or cap) of one lane


def walk_bound(lanes: int, in_bytes_per_lane: int, out_bytes_per_lane: int, rows,
               work: Work, row_ops: int, pre_rows=None, pre_tests: int = 0,
               lane_ops: int = 0) -> dict:
    """A walk's bound on these lanes: rays and outputs moved once, each
    distinct node (a ``nodes_packed`` row) and leaf row of ``rows`` the walk
    read moved once, and the ``pre_rows`` prepass block (tested
    ``pre_tests`` times); a box test per node visit, a row test per row
    tested and ``lane_ops`` operations a lane."""
    pre = 0 if pre_rows is None else pre_rows.numel() * pre_rows.element_size()
    return bound(lanes * (in_bytes_per_lane + out_bytes_per_lane)
                 + work.nodes * PACKED_NODE_BYTES + work.rows * row_bytes(rows) + pre,
                 work.visits * OPS_BOX + (work.tests + pre_tests) * row_ops
                 + lanes * lane_ops)


def window_bound(lay, act, work: Work, prepass: int, tritest: str, out_ints: int) -> dict:
    """The window walk's bound on these lanes: every active lane also tests
    the first ``prepass`` rows of the prepass block; outputs t plus
    ``out_ints`` int32 rows."""
    rows, pre = (lay.tris8, lay.prepass) if tritest == "mt" else (lay.tris8bw, lay.prepassbw)
    return walk_bound(act.shape[0], RAY_BYTES, 4 + 4 * out_ints, rows, work,
                      OPS_ROW[tritest], pre[:prepass], int(act.sum()) * prepass)


def minwalk_bound(lay, act, work: Work, prepass: int) -> dict:
    """Minwalk's bound on these lanes: the MT window walk's work on
    ``lay.tris``, 12 float32 output rows."""
    return walk_bound(act.shape[0], RAY_BYTES, 48, lay.tris, work, OPS_ROW["mt"],
                      lay.prepass[:prepass], int(act.sum()) * prepass)


def shadow_bound(lanes: int, walk: str, lay, work: Work) -> dict:
    """A shadow walk's bound on these lanes: o, d, active and the cap in
    (and the int32 target for the any-hit walk); 4 float32 rows (capped) or
    one byte (any-hit) out; the MT rows of ``lay.tris``."""
    anyhit = walk == "anyhit"
    return walk_bound(lanes, RAY_BYTES + 4 * anyhit, 1 if anyhit else 16, lay.tris, work,
                      OPS_ROW["mt"])


def full_work(fn, lanes, *rest, **kw) -> Work:
    """The work of the plain walk ``fn`` on a whole wavefront: ``lanes``
    (per-lane tensors, lanes last) go through it FULL_CHUNK at a time under
    one tally."""
    from tpu_pathtracer_torch.ops.traverse import Tally

    tally = Tally()
    for s in range(0, lanes[0].shape[-1], FULL_CHUNK):
        fn(*(a[..., s:s + FULL_CHUNK].contiguous() for a in lanes), *rest, **kw,
           tally=tally)
    if tally.nodes is None:
        return Work(0, 0, 0, 0)
    return Work(tally.visits, tally.tests, int(tally.nodes.sum()), int(tally.rows.sum()))


def at_full_width(name: str, what: str, ms: float, bnd: dict) -> dict:
    """A kernel's time on a whole wavefront beside its bound there -> the
    keys its row of the kernel table gains."""
    pct = 100.0 * bnd["bound_ms"] / ms
    log(f"  {name} on the full {what}: kernel {ms:.3f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), {pct:.2f}% of bound")
    return {"full_what": what, "bound_full_ms": bnd["bound_ms"],
            "bound_full_by": bnd["bound_by"], "full_pct_of_bound": pct}


def equal_on_every_lane(what: str, got, want) -> None:
    """Two kernels' outputs equal on every lane, bit for bit."""
    for k, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: output {k} differs on "
                                 f"{int((a != b).sum())} lanes")


def forms_equal(label: str, lay, o, d, act, t_max, prepass: int, tritest: str,
                hbm: bool = False) -> None:
    """Every form of the window walk against its (t, row) form on a whole
    wavefront: t and row equal on every lane, the payload epilogue's 12 rows
    equal to the torch payload rows over that walk (window_payload_rows), and
    with ``hbm`` the HBM route's wrapper in each form, its capped epilogue's
    4 rows equal to window_capped_rows."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht

    want = ht.window_walk(o, d, act, t_max, lay, prepass=prepass, tritest=tritest)
    forms = ("window_walk_orig", "window_walk_counts") + (("window_walk_hbm",) if hbm else ())
    for form in forms:
        got = getattr(ht, form)(o, d, act, t_max, lay, prepass=prepass, tritest=tritest)
        equal_on_every_lane(f"{form} vs window_walk, {label}", got[:2], want)
    rows = ht.window_payload_rows(lay, *want, t_max, o, d)
    resolved = {NEAREST: ht.window_walk_resolve(o, d, act, t_max, lay, prepass=prepass,
                                                tritest=tritest)}
    if hbm:
        resolved["window_walk_hbm(resolve=True)"] = ht.window_walk_hbm(
            o, d, act, t_max, lay, prepass=prepass, tritest=tritest, resolve=True)
    for form, got in resolved.items():
        equal_on_every_lane(f"{form} vs window_walk + window_payload_rows, {label}",
                            got, rows)
    capped = ""
    if hbm:
        equal_on_every_lane(
            f"window_walk_hbm(capped=True) vs window_walk + window_capped_rows, {label}",
            ht.window_walk_hbm(o, d, act, t_max, lay, prepass=prepass, tritest=tritest,
                               capped=True),
            ht.window_capped_rows(lay, *want, t_max, o, d))
        capped = ("; window_walk_hbm(capped=True): all 4 rows == window_walk + "
                  "window_capped_rows")
    torch.cuda.synchronize()
    query = "capped" if bool(torch.isfinite(t_max).any()) else "nearest"
    log(f"  {', '.join(forms)} == window_walk on all {o.shape[1]} lanes of {label} "
        f"({tritest}, {int(act.sum())} live, {query}); {', '.join(resolved)}: all 12 "
        f"rows == window_walk + window_payload_rows{capped}")


def sweep_bound(lay, act, tritest: str) -> dict:
    """The sweep's bound: every active lane tests rows 0 .. num_tris-1, each
    row moved once; outputs t and row."""
    rows = lay.tris8 if tritest == "mt" else lay.tris8bw
    work = Work(0, int(act.sum()) * lay.num_tris, 0, lay.num_tris)
    return walk_bound(act.shape[0], RAY_BYTES, 8, rows, work, OPS_ROW[tritest])


def kernel_entry(name: str, source: str, line, err: float, ms: float,
                 plain_ms: float, full_ms: float, bnd: dict, **extra) -> dict:
    """One kernel's row of the JSON table (launches are filled in later).
    ``line``: a line of ops/pallas_traverse.py, "file.py:line" under the
    reference's scripts/, or a path from the repo's root (``tpu_pathtracer/``)."""
    replaces = (f"{REF}{line}" if isinstance(line, int) else
                line if line.startswith("tpu_pathtracer/") else REF_SCRIPTS + line)
    return {"name": name, "route": "cuda", "source": SRC + source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "full_ms": full_ms, **bnd,
            **{"library_ms": None, **extra}}


class Priced(NamedTuple):
    """Water-plastic's whole wavefronts as phase 3 made them (``waves``:
    those of :func:`wavefronts` plus "env_shadow", the env-lit frame's shadow
    pack) and the work of the plain walks phase 3 priced them with, which
    the later phases reuse rather than walk again (``work``: the window walk
    on "camera" and "bounce1", BW rows and the window prepass; the capped
    walk on "shadow"; the any-hit walk on "env_shadow")."""
    waves: dict
    work: dict


def phase_kernels(renderer) -> tuple[list[dict], Priced]:
    from tpu_pathtracer_torch.ops import hopper_traverse as ht
    from tpu_pathtracer_torch.scene import attach_env

    lay, occl, cfg = renderer.layout, renderer.layout_occl, renderer.cfg
    waves = wavefronts(renderer.scene, lay, occl, cfg)
    gen = torch.Generator().manual_seed(1234)
    prepass = ht.window_prepass(lay, cfg.traversal_prepass)
    errs_a = []
    for which in ("camera", "bounce1"):
        o, d, act = draw(waves[which], SAMPLE_LANES, gen)
        t_max = torch.full_like(o[0], torch.inf)
        tk, rk = ht.window_walk(o, d, act, t_max, lay, prepass=prepass)
        (tp, rp), work_a = plain_work(ht.window_walk_plain, o, d, act, t_max, lay,
                                       prepass=prepass)
        torch.cuda.synchronize()
        errs_a.append(agree(f"window_walk/{which}", tk, rk, tp, rp))
    bound_a = window_bound(lay, act, work_a, prepass, "bw", 1)
    a_in = (o, d, act, t_max, lay)
    ms_a = cuda_ms(lambda: ht.window_walk(*a_in, prepass=prepass))
    plain_a = cuda_ms(lambda: ht.window_walk_plain(*a_in, prepass=prepass), iters=2)
    o, d, act = waves["camera"]
    full_t = torch.full_like(o[0], torch.inf)
    full_a = cuda_ms(lambda: ht.window_walk(o, d, act, full_t, lay, prepass=prepass))
    log(f"  window_walk at {SAMPLE_LANES} bounce-1 lanes: kernel {ms_a:.3f} ms, "
        f"plain {plain_a:.3f} ms; full camera wavefront ({o.shape[1]} lanes): "
        f"{full_a:.3f} ms")
    # every form against the (t, row) form on the whole wavefronts, nearest
    # and capped, both row layouts
    so, sd, sok, scap, _ = waves["shadow"]
    for tritest in ("bw", "mt"):
        for which in ("camera", "bounce1"):
            forms_equal(f"{SCENE} {which}", lay, *waves[which], full_t, prepass, tritest)
        forms_equal(f"{SCENE} shadow pack", lay, so, sd, sok, scap, prepass, tritest)
    priced = {w: full_work(ht.window_walk_plain, (*waves[w], full_t), lay, prepass=prepass)
              for w in ("camera", "bounce1")}
    full_extra = at_full_width("window_walk", "camera wavefront", full_a,
                               window_bound(lay, act, priced["camera"], prepass, "bw", 1))
    b1 = waves["bounce1"]
    full_b1 = cuda_ms(lambda: ht.window_walk(*b1, full_t, lay, prepass=prepass))
    b1_extra = at_full_width("window_walk", "bounce-1 wavefront", full_b1,
                             window_bound(lay, b1[2], priced["bounce1"], prepass, "bw", 1))
    full_extra.update(full_bounce1_ms=full_b1,
                      **{f"{k}_bounce1": v for k, v in b1_extra.items()})

    o, d, ok, cap, _ = draw(waves["shadow"], SAMPLE_LANES, gen)
    outk = ht.capped_walk(o, d, ok, cap, occl)
    outp, work = plain_work(ht.capped_walk_plain, o, d, ok, cap, occl)
    bound_b = shadow_bound(o.shape[1], "capped", occl, work)
    torch.cuda.synchronize()
    miss = lambda out: torch.where(out[0] < cap, out[0], torch.inf)  # noqa: E731
    err_b = agree("capped_walk/shadow", miss(outk), outk[3], miss(outp), outp[3])
    equal_on_every_lane("capped_walk vs its plain version (t, u, v, orig)", outk, outp)
    b_in = (o, d, ok, cap, occl)
    ms_b = cuda_ms(lambda: ht.capped_walk(*b_in))
    plain_b = cuda_ms(lambda: ht.capped_walk_plain(*b_in), iters=2)
    o, d, ok, cap, _ = waves["shadow"]
    full_b = cuda_ms(lambda: ht.capped_walk(o, d, ok, cap, occl))
    log(f"  capped_walk at {SAMPLE_LANES} shadow lanes: kernel {ms_b:.3f} ms, "
        f"plain {plain_b:.3f} ms; full shadow wavefront ({o.shape[1]} lanes, "
        f"{int(ok.sum())} live): {full_b:.3f} ms")
    priced["shadow"] = full_work(ht.capped_walk_plain, (o, d, ok, cap), occl)
    capped_extra = at_full_width("capped_walk", "shadow wavefront", full_b,
                                 shadow_bound(o.shape[1], "capped", occl, priced["shadow"]))

    # kernel C on the env-lit frame's shadow pack (area-light and env lanes)
    env_scene = attach_env(renderer.scene, sky_map())
    waves["env_shadow"] = wavefronts(env_scene, lay, occl, cfg)["shadow"]
    o, d, ok, cap, tgt = waves["env_shadow"]
    eps = cfg.distance_epsilon
    live = int(ok.sum())
    env_share = float((ok & (tgt < 0)).sum()) / max(live, 1)
    log(f"  env-lit shadow pack: {o.shape[1]} lanes, {live} live, env share "
        f"{env_share:.4f} (select_p {float(env_scene.env.select_p):.4f})")
    c_in = draw((o, d, ok, cap, tgt), SAMPLE_LANES, gen)
    ck = ht.anyhit_walk(*c_in, occl, eps)
    cp, work = plain_work(ht.anyhit_walk_plain, *c_in, occl, eps)
    bound_c = shadow_bound(SAMPLE_LANES, "anyhit", occl, work)
    torch.cuda.synchronize()
    bad = int((ck != cp).sum())
    if bad:
        raise AssertionError(f"anyhit_walk: clear masks differ on {bad} lanes")
    log(f"  anyhit_walk/shadow+env: clear masks equal on all {SAMPLE_LANES} lanes "
        f"({int(ck.sum())} clear of {int(c_in[2].sum())} live)")
    ms_c = cuda_ms(lambda: ht.anyhit_walk(*c_in, occl, eps))
    plain_c = cuda_ms(lambda: ht.anyhit_walk_plain(*c_in, occl, eps), iters=2)
    full_c = cuda_ms(lambda: ht.anyhit_walk(o, d, ok, cap, tgt, occl, eps))
    full_bc = cuda_ms(lambda: ht.capped_walk(o, d, ok, cap, occl))
    log(f"  anyhit_walk at {SAMPLE_LANES} env-lit shadow lanes: kernel {ms_c:.3f} ms, "
        f"plain {plain_c:.3f} ms; full env-lit pack ({o.shape[1]} lanes, {live} "
        f"live): any-hit {full_c:.3f} ms vs capped walk (nearest-hit rule) "
        f"{full_bc:.3f} ms")
    priced["env_shadow"] = full_work(ht.anyhit_walk_plain, (o, d, ok, cap, tgt), occl, eps)
    anyhit_extra = at_full_width("anyhit_walk", "env-lit shadow pack", full_c,
                                 shadow_bound(o.shape[1], "anyhit", occl, priced["env_shadow"]))
    return [
        kernel_entry("window_walk", "window_walk.cu", 698, max(errs_a), ms_a, plain_a,
                     full_a, bound_a, **full_extra),
        kernel_entry("capped_walk", "capped_walk.cu", 106, err_b, ms_b, plain_b,
                     full_b, bound_b, **capped_extra),
        kernel_entry("anyhit_walk", "anyhit_walk.cu", 274, float(bad), ms_c, plain_c,
                     full_c, bound_c, capped_full_ms=full_bc, env_share=env_share,
                     **anyhit_extra),
    ], Priced(waves, priced)


def check_counts(name, t_k, row_k, useful_k, spent_k, plain) -> float:
    """The counting walk against its plain version: hits as ``agree``,
    useful rows equal, spent within its warp bounds and equal across each
    warp.  Returns the useful share of spent."""
    t_p, row_p, useful_p, lo, hi = plain
    err = agree(name, t_k, row_k, t_p, row_p)
    if not torch.equal(useful_k, useful_p):
        raise AssertionError(f"{name}: useful differs on "
                             f"{int((useful_k != useful_p).sum())} lanes")
    if not bool(((lo <= spent_k) & (spent_k <= hi)).all()):
        raise AssertionError(f"{name}: spent outside its warp bounds")
    w = spent_k[:spent_k.shape[0] // 32 * 32].view(-1, 32)
    if not bool((w == w[:, :1]).all()):
        raise AssertionError(f"{name}: spent differs inside a warp")
    share = float(useful_k.double().sum() / spent_k.double().sum().clamp(min=1))
    log(f"  {name}: useful equal, spent within warp bounds; useful/spent "
        f"{share:.4f} (bounds give {float(useful_p.double().sum() / hi.double().sum()):.4f}"
        f"..{float(useful_p.double().sum() / lo.double().sum()):.4f})")
    return err


def phase_bench_kernels(renderer, priced: Priced) -> list[dict]:
    """The bench's four kernels against their plain versions on 65,536
    lanes of the 1080p wavefronts, and their times (the counting walk's
    whole bounce-1 wavefront walks what the window walk walked there, so its
    bound takes ``priced``'s work)."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht

    lay, cfg = renderer.layout, renderer.cfg
    waves = priced.waves
    gen = torch.Generator().manual_seed(4321)
    pp_win = ht.window_prepass(lay, cfg.traversal_prepass)
    pp_min = min(cfg.traversal_prepass, lay.prepass.shape[0], lay.num_tris)
    eps = cfg.distance_epsilon
    inf = {w: torch.full_like(waves[w][0][0], torch.inf) for w in ("camera", "bounce1")}
    pair = waves["bounce1"] + waves["shadow"][1:]  # path lanes and their shadow pack

    # kernel a: minwalk on camera and bounce-1 lanes
    errs, pay = [], 0.0
    for which in ("camera", "bounce1"):
        o, d, act = draw(waves[which], SAMPLE_LANES, gen)
        t_max = torch.full_like(o[0], torch.inf)
        outk = ht.minwalk(o, d, act, t_max, lay, prepass=pp_min)
        outp, work = plain_work(ht.minwalk_plain, o, d, act, t_max, lay, prepass=pp_min)
        torch.cuda.synchronize()
        hit = lambda out: torch.where(out[0] < t_max, out[0], torch.inf)  # noqa: E731
        errs.append(agree(f"minwalk/{which}", hit(outk), outk[3], hit(outp), outp[3]))
        same = outk[3] == outp[3]
        pay = max(pay, float((outk[6:] - outp[6:]).abs()[:, same].max()))
    log(f"  minwalk: payload (position, normal) max |diff| {pay:.3g} where ids agree")
    if pay > PAYLOAD_ATOL:
        raise AssertionError(f"minwalk payload differs by {pay} > {PAYLOAD_ATOL}")
    bound_a = minwalk_bound(lay, act, work, pp_min)
    a_in = (o, d, act, t_max, lay)
    ms_a = cuda_ms(lambda: ht.minwalk(*a_in, prepass=pp_min))
    plain_a = cuda_ms(lambda: ht.minwalk_plain(*a_in, prepass=pp_min), iters=2)
    full_a = {w: cuda_ms(lambda: ht.minwalk(*waves[w], inf[w], lay, prepass=pp_min))
              for w in ("camera", "bounce1")}
    win_b1 = cuda_ms(lambda: ht.window_walk(*waves["bounce1"], inf["bounce1"], lay,
                                            prepass=pp_win))
    log(f"  minwalk at {SAMPLE_LANES} bounce-1 lanes: kernel {ms_a:.3f} ms, plain "
        f"{plain_a:.3f} ms; full camera {full_a['camera']:.3f} ms, full bounce-1 "
        f"{full_a['bounce1']:.3f} ms (window walk on full bounce-1: {win_b1:.3f} ms)")
    min_extra = {}
    for w, what in (("bounce1", "bounce-1 wavefront"), ("camera", "camera wavefront")):
        # the same walk as the MT epilogue form's on the same prepass: the rows
        # the winner alone sets (t, id, material, light+1) equal; u and v
        # differ in the epilogue's clamp
        rows = [0, 3, 4, 5]
        equal_on_every_lane(
            f"minwalk vs {NEAREST} (mt), {w}",
            ht.minwalk(*waves[w], inf[w], lay, prepass=pp_min)[rows],
            ht.window_walk_resolve(*waves[w], inf[w], lay, prepass=pp_min,
                                   tritest="mt")[rows])
        extra = at_full_width(
            "minwalk", what, full_a[w],
            minwalk_bound(lay, waves[w][2],
                          full_work(ht.minwalk_plain, (*waves[w], inf[w]), lay,
                                    prepass=pp_min), pp_min))
        min_extra.update(extra if w == "bounce1" else
                         {f"{k}_camera": v for k, v in extra.items()})
    log(f"  minwalk == {NEAREST} (mt) on t, id, material and light of every lane of the "
        f"full camera and bounce-1 wavefronts")

    # kernel b: the sweep on bounce-1 lanes
    o, d, act = draw(waves["bounce1"], SAMPLE_LANES, gen)
    t_max = torch.full_like(o[0], torch.inf)
    tk, rk, ok_ = ht.sweep(o, d, act, t_max, lay, with_orig=True)
    tp, rp, op = ht.sweep_plain(o, d, act, t_max, lay, with_orig=True)
    torch.cuda.synchronize()
    err_b = agree("sweep/bounce1", tk, rk, tp, rp)
    if not torch.equal(ok_[rk == rp], op[rk == rp]):
        raise AssertionError("sweep: the latched original ids differ")
    tw, rw = ht.window_walk(o, d, act, t_max, lay, prepass=pp_win)
    log(f"  sweep vs window walk on the same lanes: rows differ on "
        f"{int((rw != rk).sum())}, max |dt| {float((tw - tk)[torch.isfinite(tk)].abs().max()):.3g}")
    bound_b = sweep_bound(lay, act, "bw")
    b_in = (o, d, act, t_max, lay)
    ms_b = cuda_ms(lambda: ht.sweep(*b_in))
    plain_b = cuda_ms(lambda: ht.sweep_plain(*b_in), iters=2)
    full_b = cuda_ms(lambda: ht.sweep(*waves["bounce1"], inf["bounce1"], lay), iters=2)
    log(f"  sweep at {SAMPLE_LANES} bounce-1 lanes: kernel {ms_b:.3f} ms, plain "
        f"{plain_b:.3f} ms; full bounce-1 ({waves['bounce1'][0].shape[1]} lanes, "
        f"{int(waves['bounce1'][2].sum())} live): {full_b:.3f} ms")
    sweep_extra = at_full_width("sweep", "bounce-1 wavefront", full_b,
                                sweep_bound(lay, waves["bounce1"][2], "bw"))

    # kernel c: the fused walk's 2N lanes, bounce-1 paths + bounce-0 shadow pack
    lanes = draw(pair, SAMPLE_LANES, gen)
    c_in = two_n(*lanes)
    tk, rk, ok_ = ht.window_walk_orig(*c_in, lay, prepass=pp_win)
    (tp, rp, op), work_c = plain_work(ht.window_walk_orig_plain, *c_in, lay,
                                       prepass=pp_win)
    bound_c = window_bound(lay, c_in[2], work_c, pp_win, "bw", 2)
    torch.cuda.synchronize()
    hit = lambda t: torch.where(t < c_in[3], t, torch.inf)  # noqa: E731
    err_c = agree("window_walk_orig/bounce1+shadow", hit(tk), rk, hit(tp), rp)
    if not torch.equal(ok_[rk == rp], op[rk == rp]):
        raise AssertionError("window_walk_orig: the latched original ids differ")
    n = SAMPLE_LANES
    _, _, _, sdir, sok, scap, tgt = lanes
    clear_k = ht.fused_clear(tk[n:], ok_[n:], sok, scap, tgt, eps)
    clear_p = ht.fused_clear(tp[n:], op[n:], sok, scap, tgt, eps)
    if not torch.equal(clear_k, clear_p):
        raise AssertionError(f"fused clear masks differ on "
                             f"{int((clear_k != clear_p).sum())} lanes")
    sep = renderer._intersect(lanes[0], sdir, sok, t_max=scap)
    sep_clear = sok & torch.where(tgt >= 0, sep.valid & (sep.t >= eps) & (sep.tri == tgt),
                                  ~sep.valid)
    log(f"  fused clear masks equal on all {n} shadow lanes ({int(clear_k.sum())} "
        f"clear of {int(sok.sum())} live); against the separate capped walk on the "
        f"leaf-8 layout they differ on {int((clear_k != sep_clear).sum())} lanes")
    ms_c = cuda_ms(lambda: ht.window_walk_orig(*c_in, lay, prepass=pp_win))
    plain_c = cuda_ms(lambda: ht.window_walk_orig_plain(*c_in, lay, prepass=pp_win),
                      iters=2)
    full_in = two_n(*pair)
    full_c = cuda_ms(lambda: ht.window_walk_orig(*full_in, lay, prepass=pp_win))
    log(f"  window_walk_orig at 2x{n} lanes: kernel {ms_c:.3f} ms, plain "
        f"{plain_c:.3f} ms; full bounce-1 + shadow ({full_in[0].shape[1]} lanes): "
        f"{full_c:.3f} ms")
    orig_extra = at_full_width(
        "window_walk_orig", "bounce-1 + shadow wavefronts", full_c,
        window_bound(lay, full_in[2], full_work(ht.window_walk_orig_plain, full_in, lay,
                                                prepass=pp_win), pp_win, "bw", 2))

    # kernel d: the counting walk on bounce-1 lanes and on the shadow pack
    o, d, alive, sdir, sok, scap, _ = draw(pair, SAMPLE_LANES, gen)
    t_max = torch.full_like(scap, torch.inf)
    errs_d = []
    for which, args in (("bounce1", (o, d, alive, t_max)), ("shadow", (o, sdir, sok, scap))):
        got = ht.window_walk_counts(*args, lay, prepass=pp_win)
        plain, work_d = plain_work(ht.window_walk_counts_plain, *args, lay,
                                    prepass=pp_win)
        if which == "bounce1":
            bound_d = window_bound(lay, alive, work_d, pp_win, "bw", 3)
        torch.cuda.synchronize()
        cap = args[3]
        errs_d.append(check_counts(
            f"window_walk_counts/{which}",
            torch.where(got[0] < cap, got[0], torch.inf), got[1], got[2], got[3],
            (torch.where(plain[0] < cap, plain[0], torch.inf), *plain[1:])))
    d_in = (o, d, alive, t_max, lay)
    ms_d = cuda_ms(lambda: ht.window_walk_counts(*d_in, prepass=pp_win))
    plain_d = cuda_ms(lambda: ht.window_walk_counts_plain(*d_in, prepass=pp_win), iters=2)
    full_d = cuda_ms(lambda: ht.window_walk_counts(*waves["bounce1"], inf["bounce1"], lay,
                                                   prepass=pp_win))
    log(f"  window_walk_counts at {SAMPLE_LANES} bounce-1 lanes: kernel {ms_d:.3f} ms, "
        f"plain {plain_d:.3f} ms; full bounce-1: {full_d:.3f} ms")
    counts_extra = at_full_width(
        "window_walk_counts", "bounce-1 wavefront", full_d,
        window_bound(lay, waves["bounce1"][2], priced.work["bounce1"], pp_win, "bw", 3))
    return [
        kernel_entry("minwalk", "minwalk.cu", 106, max(errs), ms_a, plain_a,
                     full_a["bounce1"], bound_a, payload_max_abs_err=pay,
                     full_camera_ms=full_a["camera"], window_full_bounce1_ms=win_b1,
                     **min_extra),
        kernel_entry("sweep", "sweep.cu", 1152, err_b, ms_b, plain_b, full_b, bound_b,
                     **sweep_extra),
        kernel_entry("window_walk_orig", "window_walk.cu", 698, err_c, ms_c, plain_c,
                     full_c, bound_c, **orig_extra),
        kernel_entry("window_walk_counts", "window_walk.cu", 698, max(errs_d), ms_d,
                     plain_d, full_d, bound_d, **counts_extra),
    ]


def terrain_scene(grid: int, device="cuda"):
    """tests/test_scale.py's terrain at ``grid`` (tests/torch_terrain.py,
    the JAX-free copy) through ``build_scene``."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_terrain import terrain_scene as build

    return build(grid, device)


def phase_terrain_kernels(renderer, grid: int) -> dict[str, dict]:
    """The MT and HBM-route kernel forms, each against its plain version on 65,536
    lanes of the terrain's 1080p wavefronts (camera lanes, and the live
    lanes of bounce 1 and the shadow pack: the default camera sees the
    terrain in ~13% of its pixels), and their times; returns {name: row of
    the kernel table}."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht

    lay, cfg = renderer.layout, renderer.cfg
    waves = wavefronts(renderer.scene, lay, renderer.layout_occl, cfg)
    gen = torch.Generator().manual_seed(grid)
    pp = ht.window_prepass(lay, cfg.traversal_prepass)
    eps = cfg.distance_epsilon
    inf = {w: torch.full_like(waves[w][0][0], torch.inf) for w in ("camera", "bounce1")}
    pair = waves["bounce1"] + waves["shadow"][1:]
    live = {"camera": None, "bounce1": waves["bounce1"][2], "shadow": waves["shadow"][2]}
    tag = f"grid {grid}, {lay.num_tris} triangles"
    log(f"terrain kernels ({tag}): camera {waves['camera'][0].shape[1]} lanes, bounce-1 "
        f"{int(waves['bounce1'][2].sum())} live, shadow {int(waves['shadow'][2].sum())} "
        f"live")
    out = {}

    # kernel 5: the MT window walk on camera and bounce-1 lanes
    errs = []
    for which in ("camera", "bounce1"):
        o, d, act = draw(waves[which], SAMPLE_LANES, gen, live[which])
        t_max = torch.full_like(o[0], torch.inf)
        tk, rk = ht.window_walk(o, d, act, t_max, lay, prepass=pp, tritest="mt")
        (tp, rp), work = plain_work(ht.window_walk_plain, o, d, act, t_max, lay,
                                     prepass=pp, tritest="mt")
        torch.cuda.synchronize()
        errs.append(agree(f"window_walk mt/{which} ({tag})", tk, rk, tp, rp))
    a_in = (o, d, act, t_max, lay)
    bw = cuda_ms(lambda: ht.window_walk(*a_in, prepass=pp))
    out["window_walk_mt"] = kernel_entry(
        "window_walk_mt", "window_walk.cu", 698, max(errs),
        cuda_ms(lambda: ht.window_walk(*a_in, prepass=pp, tritest="mt")),
        cuda_ms(lambda: ht.window_walk_plain(*a_in, prepass=pp, tritest="mt"), iters=1),
        cuda_ms(lambda: ht.window_walk(*waves["bounce1"], inf["bounce1"], lay,
                                       prepass=pp, tritest="mt")),
        window_bound(lay, act, work, pp, "mt", 1), bw_ms=bw,
        full_camera_ms=cuda_ms(lambda: ht.window_walk(*waves["camera"], inf["camera"],
                                                      lay, prepass=pp, tritest="mt")))

    # kernel 7's MT form: 2N lanes, bounce-1 paths + bounce-0 shadow pack
    lanes = draw(pair, SAMPLE_LANES, gen, live["bounce1"])
    c_in = two_n(*lanes)
    tk, rk, ok_ = ht.window_walk_orig(*c_in, lay, prepass=pp, tritest="mt")
    (tp, rp, op), work = plain_work(ht.window_walk_orig_plain, *c_in, lay, prepass=pp,
                                     tritest="mt")
    torch.cuda.synchronize()
    hit = lambda t: torch.where(t < c_in[3], t, torch.inf)  # noqa: E731
    err = agree(f"window_walk_orig mt/bounce1+shadow ({tag})", hit(tk), rk, hit(tp), rp)
    if not torch.equal(ok_[rk == rp], op[rk == rp]):
        raise AssertionError("window_walk_orig mt: the latched original ids differ")
    n = lanes[0].shape[1]
    _, _, _, sdir, sok, scap, tgt = lanes
    if not torch.equal(ht.fused_clear(tk[n:], ok_[n:], sok, scap, tgt, eps),
                       ht.fused_clear(tp[n:], op[n:], sok, scap, tgt, eps)):
        raise AssertionError("window_walk_orig mt: fused clear masks differ")
    full_in = two_n(*pair)
    out["window_walk_orig_mt"] = kernel_entry(
        "window_walk_orig_mt", "window_walk.cu", 698, err,
        cuda_ms(lambda: ht.window_walk_orig(*c_in, lay, prepass=pp, tritest="mt")),
        cuda_ms(lambda: ht.window_walk_orig_plain(*c_in, lay, prepass=pp, tritest="mt"),
                iters=1),
        cuda_ms(lambda: ht.window_walk_orig(*full_in, lay, prepass=pp, tritest="mt")),
        window_bound(lay, c_in[2], work, pp, "mt", 2))

    # kernel 8's MT form: the counting walk on bounce-1 lanes
    o, d, act = draw(waves["bounce1"], SAMPLE_LANES, gen, live["bounce1"])
    t_max = torch.full_like(o[0], torch.inf)
    got = ht.window_walk_counts(o, d, act, t_max, lay, prepass=pp, tritest="mt")
    plain, work = plain_work(ht.window_walk_counts_plain, o, d, act, t_max, lay,
                              prepass=pp, tritest="mt")
    torch.cuda.synchronize()
    err = check_counts(f"window_walk_counts mt/bounce1 ({tag})", *got, plain)
    d_in = (o, d, act, t_max, lay)
    out["window_walk_counts_mt"] = kernel_entry(
        "window_walk_counts_mt", "window_walk.cu", 698, err,
        cuda_ms(lambda: ht.window_walk_counts(*d_in, prepass=pp, tritest="mt")),
        cuda_ms(lambda: ht.window_walk_counts_plain(*d_in, prepass=pp, tritest="mt"),
                iters=1),
        cuda_ms(lambda: ht.window_walk_counts(*waves["bounce1"], inf["bounce1"], lay,
                                              prepass=pp, tritest="mt")),
        window_bound(lay, act, work, pp, "mt", 3))

    # kernel 6: the HBM route's window walk, nearest (bounce-1) and capped
    # (the shadow pack, t_max = the range cap, as the route's shadow query)
    o, d, act = draw(waves["bounce1"], SAMPLE_LANES, gen, live["bounce1"])
    t_max = torch.full_like(o[0], torch.inf)
    tk, rk = ht.window_walk_hbm(o, d, act, t_max, lay, prepass=pp)
    tp, rp = ht.window_walk_hbm_plain(o, d, act, t_max, lay, prepass=pp)
    torch.cuda.synchronize()
    errs = [agree(f"window_walk_hbm/bounce1 ({tag})", tk, rk, tp, rp)]
    # the route's nearest-hit queries take the payload epilogue: all 12 rows
    # against the plain version (the plain walk plus window_payload_rows)
    for tritest in ("bw", "mt"):
        want = (ht.window_payload_rows(lay, tp, rp, t_max, o, d) if tritest == "bw" else
                ht.window_walk_hbm_plain(o, d, act, t_max, lay, prepass=pp, tritest="mt",
                                         resolve=True))
        equal_on_every_lane(
            f"window_walk_hbm(resolve=True)/bounce1 ({tag}, {tritest}) vs plain",
            ht.window_walk_hbm(o, d, act, t_max, lay, prepass=pp, tritest=tritest,
                               resolve=True), want)
    log(f"  window_walk_hbm(resolve=True) == its plain version on all 12 rows of "
        f"{SAMPLE_LANES} bounce-1 lanes ({tag}, bw and mt)")
    o, d, ok, cap, _ = draw(waves["shadow"], SAMPLE_LANES, gen, live["shadow"])
    tk, rk = ht.window_walk_hbm(o, d, ok, cap, lay, prepass=pp)
    (tp, rp), work = plain_work(ht.window_walk_hbm_plain, o, d, ok, cap, lay, prepass=pp)
    torch.cuda.synchronize()
    capped = lambda t: torch.where(t < cap, t, torch.inf)  # noqa: E731
    errs.append(agree(f"window_walk_hbm/shadow capped ({tag})", capped(tk), rk,
                      capped(tp), rp))
    # the route's capped queries take the capped epilogue: its 4 rows against
    # the plain version (the plain walk plus window_capped_rows)
    for tritest in ("bw", "mt"):
        want = (ht.window_capped_rows(lay, tp, rp, cap, o, d) if tritest == "bw" else
                ht.window_walk_hbm_plain(o, d, ok, cap, lay, prepass=pp, tritest="mt",
                                         capped=True))
        equal_on_every_lane(
            f"window_walk_hbm(capped=True)/shadow ({tag}, {tritest}) vs plain",
            ht.window_walk_hbm(o, d, ok, cap, lay, prepass=pp, tritest=tritest, capped=True),
            want)
    log(f"  window_walk_hbm(capped=True) == its plain version on all 4 rows of "
        f"{SAMPLE_LANES} shadow lanes ({tag}, bw and mt)")
    h_in = (o, d, ok, cap, lay)
    so, sd, sok, scap, _ = waves["shadow"]
    # the whole shadow pack: the (t, row) form and the capped epilogue in turns
    pack = turns({"(t, row)": lambda: ht.window_walk_hbm(so, sd, sok, scap, lay,
                                                         prepass=pp),
                  "capped": lambda: ht.window_walk_hbm(so, sd, sok, scap, lay, prepass=pp,
                                                       capped=True)})
    log(f"  window_walk_hbm shadow pack ({tag}, {int(sok.sum())} live of "
        f"{sok.shape[0]}), ms in turns: " + "; ".join(
            f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in pack.items()))
    out["window_walk_hbm"] = kernel_entry(
        "window_walk_hbm", "window_walk.cu", 698, max(errs),
        cuda_ms(lambda: ht.window_walk_hbm(*h_in, prepass=pp)),
        cuda_ms(lambda: ht.window_walk_hbm_plain(*h_in, prepass=pp), iters=1),
        cuda_ms(lambda: ht.window_walk_hbm(so, sd, sok, scap, lay, prepass=pp)),
        window_bound(lay, ok, work, pp, "bw", 1),
        full_bounce1_ms=cuda_ms(lambda: ht.window_walk_hbm(*waves["bounce1"],
                                                           inf["bounce1"], lay,
                                                           prepass=pp)),
        capped_walk_full_ms=cuda_ms(lambda: ht.capped_walk(so, sd, sok, scap,
                                                           renderer.layout_occl)),
        capped_epilogue_full_ms=min(pack["capped"]))

    # every form against the (t, row) form on the whole wavefronts, and the
    # bounds of kernels 5 and 6 there
    for tritest in ("bw", "mt"):
        for which in ("camera", "bounce1"):
            forms_equal(f"{which} ({tag})", lay, *waves[which], inf[which], pp, tritest,
                        hbm=True)
        forms_equal(f"shadow pack ({tag})", lay, so, sd, sok, scap, pp, tritest, hbm=True)
    mt = out["window_walk_mt"]
    b1_work = full_work(ht.window_walk_plain, (*waves["bounce1"], inf["bounce1"]), lay,
                        prepass=pp, tritest="mt")
    mt.update(at_full_width(f"window_walk mt ({tag})", "bounce-1 wavefront", mt["full_ms"],
                            window_bound(lay, waves["bounce1"][2], b1_work, pp, "mt", 1)))
    mt.update({f"{k}_camera": v for k, v in at_full_width(
        f"window_walk mt ({tag})", "camera wavefront", mt["full_camera_ms"],
        window_bound(lay, waves["camera"][2],
                     full_work(ht.window_walk_plain, (*waves["camera"], inf["camera"]), lay,
                               prepass=pp, tritest="mt"), pp, "mt", 1)).items()})
    hb = out["window_walk_hbm"]
    hb.update(at_full_width(
        f"window_walk_hbm ({tag})", "capped shadow pack", hb["full_ms"],
        window_bound(lay, sok, full_work(ht.window_walk_hbm_plain, (so, sd, sok, scap), lay,
                                         prepass=pp), pp, "bw", 1)))
    hb.update({f"{k}_bounce1": v for k, v in at_full_width(
        f"window_walk_hbm ({tag})", "bounce-1 wavefront", hb["full_bounce1_ms"],
        window_bound(lay, waves["bounce1"][2],
                     full_work(ht.window_walk_hbm_plain, (*waves["bounce1"], inf["bounce1"]),
                               lay, prepass=pp), pp, "bw", 1)).items()})

    if grid == TERRAIN_GRIDS[0]:
        # the full-width bounds of kernels 7 and 8's MT forms: the fused walk
        # on the whole 2N wavefront, the counting walk on the whole bounce-1
        # wavefront (the MT window walk's work there)
        orig = out["window_walk_orig_mt"]
        orig.update(at_full_width(
            f"window_walk_orig mt ({tag})", "2N bounce-1 + shadow wavefront", orig["full_ms"],
            window_bound(lay, full_in[2], full_work(ht.window_walk_orig_plain, full_in, lay,
                                                    prepass=pp, tritest="mt"),
                         pp, "mt", 2)))
        counts = out["window_walk_counts_mt"]
        counts.update(at_full_width(f"window_walk_counts mt ({tag})", "bounce-1 wavefront",
                                    counts["full_ms"],
                                    window_bound(lay, waves["bounce1"][2], b1_work, pp,
                                                 "mt", 3)))
        # kernel 9's MT form: the sweep on bounce-1 lanes (O(rows): GRID 256 only)
        o, d, act = draw(waves["bounce1"], SAMPLE_LANES, gen, live["bounce1"])
        t_max = torch.full_like(o[0], torch.inf)
        tk, rk, ok_ = ht.sweep(o, d, act, t_max, lay, with_orig=True, tritest="mt")
        tp, rp, op = ht.sweep_plain(o, d, act, t_max, lay, with_orig=True, tritest="mt")
        torch.cuda.synchronize()
        err = agree(f"sweep mt/bounce1 ({tag})", tk, rk, tp, rp)
        if not torch.equal(ok_[rk == rp], op[rk == rp]):
            raise AssertionError("sweep mt: the latched original ids differ")
        b_in = (o, d, act, t_max, lay)
        out["sweep_mt"] = kernel_entry(
            "sweep_mt", "sweep.cu", 1152, err,
            cuda_ms(lambda: ht.sweep(*b_in, tritest="mt"), iters=2),
            cuda_ms(lambda: ht.sweep_plain(*b_in, tritest="mt"), iters=1),
            cuda_ms(lambda: ht.sweep(*waves["bounce1"], inf["bounce1"], lay,
                                     tritest="mt"), iters=1),
            sweep_bound(lay, act, "mt"))
        out["sweep_mt"].update(at_full_width(
            f"sweep mt ({tag})", "bounce-1 wavefront", out["sweep_mt"]["full_ms"],
            sweep_bound(lay, waves["bounce1"][2], "mt")))
    for k, e in out.items():
        log(f"  {k} ({tag}) at {SAMPLE_LANES} lanes: kernel {e['ms']:.3f} ms, plain "
            f"{e['plain_ms']:.1f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}); "
            f"full wavefront {e['full_ms']:.3f} ms"
            + "".join(f", {x} {e[x]:.3f} ms" for x in e if x.endswith("_ms")
                      and x not in ("ms", "plain_ms", "full_ms", "bound_ms",
                                    "library_ms")))
    return out


def kernel_home(name: str):
    """One of KERNELS -> (the module that holds its wrapper, the wrapper's
    name there, its plain version's name there)."""
    import importlib

    mod, attr, plain = KERNEL_HOMES.get(name, ("ops.hopper_traverse", name,
                                              f"{name}_plain"))
    return importlib.import_module(f"tpu_pathtracer_torch.{mod}"), attr, plain


@contextlib.contextmanager
def counted_run():
    """Zero every kernel's launch counts and count plain-version calls on
    CUDA tensors for the run inside; yields {"launches": ..., "launches_mt":
    ..., "launches_resolve": ..., "launches_capped": ..., "plain_cuda": ...},
    filled in when the run ends ("launches_mt": the Moller-Trumbore form's
    launches of the wrappers that take tritest; "launches_resolve" and
    "launches_capped": the payload and capped epilogue forms' launches of
    window_walk_hbm)."""
    where = {k: kernel_home(k) for k in KERNELS}  # kernel -> (module, wrapper, plain)
    plains = {(mod, plain) for mod, _, plain in where.values()}
    plain_cuda = {plain: 0 for _, plain in plains}

    def on_cuda(a) -> bool:
        """A CUDA tensor, or one inside a tuple, list or dict argument (the
        shading's plain version takes NamedTuples of planes)."""
        if isinstance(a, torch.Tensor):
            return a.is_cuda
        if isinstance(a, (tuple, list)):
            return any(on_cuda(x) for x in a)
        return isinstance(a, dict) and any(on_cuda(x) for x in a.values())

    def counted(name, fn):
        def wrapper(*args, **kw):
            if any(on_cuda(a) for a in (*args, *kw.values())):
                plain_cuda[name] += 1
            return fn(*args, **kw)
        return wrapper

    saved = {(mod, plain): getattr(mod, plain) for mod, plain in plains}
    for (mod, plain), fn in saved.items():
        setattr(mod, plain, counted(plain, fn))
    fns = {k: getattr(mod, attr) for k, (mod, attr, _) in where.items()}
    extra = {c: [k for k in KERNELS if hasattr(fns[k], c)]
             for c in ("launches_mt", "launches_resolve", "launches_capped")}
    for k in KERNELS:
        for c in ("launches", "launches_mt", "launches_resolve", "launches_capped"):
            if hasattr(fns[k], c):
                setattr(fns[k], c, 0)
    out = {"plain_cuda": plain_cuda}
    try:
        yield out
    finally:
        out["launches"] = {k: fns[k].launches for k in KERNELS}
        for c, ks in extra.items():
            out[c] = {k: getattr(fns[k], c) for k in ks}
        for (mod, plain), fn in saved.items():
            setattr(mod, plain, fn)


def timed_frames(renderer, timed: int = 3) -> tuple[float, dict]:
    """2 warm-up + ``timed`` frames (host clock, ending in a synchronize)
    and one more frame under the CUDA-event StageTimer -> (ms/frame,
    stages); renders ``timed + 3`` frames."""
    renderer.run(2)
    t0 = time.perf_counter()
    renderer.run(timed)
    ms = (time.perf_counter() - t0) / timed * 1e3
    return ms, staged_frame(renderer)


def staged_frame(renderer) -> dict:
    """One more frame under the CUDA-event StageTimer -> {stage: ms}."""
    from tpu_pathtracer_torch.render.state import render_frame
    from tpu_pathtracer_torch.render.timing import StageTimer

    timer = StageTimer()
    renderer.state = render_frame(renderer.state, renderer.scene, renderer.cfg,
                                  renderer.camera, renderer._intersect, timer=timer)
    return timer.totals()


def walk_ms(stages: dict) -> float:
    """The walks' share of a staged frame, in ms."""
    return sum(stages.get(k, 0.0) for k in ("walk_nearest", "walk_shadow", "walk_fused"))


def sample_ms(stages: dict) -> float:
    """A staged frame's wavefronts, in ms: their preparation, bounces and
    restore (the sort bounds' two host reads aside)."""
    return sum(stages.get(k, 0.0) for k in ("prepare", "bounce", "restore"))


def stage_line(stages: dict) -> str:
    walks = walk_ms(stages)
    sample = sample_ms(stages)
    other = sample - stages.get("sort", 0.0) - walks
    return ("  stages (ms, one frame): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(stages.items()))
        + f", shading+rest {other:.2f}; walks {walks:.2f} = "
        f"{walks / sample:.2%} of sample")


def phase_main_path(renderer) -> tuple[dict, int]:
    """Drive the main path -> (each kernel's launches in that run, frames
    rendered)."""
    from tpu_pathtracer_torch.render.state import (frame_rng_key,
                                                   fused_wavefront_key)
    from tpu_pathtracer_torch.render.wavefront import render_sample

    with counted_run() as run:
        ms, stages = timed_frames(renderer)
        key = fused_wavefront_key(frame_rng_key(renderer.cfg, renderer.state.key,
                                                renderer.state.frame_index))
        _, nrays = render_sample(
            renderer.scene, renderer.cfg, renderer.camera, HEIGHT, WIDTH, key,
            renderer.state.frame_index, renderer._intersect, with_ray_count=True)
        nrays = int(nrays)
    launches, plain_cuda = run["launches"], run["plain_cuda"]
    img = renderer.image()
    log(f"main path: {ms:.2f} ms/frame at {WIDTH}x{HEIGHT} depth "
        f"{renderer.cfg.max_path_length}; {nrays} traced rays/frame = "
        f"{nrays / ms / 1e3:.2f} Mrays/s; HUD {renderer.hud()}")
    log(stage_line(stages))
    log(f"  kernel launches in the main-path run: {launches}; plain versions "
        f"on CUDA tensors: {plain_cuda}")
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
        raise AssertionError(f"main path image not finite / wrong shape {img.shape}")
    frames = 3 + 3 + 1  # timed_frames(timed=3), then the counted frame
    want = {"uniforms": 9, NEAREST: 8, "shade_bounce": 8, "sort_key": 7, "gather_planes": 7}
    if launches["capped_walk"] <= 0 or any(launches[k] != n * frames
                                           for k, n in want.items()):
        raise AssertionError(f"the main path's kernels did not launch {want} a frame "
                             f"over {frames} frames: {launches}")
    extra = {k: launches[k] for k in KERNELS if k not in MAIN_PATH and launches[k]}
    if extra:
        raise AssertionError(f"the default main path launched other kernels: {extra}")
    if any(plain_cuda.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain_cuda}")
    return launches, frames


def check_parity(what: str, img, gold) -> dict:
    from tpu_pathtracer_torch.utils.compare import metrics

    m = metrics(img, gold)
    log(f"{what}: {m}")
    rel, lo, hi = PARITY
    if not np.isfinite(img).all() or not (m["rel_mse"] < rel and lo < m["mean_ratio"] < hi):
        raise AssertionError(f"{what} gate failed: {m}")
    return m


def phase_parity(variant: str | None = None) -> dict:
    """The self-golden gate for the default config or one of VARIANTS or
    MT_VARIANTS -> the run's counts (:func:`counted_run`)."""
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.io.exr import read_exr

    here = os.path.dirname(os.path.abspath(__file__))
    gold, _ = read_exr(os.path.join(here, "assets", "self_golden", f"{SCENE}-8.exr"))
    kw, kernel = {**VARIANTS, **MT_VARIANTS}[variant] if variant else ({}, NEAREST)
    with counted_run() as run:
        r = Renderer(SCENE, 200, 150, RenderConfig(samples_per_frame=1, max_path_length=8,
                                                   **kw))
        r.run(PARITY_FRAMES)
    if not run["launches"][kernel] or any(run["plain_cuda"].values()):
        raise AssertionError(f"parity run {variant}: {run}")
    if "tritest" in kw and run["launches_mt"][kernel] != run["launches"][kernel]:
        raise AssertionError(f"parity run {variant}: not every launch the MT form: {run}")
    run["metrics"] = check_parity(f"parity{f' ({variant})' if variant else ''} vs "
                                  "self-golden (150x200, depth 8, 16 frames)", r.image(),
                                  gold)
    return run


def run_cli(argv: list[str]) -> tuple[int, str, float]:
    """``tpu_pathtracer_torch.cli.main(argv)`` in this process -> (rc, its
    stdout, wall seconds); the output is echoed indented."""
    from tpu_pathtracer_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    return rc, buf.getvalue(), seconds


def kernel_kind(name: str) -> str:
    """A profiler kernel name -> the port's kernel it launches ("torch ops"
    for any other).  Matched on the kernels' own symbols (``sweep_kernel``,
    ...): CUB's radix sort has ``Upsweep``/``Downsweep`` kernels, and the
    window walk's variants share ``window_walk_kernel``."""
    return next((k for k in KERNELS if re.search(rf"\b{k}_kernel\b", name)), "torch ops")


@contextlib.contextmanager
def frame_clock():
    """Wall clock of Renderer frame loops run inside: from the first step to
    the end of the last sync that waited for frames; yields {"frames": n,
    "seconds": s}, filled in as frames run."""
    from tpu_pathtracer_torch.renderer import Renderer

    step, sync = Renderer.step, Renderer._sync
    clock = {"frames": 0, "seconds": 0.0, "t0": None}

    def timed_step(self, timer=None):
        if clock["t0"] is None:
            clock["t0"] = time.perf_counter()
        clock["frames"] += 1
        step(self, timer)

    def timed_sync(self, trace):
        waited = self._in_flight > 0
        sync(self, trace)
        if waited and clock["t0"] is not None:
            clock["seconds"] = time.perf_counter() - clock["t0"]

    Renderer.step, Renderer._sync = timed_step, timed_sync
    try:
        yield clock
    finally:
        Renderer.step, Renderer._sync = step, sync


def phase_cli_env(tmp: str) -> dict:
    """The CLI with --env at full width; returns each kernel's launches in
    the 5-frame env run."""
    from tpu_pathtracer_torch.io.checkpoint import load_checkpoint
    from tpu_pathtracer_torch.io.exr import read_exr, write_exr
    from tpu_pathtracer_torch.io.png import read_png

    env = os.path.join(tmp, "sky.exr")
    write_exr(env, sky_map(), half=False)
    out = {k: os.path.join(tmp, k) for k in ("a.exr", "a.png", "a.npz",
                                             "b.exr", "b.png", "b.npz", "lens.exr")}
    common = ["--scene", SCENE, "--width", str(WIDTH), "--height", str(HEIGHT),
              "--depth", "8", "--env", env, "--hud-every", "1"]
    with counted_run() as run, frame_clock() as clock:
        rc_a, text_a, sec_a = run_cli(common + ["--frames", "5", "--exr", out["a.exr"],
                                                "--png", out["a.png"],
                                                "--checkpoint", out["a.npz"]])
    launches, plain_cuda = run["launches"], run["plain_cuda"]
    with counted_run() as run_b:
        rc_b, text_b, sec_b = run_cli(common + ["--frames", "1", "--resume", out["a.npz"],
                                                "--exr", out["b.exr"], "--png", out["b.png"],
                                                "--checkpoint", out["b.npz"]])
    rc_l, _, _ = run_cli(["--scene", SCENE, "--width", "200", "--height", "150",
                          "--depth", "8", "--frames", "1", "--aperture", "0.02",
                          "--exr", out["lens.exr"]])
    if (rc_a, rc_b, rc_l) != (0, 0, 0):
        raise AssertionError(f"CLI exit codes {(rc_a, rc_b, rc_l)}")
    missing = [k for k, v in out.items() if not os.path.exists(v)]
    if missing:
        raise AssertionError(f"CLI did not write {missing}")
    png = read_png(out["a.png"])
    img, _ = read_exr(out["a.exr"])
    lens, _ = read_exr(out["lens.exr"])
    if png.shape != (HEIGHT, WIDTH, 3) or img.shape != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"CLI image shapes: png {png.shape}, exr {img.shape}")
    if not (np.isfinite(img).all() and np.isfinite(lens).all() and img.mean() > 0):
        raise AssertionError("CLI image not finite or black")
    if "resumed at frame 5" not in text_b or load_checkpoint(out["b.npz"]).frame_index != 6:
        raise AssertionError("the resumed run did not continue at frame 5")
    huds = [float(x) for x in re.findall(r"([0-9.]+) ms/frame", text_a)]
    per_frame = clock["seconds"] / clock["frames"] * 1e3
    log(f"CLI env path ({WIDTH}x{HEIGHT}, depth 8, 1024x2048 map): HUD "
        f"{huds[-1]:.2f} ms/frame (EMA after 5 frames); wall clock of the frame "
        f"loop {per_frame:.2f} ms/frame over {clock['frames']} frames (HUD sync "
        f"every frame); whole calls {sec_a:.2f} s (5 frames) and {sec_b:.2f} s "
        f"(1 frame), set-up, env build and outputs included")
    log(f"  kernel launches in the 5-frame env run: {launches}; plain versions "
        f"on CUDA tensors: {plain_cuda}; resumed run: {run_b['launches']}")
    if launches["anyhit_walk"] <= 0 or launches[NEAREST] <= 0:
        raise AssertionError(f"a kernel of the env path never launched: {launches}")
    if any(plain_cuda.values()) or any(run_b["plain_cuda"].values()):
        raise AssertionError("plain versions ran on CUDA tensors")

    # the same env-lit frame through Renderer, as phase 4 times the main path
    from tpu_pathtracer_torch import Renderer
    from tpu_pathtracer_torch.scene import attach_env, load_scene, scene_path

    r = Renderer(attach_env(load_scene(scene_path(SCENE)), env), WIDTH, HEIGHT)
    ms, stages = timed_frames(r)
    log(f"  env-lit frame through Renderer: {ms:.2f} ms/frame at {WIDTH}x{HEIGHT} "
        f"depth 8 (2 warm-up + 3 timed frames, no HUD sync per frame)")
    log(stage_line(stages))
    # Renderer.profile's torch.profiler trace of one env-lit frame: device
    # kernel time by kind
    prof = os.path.join(tmp, "prof")
    r.profile(prof, frames=1)
    with open(os.path.join(prof, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    by_kind: dict[str, float] = {}
    for e in events:
        kind = kernel_kind(e["name"])
        by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"] / 1e3
    if not events:
        log("  profiler, one env-lit frame: the trace holds no device kernels "
            "(device time not measured)")
        return launches
    log(f"  profiler, one env-lit frame: {len(events)} kernels, "
        f"{sum(by_kind.values()):.2f} ms device time; by kind (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_kind.items())))
    return launches


def phase_env_parity() -> dict:
    """Any-hit walk against the capped walk on the same env-lit frames."""
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.ops import hopper_traverse as ht
    from tpu_pathtracer_torch.scene import attach_env, load_scene, scene_path

    scene = attach_env(load_scene(scene_path(SCENE)), sky_map())
    imgs = {}
    for mode in ("auto", "off"):
        n0 = ht.anyhit_walk.launches
        r = Renderer(scene, 200, 150, RenderConfig(max_path_length=8,
                                                   occlusion_anyhit=mode))
        r.run(16)
        imgs[mode] = r.image()
        used = ht.anyhit_walk.launches - n0
        if (used > 0) != (mode == "auto"):
            raise AssertionError(f"occlusion_anyhit={mode}: {used} any-hit launches")
    return check_parity("env parity, any-hit vs capped walk (150x200, depth 8, "
                        "16 frames)", imgs["auto"], imgs["off"])


def phase_bench() -> dict:
    """``tpu_pathtracer_torch.bench.main`` at 1920x1080, depth 8: the
    default flags with 5 frames, then each of VARIANTS with 3 frames and no
    utilization block.  Returns each bench kernel's launches in the run
    that drives it."""
    from tpu_pathtracer_torch import bench

    runs = [("default", ["--frames", "5"], (NEAREST, "capped_walk",
                                            "window_walk_counts"))]
    flags = {"minwalk": ["--kernel", "minwalk"], "sweep": ["--kernel", "sweep"],
             "fused": ["--fuse-shadow"]}
    runs += [(v, flags[v] + ["--frames", "3", "--no-utilization"], (k,))
             for v, (_, k) in VARIANTS.items()]
    launches = {}
    for name, argv, kernels in runs:
        buf = io.StringIO()
        with counted_run() as run, contextlib.redirect_stdout(buf):
            rc = bench.main(["--width", str(WIDTH), "--height", str(HEIGHT),
                             "--depth", "8"] + argv)
        line = buf.getvalue().strip().splitlines()[-1]
        log(f"bench {name}: {line}")
        out = json.loads(line)
        log(f"  kernel launches: {run['launches']}; plain versions on CUDA tensors: "
            f"{run['plain_cuda']}")
        if rc or not out["finite"] or out["value"] <= 0 or out["rays_traced_per_frame"] <= 0:
            raise AssertionError(f"bench {name}: rc {rc}, {out}")
        if out["package"] != "tpu_pathtracer_torch" or "," not in out["device"]:
            raise AssertionError(f"bench {name}: package/device fields {out}")
        if any(run["plain_cuda"].values()):
            raise AssertionError(f"bench {name}: plain versions ran on CUDA tensors")
        if min(run["launches"][k] for k in kernels) <= 0:
            raise AssertionError(f"bench {name} never launched {kernels}: "
                                 f"{run['launches']}")
        if name == "default":
            u = out["utilization"]
            if not u["spent_lane_ops_per_ray"] >= u["useful_lane_ops_per_ray"] > 0:
                raise AssertionError(f"bench utilization block: {u}")
        launches[kernels[-1]] = run["launches"][kernels[-1]]
    return launches


MITSUBA_GATES = (("cornellbox", 2), ("cornellbox", 8), ("white-box", 2))
MITSUBA = (0.05, 0.95, 1.05)  # rel_mse <, mean_ratio in (lo, hi): test_render_golden.py
MODE_BASE = {"max_path_length": 8}
# each frame mode against its partner at 1080p, one frame each: (mode, partner,
# (atol, rtol) of the reference's own test of the mode, or None: bit-equal)
MODE_PAIRS = {
    "fuse 2 vs fuse 1 (spp 2)": ({"samples_per_frame": 2, "fuse_samples": 2},
                                 {"samples_per_frame": 2, "fuse_samples": 1}, (1e-6, 1e-5)),
    "row tiles 2 vs untiled (spp 2)": ({"samples_per_frame": 2, "row_tiles": 2},
                                       {"samples_per_frame": 2, "fuse_samples": 2},
                                       (2e-6, 0.0)),
    "prefix_sort vs default": ({"prefix_sort": True}, {}, (2e-6, 1e-5)),
    "sort_bounce_skip=1,4,5 vs default": ({"sort_bounce_skip": "1,4,5"}, {}, (2e-6, 1e-5)),
    "cull_zero_nee vs default": ({"cull_zero_nee": True}, {}, None),
}
CARD_VS_CPU = (1e-5, 3)  # atol, pixels of the 48x64 frame allowed past it


def mode_frame(renderer, cfg, what: str, kernels=(NEAREST, "capped_walk")):
    """Frame 0 of ``cfg`` through render_frame with ``renderer``'s scene and
    intersector, in a counted run that must launch ``kernels`` and no plain
    version on a CUDA tensor -> (image, the run's launches)."""
    from tpu_pathtracer_torch.ops.shade import shade_kernel_covers
    from tpu_pathtracer_torch.render.state import init_state, render_frame

    with counted_run() as run:
        st = render_frame(init_state(HEIGHT, WIDTH, samples=cfg.spectrum_samples),
                          renderer.scene, cfg, renderer.camera, renderer._intersect)
        img = st.accum.cpu().numpy()
    if min(run["launches"][k] for k in kernels) <= 0 or any(run["plain_cuda"].values()):
        raise AssertionError(f"frame mode {what}: expected launches of {kernels}: {run}")
    # the shading kernel runs where its rule covers the frame, and only there
    if bool(run["launches"]["shade_bounce"]) != shade_kernel_covers(cfg, renderer.scene):
        raise AssertionError(f"frame mode {what}: shade_bounce launched "
                             f"{run['launches']['shade_bounce']} times: {run}")
    if not np.isfinite(img).all() or img.mean() <= 0:
        raise AssertionError(f"frame mode {what}: image not finite or black")
    return img, run["launches"]


def mode_turns(label: str, tmp: str, configs: dict, per: int = 1) -> dict:
    """Renderer frames of each config of ``configs`` in turns (first to last
    and back): 1 warm-up + 2 timed frames a turn by the host clock, one
    staged frame (walk spans) and one profiled frame (device time, kernels);
    launches counted over the turn's 5 frames.  ``per``: samples a frame.
    -> {config: [turn readings]}."""
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.ops.shade import shade_kernel_covers

    rs = {k: Renderer(SCENE, WIDTH, HEIGHT, RenderConfig(**MODE_BASE, **kw))
          for k, kw in configs.items()}
    order = list(configs) + list(configs)[::-1]
    out = {k: [] for k in configs}
    for i, k in enumerate(order):
        r = rs[k]
        with counted_run() as run:
            r.run(1)
            t0 = time.perf_counter()
            r.run(2)
            ms = (time.perf_counter() - t0) / 2 * 1e3
            stages = staged_frame(r)
            dev, count = device_ms(r, os.path.join(tmp, f"{label}{i}"))
        launches = {n: run["launches"][n] / 5 for n in (NEAREST, "capped_walk", *SHADE_SORT)}
        covered = shade_kernel_covers(r.cfg, r.scene)
        if (min(launches[n] for n in (NEAREST, "capped_walk")) <= 0
                or bool(launches["shade_bounce"]) != covered
                or bool(launches["sort_key"]) != r.cfg.sort_rays
                or any(run["plain_cuda"].values())):
            raise AssertionError(f"{label} turn {k} (shading kernel covers it: {covered}): "
                                 f"{run}")
        out[k].append({"ms": ms, "walk_nearest": stages.get("walk_nearest", 0.0),
                       "walk_shadow": stages.get("walk_shadow", 0.0),
                       "sort": stages.get("sort", 0.0), "device_ms": dev,
                       "kernels": count, "launches": launches})
        log(f"  {label}, {k}: {ms:.2f} ms/frame = {ms / per:.2f} ms/sample; walk_nearest "
            f"{stages.get('walk_nearest', 0.0):.2f} ms = "
            f"{stages.get('walk_nearest', 0.0) / per:.2f} ms/sample, walk_shadow "
            f"{stages.get('walk_shadow', 0.0):.2f}, sort {stages.get('sort', 0.0):.2f} ms; "
            f"device {dev:.2f} ms in {count} kernels a frame; launches a frame "
            + ", ".join(f"{n} {v:g} ({v / per:g} a sample)" for n, v in launches.items()))
    return out


def phase_frame_modes(tmp: str, smi: str) -> dict:
    """The frame modes on the card: the Mitsuba gates (75x100, 48 spp);
    each mode against its partner at 1080p; the unsorted pipeline's
    self-golden gate (150x200, depth 8, 16 frames); TILED and r2 frames
    against the port's own CPU frames (48x64); bench --spp 2 --fuse 2 and
    the CLI with --spp-per-frame 2 --row-tiles 2 --noise tiled and an env
    map; then fused against unfused and unsorted against sorted 1080p
    frames in turns -> the launches a sample at fuse 2 of kernels 1, 2 and
    7."""
    from tpu_pathtracer_torch import Renderer, RenderConfig, bench
    from tpu_pathtracer_torch.config import NoiseMode
    from tpu_pathtracer_torch.io.exr import read_exr, write_exr
    from tpu_pathtracer_torch.scene.assets import golden_path
    from tpu_pathtracer_torch.utils.compare import downsample, metrics

    t_phase = time.perf_counter()
    log(f"frame modes on {smi}")
    rel, lo, hi = MITSUBA
    for name, depth in MITSUBA_GATES:
        with counted_run() as run:
            r = Renderer(name, 100, 75, RenderConfig(samples_per_frame=48,
                                                     max_path_length=depth))
            r.run(1)
        gold, _ = read_exr(golden_path(name, depth))
        m = metrics(r.image(), downsample(gold, 75, 100))
        log(f"  Mitsuba gate {name} depth {depth} (75x100, 48 spp, fused 2 a wavefront): "
            f"{m}; launches {run['launches'][NEAREST]} window, "
            f"{run['launches']['capped_walk']} capped")
        if not (m["rel_mse"] < rel and lo < m["mean_ratio"] < hi) or not run["launches"][
                NEAREST] or any(run["plain_cuda"].values()):
            raise AssertionError(f"Mitsuba gate {name} depth {depth}: {m}, {run}")

    renderer = Renderer(SCENE, WIDTH, HEIGHT)
    imgs, per_sample = {}, {}
    for what, (kw_a, kw_b, tol) in MODE_PAIRS.items():
        pair = []
        for kw in (kw_a, kw_b):
            key = json.dumps(kw, sort_keys=True)
            if key not in imgs:
                imgs[key] = mode_frame(renderer, RenderConfig(**MODE_BASE, **kw), key)
            pair.append(imgs[key])
        (a, la), (b, _) = pair
        d = float(np.abs(a - b).max())
        ok = np.array_equal(a, b) if tol is None else np.allclose(a, b, atol=tol[0],
                                                                  rtol=tol[1])
        log(f"  {what} (1080p, depth 8, frame 0): max |diff| {d:.3g}, "
            f"{'bit-equal' if tol is None else f'atol {tol[0]:g}, rtol {tol[1]:g}'}; "
            f"launches {la[NEAREST]} window, {la['capped_walk']} capped")
        if not ok:
            raise AssertionError(f"frame mode {what}: max |diff| {d}")
        if what.startswith("fuse 2"):
            per_sample = {k: la[k] / 2 for k in (NEAREST, "capped_walk", *SHADE_SORT)}
    fused_cfg = RenderConfig(**MODE_BASE, samples_per_frame=2, fuse_samples=2,
                             fuse_shadow_walk=True)
    img, la = mode_frame(renderer, fused_cfg, "fused walk, spp 2",
                         kernels=(NEAREST, "window_walk_orig"))
    per_sample["window_walk_orig"] = la["window_walk_orig"] / 2
    check_parity("  fused path+shadow walk at spp 2 (2N = "
                 f"{4 * HEIGHT * WIDTH} lanes) vs separate walks",
                 img, imgs[json.dumps(MODE_PAIRS["fuse 2 vs fuse 1 (spp 2)"][0],
                                      sort_keys=True)][0])
    del renderer, imgs

    here = os.path.dirname(os.path.abspath(__file__))
    gold, _ = read_exr(os.path.join(here, "assets", "self_golden", f"{SCENE}-8.exr"))
    with counted_run() as run:
        r = Renderer(SCENE, 200, 150, RenderConfig(max_path_length=8, sort_rays=False))
        r.run(PARITY_FRAMES)
    if (min(run["launches"][k] for k in (NEAREST, "capped_walk")) <= 0
            or any(run["plain_cuda"].values())):
        raise AssertionError(f"unsorted gate: {run}")
    check_parity("  unsorted pipeline (sort_rays=False) vs self-golden (150x200, depth 8, "
                 "16 frames)", r.image(), gold)

    atol, allowed = CARD_VS_CPU
    for kw, frames in (({"noise_mode": NoiseMode.TILED}, 4), ({"sampler": "r2"}, 2)):
        got = {}
        for dev in ("cuda", "cpu"):
            with counted_run() as run:
                r = Renderer("cornellbox", 64, 48, RenderConfig(max_path_length=4, **kw),
                             device=dev)
                r.run(frames)
            got[dev] = r.image()
            if dev == "cuda" and (
                    min(run["launches"][k] for k in (NEAREST, "capped_walk")) <= 0
                    or any(run["plain_cuda"].values())):
                raise AssertionError(f"{kw} card frame: {run}")
            if dev == "cuda" and "sampler" in kw:  # the r2 sampler's own kernel
                r2_run = {"launches": run["launches"]["uniforms_r2"], "frames": frames}
                if not r2_run["launches"] or run["launches"]["uniforms"]:
                    raise AssertionError(f"r2 card frame: not on uniforms_r2: {run}")
        d = np.abs(got["cuda"] - got["cpu"]).max(axis=2)
        off = int((d > atol).sum())
        log(f"  {kw} card frame vs the port's CPU frame (48x64, depth 4, {frames} frames): "
            f"max |diff| {float(d.max()):.3g}, {off} pixels past atol {atol:g}")
        if off > allowed or not np.isfinite(got["cuda"]).all():
            raise AssertionError(f"{kw}: card frame differs from the CPU frame")

    buf = io.StringIO()
    with counted_run() as run, contextlib.redirect_stdout(buf):
        rc = bench.main(["--width", str(WIDTH), "--height", str(HEIGHT), "--depth", "8",
                         "--spp", "2", "--fuse", "2", "--frames", "2", "--warmup", "1"])
    line = buf.getvalue().strip().splitlines()[-1]
    log(f"  bench --spp 2 --fuse 2: {line}")
    out = json.loads(line)
    want = (NEAREST, "capped_walk", "window_walk_counts")
    if (rc or not out["finite"] or not out["metric"].endswith("_2spp")
            or "density_caveat" not in out["utilization"]
            or min(run["launches"][k] for k in want) <= 0
            or any(run["plain_cuda"].values())):
        raise AssertionError(f"bench --spp 2: rc {rc}, {out}, {run}")

    env = os.path.join(tmp, "modes-sky.exr")
    write_exr(env, sky_map(), half=False)
    exr = os.path.join(tmp, "modes.exr")
    with counted_run() as run:
        rc, _, sec = run_cli(["--scene", SCENE, "--width", str(WIDTH), "--height",
                              str(HEIGHT), "--depth", "8", "--frames", "2", "--env", env,
                              "--spp-per-frame", "2", "--row-tiles", "2", "--noise",
                              "tiled", "--exr", exr])
    img, _ = read_exr(exr)
    log(f"  CLI --spp-per-frame 2 --row-tiles 2 --noise tiled --env: rc {rc}, {sec:.2f} s, "
        f"launches {run['launches']}")
    if (rc or img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all()
            or min(run["launches"][k] for k in (NEAREST, "anyhit_walk")) <= 0
            or any(run["plain_cuda"].values())):
        raise AssertionError(f"CLI frame modes: rc {rc}, {run}")

    log(f"frame-mode turns on {smi} ({WIDTH}x{HEIGHT}, depth 8)")
    fuse = mode_turns("fuse", tmp, {"fuse 2": {"samples_per_frame": 2, "fuse_samples": 2},
                                    "fuse 1": {"samples_per_frame": 2, "fuse_samples": 1}},
                      per=2)
    sort = mode_turns("sort", tmp, {"sorted": {}, "unsorted": {"sort_rays": False}})
    log(f"frame modes phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_per_sample_fuse2": per_sample, "fuse_turns": fuse,
            "sort_turns": sort, "uniforms_r2": r2_run}


# the small scenes of the reference's own tests of the extensions (written
# out here: this script imports no test code): the GGX floor under a big
# light (tests/test_rough_materials.py:_rough_scene), the textured floor
# (tests/test_texture.py) and the tilted glass pane over a lit floor
# (tests/test_bsdf.py:test_refract_scene_renders_finite_and_differs)
QUAD_OBJ = """mtllib scene.mtl
v -2 0 -2
v  2 0 -2
v  2 0  2
v -2 0  2
v -2 1.5 -2
v  2 1.5 -2
v  2 1.5  2
v -2 1.5  2
vn 0 1 0
vn 0 -1 0
usemtl floor
f 1//1 2//1 3//1
f 1//1 3//1 4//1
usemtl lamp
f 5//2 7//2 6//2
f 5//2 8//2 7//2
"""
ROUGH_MTL = """newmtl floor
Kd 0.9 0.6 0.3
Ka 0 0 0
Ks {ks}
newmtl lamp
Kd 0 0 0
Ka 1 1 1
Ks 1 0 0
"""
TEX_OBJ = """mtllib scene.mtl
v -2 0 -2
v  2 0 -2
v  2 0  2
v -2 0  2
v -1 3 -1
v  1 3 -1
v  1 3  1
v -1 3  1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
vn 0 -1 0
usemtl floor
f 1/1/1 2/2/1 3/3/1
f 1/1/1 3/3/1 4/4/1
usemtl lamp
f 5/1/2 7/3/2 6/2/2
f 5/1/2 8/4/2 7/3/2
"""
TEX_MTL = """newmtl floor
Kd 1 1 1
Ka 0 0 0
Ks 1 0 0
map_Kd tex.png
newmtl lamp
Kd 0 0 0
Ka 8 8 8
Ks 1 0 0
"""
GLASS_OBJ = """mtllib scene.mtl
v -3 0 -3
v  3 0 -3
v  3 0  3
v -3 0  3
v -2 0.2 1.4
v  2 0.2 1.4
v  2 2.2 0.4
v -2 2.2 0.4
v -2 3.2 -2
v  2 3.2 -2
v  2 3.2  0
v -2 3.2  0
vn 0 1 0
vn 0 0.4472 0.8944
vn 0 -1 0
usemtl floor
f 1//1 2//1 3//1
f 1//1 3//1 4//1
usemtl glass
f 5//2 6//2 7//2
f 5//2 7//2 8//2
usemtl lamp
f 9//3 11//3 10//3
f 9//3 12//3 11//3
"""
GLASS_MTL = """newmtl floor
Kd 0.8 0.2 0.1
Ka 0 0 0
Ks 1 0 0
newmtl glass
Kd 1 1 1
Ka 0 0 0
Ks 0 0 1.5
newmtl lamp
Kd 0 0 0
Ka 3 3 3
Ks 1 0 0
"""
DISPERSION = 0.0042  # Cauchy B (um^2) of BK7
HERO = {"spectrum_samples": 16, "hero_wavelengths": 4}
# the spectral and material path's pairs at 1080p, one frame each: (config,
# partner, (atol, rtol) or None: bit-equal)
SPECTRAL_PAIRS = {
    "hero fuse 2 vs fuse 1 (spp 2)": ({**HERO, "samples_per_frame": 2, "fuse_samples": 2},
                                      {**HERO, "samples_per_frame": 2, "fuse_samples": 1},
                                      (1e-6, 1e-5)),
    "hero prefix_sort vs default": ({**HERO, "prefix_sort": True}, HERO, (2e-6, 0.0)),
    "bake_materials vs unbaked": ({"bake_materials": True}, {}, None),
}


def small_scenes(tmp: str) -> dict:
    """Write the extension test scenes into ``tmp`` -> {name: (obj path,
    load_scene keywords)}."""
    from tpu_pathtracer_torch.io.png import write_png

    def put(name, obj, mtl):
        d = os.path.join(tmp, name)
        os.makedirs(d, exist_ok=True)
        for ext, text in (("obj", obj), ("mtl", mtl)):
            with open(os.path.join(d, f"scene.{ext}"), "w") as fh:
                fh.write(text)
        return os.path.join(d, "scene.obj")

    tex = put("textured", TEX_OBJ, TEX_MTL)
    write_png(os.path.join(os.path.dirname(tex), "tex.png"),
              np.random.default_rng(3).uniform(0.0, 1.0, (8, 6, 3)).astype(np.float32))
    return {
        "GGX conductor": (put("conductor", QUAD_OBJ, ROUGH_MTL.format(ks="0.5 1 0")),
                          {"rough_materials": True}),
        "GGX plastic": (put("plastic", QUAD_OBJ, ROUGH_MTL.format(ks="0.3 0 -1.49")),
                        {"rough_materials": True}),
        "textured": (tex, {}),
        "glass pane": (put("glass", GLASS_OBJ, GLASS_MTL), {}),
    }


def phase_spectral(tmp: str, smi: str) -> dict:
    """The spectral and material path on the card: the user's spectral CLI
    command at 1080p (S = 16, hero 4, dispersion), and with --env; card
    frames against the port's CPU frames (48x64, depth 4) for each
    extension; the 1080p pairs (hero fuse 2 vs fuse 1, hero prefix sorts,
    baked vs unbaked), the GGX and textured scenes at 1080p; the bench with
    --bake-materials (an inert field on the card); then three configurations
    in turns -> the launches a frame of kernels 1, 2 and 4 on the spectral
    CLI path."""
    from tpu_pathtracer_torch import Renderer, RenderConfig, bench
    from tpu_pathtracer_torch.io.exr import read_exr, write_exr
    from tpu_pathtracer_torch.scene import attach_dispersion, load_scene, scene_path

    t_phase = time.perf_counter()
    log(f"spectral and material path on {smi}")
    env = os.path.join(tmp, "spectral-sky.exr")
    write_exr(env, sky_map(), half=False)
    per_frame = {}
    for label, extra, kernels in (
            ("", [], (NEAREST, "capped_walk")),
            (" --env", ["--env", env], (NEAREST, "anyhit_walk"))):
        exr, png = os.path.join(tmp, "spectral.exr"), os.path.join(tmp, "spectral.png")
        with counted_run() as run:
            rc, _, sec = run_cli(["--scene", SCENE, "--width", str(WIDTH), "--height",
                                  str(HEIGHT), "--depth", "8", "--frames", "5",
                                  "--spectrum", "16", "--hero", "4", "--dispersion",
                                  str(DISPERSION), "-o", exr, "--png", png] + extra)
        img, _ = read_exr(exr)
        la = run["launches"]
        log(f"  CLI --spectrum 16 --hero 4 --dispersion {DISPERSION}{label} (1080p, depth "
            f"8, 5 frames): rc {rc}, {sec:.2f} s, EXR {img.shape}, mean "
            f"{float(img.mean()):.5f}; launches a frame "
            + ", ".join(f"{k} {la[k] / 5:g}" for k in
                        (NEAREST, "capped_walk", "anyhit_walk")))
        # hero sampling with dispersion (and the env) shades in the kernel
        # (ops/shade.py:shade_kernel_covers), once a bounce; its sorts take the
        # kernels
        if (rc or img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all()
                or img.mean() <= 0 or not os.path.exists(png)
                or min(la[k] for k in kernels) <= 0 or la["shade_bounce"] != 8 * 5
                or not la["sort_key"] or any(run["plain_cuda"].values())):
            raise AssertionError(f"spectral CLI{label}: rc {rc}, {run}")
        for k in (*kernels, *SHADE_SORT):
            per_frame[k] = la[k] / 5

    atol, allowed = CARD_VS_CPU
    scenes = small_scenes(tmp)
    cases = {
        "S 8": (lambda dev: load_scene(scene_path("cornellbox"), samples=8, device=dev),
                {"spectrum_samples": 8}),
        "S 16, hero 4, dispersion": (
            lambda dev: attach_dispersion(load_scene(scene_path(SCENE), samples=16,
                                                     device=dev), DISPERSION), HERO),
        "bake_materials": (lambda dev: load_scene(scene_path(SCENE), device=dev),
                           {"bake_materials": True}),
        **{name: ((lambda dev, p=path, kw=kw: load_scene(p, device=dev, **kw)),
                  {"refract_dielectric": True} if name == "glass pane" else {})
           for name, (path, kw) in scenes.items()},
    }
    for what, (make, kw) in cases.items():
        got = {}
        for dev in ("cuda", "cpu"):
            with counted_run() as run:
                r = Renderer(make(dev), 64, 48, RenderConfig(max_path_length=4, **kw),
                             device=dev)
                r.run(2)
            got[dev] = r.image()
            if dev == "cuda" and (
                    min(run["launches"][k] for k in (NEAREST, "capped_walk")) <= 0
                    or any(run["plain_cuda"].values())):
                raise AssertionError(f"{what} card frame: {run}")
        d = np.abs(got["cuda"] - got["cpu"]).max(axis=2)
        off = int((d > atol).sum())
        log(f"  {what}: card frame vs the port's CPU frame (48x64, depth 4, 2 frames, "
            f"S {got['cuda'].shape[2]}): max |diff| {float(d.max()):.3g}, {off} pixels past "
            f"atol {atol:g}")
        if off > allowed or not np.isfinite(got["cuda"]).all() or got["cuda"].mean() <= 0:
            raise AssertionError(f"{what}: card frame differs from the CPU frame")

    scene16 = load_scene(scene_path(SCENE), samples=16)
    scene3 = load_scene(scene_path(SCENE))
    for what, (kw_a, kw_b, tol) in SPECTRAL_PAIRS.items():
        scene = scene16 if "hero" in what else scene3
        (a, la), (b, _) = (mode_frame(Renderer(scene, WIDTH, HEIGHT, cfg), cfg, what)
                           for cfg in (RenderConfig(**MODE_BASE, **kw) for kw in (kw_a, kw_b)))
        d = float(np.abs(a - b).max())
        ok = np.array_equal(a, b) if tol is None else np.allclose(a, b, atol=tol[0],
                                                                  rtol=tol[1])
        log(f"  {what} (1080p, depth 8, frame 0): max |diff| {d:.3g}, "
            f"{'bit-equal' if tol is None else f'atol {tol[0]:g}, rtol {tol[1]:g}'}; "
            f"launches {la[NEAREST]} window, {la['capped_walk']} capped")
        if not ok:
            raise AssertionError(f"{what}: max |diff| {d}")
    for name in ("GGX conductor", "GGX plastic", "textured"):
        path, kw = scenes[name]
        img, la = mode_frame(Renderer(load_scene(path, **kw), WIDTH, HEIGHT),
                             RenderConfig(**MODE_BASE), name)
        log(f"  {name} at 1080p, depth 8, frame 0: finite, mean {float(img.mean()):.5f}; "
            f"launches {la[NEAREST]} window, {la['capped_walk']} capped")
    del scene16, scene3

    buf = io.StringIO()
    with counted_run() as run, contextlib.redirect_stdout(buf):
        rc = bench.main(["--width", str(WIDTH), "--height", str(HEIGHT), "--depth", "8",
                         "--bake-materials", "--frames", "2", "--warmup", "1"])
    line = buf.getvalue().strip().splitlines()[-1]
    log(f"  bench --bake-materials: {line}")
    out = json.loads(line)
    want = (NEAREST, "capped_walk", "window_walk_counts")
    if (rc or not out["finite"] or "utilization" not in out
            or min(run["launches"][k] for k in want) <= 0
            or any(run["plain_cuda"].values())):
        raise AssertionError(f"bench --bake-materials: rc {rc}, {out}, {run}")

    log(f"spectral turns on {smi} ({WIDTH}x{HEIGHT}, depth 8)")
    configs = {"S 3": {}, "S 16, hero 4": HERO, "S 16": {"spectrum_samples": 16}}
    turns = mode_turns("spectral", tmp, configs)
    log(f"spectral phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_per_frame_spectral": per_frame, "turns": turns}


MESH_SPP_ATOL = 2e-6  # a sample split: the rounding of the sum over spp (tests/test_parallel.py)
MESH_WORKER_TIMEOUT = 240  # seconds a process of the two-process run may take


def cuda_mesh(tiles: int, spp: int = 1):
    """A virtual mesh on the one card: ``cuda:0`` named tiles x spp times."""
    from tpu_pathtracer_torch.parallel.tiles import make_mesh

    return make_mesh(tiles, spp, devices=[torch.device("cuda:0")] * (tiles * spp))


def mesh_run(what: str, scene, frames: int, mesh=None, width: int | None = None,
             height: int | None = None, kernels=(NEAREST, "capped_walk"), **kw):
    """``frames`` Renderer frames of ``scene`` (depth 8, ``kw`` RenderConfig
    fields; WIDTH x HEIGHT unless given) on ``mesh`` or on no mesh, in a
    counted run that must launch ``kernels`` and no plain version on a CUDA
    tensor -> (renderer, image, launches a frame)."""
    from tpu_pathtracer_torch import Renderer, RenderConfig

    width, height = width or WIDTH, height or HEIGHT
    with counted_run() as run:
        r = Renderer(scene, width, height, RenderConfig(max_path_length=8, **kw), mesh=mesh)
        r.run(frames)
        img = r.image()
    if min(run["launches"][k] for k in kernels) <= 0 or any(run["plain_cuda"].values()):
        raise AssertionError(f"mesh run {what}: expected launches of {kernels}: {run}")
    if img.shape[:2] != (height, width) or not np.isfinite(img).all():
        raise AssertionError(f"mesh run {what}: image not finite or of shape {img.shape}")
    return r, img, {k: v / frames for k, v in run["launches"].items() if v}


def mesh_equal(what: str, got, want, atol: float | None = None) -> None:
    """Bit-equal (``atol`` None) or within ``atol``, else fail."""
    d = float(np.abs(got - want).max())
    ok = np.array_equal(got, want) if atol is None else d <= atol
    log(f"  {what}: max |diff| {d:.3g} ({'bit-equal' if atol is None else f'atol {atol:g}'})")
    if not ok:
        raise AssertionError(f"{what}: max |diff| {d}")


def multihost_worker() -> None:
    """One process of the two-process run (``python -c "import chip_smoke;
    chip_smoke.multihost_worker()" <rank> <port> <dir>``): gloo on
    127.0.0.1, a multihost mesh of this process's local card, 3 frames at
    1080p; the gathered image must equal the single-process one in
    ``<dir>/ref.npy``; then the directory checkpoint ``<dir>/ck``, written
    with the other rank."""
    from tpu_pathtracer_torch import Renderer
    from tpu_pathtracer_torch.parallel.multihost import make_multihost_mesh

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=2, rank=rank)
    try:
        mesh = make_multihost_mesh()
        if mesh.shape != {"tiles": 2, "spp": 1} or mesh.ranks != ((0,), (1,)):
            raise AssertionError(f"multihost mesh {mesh}")
        with counted_run() as run:
            r = Renderer(SCENE, WIDTH, HEIGHT, mesh=mesh)
            t0 = time.perf_counter()
            r.run(3)
            ms = (time.perf_counter() - t0) / 3 * 1e3
        img = r.image()
        if not np.array_equal(img, np.load(os.path.join(out, "ref.npy"))):
            raise AssertionError(f"rank {rank}: the gathered image differs from the "
                                 "single-process frame")
        if min(run["launches"][k] for k in (NEAREST, "capped_walk")) <= 0 or any(
                run["plain_cuda"].values()):
            raise AssertionError(f"rank {rank}: {run}")
        r.save_checkpoint(os.path.join(out, "ck"))
    finally:
        torch.distributed.destroy_process_group()
    launches = {k: v for k, v in run["launches"].items() if v}
    print(f"MULTIHOST_OK rank {rank}: {ms:.2f} ms/frame, launches {launches}", flush=True)


def two_process_run(tmp: str, ref) -> None:
    """Two processes on the one card joined by gloo, each rendering its tile
    of a 2x1 multihost mesh; each must exit 0 within MESH_WORKER_TIMEOUT,
    and the checkpoint directory both wrote must hold ``ref``."""
    import socket

    from tpu_pathtracer_torch.io.checkpoint import load_checkpoint

    np.save(os.path.join(tmp, "ref.npy"), ref)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.multihost_worker()",
         str(rank), port, tmp], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            left = max(1.0, MESH_WORKER_TIMEOUT - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-12:]:
            log(f"  | rank {rank}: {line}")
        if p.returncode:
            raise AssertionError(f"two-process run: rank {rank} exited {p.returncode}")
    st = load_checkpoint(os.path.join(tmp, "ck"))
    if st.frame_index != 3 or not np.array_equal(st.accum.numpy(), ref):
        raise AssertionError("two-process run: the checkpoint both ranks wrote differs")
    log(f"  two processes on one card (gloo, a 2x1 multihost mesh, 3 frames at "
        f"{WIDTH}x{HEIGHT}): gathered images and the shared checkpoint equal the "
        f"single-process frame; {time.perf_counter() - t0:.1f} s")


def phase_multi_device(tmp: str, smi: str) -> dict:
    """The multi-device split on the card (Water-plastic, 1080p, depth 8):
    1x1 and 2x1 virtual meshes bit-equal to the single-device frames with
    the 1x1 launching what Renderer() launches; 1x2 and 2x2 at 2 spp within
    MESH_SPP_ATOL; the env-lit 2x1 mesh; the self-golden gate on 2x1, and
    its limits on 2x2 at 2 spp against Renderer() at 2 spp; two processes
    on the card; the directory checkpoint of the 2x1 mesh resumed
    on 1x1 and on no mesh; bench --mesh 1x1; then no mesh, 1x1 and 2x1 in
    turns -> the launches a frame of kernels 1, 2 and 4 on the 2x1 mesh."""
    from tpu_pathtracer_torch import Renderer, RenderConfig, bench
    from tpu_pathtracer_torch.io.exr import read_exr
    from tpu_pathtracer_torch.scene import attach_env, load_scene, scene_path

    t_phase = time.perf_counter()
    log(f"multi-device split on {smi} ({WIDTH}x{HEIGHT}, depth 8, virtual meshes on cuda:0)")
    scene = load_scene(scene_path(SCENE))

    plain, img, per = mesh_run("no mesh", scene, 3)
    r11, img11, per11 = mesh_run("1x1", scene, 3, mesh=cuda_mesh(1))
    mesh_equal("1x1 mesh vs Renderer(), 3 frames", img11, img)
    if per11 != per:
        raise AssertionError(f"1x1 launches a frame {per11} against Renderer()'s {per}")
    log(f"  launches a frame, no mesh and 1x1: {per}")
    r21, img21, per21 = mesh_run("2x1", scene, 3, mesh=cuda_mesh(2))
    mesh_equal("2x1 mesh vs Renderer(), 3 frames", img21, img)
    log(f"  launches a frame, 2x1: {per21}")
    _, img2, _ = mesh_run("no mesh, 2 spp", scene, 2, samples_per_frame=2)
    for tiles, spp in ((1, 2), (2, 2)):
        _, got, _ = mesh_run(f"{tiles}x{spp}", scene, 2, mesh=cuda_mesh(tiles, spp),
                             samples_per_frame=2)
        mesh_equal(f"{tiles}x{spp} mesh vs Renderer() at 2 spp, 2 frames", got, img2,
                   MESH_SPP_ATOL)
    lit = attach_env(scene, sky_map())
    env_kernels = (NEAREST, "anyhit_walk")
    _, want, _ = mesh_run("env-lit, no mesh", lit, 2, kernels=env_kernels)
    _, got, per_env = mesh_run("env-lit 2x1", lit, 2, mesh=cuda_mesh(2), kernels=env_kernels)
    mesh_equal("env-lit 2x1 mesh vs Renderer(), 2 frames", got, want)
    log(f"  launches a frame, env-lit 2x1: {per_env}")

    # the committed self-golden holds 1-spp frames, which a 2-sample-shard
    # mesh cannot split: 2x1 takes that gate, 2x2 at 2 spp the same limits
    # against the single-device 2-spp frames
    here = os.path.dirname(os.path.abspath(__file__))
    gold, _ = read_exr(os.path.join(here, "assets", "self_golden", f"{SCENE}-8.exr"))
    gate = {"scene": scene, "frames": PARITY_FRAMES, "width": 200, "height": 150}
    _, got, _ = mesh_run("2x1 gate", mesh=cuda_mesh(2), **gate)
    check_parity(f"  2x1 mesh vs self-golden (150x200, depth 8, {PARITY_FRAMES} frames)",
                 got, gold)
    _, want, _ = mesh_run("2-spp gate", samples_per_frame=2, **gate)
    _, got, _ = mesh_run("2x2 gate", mesh=cuda_mesh(2, 2), samples_per_frame=2, **gate)
    check_parity(f"  2x2 mesh vs Renderer() at 2 spp (150x200, depth 8, {PARITY_FRAMES} "
                 "frames)", got, want)

    two_process_run(tmp, img)

    ck = os.path.join(tmp, "mesh-ck")
    r21.save_checkpoint(ck)
    with counted_run() as run:
        r21.run(1)
        nxt = {"2x1": r21.image()}
        for label, mesh in (("1x1", cuda_mesh(1)), ("no mesh", None)):
            r = Renderer(scene, WIDTH, HEIGHT, mesh=mesh)
            r.load_checkpoint(ck)
            r.run(1)
            nxt[label] = r.image()
    if any(run["plain_cuda"].values()):
        raise AssertionError(f"checkpoint resume: {run}")
    for label in ("1x1", "no mesh"):
        mesh_equal(f"frame 4 resumed on {label} from the 2x1 mesh's directory checkpoint "
                   "vs the 2x1 mesh's own", nxt[label], nxt["2x1"])
    del plain, r11, r21

    buf = io.StringIO()
    with counted_run() as run, contextlib.redirect_stdout(buf):
        rc = bench.main(["--width", str(WIDTH), "--height", str(HEIGHT), "--mesh", "1x1",
                         "--frames", "2", "--warmup", "1"])
    line = buf.getvalue().strip().splitlines()[-1]
    log(f"  bench --mesh 1x1: {line}")
    out = json.loads(line)
    if (rc or out["metric"] != "traced_mrays_per_sec_aggregate_1x1mesh_1spp"
            or out["mesh"] != "1x1" or "utilization" in out or not out["finite"]
            or min(run["launches"][k] for k in (NEAREST, "capped_walk")) <= 0
            or any(run["plain_cuda"].values())):
        raise AssertionError(f"bench --mesh 1x1: rc {rc}, {out}, {run}")

    log(f"mesh turns on {smi} ({WIDTH}x{HEIGHT}, depth 8; 1 warm-up + 2 timed frames "
        "and one profiled frame a turn)")
    rs = {"no mesh": Renderer(scene, WIDTH, HEIGHT),
          "1x1": Renderer(scene, WIDTH, HEIGHT, mesh=cuda_mesh(1)),
          "2x1": Renderer(scene, WIDTH, HEIGHT, mesh=cuda_mesh(2))}
    turns = {k: [] for k in rs}
    for i, k in enumerate(list(rs) + list(rs)[::-1]):
        with counted_run() as run:
            rs[k].run(1)
            t0 = time.perf_counter()
            rs[k].run(2)
            ms = (time.perf_counter() - t0) / 2 * 1e3
            dev, count = device_ms(rs[k], os.path.join(tmp, f"mesh{i}"))
        launches = {n: run["launches"][n] / 4 for n in (NEAREST, "capped_walk")}
        turns[k].append({"ms": ms, "device_ms": dev, "kernels": count, "launches": launches})
        log(f"  mesh turn, {k}: {ms:.2f} ms/frame; device {dev:.2f} ms in {count} kernels "
            "a frame; launches a frame " + ", ".join(f"{n} {v:g}" for n, v in launches.items()))
    log(f"multi-device phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_per_frame_mesh2x1": {**{k: per21[k] for k in (NEAREST,
                                                                     "capped_walk",
                                                                     *SHADE_SORT)},
                                           "anyhit_walk": per_env["anyhit_walk"]},
            "turns": turns}


def terrain_renderer(scene, **kw):
    """Renderer(scene, WIDTH, HEIGHT) with the default camera and SAH
    builder; ``kw`` are RenderConfig fields.  Prints the table bytes the
    route choice reads."""
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.render import wavefront as wf

    t0 = time.perf_counter()
    r = Renderer(scene, WIDTH, HEIGHT, RenderConfig(**kw), builder="sah")
    torch.cuda.synchronize()
    log(f"  Renderer(build_scene(terrain)) {WIDTH}x{HEIGHT} {kw or 'default'}: "
        f"{scene.num_triangles} triangles, {r.layout.num_nodes} + "
        f"{r.layout_occl.num_nodes} nodes, set-up {time.perf_counter() - t0:.2f} s; "
        f"table bytes {wf.layout_vmem_bytes(r.layout)} (leaf 56), "
        f"{wf.layout_vmem_bytes(r.layout_occl)} (leaf 8), HBM-route resident "
        f"{wf.layout_hbm_vmem_bytes(r.layout)}; route "
        f"{'HBM' if r._intersect.hbm else 'whole-table'}")
    return r


def phase_terrain_path(scene, label: str, timed: int = 3, **kw) -> tuple[dict, int]:
    """The terrain frame at 1920x1080, depth 8, through Renderer: the route
    must be the HBM route; 2 warm-up + ``timed`` frames, exact rays, spans;
    the HBM window walk launched (its nearest-hit queries through the
    payload epilogue, its capped ones without), every launch in the config's
    tritest form, and no other kernel but the uniforms -> (the run's counts,
    frames rendered)."""
    from tpu_pathtracer_torch.render.state import frame_rng_key, fused_wavefront_key
    from tpu_pathtracer_torch.render.wavefront import hbm_route, render_sample

    r = terrain_renderer(scene, **kw)
    if not (r._intersect.hbm and hbm_route(r.cfg, r.layout, r.layout_occl)):
        raise AssertionError(f"terrain {label}: the default config did not take the "
                             "HBM route")
    with counted_run() as run:
        ms, stages = timed_frames(r, timed)
        key = fused_wavefront_key(frame_rng_key(r.cfg, r.state.key, r.state.frame_index))
        _, nrays = render_sample(r.scene, r.cfg, r.camera, HEIGHT, WIDTH, key,
                                 r.state.frame_index, r._intersect, with_ray_count=True)
        nrays = int(nrays)
    img = r.image()
    launches = run["launches"]
    log(f"terrain path {label}: {ms:.2f} ms/frame at {WIDTH}x{HEIGHT} depth 8 "
        f"(2 warm-up + {timed} timed); {nrays} traced rays/frame = "
        f"{nrays / ms / 1e3:.2f} Mrays/s; image mean {float(img.mean()):.5f}")
    log(stage_line(stages))
    log(f"  kernel launches: {launches}; plain versions on CUDA tensors: "
        f"{run['plain_cuda']}")
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all() or img.mean() <= 0:
        raise AssertionError(f"terrain {label}: image not finite, lit, or of its shape")
    others = {k: v for k, v in launches.items()
              if v and k not in ("window_walk_hbm", "uniforms", *SHADE_SORT)}
    if (launches["window_walk_hbm"] <= 0 or others or any(run["plain_cuda"].values())
            or min(launches[k] for k in SHADE_SORT) <= 0
            or min(run[c]["window_walk_hbm"] for c in ("launches_resolve",
                                                       "launches_capped")) <= 0
            or run["launches_resolve"]["window_walk_hbm"]
            + run["launches_capped"]["window_walk_hbm"] != launches["window_walk_hbm"]):
        raise AssertionError(f"terrain {label}: expected only window_walk_hbm (nearest "
                             f"queries through its payload epilogue, capped ones "
                             f"through its capped epilogue), uniforms and "
                             f"{SHADE_SORT}: {run}")
    mt = launches["window_walk_hbm"] if r.cfg.tritest == "mt" else 0
    if run["launches_mt"]["window_walk_hbm"] != mt:
        raise AssertionError(f"terrain {label}: MT launches {run['launches_mt']}, "
                             f"expected {mt} (tritest={r.cfg.tritest})")
    return run, timed + 3 + 1


def phase_terrain_counts(scene) -> dict:
    """The utilization block on the GRID 256 terrain with tritest="mt": the
    MT counting walk on its sorted bounce-1 wavefront -> its MT launches."""
    from tpu_pathtracer_torch.render.stats import utilization_report

    r = terrain_renderer(scene, tritest="mt")
    with counted_run() as run:
        rep = utilization_report(r.scene, r.cfg, r.layout, HEIGHT, WIDTH, r._intersect,
                                 1.0, 1.0)
    keys = ("live_rays", "spent_lane_ops_per_ray", "useful_lane_ops_per_ray",
            "mt_lane_utilization")
    log(f"terrain utilization (tritest=mt, {scene.num_triangles} triangles): "
        f"{ {k: rep[k] for k in keys} }")
    n = run["launches_mt"]["window_walk_counts"]
    if not n or n != run["launches"]["window_walk_counts"] or any(
            run["plain_cuda"].values()):
        raise AssertionError(f"terrain utilization: {run}")
    return n


def route_turns(scene, frames: int = 3) -> dict:
    """The HBM route and the whole-table route (hbm_tables "auto" and "off")
    on the same terrain layouts, in turns hbm, tables, tables, hbm: 1
    warm-up + ``frames`` frames each (host clock ending in a synchronise),
    then one frame under the StageTimer for the walks' time -> {route:
    [ms/frame per turn]} and {route: [walk ms per turn]}."""
    from tpu_pathtracer_torch.render.wavefront import make_intersector

    r = terrain_renderer(scene)
    fns = {"hbm": r._intersect,
           "tables": make_intersector(r.scene, r.cfg.replace(hbm_tables="off"),
                                      r.layout, r.layout_occl)}
    if not fns["hbm"].hbm or fns["tables"].hbm:
        raise AssertionError("route turns: the routes are not the ones asked for")
    out = {"hbm": [], "tables": []}
    walks = {"hbm": [], "tables": []}
    for route in ("hbm", "tables", "tables", "hbm"):
        r._intersect = fns[route]
        r.run(1)
        t0 = time.perf_counter()
        r.run(frames)
        out[route].append((time.perf_counter() - t0) / frames * 1e3)
        walks[route].append(walk_ms(staged_frame(r)))
    log(f"route turns ({scene.num_triangles} triangles, {WIDTH}x{HEIGHT}, depth 8, "
        f"{frames} frames a turn, ms/frame): HBM {out['hbm']}, whole-table "
        f"{out['tables']}; walks (ms, one staged frame a turn): HBM {walks['hbm']}, "
        f"whole-table {walks['tables']}")
    return out, walks


def phase_lbvh(scene_cuda, scene_cpu) -> None:
    """builder="lbvh" on CUDA tensors == the CPU build, table for table."""
    from tpu_pathtracer_torch.accel import build_layout

    t0 = time.perf_counter()
    lay_c = build_layout(scene_cuda, leaf_size=56, builder="lbvh")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    lay_h = build_layout(scene_cpu, leaf_size=56, builder="lbvh")
    t_host = time.perf_counter() - t0
    for name, a in lay_h._asdict().items():
        b = getattr(lay_c, name)
        if isinstance(a, torch.Tensor):
            if not torch.equal(a, b.cpu()):
                raise AssertionError(f"LBVH on the card: table {name} differs")
        elif a != b:
            raise AssertionError(f"LBVH on the card: {name} {b} != {a}")
    log(f"LBVH ({scene_cpu.num_triangles} triangles, leaf 56): the card's layout "
        f"equals the CPU's in every table ({lay_c.num_nodes} nodes); build + layout "
        f"{t_card:.2f} s with the build on the card, {t_host:.2f} s on the CPU")


def phase_backend_parity(terrain) -> None:
    """The route, builder and backend gates (150x200, depth 8, 16 frames,
    PARITY): each image against the same scene through another route."""
    from tpu_pathtracer_torch import Renderer, RenderConfig

    def image(scene, builder="sah", **kw):
        r = Renderer(scene, 200, 150, RenderConfig(max_path_length=8, **kw),
                     builder=builder)
        r.run(16)
        return r.image(), r

    hbm, rh = image(terrain)
    tables, rt = image(terrain, hbm_tables="off")
    if not rh._intersect.hbm or rt._intersect.hbm:
        raise AssertionError("terrain parity: the routes are not the ones asked for")
    check_parity("terrain parity, HBM route vs whole-table route", hbm, tables)
    lbvh, _ = image(terrain, builder="lbvh")
    check_parity("terrain parity, LBVH vs SAH build", lbvh, hbm)
    box = "cornellbox"
    kernels, _ = image(box)
    for kw in ({"use_pallas": False}, {"intersector": "brute"}):
        with counted_run() as run:
            img, _ = image(box, **kw)
        # the uniforms and the shading are kernels on every backend; no walk
        # kernel may run, and the unsorted pipeline no sort
        walks = {k: v for k, v in run["launches"].items()
                 if v and k not in ("uniforms", "uniforms_r2", "shade_bounce")}
        if (walks or not run["launches"]["uniforms"] or not run["launches"]["shade_bounce"]
                or any(run["plain_cuda"].values())):
            raise AssertionError(f"{kw}: the portable backend ran a walk or sort kernel, "
                                 f"or no uniforms or shading kernel: {run}")
        check_parity(f"cornellbox {kw} vs the kernel route", img, kernels)


def phase_edge_shapes(renderer) -> None:
    """The redesigned walks on the shapes a warp-cooperative kernel can get
    wrong, each against its plain version, bit for bit: lane counts around a
    warp (EDGE_LANES), every lane dead, one live lane a warp, prepass 0 and
    32, and the leaf-8 and leaf-16 layouts of the same scene; the shadow
    walks also with environment lanes and infinite caps."""
    from tpu_pathtracer_torch.accel import build_layout
    from tpu_pathtracer_torch.ops import hopper_traverse as ht

    waves = wavefronts(renderer.scene, renderer.layout, renderer.layout_occl, renderer.cfg)
    gen = torch.Generator().manual_seed(97531)
    pool = draw(waves["bounce1"], max(EDGE_LANES), gen, waves["bounce1"][2])
    layouts = {56: renderer.layout, 16: build_layout(renderer.scene, 16),
               8: renderer.layout_occl}

    def check(what, o, d, act, t_max, lay, prepass, tritest):
        pp = ht.window_prepass(lay, prepass)
        for form in ("window_walk", "window_walk_orig", "window_walk_counts"):
            got = getattr(ht, form)(o, d, act, t_max, lay, prepass=pp, tritest=tritest)
            want = getattr(ht, f"{form}_plain")(o, d, act, t_max, lay, prepass=pp,
                                                tritest=tritest)
            if form == "window_walk_counts":
                lo, hi = want[3], want[4]
                if not bool(((lo <= got[3]) & (got[3] <= hi)).all()):
                    raise AssertionError(f"edge {what}: spent outside its warp bounds")
                got, want = got[:3], want[:3]
            equal_on_every_lane(f"edge {what}: {form} ({tritest}) vs plain", got, want)
            if form == "window_walk":  # window_walk_resolve_plain's rows, walked once
                equal_on_every_lane(
                    f"edge {what}: {NEAREST} ({tritest}) vs plain",
                    ht.window_walk_resolve(o, d, act, t_max, lay, prepass=pp,
                                           tritest=tritest),
                    ht.window_payload_rows(lay, *want, t_max, o, d))
        if tritest == "mt":
            pm = min(prepass, lay.prepass.shape[0], lay.num_tris)
            got = ht.minwalk(o, d, act, t_max, lay, prepass=pm)
            want = ht.minwalk_plain(o, d, act, t_max, lay, prepass=pm)
            equal_on_every_lane(f"edge {what}: minwalk rows 0-5 vs plain", got[:6], want[:6])
            if float((got[6:] - want[6:]).abs().max()) > PAYLOAD_ATOL:
                raise AssertionError(f"edge {what}: minwalk payload beyond {PAYLOAD_ATOL}")

    cases = 0
    for n in EDGE_LANES:
        o, d, act = (a[..., :n].contiguous() for a in pool)
        inf = torch.full((n,), torch.inf, device=o.device)
        capped = torch.where(torch.arange(n, device=o.device) % 3 == 0, 1.5, torch.inf)
        one = torch.arange(n, device=o.device) % 32 == 7     # one live lane a warp
        masks = {"live": act, "dead": torch.zeros_like(act), "one-a-warp": one | (n < 8)}
        # the plain walk takes ~0.3 s a call at 65,537 lanes: there each mask
        # runs with one prepass
        combos = [(m, pre) for m in masks for pre in (0, 32)] if n < 64 else [
            ("live", 32), ("dead", 32), ("one-a-warp", 0)]
        for tritest in ("bw", "mt"):
            for mask_name, prepass in combos:
                check(f"n={n} {mask_name} prepass={prepass}", o, d, masks[mask_name],
                      capped if prepass else inf, layouts[56], prepass, tritest)
                cases += 1
            for leaf in (16, 8):
                check(f"n={n} leaf {leaf}", o, d, act, inf, layouts[leaf], 32, tritest)
                cases += 1
    torch.cuda.synchronize()
    log(f"edge shapes: {cases} cases (lanes {EDGE_LANES}; live, all dead and one live lane a "
        f"warp; prepass 0 and 32; leaf 56, 16 and 8; bw and mt): every form of the window "
        f"walk (its payload epilogue on all 12 rows) and minwalk bit-equal to its plain "
        f"version")

    # the shadow walks on the shadow pack's lanes, every fifth one turned into
    # an environment lane (target -1, cap 1e30), with finite and infinite caps
    pool = draw(waves["shadow"], max(EDGE_LANES), gen, waves["shadow"][2])
    env = torch.arange(max(EDGE_LANES), device=pool[0].device) % 5 == 0
    pool = (*pool[:3], torch.where(env, 1e30, pool[3]).contiguous(),
            torch.where(env, -1, pool[4]).contiguous())
    eps = renderer.cfg.distance_epsilon
    cases = 0
    for n in EDGE_LANES:
        o, d, act, cap, tgt = (a[..., :n].contiguous() for a in pool)
        lanes = torch.arange(n, device=o.device)
        masks = {"live": act, "dead": torch.zeros_like(act),
                 "one-a-warp": (lanes % 32 == 7) | (n < 8)}
        caps = {"caps": cap, "infinite caps": torch.full_like(cap, torch.inf)}
        # the plain walks take ~0.3 s a call at 65,537 lanes: there the live
        # mask runs on each layout, the other masks on leaf 8
        for leaf, lay in layouts.items():
            for mask_name, live in masks.items():
                if n > 64 and mask_name != "live" and leaf != 8:
                    continue
                for cap_name, c in caps.items():
                    what = f"edge n={n} leaf {leaf} {mask_name} {cap_name}"
                    want = ht.capped_walk_plain(o, d, live, c, lay)
                    equal_on_every_lane(f"{what}: capped_walk vs plain",
                                        (ht.capped_walk(o, d, live, c, lay),), (want,))
                    want = ht.anyhit_walk_plain(o, d, live, c, tgt, lay, eps)
                    equal_on_every_lane(f"{what}: anyhit_walk vs plain",
                                        (ht.anyhit_walk(o, d, live, c, tgt, lay, eps),),
                                        (want,))
                    cases += 1
    torch.cuda.synchronize()
    log(f"edge shapes, shadow walks: {cases} cases (lanes {EDGE_LANES}; live, all dead and "
        f"one live lane a warp; NEE caps with every fifth lane an environment lane, and "
        f"infinite caps; leaf 56, 16 and 8): the capped and any-hit walks bit-equal to "
        f"their plain versions")


def turns(fns: dict, iters: int = 5, rounds: int = 1) -> dict:
    """Each of ``fns`` timed in turns, first to last and back, ``rounds``
    times over (so two versions read new, old, old, new, ...) -> {name:
    [ms, ...]}, two readings a round."""
    names = list(fns)
    out = {k: [] for k in names}
    for k in (names + names[::-1]) * rounds:
        out[k].append(cuda_ms(fns[k], iters))
    return out


def device_ms(renderer, tmp: str) -> tuple[float, int]:
    """One frame under torch.profiler -> (device kernel ms, kernels), (nan,
    0) when the trace holds no device kernels."""
    renderer.profile(tmp, frames=1)
    with open(os.path.join(tmp, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    return (sum(e["dur"] for e in events) / 1e3 if events else float("nan")), len(events)


def max_diff(a, b) -> float:
    """max |a - b| over the lanes where both are finite; raises when one is
    finite where the other is not."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        raise AssertionError(f"finite on {int(fa.sum())} lanes against {int(fb.sum())}")
    return float((a - b)[fa].abs().max()) if bool(fa.any()) else 0.0


def sweep_bounds(lay, act, first, n_prepass: int, tests: int,
                 boxes: int) -> tuple[dict, dict]:
    """The bounds of the candidate-sweep pair on these lanes -> (count
    kernel's, targeted kernel's).  Both: o, d and the active mask read once
    (25 B a lane), the leaf boxes and the prepass block once, every live
    lane against every prepass row.  The count kernel needs every leaf box
    on every live lane (a count has no early end), adds one to its count per
    box test and writes 8 B a lane.  The targeted kernel needs only the
    boxes up to its lowest candidate: ``boxes`` box tests (first + 1 a lane
    with a candidate, every leaf a lane without, the plain version's tally);
    it also reads t_max, ``leafmeta`` and the rows of each distinct tested
    leaf, writes 20 B a lane and runs ``tests`` Moller-Trumbore row tests
    (the same tally)."""
    lanes, live = act.shape[0], int(act.sum())
    shared = (lay.num_leaves * row_bytes(lay.leafbox) + n_prepass * row_bytes(lay.prepass))
    prime = live * n_prepass * OPS_ROW["mt"]
    leaves = torch.unique(first[act & (first < lay.num_leaves)]).to(torch.int64)
    leaf_rows = int(lay.leafmeta[leaves, 1].sum())
    return (bound(lanes * (25 + 8) + shared,
                  prime + live * lay.num_leaves * (OPS_LEAF_BOX + 1)),
            bound(lanes * (RAY_BYTES + 20) + shared + lay.num_leaves * row_bytes(lay.leafmeta)
                  + leaf_rows * row_bytes(lay.tris8),
                  prime + boxes * OPS_LEAF_BOX + tests * OPS_ROW["mt"]))


def count_equals_plain(label: str, o, d, act, lay, pp: int, got) -> None:
    """The count kernel's outputs on a whole wavefront against its plain
    version, run FULL_CHUNK lanes at a time: equal on every lane."""
    from tpu_pathtracer_torch.scripts import experimental_sweep as es

    for s0 in range(0, o.shape[1], FULL_CHUNK):
        part = slice(s0, s0 + FULL_CHUNK)
        want = es.sweep_count_plain(o[:, part].contiguous(), d[:, part].contiguous(), lay,
                                    active=act[part].contiguous(), prepass=pp)
        equal_on_every_lane(f"sweep_count vs its plain version, {label}",
                            (got[0][part], got[1][part]), want)
    log(f"  sweep_count == its plain version on all {o.shape[1]} lanes of {label}")


def sweep1_work(lay, sel, first) -> tuple[int, int]:
    """The targeted kernel's work on the lanes ``sel``, unbounded, whose
    lowest candidate leaf is ``first`` (the count's) -> (leaf row tests,
    box tests): each such lane's leaf's rows, and first + 1 boxes on a lane
    with a candidate, every leaf on one without, as the tally of
    ``intersect_sweep1_plain`` counts them."""
    f = first[sel].to(torch.int64)
    tests = int(lay.leafmeta[f[f < lay.num_leaves], 1].sum())
    return tests, int(torch.clamp(f + 1, max=lay.num_leaves).sum())


def sweep1_device_us(label: str, o, d, sel, lay, pp: int) -> float:
    """Device microseconds a call of the targeted kernel (its three launches:
    the tally, the list of active lanes and the march) on one wavefront's
    lanes with at most one candidate, the calls queued behind a spin kernel
    (:func:`queued_ms`), as every short kernel here is timed."""
    from tpu_pathtracer_torch.scripts import experimental_sweep as es

    us = 1e3 * queued_ms(lambda: es.intersect_sweep1(o, d, lay, active=sel, prepass=pp))
    log(f"  sweep1 {label}: device time a call (its three launches, queued) {us:.1f} us")
    return us


def phase_sweep_kernels(renderer, terrain, compiler_log: str) -> list[dict]:
    """The candidate-sweep pair against its plain versions on 65,536 lanes
    of the Water-plastic camera and bounce-1 wavefronts, on the leaf-56 and
    the leaf-8 layout, and the count on the whole bounce-1 wavefront; timed
    on the bounce-1 lanes (and the full bounce-1 wavefront) of the leaf-56
    layout, with the leaf-8 times beside; the bounds on the full wavefront
    at both leaf sizes; the targeted kernel's device time a call there; then
    the terrain ``terrain``'s whole bounce-1 wavefront on its leaf-8 layout
    (many tiles of boxes): the count equal to its plain version on every
    lane, both kernels timed beside their bounds -> the pair's rows of the
    kernel table."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht
    from tpu_pathtracer_torch.ops.traverse import Tally
    from tpu_pathtracer_torch.scripts import experimental_sweep as es

    cfg = renderer.cfg
    layouts = {"leaf 56": renderer.layout, "leaf 8": renderer.layout_occl}
    waves = wavefronts(renderer.scene, renderer.layout, renderer.layout_occl, cfg)
    gen = torch.Generator().manual_seed(2468)
    err_count, err_one, rows, timed = 0.0, 0.0, {}, {}
    for which in ("camera", "bounce1"):
        o, d, act = draw(waves[which], SAMPLE_LANES, gen)
        for label, lay in layouts.items():
            pp = ht.window_prepass(lay, cfg.traversal_prepass)
            ck, fk = es.sweep_count(o, d, lay, active=act, prepass=pp)
            cp, fp = es.sweep_count_plain(o, d, lay, active=act, prepass=pp)
            sel = act & (ck <= 1)
            rk, _ = es.intersect_sweep1(o, d, lay, active=sel, prepass=pp)
            tally = Tally()
            rp, _ = es.intersect_sweep1_plain(o, d, lay, active=sel, prepass=pp,
                                              tally=tally)
            torch.cuda.synchronize()
            bad = int((ck != cp).sum() + (fk != fp).sum())
            if bad:
                raise AssertionError(f"sweep_count/{which} ({label}): counts or first "
                                     f"leaves differ on {bad} lanes")
            if not (torch.equal(rk.row, rp.row) and torch.equal(rk.orig, rp.orig)):
                raise AssertionError(f"sweep1/{which} ({label}): rows or original ids "
                                     f"differ on {int((rk.row != rp.row).sum())} lanes")
            err = max(max_diff(rk.t, rp.t), max_diff(rk.u, rp.u), max_diff(rk.v, rp.v))
            if err > 0.0:
                raise AssertionError(f"sweep1/{which} ({label}): t, u or v differ by {err}")
            err_count, err_one = max(err_count, float(bad)), max(err_one, err)
            log(f"  sweep_count, sweep1/{which} "
                f"({label}, {lay.num_leaves} leaves, prepass {pp}): counts, first leaves, "
                f"t, u, v, row, orig equal on all {SAMPLE_LANES} lanes; {int(sel.sum())} "
                f"lanes with <= 1 candidate, {int(torch.isfinite(rk.t[sel]).sum())} of "
                "them hit")
            timed[label] = (o, d, act, sel, lay, pp, fk, tally.tests, tally.visits)
    fo, fd, fact = waves["bounce1"]
    full_bounds, fsels = {}, {}
    for label, (o, d, act, sel, lay, pp, first, tests, boxes) in timed.items():
        bnd_c, _ = sweep_bounds(lay, act, first, pp, 0, 0)            # every live lane
        _, bnd_1 = sweep_bounds(lay, sel, first, pp, tests, boxes)    # the <= 1 lanes
        fc, ff = es.sweep_count(fo, fd, lay, active=fact, prepass=pp)
        count_equals_plain(f"the bounce-1 wavefront ({label})", fo, fd, fact, lay, pp,
                           (fc, ff))
        fsel = fact & (fc <= 1)
        # the whole wavefront's bounds: the targeted kernel's from its work
        # there (the count's first leaves equal the plain version's)
        full_bounds[label] = (sweep_bounds(lay, fact, ff, pp, 0, 0)[0],
                              sweep_bounds(lay, fsel, ff, pp, *sweep1_work(lay, fsel, ff))[1])
        fsels[label] = fsel
        rows[label] = (
            dict(ms=cuda_ms(lambda: es.sweep_count(o, d, lay, active=act, prepass=pp)),
                 plain_ms=cuda_ms(lambda: es.sweep_count_plain(o, d, lay, active=act,
                                                               prepass=pp), iters=2),
                 full_ms=cuda_ms(lambda: es.sweep_count(fo, fd, lay, active=fact,
                                                        prepass=pp), iters=3), **bnd_c),
            dict(ms=cuda_ms(lambda: es.intersect_sweep1(o, d, lay, active=sel, prepass=pp)),
                 plain_ms=cuda_ms(lambda: es.intersect_sweep1_plain(
                     o, d, lay, active=sel, prepass=pp), iters=2),
                 full_ms=cuda_ms(lambda: es.intersect_sweep1(fo, fd, lay, active=fsel,
                                                             prepass=pp), iters=3), **bnd_1))
        for name, r in zip(("sweep_count", "sweep1"), rows[label]):
            log(f"  {name} ({label}) at {SAMPLE_LANES} bounce-1 lanes: kernel "
                f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}); full bounce-1 "
                f"({fo.shape[1]} lanes) {r['full_ms']:.3f} ms")
    prof1 = {label: sweep1_device_us(f"{SCENE} bounce-1, {label}", fo, fd, fsels[label],
                                     lay, pp)
             for label, (_, _, _, _, lay, pp, _, _, _) in timed.items()}
    # the terrain's whole bounce-1 wavefront on its leaf-8 layout
    tr = terrain_renderer(terrain)
    tw = wavefronts(tr.scene, tr.layout, tr.layout_occl, tr.cfg)["bounce1"]
    tlay = tr.layout_occl
    tpp = ht.window_prepass(tlay, tr.cfg.traversal_prepass)
    tag = f"terrain ({terrain.num_triangles} triangles) bounce-1, leaf 8"
    tc = es.sweep_count(tw[0], tw[1], tlay, active=tw[2], prepass=tpp)
    count_equals_plain(tag, *tw, tlay, tpp, tc)
    tsel = tw[2] & (tc[0] <= 1)
    terrain_ms = (
        march_ms(f"sweep_count {tag} ({tw[0].shape[1]} lanes, {int(tw[2].sum())} live, "
                 f"{tlay.num_leaves} leaves, prepass {tpp})",
                 lambda: es.sweep_count(tw[0], tw[1], tlay, active=tw[2], prepass=tpp),
                 sweep_bounds(tlay, tw[2], tc[1], tpp, 0, 0)[0]["bound_ms"]),
        march_ms(f"sweep1 {tag} ({int(tsel.sum())} lanes with <= 1 candidate)",
                 lambda: es.intersect_sweep1(tw[0], tw[1], tlay, active=tsel, prepass=tpp),
                 sweep_bounds(tlay, tsel, tc[1], tpp,
                              *sweep1_work(tlay, tsel, tc[1]))[1]["bound_ms"]))
    del tr, tw, tlay, tc, tsel
    out = []
    for k, (name, line, err) in enumerate((("sweep_count", 82, err_count),
                                           ("sweep1", 156, err_one))):
        main, other = rows["leaf 56"][k], rows["leaf 8"][k]
        ms, plain_ms, full_ms = (main.pop(x) for x in ("ms", "plain_ms", "full_ms"))
        main.update(at_full_width(f"{name} (leaf 56)", "bounce-1 wavefront", full_ms,
                                  full_bounds["leaf 56"][k]))
        other.update(at_full_width(f"{name} (leaf 8)", "bounce-1 wavefront",
                                   other["full_ms"], full_bounds["leaf 8"][k]))
        extra = {f"{x}_leaf8": v for x, v in other.items()
                 if x.endswith("ms") or x.endswith("_by") or x.endswith("pct_of_bound")}
        extra["terrain_full_ms"] = terrain_ms[k]
        if name == "sweep_count":
            extra.update(k_lanes=es.K_LANES,
                         registers=kernel_registers(compiler_log, "sweep_count_kernel"))
        else:
            extra.update(device_us=prof1, k_lanes=es.SWEEP1_K,
                         threads=es.SWEEP1_THREADS,
                         registers=kernel_registers(compiler_log, "sweep1_kernel"))
        out.append(kernel_entry(
            name, "candidate_sweep.cu", f"experimental_pallas_sweep.py:{line}", err, ms,
            plain_ms, full_ms, main, **extra))
    return out


def split_run(label: str, o, d, act, lay, prepass: int) -> dict:
    """The candidate split on one wavefront and layout: the count kernel,
    the targeted kernel on the lanes with at most one candidate leaf, the MT
    window walk on all lanes; asserts the split property and returns the
    kernels' launches in that run; then times the four launches."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht
    from tpu_pathtracer_torch.scripts import experimental_sweep as es

    pp = ht.window_prepass(lay, prepass)
    with counted_run() as run:
        cnt, first = es.sweep_count(o, d, lay, active=act, prepass=pp)
        sel = act & (cnt <= 1)
        raw, tmax = es.intersect_sweep1(o, d, lay, active=sel, prepass=pp)
        tw, rw = ht.window_walk(o, d, act, tmax, lay, prepass=pp, tritest="mt")
        hs = ht.resolve_window_payload(lay, raw.t, raw.row, tmax, o, d)
        hw = ht.resolve_window_payload(lay, tw, rw, tmax, o, d)
    torch.cuda.synchronize()
    if any(run["plain_cuda"].values()):
        raise AssertionError(f"split {label}: plain versions ran on CUDA tensors: {run}")
    fin_s, fin_w = torch.isfinite(hs.t[sel]), torch.isfinite(hw.t[sel])
    if not torch.equal(fin_s, fin_w):
        raise AssertionError(f"split {label}: hit/miss differs from the window walk on "
                             f"{int((fin_s != fin_w).sum())} lanes with <= 1 candidate")
    if not torch.equal(hs.tri[sel], hw.tri[sel]):
        raise AssertionError(f"split {label}: triangle ids differ on "
                             f"{int((hs.tri[sel] != hw.tri[sel]).sum())} lanes")
    if not torch.equal(hs.t[sel], hw.t[sel]):  # tolerance 0: the same rows, order, arithmetic
        raise AssertionError(f"split {label}: t differs by up to "
                             f"{max_diff(hs.t[sel], hw.t[sel])}")
    hit = sel & torch.isfinite(hs.t)
    if not torch.equal(raw.orig[hit].to(torch.int64), hw.tri[hit]):
        raise AssertionError(f"split {label}: the targeted kernel's original ids differ")
    none = act & (cnt == 0)
    pre_rows = lay.prepass[:pp, 21].to(torch.int32)
    if not bool(((raw.row[none] == lay.num_tris) | torch.isin(raw.row[none], pre_rows)).all()):
        raise AssertionError(f"split {label}: a lane with no candidate is neither a miss "
                             "nor a prepass hit")
    live = max(int(act.sum()), 1)
    c = cnt[act].to(torch.float32)
    many = act & (cnt > 1)
    out = {
        "label": label, "lanes": o.shape[1], "live": int(act.sum()),
        "leaves": lay.num_leaves, "prepass": pp,
        "share_0": int(none.sum()) / live, "share_1": int((act & (cnt == 1)).sum()) / live,
        "share_many": int(many.sum()) / live, "mean_count": float(c.mean()),
        "p95_count": float(c.sort().values[int(0.95 * (c.numel() - 1))]),
        "hits_le1": int(hit.sum()),
        "count_ms": cuda_ms(lambda: es.sweep_count(o, d, lay, active=act, prepass=pp), 3),
        "sweep1_ms": cuda_ms(lambda: es.intersect_sweep1(o, d, lay, active=sel,
                                                         prepass=pp), 3),
        "window_all_ms": cuda_ms(lambda: ht.window_walk(o, d, act, tmax, lay, prepass=pp,
                                                        tritest="mt"), 3),
        "window_many_ms": cuda_ms(lambda: ht.window_walk(o, d, many, tmax, lay, prepass=pp,
                                                         tritest="mt"), 3),
        "launches": run["launches"],
    }
    log(f"split {label}: {out['lanes']} lanes ({out['live']} live), {out['leaves']} leaves, "
        f"prepass {pp}: candidates 0 / 1 / >1 on {out['share_0']:.4f} / "
        f"{out['share_1']:.4f} / {out['share_many']:.4f} of the live lanes, mean "
        f"{out['mean_count']:.3f}, p95 {out['p95_count']:.0f}; the targeted result equals "
        f"the MT window walk on all {int(sel.sum())} lanes with <= 1 candidate "
        f"({out['hits_le1']} hits, t bit-equal); ms: count {out['count_ms']:.3f}, targeted "
        f"{out['sweep1_ms']:.3f}, window walk on all lanes {out['window_all_ms']:.3f}, on "
        f"the >1 lanes only {out['window_many_ms']:.3f}")
    return out


def phase_split(renderer, terrain) -> dict:
    """The candidate split at full width -> the launches of ``sweep_count``
    and ``sweep1`` over all its runs."""
    cfg = renderer.cfg
    runs = []
    waves = wavefronts(renderer.scene, renderer.layout, renderer.layout_occl, cfg)
    for which in ("camera", "bounce1"):
        for leaf, lay in ((56, renderer.layout), (8, renderer.layout_occl)):
            runs.append(split_run(f"{SCENE} {which}, leaf {leaf}", *waves[which], lay,
                                  cfg.traversal_prepass))
    del waves
    r = terrain_renderer(terrain)
    waves = wavefronts(r.scene, r.layout, r.layout_occl, r.cfg)
    tris = terrain.num_triangles
    gen = torch.Generator().manual_seed(1357)
    for which, live in (("camera", None), ("bounce1", waves["bounce1"][2])):
        lanes = draw(waves[which], SAMPLE_LANES, gen, live)
        for leaf, lay in ((56, r.layout), (8, r.layout_occl)):
            runs.append(split_run(f"terrain ({tris} triangles) {which}, {SAMPLE_LANES} "
                                  f"lanes, leaf {leaf}", *lanes, lay,
                                  r.cfg.traversal_prepass))
        runs.append(split_run(f"terrain ({tris} triangles) {which}, whole wavefront, "
                              f"leaf 56", *waves[which], r.layout, r.cfg.traversal_prepass))
    return {k: sum(x["launches"][k] for x in runs) for k in ("sweep_count", "sweep1")}


def echo_main(main, what: str) -> tuple[dict, list[str]]:
    """Run a tool's ``main([])`` under :func:`counted_run`, echo its lines
    -> (the run's counts, the lines)."""
    buf = io.StringIO()
    with counted_run() as run, contextlib.redirect_stdout(buf):
        rc = main([])
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  | {line}")
    if rc or any(run["plain_cuda"].values()):
        raise AssertionError(f"{what}: rc {rc}, plain versions on CUDA tensors "
                             f"{run['plain_cuda']}")
    return run, lines


def phase_launch_probe(smi: str) -> tuple[dict, int]:
    """The no-op against its plain version at each tile, its times beside
    the PyTorch call pair that computes the same function, then the launch
    probe's ``main()`` -> (the no-op's row of the kernel table, the launches
    of that run)."""
    from tpu_pathtracer_torch.scripts import perf_launch as pl

    gen = torch.Generator(device="cuda").manual_seed(97)
    full = torch.randn((8, pl.N), generator=gen, device="cuda")
    tables = [torch.zeros((64, 8), device="cuda") for _ in range(3)]
    err = 0.0
    for tile in pl.TILES:
        for tbl in ([], tables):
            err = max(err, float((pl.noop(full, tbl, tile)
                                  - pl.noop_plain(full, tbl, tile)).abs().max()))
    if err > 0.0:
        raise AssertionError(f"noop differs from its plain version by {err}")
    log(f"  noop == its plain version at tiles {pl.TILES}, with 0 and 3 tables, on "
        f"{pl.N} lanes")

    def library(x):
        out = torch.zeros_like(x)
        out[0].copy_(x[0])
        return out

    small = full[:, :SAMPLE_LANES].contiguous()
    tile = pl.TILES[0]
    times = {f"{name}{tag}": cuda_ms(lambda: fn(x), iters=20)
             for tag, x in (("", small), ("_full", full))
             for name, fn in (("ms", lambda x: pl.noop(x, [], tile)),
                              ("plain_ms", lambda x: pl.noop_plain(x, [], tile)),
                              ("library_ms", library))}
    bnd = bound(SAMPLE_LANES * 36, 0)
    entry = kernel_entry("noop", "probes.cu", "perf_launch.py:47", err, times["ms"],
                         times["plain_ms"], times["ms_full"], bnd,
                         library_ms=times["library_ms"],
                         plain_full_ms=times["plain_ms_full"],
                         library_full_ms=times["library_ms_full"],
                         bound_full_ms=bound(pl.N * 36, 0)["bound_ms"])
    log(f"  noop at tile {tile}, {SAMPLE_LANES} lanes: kernel {entry['ms']:.4f} ms, plain "
        f"{entry['plain_ms']:.4f} ms, zeros + copy_ {entry['library_ms']:.4f} ms, bound "
        f"{entry['bound_ms']:.5f} ms (bytes); {pl.N} lanes: {entry['full_ms']:.4f}, "
        f"{entry['plain_full_ms']:.4f}, {entry['library_full_ms']:.4f}, "
        f"{entry['bound_full_ms']:.5f} ms")
    # the kernel against the PyTorch call pair in turns (noop, zeros + copy_,
    # zeros + copy_, noop, ...), 50 back-to-back launches a reading, at both
    # widths; the quartiles of the readings say whether one is slower beyond
    # the spread
    for tag, x in (("", small), ("_full", full)):
        ab = turns({"noop": lambda x=x: pl.noop(x, [], tile),
                    "zeros + copy_": lambda x=x: library(x)}, iters=50, rounds=LAUNCH_ROUNDS)
        q = {k: statistics.quantiles(v, n=4) for k, v in ab.items()}
        entry[f"turns{tag}_ms"] = ab
        log(f"  noop against zeros + copy_ in turns at {x.shape[1]} lanes ({2 * LAUNCH_ROUNDS} "
            f"readings of 50 launches each), ms: "
            + ", ".join(f"{k} median {q[k][1]:.4f}, quartiles {q[k][0]:.4f}-{q[k][2]:.4f}, "
                        f"range {min(v):.4f}-{max(v):.4f}" for k, v in ab.items()))
    run, lines = echo_main(pl.main, "launch probe")
    launches = run["launches"]
    if min(launches[k] for k in ("noop", "capped_walk", "window_walk")) <= 0:
        raise AssertionError(f"launch probe: a kernel never launched: {launches}")
    if not lines[0].endswith(smi) or sum(ln.startswith("tile=") for ln in lines) != len(pl.TILES):
        raise AssertionError("launch probe: its lines are not the ones expected")
    return entry, launches


def probe_bound(lanes: int, rows: int, table_rows: int, ops_per_row: int) -> dict:
    """The row-test probe's bound: 32 bytes of rays read and 8 written a
    lane, the (table_rows, 16) float32 table once; every lane ``rows`` row
    tests of ``ops_per_row`` operations."""
    return bound(lanes * (32 + 8) + table_rows * 64, lanes * rows * ops_per_row)


def march_ms(label: str, fn, bnd_ms: float) -> list[float]:
    """A dense march timed twice by CUDA events, 3 launches a reading ->
    [ms, ms]; logs them beside the share of the bound."""
    ms = [cuda_ms(fn, iters=3) for _ in range(2)]
    log(f"  {label}: {ms[0]:.3f}/{ms[1]:.3f} ms, {100 * bnd_ms / min(ms):.1f}% of the "
        f"{bnd_ms:.4f} ms bound")
    return ms


def phase_rowtest_probe(compiler_log: str) -> tuple[dict, int]:
    """Each of the six probe variants against its plain version on 65,536
    lanes and, at the tool's own width and inputs, on every 32nd lane; then
    the probe's ``main()`` with the default flags -> (the probe's row of the
    kernel table, with the anchor variant's numbers and every variant's
    beside; the probe's launches in ``main()``)."""
    from tpu_pathtracer_torch.scripts import perf_ophit_probe as pp

    rays, tris = pp.probe_inputs(SAMPLE_LANES, pp.T8, "cuda", seed=1)
    tile, mtblock = 768, 16
    rows = pp.T8 // mtblock * mtblock
    per = {}
    for v in pp.VARIANTS:
        tk, ik = pp.rowtest_probe(v, rays, tris, tile, mtblock)
        tp, ip = pp.rowtest_probe_plain(v, rays, tris, mtblock)
        torch.cuda.synchronize()
        err = agree(f"rowtest_probe/{v}", tk, ik, tp, ip)
        if not (torch.equal(tk, tp) and torch.equal(ik, ip)):
            raise AssertionError(f"rowtest_probe/{v}: not bit-equal to its plain version")
        per[v] = {"max_abs_err": err,
                  "ms": cuda_ms(lambda: pp.rowtest_probe(v, rays, tris, tile, mtblock)),
                  "plain_ms": cuda_ms(lambda: pp.rowtest_probe_plain(v, rays, tris,
                                                                     mtblock), iters=1),
                  **probe_bound(SAMPLE_LANES, rows, pp.T8, pp.ROWTEST_OPS[v])}
        log(f"  rowtest_probe/{v} at {SAMPLE_LANES} lanes x {rows} rows: kernel "
            f"{per[v]['ms']:.3f} ms, plain {per[v]['plain_ms']:.1f} ms, bound "
            f"{per[v]['bound_ms']:.3f} ms ({per[v]['bound_by']})")
    # the launch the tool times: its own inputs at all its lanes, every 32nd
    # lane held against the plain version
    frays, ftris = pp.probe_inputs(pp.N, pp.T8, "cuda")
    srays = frays[:, ::FULL_STRIDE].contiguous()
    for v in pp.VARIANTS:
        tk, ik = pp.rowtest_probe(v, frays, ftris, tile, mtblock)
        tp, ip = pp.rowtest_probe_plain(v, srays, ftris, mtblock)
        torch.cuda.synchronize()
        if not (torch.equal(tk[::FULL_STRIDE], tp) and torch.equal(ik[::FULL_STRIDE], ip)):
            raise AssertionError(f"rowtest_probe/{v} at {pp.N} lanes: not bit-equal to "
                                 f"its plain version on one lane in {FULL_STRIDE}")
    log(f"  rowtest_probe at {pp.N} lanes (the tool's inputs): all {len(pp.VARIANTS)} "
        f"variants bit-equal to their plain versions on one lane in {FULL_STRIDE} "
        f"({srays.shape[1]} lanes)")
    del srays, frays, ftris
    run, lines = echo_main(pp.main, "row-test probe")
    full = {m[1]: float(m[2]) for m in (re.match(r"ROW (\S+)\s+([0-9.]+) ms", ln)
                                        for ln in lines) if m}
    if tuple(full) != pp.VARIANTS or run["launches"]["rowtest_probe"] <= 0:
        raise AssertionError(f"row-test probe: ROW lines {tuple(full)}, launches "
                             f"{run['launches']}")
    anchor = per["full-bw"]
    keys = ("bound_ms", "bound_by", "bound_bytes", "bound_ops")
    variants = {}
    for v in pp.VARIANTS:
        bnd_full = probe_bound(pp.N, rows, pp.T8, pp.ROWTEST_OPS[v])["bound_ms"]
        variants[v] = {"ms": per[v]["ms"], "plain_ms": per[v]["plain_ms"],
                       "full_ms": full[v], "bound_ms": per[v]["bound_ms"],
                       "bound_full_ms": bnd_full,
                       "full_pct_of_bound": 100.0 * bnd_full / full[v],
                       "ops_per_rowtest": pp.ROWTEST_OPS[v]}
        log(f"  rowtest_probe/{v} at {pp.N} lanes (perf_ophit_probe.main): {full[v]:.1f} ms, "
            f"bound {bnd_full:.3f} ms, {variants[v]['full_pct_of_bound']:.1f}% of bound")
    entry = kernel_entry(
        "rowtest_probe", "probes.cu", "perf_ophit_probe.py:101",
        max(x["max_abs_err"] for x in per.values()), anchor["ms"], anchor["plain_ms"],
        full["full-bw"], {k: anchor[k] for k in keys}, variants=variants,
        k_lanes=pp.K_LANES, registers=kernel_registers(compiler_log, "rowtest_probe_kernel"))
    entry.update(at_full_width("rowtest_probe/full-bw", f"{pp.N}-lane march",
                               full["full-bw"],
                               probe_bound(pp.N, rows, pp.T8, OPS_ROW["bw"])))
    return entry, run["launches"]["rowtest_probe"]


RNG_CASES = ((0, 0, 0), (7, -1, 0x80000001), (0xFFFFFFFF, 5, 0xFFFFFFFF))  # frame, bounce, salt
R2_COUNTS = (4, 6, 10)
VIRTUAL_SAMPLE = 2000  # a fused sample whose virtual ids pixel + s*H*W lie past 2^31
SELF_GOLDEN_REL_MSE = 1.5807e-8  # the default path's reading against the self-golden, 5 digits
OPS_PCG4D = 32  # 4 + 4 multiply-adds, two rounds of 4 + 4, 4 shifts and 4 xors
OPS_UNIT = 3    # a row's shift, convert and scale
OPS_R2_ROW = 3  # the r2 row's xor, multiply and add
# the epilogue a lane: the MT row test again, the t rule and two clamps (8),
# the payload of write_payload (39)
OPS_RESOLVE = OPS_ROW["mt"] + 8 + 39
ROW_BYTES_MT = 96  # one lay.tris row, read once a lane by the epilogue


def uniforms_bound(lanes: int, count: int, r2: bool) -> dict:
    """A draw's bound: the int64 id read once and ``count`` float32 rows
    written once a lane; its integer operations (a pcg4d call per group, two
    for r2) each in an FMA's slot."""
    groups = (count + 3) // 4
    ops = groups * OPS_PCG4D * (2 if r2 else 1) + count * (OPS_UNIT + OPS_R2_ROW * r2)
    return bound(lanes * (8 + 4 * count), lanes * ops)


def resolve_bound(lay, act, work: Work, prepass: int) -> dict:
    """The epilogue form's bound on these lanes (BW rows): the window walk's
    work, 48 bytes of payload out instead of (t, row), one MT row of
    ``lay.tris`` read a lane and the resolve's operations a lane."""
    return walk_bound(act.shape[0], RAY_BYTES + ROW_BYTES_MT, 48, lay.tris8bw, work,
                      OPS_ROW["bw"], lay.prepassbw[:prepass], int(act.sum()) * prepass,
                      lane_ops=OPS_RESOLVE)


QUEUE_SPIN_CYCLES = 100_000_000  # ~50 ms of a spin kernel: the host queues the calls meanwhile


def queued_ms(fn, iters: int = 20) -> float:
    """Device milliseconds a call of ``fn``, the mean over ``iters`` calls
    queued behind a spin kernel (``torch.cuda._sleep``) after one warm-up:
    the host's work a call (for a short kernel more than the kernel itself)
    overlaps the spin, so the events time the launches back to back on the
    card alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if end.query():
        raise AssertionError("queued_ms: the spin ended before the host queued the calls")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


RNG_RESOLVE_STAGES = ("rng", "resolve")  # the stages phase 21 puts back
SHADE_SORT_STAGES = ("shade", "sort")   # the stages phase 22 puts back


def torch_resolved(walk):
    """``window_walk_resolve``'s signature on a window walk that returns (t,
    row) followed by the torch payload rows (``window_payload_rows``): the
    epilogue form with its epilogue put back in torch."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht

    def fn(o, d, active, t_max, lay, t_min=0.0, prepass=ht.DEFAULT_PREPASS,
           tritest="bw"):
        t, row = walk(o, d, active, t_max, lay, t_min, prepass, tritest)
        return ht.window_payload_rows(lay, t, row, t_max, o, d)

    return fn


@contextlib.contextmanager
def plain_stages(stages=RNG_RESOLVE_STAGES):
    """XLA-fused stages back on their plain torch versions for the run
    inside, as the frame ran them before their kernels.  ``stages``, any of:
    "rng", ``uniforms`` and ``uniforms_r2`` of ops/rng.py standing aside for
    ``uniforms_plain`` and ``uniforms_r2_plain``; "resolve",
    ``window_walk_resolve`` for the window walk kernel followed by the torch
    payload rows (``window_payload_rows``); "shade", ops/shade.py's
    ``shade_bounce`` for ``shade_bounce_plain`` (render/wavefront.py:
    _shade_plain); "sort", ops/wavefront_sort.py's ``sort_key`` and
    ``gather_planes`` for their plain versions.  Inside a counted run the
    plain versions put back are its counted ones."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht
    from tpu_pathtracer_torch.ops import rng
    from tpu_pathtracer_torch.ops import shade
    from tpu_pathtracer_torch.ops import wavefront_sort as sort

    swaps = {"rng": [(rng, "uniforms", rng.uniforms_plain),
                     (rng, "uniforms_r2", rng.uniforms_r2_plain)],
             "resolve": [(ht, "window_walk_resolve", torch_resolved(ht.window_walk))],
             "shade": [(shade, "shade_bounce", shade.shade_bounce_plain)],
             "sort": [(sort, "sort_key", sort.sort_key_plain),
                      (sort, "gather_planes", gather_planes_plain)]}
    chosen = [x for st in stages for x in swaps[st]]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in chosen]
    for mod, name, fn in chosen:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def sort_gather(planes, perm, key):
    """The gather as render/wavefront.py:sort_wavefront calls it: ``planes``
    a PathState's then a ShadowPack's, pixel and alive read from the sorted
    ``key``."""
    from tpu_pathtracer_torch.ops import wavefront_sort as sort
    from tpu_pathtracer_torch.render.wavefront import PathState

    return sort.gather_planes(planes, perm, key, pixel=PathState._fields.index("pixel"),
                              alive=PathState._fields.index("alive"))


def gather_planes_plain(planes, perm, key=None, pixel=None, alive=None, out=None):
    """ops/wavefront_sort.py:gather_planes_plain in the place of the gather
    kernel's wrapper, whose call passes the sorted key (the plain version
    gathers every plane, pixel and alive too) and, on the chain graphs'
    path, the planes to write."""
    from tpu_pathtracer_torch.ops import wavefront_sort as sort

    return sort.gather_planes_plain(planes, perm, out=out)


def stage_turns(label: str, tmp: str, scene) -> dict:
    """One 1080p frame path with the two stages' kernels and with their plain
    versions put back (:func:`plain_stages`), in turns (kernels, plain,
    plain, kernels): each turn from a reset, 1 warm-up + 3 frames by the
    host clock, one staged frame (walk_nearest) and one profiled frame
    (device ms, kernels a frame).  Every turn's image after its 4 frames
    must equal the first turn's bit for bit; a kernels turn launches 9
    uniforms and 8 epilogue walks a frame, a plain turn none of them and 8
    window walks -> {"kernels": [readings], "plain": [readings]}."""
    from tpu_pathtracer_torch import Renderer

    r = Renderer(scene, WIDTH, HEIGHT)
    out = {"kernels": [], "plain": []}
    first = None
    frames = 4 + 1 + 1
    for i, which in enumerate(("kernels", "plain", "plain", "kernels")):
        r.reset()
        with counted_run() as run, (plain_stages() if which == "plain"
                                    else contextlib.nullcontext()):
            r.run(1)
            t0 = time.perf_counter()
            r.run(3)
            ms = (time.perf_counter() - t0) / 3 * 1e3
            img = r.image()
            span = staged_frame(r).get("walk_nearest", float("nan"))
            dev, count = device_ms(r, os.path.join(tmp, f"stages{label}{i}"))
        la, plain_cuda = run["launches"], run["plain_cuda"]
        want = ((9 * frames, 8 * frames, 0) if which == "kernels"
                else (0, 0, 8 * frames))
        got = (la["uniforms"], la[NEAREST], la["window_walk"])
        if got != want or (which == "kernels") == bool(plain_cuda["uniforms_plain"]):
            raise AssertionError(f"stage turns {label}, {which}: launches (uniforms, "
                                 f"{NEAREST}, window_walk) {got}, expected {want}: {run}")
        first = img if first is None else first
        diff = float(np.abs(img - first).max())
        if not np.array_equal(img, first):
            raise AssertionError(f"stage turns {label}, {which}: the frame differs from "
                                 f"the first turn's by {diff}")
        out[which].append({"ms": ms, "walk_nearest": span, "device_ms": dev,
                           "kernels": count})
        log(f"  stage turn {label}, {which}: {ms:.2f} ms/frame, walk_nearest {span:.2f} "
            f"ms, device {dev:.2f} ms in {count} kernels a frame; launches a frame: "
            f"uniforms {got[0] / frames:g}, {NEAREST} {got[1] / frames:g}, window_walk "
            f"{got[2] / frames:g}; image max |diff| to turn 1: {diff:g}")
    return out


def phase_fused_stages(smi: str, priced: Priced) -> list[dict]:
    """Phase 21: the hand kernels of the two XLA-fused stages.  The PCG4D
    uniforms (csrc/rng.cu) against their plain versions bit for bit; the
    window walk's payload epilogue against its plain version (65,536 lanes
    of the camera and bounce-1 wavefronts, BW and MT; every lane of the
    whole wavefronts is held in phases 3 and 10); their times and bounds;
    then the main path and the env-lit path in turns with the plain versions
    put back, and the self-golden gate -> the three kernels' rows of the
    kernel table."""
    from tpu_pathtracer_torch import Renderer
    from tpu_pathtracer_torch.ops import hopper_traverse as ht
    from tpu_pathtracer_torch.ops import rng
    from tpu_pathtracer_torch.render import noise
    from tpu_pathtracer_torch.render.order import make_order
    from tpu_pathtracer_torch.scene import attach_env, load_scene, scene_path

    t_phase = time.perf_counter()
    log(f"XLA-fused stages as hand kernels on {smi}")
    renderer = Renderer(SCENE, WIDTH, HEIGHT)
    lay, cfg = renderer.layout, renderer.cfg
    dev = lay.tris.device
    order = make_order(HEIGHT, WIDTH, 0, cfg.traversal_tile, device=dev)
    pids = noise.pids_from_order(order, WIDTH).contiguous()         # the frame's own ids
    gen = torch.Generator(device=dev).manual_seed(2468)
    lanes = {"0 lanes": pids[:0], **{f"{n} lanes": torch.randint(
        0, 2**32, (n,), generator=gen, device=dev) for n in EDGE_LANES},
        f"1080p ids of sample {VIRTUAL_SAMPLE}": pids + VIRTUAL_SAMPLE * HEIGHT * WIDTH}
    salt = noise.key_salt(rng.prng_key(0))
    cases = 0
    for what, pid in lanes.items():
        for frame, bounce, sl in (*RNG_CASES, (3, 2, salt)):
            for count in range(1, 11):
                got = rng.uniforms(pid, frame, bounce, sl, count)
                equal_on_every_lane(f"uniforms count {count}, {what}", got,
                                    rng.uniforms_plain(pid, frame, bounce, sl, count))
                cases += 1
            for count in R2_COUNTS:
                got = rng.uniforms_r2(pid, frame, bounce, sl, count)
                equal_on_every_lane(f"uniforms_r2 count {count}, {what}", got,
                                    rng.uniforms_r2_plain(pid, frame, bounce, sl, count))
                cases += 1
    torch.cuda.synchronize()
    log(f"  uniforms (counts 1-10) and uniforms_r2 (counts {R2_COUNTS}) == their plain "
        f"versions bit for bit in {cases} cases: {', '.join(lanes)}; frames, bounces and "
        f"salts {RNG_CASES} and the frame's own salt (virtual ids up to "
        f"{int(lanes[f'1080p ids of sample {VIRTUAL_SAMPLE}'].max())})")

    # the epilogue against its plain version on drawn lanes (the whole
    # wavefronts: phases 3 and 10, against the (t, row) walk plus the torch rows)
    pp = ht.window_prepass(lay, cfg.traversal_prepass)
    draws = {}
    for which in ("camera", "bounce1"):
        o, d, act = draw(priced.waves[which], SAMPLE_LANES, torch.Generator().manual_seed(11))
        t_max = torch.where(torch.arange(o.shape[1], device=dev) % 5 == 1, 0.5,
                            torch.inf).contiguous()
        draws[which] = (o, d, act, t_max)
        for tritest in ("bw", "mt"):
            got = ht.window_walk_resolve(o, d, act, t_max, lay, prepass=pp, tritest=tritest)
            want = ht.window_walk_resolve_plain(o, d, act, t_max, lay, prepass=pp,
                                                tritest=tritest)
            equal_on_every_lane(f"{NEAREST} vs plain, {which} ({tritest})", got, want)
    torch.cuda.synchronize()
    log(f"  {NEAREST} == its plain version on all 12 rows of {SAMPLE_LANES} camera and "
        f"bounce-1 lanes (bw and mt, every fifth lane capped at 0.5)")

    # times and bounds: the uniforms at count 6 (a bounce's), 65,536 and all
    # 2,073,600 of the frame's ids; the epilogue form beside the window walk
    # the kernel's own time, its calls queued behind a spin ("ms"); CUDA
    # events over calls issued as the host goes ("events_ms") also hold each
    # call's host work
    entries = []
    for name, r2 in (("uniforms", False), ("uniforms_r2", True)):
        fn, plain = getattr(rng, name), getattr(rng, f"{name}_plain")
        small = pids[:SAMPLE_LANES].contiguous()
        ms, full_ms, full10 = (queued_ms(lambda p=p, c=c: fn(p, 3, 2, salt, c))
                               for p, c in ((small, 6), (pids, 6), (pids, 10)))
        events = [cuda_ms(lambda p=p: fn(p, 3, 2, salt, 6), iters=20) for p in (small, pids)]
        plain_ms = cuda_ms(lambda: plain(small, 3, 2, salt, 6))
        plain_full = cuda_ms(lambda: plain(pids, 3, 2, salt, 6))
        bnd, bfull = uniforms_bound(SAMPLE_LANES, 6, r2), uniforms_bound(pids.shape[0], 6, r2)
        line = "rng.py:99" if r2 else "rng.py:56"
        entries.append(kernel_entry(
            name, "rng.cu", f"tpu_pathtracer/ops/{line}", 0.0, ms, plain_ms, full_ms, bnd,
            plain_full_ms=plain_full, full_count10_ms=full10, events_ms=events[0],
            events_full_ms=events[1], bound_full_ms=bfull["bound_ms"],
            bound_full_by=bfull["bound_by"],
            full_pct_of_bound=100.0 * bfull["bound_ms"] / full_ms))
        log(f"  {name} count 6, device time a launch (queued): {SAMPLE_LANES} lanes "
            f"{ms * 1e3:.2f} us, bound {bnd['bound_ms'] * 1e3:.3f} us ({bnd['bound_by']}); "
            f"{pids.shape[0]} lanes {full_ms * 1e3:.2f} us, bound {bfull['bound_ms'] * 1e3:.3f} "
            f"us ({bfull['bound_by']}) = {100.0 * bfull['bound_ms'] / full_ms:.1f}% of bound; "
            f"count 10 {full10 * 1e3:.2f} us.  CUDA events over 20 back-to-back calls: "
            f"{events[0] * 1e3:.2f} and {events[1] * 1e3:.2f} us a call.  Plain: "
            f"{plain_ms:.3f} and {plain_full:.3f} ms")

    o, d, act, t_max = draws["bounce1"]
    inf = torch.full_like(o[0], torch.inf)
    args = (o, d, act, inf, lay)
    (_, work) = plain_work(ht.window_walk_resolve_plain, *args, prepass=pp)
    bnd = resolve_bound(lay, act, work, pp)
    ms = cuda_ms(lambda: ht.window_walk_resolve(*args, prepass=pp))
    walk_only = cuda_ms(lambda: ht.window_walk(*args, prepass=pp))
    plain_ms = cuda_ms(lambda: ht.window_walk_resolve_plain(*args, prepass=pp), iters=2)
    full = {}
    for which in ("camera", "bounce1"):
        w = (*priced.waves[which], torch.full_like(priced.waves[which][0][0], torch.inf), lay)
        full[which] = turns({NEAREST: lambda w=w: ht.window_walk_resolve(*w, prepass=pp),
                             "window_walk": lambda w=w: ht.window_walk(*w, prepass=pp)})
        b = resolve_bound(lay, w[2], priced.work[which], pp)
        full[which]["bound_ms"] = b["bound_ms"]
        full[which]["bound_by"] = b["bound_by"]
        log(f"  {NEAREST} on the full {which} wavefront, ms in turns (epilogue, walk, walk, "
            f"epilogue): {NEAREST} {full[which][NEAREST]}, window_walk "
            f"{full[which]['window_walk']}; bound {b['bound_ms']:.4f} ms ({b['bound_by']}) = "
            f"{100.0 * b['bound_ms'] / min(full[which][NEAREST]):.1f}% of the faster reading")
    entries.append(kernel_entry(
        NEAREST, "window_walk.cu", "tpu_pathtracer/ops/pallas_traverse.py:1043", 0.0, ms,
        plain_ms, min(full["camera"][NEAREST]), bnd, walk_ms=walk_only,
        full_turns=full, full_bounce1_ms=min(full["bounce1"][NEAREST]),
        bound_full_ms=full["camera"]["bound_ms"], bound_full_by=full["camera"]["bound_by"],
        full_pct_of_bound=100.0 * full["camera"]["bound_ms"] / min(full["camera"][NEAREST]),
        bound_full_bounce1_ms=full["bounce1"]["bound_ms"],
        full_pct_of_bound_bounce1=100.0 * full["bounce1"]["bound_ms"]
        / min(full["bounce1"][NEAREST])))
    log(f"  {NEAREST} at {SAMPLE_LANES} bounce-1 lanes: kernel {ms:.3f} ms (window_walk "
        f"{walk_only:.3f}), plain {plain_ms:.1f} ms, bound {bnd['bound_ms']:.5f} ms "
        f"({bnd['bound_by']})")
    del renderer

    # the frames: kernels against the plain versions put back, in turns
    scene = load_scene(scene_path(SCENE))
    with tempfile.TemporaryDirectory() as tmp:
        for label, sc in (("main path", scene), ("env-lit path", attach_env(scene, sky_map()))):
            stage_turns(label, tmp, sc)
    m = phase_parity()["metrics"]
    if float(f"{m['rel_mse']:.4e}") > SELF_GOLDEN_REL_MSE:
        raise AssertionError(f"self-golden gate: rel_mse {m['rel_mse']} above "
                             f"{SELF_GOLDEN_REL_MSE}")
    log(f"fused-stages phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


# the shading kernel's bytes a lane (csrc/shade.cu): the state, the hit record
# and six uniform rows in (113 + 8 C), the new state and the pack out (62 + 12 C),
# and the inline form's shadow origin; its float32 operations a lane, counted
# from the source (cosf, sinf, atan2f and acosf as 20 each), S-independent
# and a plane's; the env eval a lane (the texel of the direction), the env
# sample on a lane whose NEE picks the env (the alias slot, the jittered
# direction), and the dispersion weights a plane (two Fresnels, two quotients)
OPS_SHADE_LANE, OPS_SHADE_PLANE = 360, 10
OPS_ENV_EVAL, OPS_ENV_SAMPLE, OPS_DISPERSION_PLANE = 60, 80, 60
SORT_KEY_LANE_BYTES = 33 + 8  # origin, direction, alive, pixel in; the key out
OPS_SORT_KEY = 90             # float and integer operations of one key
SPECTRAL = {"spectrum_samples": 16, "hero_wavelengths": 4}  # the spectral CLI path
SHADE_SORT_TURNS = {          # phase 22's frame paths: scene, config, launches a frame
    "main path": ("main", {}, {"shade_bounce": 8, "sort_key": 7, "gather_planes": 7}),
    "unsorted": ("main", {"sort_rays": False},
                 {"shade_bounce": 8, "sort_key": 0, "gather_planes": 0}),
    "fused walk": ("main", {"fuse_shadow_walk": True},
                   {"shade_bounce": 8, "sort_key": 7, "gather_planes": 7}),
    "prefix sorts": ("main", {"prefix_sort": True},
                     {"shade_bounce": 8, "sort_key": 7, "gather_planes": 7}),
    "env-lit path": ("env", {}, {"shade_bounce": 8, "sort_key": 7, "gather_planes": 7}),
    "spectral path": ("spectral", SPECTRAL,
                      {"shade_bounce": 8, "sort_key": 7, "gather_planes": 7}),
    "spectral env path": ("spectral env", SPECTRAL,
                          {"shade_bounce": 8, "sort_key": 7, "gather_planes": 7}),
}


def table_bytes(*tables) -> int:
    return sum(t.numel() * t.element_size() for t in tables)


def shade_bound(st, hit, uni, scene, inline: bool) -> dict:
    """One shading launch's bound on these lanes, from this run's data: each
    plane of the lane read and written once (175 + 20 C bytes, C the carried
    planes; the inline form 12 more), hero bins 8 C; with an environment
    light its four uniform rows (16), the alias slot and the sampled texel's
    row (12 + 4 + 4 C) on each lane whose NEE picks the env, and the texel's
    row (4 + 4 C) the eval reads on each live lane that missed (the lanes
    whose env radiance the result needs); the scene tables once (the per-bin
    tables a hero lane reads among them); its operations a lane, the env's
    and the dispersion's included."""
    n, c = st.alive.shape[0], st.throughput.shape[0]
    env = scene.env
    tables = table_bytes(scene.mat_diffuse, scene.mat_emissive, scene.mat_ior,
                         scene.mat_type, scene.light_cdf, scene.light_p, scene.light_n,
                         scene.light_pdf, scene.light_area, scene.light_tri,
                         scene.light_emissive,
                         *(() if scene.mat_ior_bins is None else (scene.mat_ior_bins,)))
    lane = 175 + 20 * c + (12 if inline else 0) + (8 * c if st.bins is not None else 0)
    nbytes = n * lane + tables
    ops = n * (OPS_SHADE_LANE + OPS_SHADE_PLANE * c)
    if scene.mat_ior_bins is not None:
        ops += n * OPS_DISPERSION_PLANE * c
    if env is not None:
        picks = int((uni["env_select"] < env.select_p).sum())
        misses = int((st.alive & ~torch.isfinite(hit.t)).sum())
        nbytes += n * 16 + picks * (16 + 4 * c) + misses * (4 + 4 * c)
        ops += n * OPS_ENV_EVAL + picks * OPS_ENV_SAMPLE
    return bound(nbytes, ops)


def gather_bound(planes, lanes: int) -> dict:
    """The gather's bound: the permutation read once, every plane read and
    written once."""
    return bound(lanes * 8 + 2 * table_bytes(*(x for x in planes if x is not None)), 0)


def gather_sectors(planes, perm) -> dict:
    """The 32-byte sectors the gather's reads through ``perm`` touch, row by
    row of every plane: the mean distinct sectors (and 128-byte lines) a
    warp of 32 consecutive outputs reads from one row, by element size; the
    bytes of those sectors over all warps and rows (what L2 serves the SMs
    when no warp finds a sector another warp fetched); and the distinct
    sectors of the whole pass, each of which device memory must serve at
    least once.  The sector floor: those distinct sectors' bytes, the
    writes and the permutation over 3.35 TB/s."""
    n = perm.shape[0]
    warps = n // 32
    by_elem, warp_bytes, pass_bytes, out_bytes = {}, 0, 0, 0
    for x in planes:
        if x is None:
            continue
        e = x.element_size()
        for r in range(1 if x.dim() == 1 else x.shape[0]):
            byte = r * n * e + perm * e
            sec = torch.sort((byte[:warps * 32] // 32).view(warps, 32), dim=1).values
            line = torch.sort((byte[:warps * 32] // 128).view(warps, 32), dim=1).values
            per_warp = int((1 + (sec[:, 1:] != sec[:, :-1]).sum(1)).sum())
            lines = int((1 + (line[:, 1:] != line[:, :-1]).sum(1)).sum())
            d = by_elem.setdefault(e, {"rows": 0, "sectors": 0, "lines": 0})
            d["rows"] += 1
            d["sectors"] += per_warp
            d["lines"] += lines
            warp_bytes += 32 * per_warp
            pass_bytes += 32 * int(torch.unique(byte // 32).numel())
            out_bytes += n * e
    per = {e: {"rows": d["rows"], "sectors_per_warp": d["sectors"] / (d["rows"] * warps),
               "lines_per_warp": d["lines"] / (d["rows"] * warps)}
           for e, d in sorted(by_elem.items())}
    return {"by_element_size": per, "warp_sector_mb": warp_bytes / 1e6,
            "pass_sector_mb": pass_bytes / 1e6, "row_mb": out_bytes / 1e6,
            "sector_floor_ms": (pass_bytes + out_bytes + 8 * n) / HBM_BYTES_PER_S * 1e3}


def shade_inputs(renderer) -> tuple[dict, dict]:
    """A frame path's frame-0 inputs of both new stages at full width, made
    as render_sample makes them (hero bins, the env's uniform rows):
    {"camera": bounce 0's (state, hit, uniforms, bounce), "bounce1": bounce
    1's after the first sort and the shadow resolve}, {"bounce 1": the first
    sort's (state, pack), "bounce 2": the second's}."""
    from tpu_pathtracer_torch.ops.rng import fold_in, prng_key
    from tpu_pathtracer_torch.render import noise, state, wavefront
    from tpu_pathtracer_torch.models.camera import generate_rays_flat
    from tpu_pathtracer_torch.render.order import make_order

    scene, cfg, isect = renderer.scene, renderer.cfg, renderer._intersect
    dev = scene.p0.device
    key = state.fused_wavefront_key(state.frame_rng_key(cfg, prng_key(0), 0))
    order = make_order(HEIGHT, WIDTH, 0, cfg.traversal_tile, device=dev)
    pids = noise.pids_from_order(order, WIDTH)
    jitter = noise.camera_jitter(cfg, fold_in(key, 0xC0FFEE), 0, pids, HEIGHT, WIDTH)
    o, d = generate_rays_flat(renderer.camera, order.rows, order.cols, jitter[0:2],
                              HEIGHT, WIDTH, lens_u=jitter[2:4])
    hero = cfg.hero_wavelengths if cfg.spectrum_samples > 3 else 0
    bins = noise.hero_bins(cfg, key, 0, pids) if hero else None
    st0 = wavefront.initial_path_state(o, d, hero or cfg.spectrum_samples, pids, bins)
    wmin, winv = wavefront.scene_sort_bounds(scene)
    shading, sorts, st, pack = {}, {}, st0, None
    for b, name in ((0, "camera"), (1, "bounce1")):
        if pack is not None:
            sorts[f"bounce {b}"] = (st, pack)
            st = wavefront.resolve_shadow(isect, *wavefront.sort_wavefront(st, wmin, winv,
                                                                          pack),
                                          cfg.distance_epsilon)
        hit = isect(st.origin, st.direction, st.alive, coherent=b == 0)
        uni = noise.bounce_uniforms(cfg, key, 0, b, st.pixel, HEIGHT, WIDTH,
                                    with_env=scene.env is not None)
        shading[name] = (st, hit, uni, b)
        st, pack = wavefront.trace_bounce(scene, cfg, isect, b, st, uni, defer_shadow=True,
                                          hit=hit)
    sorts["bounce 2"] = (st, pack)
    return shading, sorts


def take_lanes(x, idx):
    """A NamedTuple of planes, a dict of uniform rows or one plane, at the
    lanes ``idx`` (contiguous)."""
    if x is None or isinstance(x, int):
        return x
    if isinstance(x, dict):
        return {k: v.index_select(-1, idx).contiguous() for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(take_lanes(v, idx) for v in x))
    return x.index_select(-1, idx).contiguous()


def same_bits(what: str, got, want) -> None:
    """Two outputs of a stage (nested tuples of planes) bit for bit."""
    if isinstance(got, (tuple, list)):
        for k, (a, b) in enumerate(zip(got, want, strict=True)):
            same_bits(f"{what}[{k}]", a, b)
        return
    if got is None or want is None:
        if got is not want:
            raise AssertionError(f"{what}: one side is None")
        return
    a, b = ((x.view(torch.int32) if x.dtype == torch.float32 else x) for x in (got, want))
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"{what}: differs on {int((a != b).sum())} elements")


def shade_sort_turns(label: str, tmp: str, scene, kw: dict, want: dict) -> dict:
    """One 1080p frame path with the shading and sort kernels and with their
    plain versions put back (``plain_stages(SHADE_SORT_STAGES)``), in turns
    (kernels, plain, plain, kernels): each turn from a reset, 1 warm-up + 3
    frames by the host clock, one staged frame (sort and walk spans) and one
    profiled frame (device ms, kernels a frame).  Every turn's image equals
    the first's bit for bit; a kernels turn launches ``want`` a frame, a plain
    turn none of the three -> {"kernels": [readings], "plain": [readings]}."""
    from tpu_pathtracer_torch import Renderer, RenderConfig

    r = Renderer(scene, WIDTH, HEIGHT, RenderConfig(**kw))
    out = {"kernels": [], "plain": []}
    first = None
    frames = 4 + 1 + 1
    for i, which in enumerate(("kernels", "plain", "plain", "kernels")):
        r.reset()
        with counted_run() as run, (plain_stages(SHADE_SORT_STAGES) if which == "plain"
                                    else contextlib.nullcontext()):
            r.run(1)
            t0 = time.perf_counter()
            r.run(3)
            ms = (time.perf_counter() - t0) / 3 * 1e3
            img = r.image()
            spans = staged_frame(r)
            dev, count = device_ms(r, os.path.join(tmp, f"shade{label}{i}"))
        la = {k: run["launches"][k] / frames for k in SHADE_SORT}
        expect = want if which == "kernels" else {k: 0 for k in SHADE_SORT}
        # a plain turn runs the plain versions put back where the kernels ran
        plain = {k: bool(v) for k, v in run["plain_cuda"].items() if v}
        expect_plain = {f"{k}_plain": True for k in SHADE_SORT
                        if which == "plain" and want[k]}
        if la != expect or plain != expect_plain:
            raise AssertionError(f"shade/sort turns {label}, {which}: launches a frame {la}, "
                                 f"expected {expect}; plain versions on CUDA tensors "
                                 f"{plain}, expected {expect_plain}: {run}")
        first = img if first is None else first
        diff = float(np.abs(img - first).max())
        if not np.array_equal(img, first):
            raise AssertionError(f"shade/sort turns {label}, {which}: the frame differs from "
                                 f"the first turn's by {diff}")
        reading = {"ms": ms, "device_ms": dev, "kernels": count,
                   **{k: spans.get(k, 0.0) for k in ("sort", "walk_nearest", "walk_shadow",
                                                     "walk_fused")},
                   "sample": sample_ms(spans)}
        out[which].append(reading)
        log(f"  shade/sort turn {label}, {which}: {ms:.2f} ms/frame, device {dev:.2f} ms in "
            f"{count} kernels a frame; spans sort {reading['sort']:.2f}, walk_nearest "
            f"{reading['walk_nearest']:.2f}, walk_shadow {reading['walk_shadow']:.2f}, "
            f"walk_fused {reading['walk_fused']:.2f}, sample {reading['sample']:.2f} ms; "
            f"launches a frame {la}; image max |diff| to turn 1: {diff:g}")
    return out


def shade_scenes() -> dict:
    """Phase 22's scenes: "main" (Water-plastic), "env" (with sky_map's
    environment light), "spectral" (S = 16 with the spectral CLI's
    dispersion) and "spectral env" (both), as the CLI builds them."""
    from tpu_pathtracer_torch.scene import attach_dispersion, attach_env, load_scene
    from tpu_pathtracer_torch.scene import scene_path

    main = load_scene(scene_path(SCENE))
    spectral = attach_dispersion(load_scene(scene_path(SCENE), samples=16), DISPERSION)
    sky = sky_map()
    return {"main": main, "env": attach_env(main, sky), "spectral": spectral,
            "spectral env": attach_env(spectral, sky)}


# phase 22's forms of the shading kernel: the frame path whose wavefronts
# it is held and timed on (a scene of shade_scenes and a config)
SHADE_FORMS = {"parity": ("main", {}), "env-lit": ("env", {}), "hero": ("spectral", SPECTRAL),
               "hero env": ("spectral env", SPECTRAL)}


def nonfinite_map_scene(scene, st, hit):
    """``scene`` with its env map's texel that the most lanes of ``st`` with
    a hit look toward made NaN in every plane (every other table as it
    was): its radiance_max is None, so the shading kernel takes the
    every-lane path, and each such lane's radiance turns NaN."""
    from tpu_pathtracer_torch.models.envlight import TABLES, env_to, texel_index

    env = scene.env
    idx = texel_index(env, st.direction)[st.alive & torch.isfinite(hit.t)]
    common = int(torch.mode(idx).values)
    rad = env.radiance.cpu().numpy().copy()
    rad.reshape(rad.shape[0], -1)[:, common] = np.nan
    # env_to derives the records (and radiance_max) anew from the tables
    arrays = {k: getattr(env, k).cpu().numpy() for k in TABLES}
    out = env_to({**arrays, "radiance": rad}, env.radiance.device)
    if out.radiance_max is not None:
        raise AssertionError("a map with a NaN texel passed the map check")
    if not torch.isnan(out.texel_rec[common, :rad.shape[0]]).all():
        raise AssertionError("the NaN texel did not reach the texel records")
    return scene._replace(env=out)


ENV_LAYOUTS = ("plane-major", "records")  # env_sectors: the planes, the records


def distinct_sectors(offs, lanes: int) -> tuple[int, int]:
    """Byte offsets into one table, (R, N) with -1 where a lane reads
    nothing -> (the distinct 32-byte sectors a warp of 32 consecutive lanes
    reads, summed over the warps; the distinct sectors of the whole launch)."""
    sec = torch.where(offs >= 0, offs // 32, -1)
    w = lanes // 32 * 32
    g = sec[:, :w].reshape(sec.shape[0], w // 32, 32).permute(1, 0, 2).reshape(w // 32, -1)
    g = torch.sort(g, dim=1).values
    new = torch.ones_like(g, dtype=torch.bool)
    new[:, 1:] = g[:, 1:] != g[:, :-1]
    per_warp = int((new & (g >= 0)).sum())
    return per_warp, int(torch.unique(sec[sec >= 0]).numel())


def lane_sectors(offs, mask) -> float:
    """The distinct sectors a lane of ``mask`` reads from one table, on the
    mean (no lane sharing a sector with another)."""
    if not bool(mask.any()):
        return 0.0
    sec = torch.sort(torch.where(offs >= 0, offs // 32, -1)[:, mask], dim=0).values
    new = torch.ones_like(sec, dtype=torch.bool)
    new[1:] = sec[1:] != sec[:-1]
    return float((new & (sec >= 0)).sum()) / int(mask.sum())


def env_sectors(scene, st, hit, uni, inline: bool = False) -> dict:
    """The 32-byte sectors one shading launch's env reads touch on these
    lanes, in each layout of :data:`ENV_LAYOUTS`: "plane-major" (the
    reference's tables as the kernel read them before the records: alias_p,
    alias_i, pdf_sa and one radiance row a carried plane) and "records" (the
    records of models/envlight.py:env_records, laid out as its texel_layout
    and ALIAS_WORDS say).  A lane whose NEE picks the env reads the
    alias slot and the chosen texel; a lane whose texel the eval needs
    (a live lane that missed; on a map that fails the check, or where
    radiance_max * throughput overflows, any lane) reads that texel.  For
    each layout: the distinct sectors a pick and a miss read (their own),
    the sectors of all warps (a warp's 32 consecutive lanes, each distinct
    sector once: what L2 serves the SMs), the distinct sectors of the whole
    launch (what device memory must serve at least once), and the sector
    floor: those, with the bound's other bytes (:func:`shade_bound`
    without its env texel and slot bytes), over 3.35 TB/s."""
    from tpu_pathtracer_torch.models.envlight import ALIAS_WORDS, texel_index, texel_layout

    env = scene.env
    s = env.radiance.shape[0]
    k = env.pdf_sa.numel()
    n, c = st.alive.shape[0], st.throughput.shape[0]
    dev = st.alive.device
    rows = (st.bins if st.bins is not None
            else torch.arange(c, device=dev)[:, None].expand(c, n))
    x = uni["env_alias"] * float(np.float32(k))
    slot = x.to(torch.int32).clamp(0, k - 1).long()
    e_idx = torch.where(x - slot.float() >= env.alias_p[slot], env.alias_i[slot], slot)
    pick = uni["env_select"] < env.select_p
    rmax = float("inf") if env.radiance_max is None else env.radiance_max
    miss = st.alive & ~torch.isfinite(hit.t)
    read = miss | ~torch.isfinite(rmax * st.throughput).all(0)
    m_idx = texel_index(env, st.direction)

    def at(mask, off):
        return torch.where(mask, off, -1).reshape(-1, n)

    reads = {"plane-major": {
        "pick": {"alias_p": at(pick, slot * 4), "alias_i": at(pick, slot * 8),
                 "pdf_sa": at(pick, e_idx * 4), "radiance": at(pick, (rows * k + e_idx) * 4)},
        "miss": {"pdf_sa": at(read, m_idx * 4), "radiance": at(read, (rows * k + m_idx) * 4)}}}
    t, pdf_col = texel_layout(s)

    def texel(idx, mask, pdf: bool):
        if t == 4:  # one 16-byte load
            return at(mask, idx * 16)
        offs = [at(mask, (idx * t + rows) * 4)]
        if pdf and pdf_col >= 0:
            offs.append(at(mask, (idx * t + pdf_col) * 4))
        return torch.cat(offs)

    # a pick's pdf is in the slot's record; a miss's in its texel's, or pdf_sa
    reads["records"] = {"pick": {"alias_rec": at(pick, slot * 4 * ALIAS_WORDS),
                                 "texel_rec": texel(e_idx, pick, False)},
                        "miss": {"texel_rec": texel(m_idx, read, True)}}
    if pdf_col < 0:
        reads["records"]["miss"]["pdf_sa"] = at(read, m_idx * 4)
    picks, misses = int(pick.sum()), int(miss.sum())
    base = (shade_bound(st, hit, uni, scene, inline)["bound_bytes"]
            - picks * (16 + 4 * c) - misses * (4 + 4 * c))
    out = {"picks": picks, "misses": misses, "texel_reads": int(read.sum())}
    for name, r in reads.items():
        tables = set(r["pick"]) | set(r["miss"])
        warp = launch = 0
        for tab in tables:
            offs = torch.cat([r[w][tab] for w in ("pick", "miss") if tab in r[w]])
            wp, ln = distinct_sectors(offs, n)
            warp, launch = warp + wp, launch + ln
        out[name] = {
            "sectors_per_pick": sum(lane_sectors(o, pick) for o in r["pick"].values()),
            "sectors_per_miss": sum(lane_sectors(o, read) for o in r["miss"].values()),
            "warp_sector_mb": 32 * warp / 1e6, "launch_sector_mb": 32 * launch / 1e6,
            "sector_floor_ms": (base + 32 * launch) / HBM_BYTES_PER_S * 1e3}
    return out


def env_miss_shares(scene) -> list[dict]:
    """The lanes each bounce of one 1080p frame (after a warm-up frame) of
    the env-lit path shades, its live lanes and the live lanes whose ray
    missed (the only lanes whose env texel the shading must read) ->
    [{"bounce", "lanes", "live", "misses", "share"}].  The frame runs under a
    StageTimer, so its bounces call the wrapper rather than replay a graph
    (render/graphs.py)."""
    from tpu_pathtracer_torch import Renderer
    from tpu_pathtracer_torch.ops import shade
    from tpu_pathtracer_torch.render.timing import StageTimer

    r = Renderer(scene, WIDTH, HEIGHT)
    r.run(1)
    wrapper, out = shade.shade_bounce, []

    def record(scene, cfg, bounce, state, uniforms, hit, inline):
        misses = int((state.alive & ~torch.isfinite(hit.t)).sum())
        n = state.alive.shape[0]
        out.append({"bounce": bounce, "lanes": n, "live": int(state.alive.sum()),
                    "misses": misses, "share": misses / n})
        return wrapper(scene, cfg, bounce, state, uniforms, hit, inline)

    record.launches = 0  # the wrapper counts its launches here meanwhile
    shade.shade_bounce = record
    try:
        r.step(timer=StageTimer())
    finally:
        shade.shade_bounce = wrapper
    torch.cuda.synchronize()
    return out


def shade_form(label: str, scene, kw: dict, gen) -> tuple[dict, dict]:
    """The shading kernel on one frame path's 1080p frame-0 wavefronts:
    bit for bit against its plain version on every lane of the whole camera
    and bounce-1 wavefronts and of 65,536 lanes drawn from them (both forms
    of the bounce), then its time on bounce 1 (queued) beside its bound
    (:func:`shade_bound`, from these lanes) and the plain version's (CUDA
    events) -> (readings, the path's sorts as :func:`shade_inputs` gives
    them)."""
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.ops import shade

    renderer = Renderer(scene, WIDTH, HEIGHT, RenderConfig(**kw))
    cfg = renderer.cfg
    shading, sorts = shade_inputs(renderer)
    n_full = shading["camera"][0].alive.shape[0]
    idx = torch.randperm(n_full, generator=gen)[:SAMPLE_LANES].to(scene.p0.device)

    def args(which, lanes):
        st, hit, uni, b = shading[which]
        if lanes != "full":
            st, hit, uni = (take_lanes(x, idx) for x in (st, hit, uni))
        return scene, cfg, b, st, uni, hit

    for which in shading:
        for lanes in ("full", SAMPLE_LANES):
            a = args(which, lanes)
            for inline in (False, True):
                same_bits(f"shade_bounce vs plain, {label}, {which}, {lanes} lanes, "
                          f"inline={inline}", shade.shade_bounce(*a, inline),
                          shade.shade_bounce_plain(*a, inline))
    every_lane = None
    if scene.env is not None:
        # a map with a NaN texel fails the map check: the every-lane path
        st, hit = shading["bounce1"][0], shading["bounce1"][1]
        bad = nonfinite_map_scene(scene, st, hit)
        for which in shading:
            a = (bad, *args(which, "full")[1:])
            got = shade.shade_bounce(*a, False)
            same_bits(f"shade_bounce vs plain, {label}, {which}, a NaN texel in the map",
                      got, shade.shade_bounce_plain(*a, False))
        nan_lanes = int(torch.isnan(got[0].radiance).any(0).sum())
        every_lane = queued_ms(lambda: shade.shade_bounce(bad, *args("bounce1", "full")[1:],
                                                          False))
        log(f"  shade_bounce, {label}, a map with a NaN texel (radiance_max None: the "
            f"every-lane path) == its plain version bit for bit on every lane of the whole "
            f"camera and bounce-1 wavefronts ({nan_lanes} bounce-1 lanes turned NaN); "
            f"bounce 1 {every_lane:.4f} ms (queued)")
        # the env's NEE arm alone: every lane's NEE on the area lights, then on
        # the env (select_p 0 and 1; held to the plain version all the same)
        arm = {}
        for p_sel in (0.0, 1.0):
            one = scene._replace(env=scene.env._replace(
                select_p=torch.full_like(scene.env.select_p, p_sel)))
            a = (one, *args("bounce1", "full")[1:])
            same_bits(f"shade_bounce vs plain, {label}, bounce1, select_p {p_sel:g}",
                      shade.shade_bounce(*a, False), shade.shade_bounce_plain(*a, False))
            arm[p_sel] = queued_ms(lambda a=a: shade.shade_bounce(*a, False))
        log(f"  shade_bounce, {label}, bounce 1 with select_p {float(scene.env.select_p):.4f} "
            f"set to 0 (no lane samples the env) {arm[0.0]:.4f} ms and to 1 (every lane "
            f"does) {arm[1.0]:.4f} ms (queued; each bit-equal to its plain version)")
        *_, st1, uni1, hit1 = args("bounce1", "full")
        sectors = env_sectors(scene, st1, hit1, uni1)
        log(f"  shade_bounce, {label}, bounce 1: the env reads' 32-byte sectors "
            f"(chip_smoke.env_sectors; {sectors['picks']} lanes pick the env, "
            f"{sectors['misses']} missed): " + "; ".join(
                f"{name} {d['sectors_per_pick']:.2f} a pick, {d['sectors_per_miss']:.2f} a "
                f"miss, warps {d['warp_sector_mb']:.1f} MB, launch {d['launch_sector_mb']:.1f} "
                f"MB, sector floor {d['sector_floor_ms']:.4f} ms"
                for name, d in ((n, sectors[n]) for n in ENV_LAYOUTS)))
    torch.cuda.synchronize()
    live = [int(v[0].alive.sum()) for v in shading.values()]
    small, full = args("bounce1", SAMPLE_LANES), args("bounce1", "full")
    ms, full_ms = (queued_ms(lambda a=a: shade.shade_bounce(*a, False)) for a in (small, full))
    inline_ms = queued_ms(lambda: shade.shade_bounce(*full, True))
    plain_ms, plain_full = (cuda_ms(lambda a=a: shade.shade_bounce_plain(*a, False), iters=3)
                            for a in (small, full))
    bnd, bfull, bin_ = (shade_bound(a[3], a[5], a[4], scene, inline)
                        for a, inline in ((small, False), (full, False), (full, True)))
    c = full[3].throughput.shape[0]
    log(f"  shade_bounce, {label} (C = {c} carried planes of S = "
        f"{scene.mat_diffuse.shape[0]}) == its plain version bit for bit on every lane of "
        f"the whole camera and bounce-1 wavefronts ({n_full} lanes; live {live}) and of "
        f"{SAMPLE_LANES} lanes drawn from them, both forms; bounce 1, device time a launch "
        f"(queued): {SAMPLE_LANES} lanes {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}); {n_full} lanes {full_ms:.4f} ms, bound "
        f"{bfull['bound_ms']:.4f} ms ({bfull['bound_by']}) = "
        f"{100.0 * bfull['bound_ms'] / full_ms:.1f}% of bound; inline form "
        f"{inline_ms:.4f} ms (bound {bin_['bound_ms']:.4f}).  Plain: {plain_ms:.3f} and "
        f"{plain_full:.3f} ms")
    readings = {"ms": ms, "plain_ms": plain_ms, "full_ms": full_ms, "bound": bnd,
                "plain_full_ms": plain_full, "full_inline_ms": inline_ms,
                "bound_full": bfull, "bound_full_inline_ms": bin_["bound_ms"],
                "full_pct_of_bound": 100.0 * bfull["bound_ms"] / full_ms, "planes": c,
                "lanes": n_full, "live": live}
    if every_lane is not None:
        readings["full_every_lane_ms"] = every_lane
        readings["full_select_p0_ms"], readings["full_select_p1_ms"] = arm[0.0], arm[1.0]
        readings["select_p"] = float(scene.env.select_p)
        readings["misses"] = [int((v[0].alive & ~torch.isfinite(v[1].t)).sum())
                              for v in shading.values()]
        readings["env_sectors"] = sectors
    return readings, sorts


def phase_shade_sort(smi: str, compiler_log: str) -> list[dict]:
    """Phase 22: the hand kernels of the shading (csrc/shade.cu) and the
    wavefront sort (csrc/wavefront_sort.cu).  The shading in each of its
    forms (:data:`SHADE_FORMS`: parity, env-lit, hero with dispersion, and
    that with the env; the env forms also on a map with a NaN texel) and the
    sort (the gather reading pixel and alive from the sorted key, and
    gathering every plane) against their plain versions bit for bit on
    every lane of the frame path's whole camera and bounce-1 wavefronts (the
    shading in both forms of the bounce; the sorts after bounces 0 and 1 of
    the main path, the hero plane set and S = 16) and on 65,536 lanes drawn
    from them; their times (queued) beside their bounds, the plain
    versions', torch.sort's and ATen's index_select a plane; the gather's
    sectors (:func:`gather_sectors`) and the env-lit frame's misses
    (:func:`env_miss_shares`); then the main path, the unsorted frame, the
    fused walk, prefix sorts, the env-lit path and the spectral path without
    and with the env in turns with the plain versions put back, and the
    self-golden gate -> the three kernels' rows of the kernel table (the
    shading's other forms under "forms")."""
    from tpu_pathtracer_torch.ops import wavefront_sort as sort
    from tpu_pathtracer_torch.render.wavefront import scene_sort_bounds

    t_phase = time.perf_counter()
    log(f"the shading and the wavefront sort as hand kernels on {smi}")
    scenes = shade_scenes()
    gen = torch.Generator().manual_seed(23)
    forms, form_sorts = {}, {}
    for label, (which, kw) in SHADE_FORMS.items():
        forms[label], form_sorts[label] = shade_form(label, scenes[which], kw, gen)
        if "env_sectors" in forms[label]:
            f = forms[label]
            floor = f["env_sectors"]["records"]["sector_floor_ms"]
            log(f"  shade_bounce, {label}, bounce 1: {f['full_ms']:.4f} ms against the sector "
                f"floor of the records {floor:.4f} ms = "
                f"{100.0 * floor / f['full_ms']:.1f}% (bound "
                f"{f['bound_full']['bound_ms']:.4f} ms = {f['full_pct_of_bound']:.1f}%)")
    registers = kernel_registers(compiler_log, "shade_bounce_kernel")
    log("  ptxas, shade_bounce_kernel<env, hero, dispersion>: " + "; ".join(
        f"<{k}> {v['registers']} registers, {v['spill_bytes']} bytes spilled"
        for k, v in sorted(registers.items())))
    shares = env_miss_shares(scenes["env"])
    forms["env-lit"]["miss_shares"] = shares
    log("  the env-lit path's lanes whose ray missed (their env texel the only one the "
        "shading reads), a frame's bounces: " + "; ".join(
            f"bounce {x['bounce']} {x['misses']} of {x['lanes']} lanes "
            f"({100.0 * x['share']:.2f}%; live {x['live']})" for x in shares))
    sorts = form_sorts["parity"]
    scene = scenes["main"]
    wmin, winv = scene_sort_bounds(scene)
    n_full = forms["parity"]["lanes"]
    idx = torch.randperm(n_full, generator=gen)[:SAMPLE_LANES].to(scene.p0.device)

    def sort_args(which, lanes):
        st, pack = sorts[which]
        if lanes != "full":
            st, pack = take_lanes(st, idx), take_lanes(pack, idx)
        return st, pack

    # the plane sets of the gather: the main path's (S = 3), hero C = 4 with
    # its bins plane (the spectral path's), and S = 16 without hero
    from tpu_pathtracer_torch import Renderer, RenderConfig

    wide = Renderer(scenes["spectral"], WIDTH, HEIGHT, RenderConfig(spectrum_samples=16))
    plane_sets = {"S = 3": sorts, "hero C = 4": form_sorts["hero"],
                  "S = 16": shade_inputs(wide)[1]}
    del wide
    for label, set_sorts in plane_sets.items():
        for which in set_sorts:
            for lanes in ("full", SAMPLE_LANES) if label == "S = 3" else ("full",):
                st, pack = (sort_args(which, lanes) if label == "S = 3"
                            else set_sorts[which])
                key = sort.sort_key(st.origin, st.direction, st.alive, st.pixel, wmin,
                                    winv)
                same_bits(f"sort_key vs plain, {label}, sort at {which}, {lanes} lanes", key,
                          sort.sort_key_plain(st.origin, st.direction, st.alive, st.pixel,
                                              wmin, winv))
                skey, perm = torch.sort(key, stable=True)
                want = sort.gather_planes_plain([*st, *pack], perm)
                same_bits(f"gather_planes vs plain, {label}, sort at {which}, {lanes} lanes",
                          sort_gather([*st, *pack], perm, skey), want)
                same_bits(f"gather_planes without the key vs plain, {label}, sort at "
                          f"{which}, {lanes} lanes", sort.gather_planes([*st, *pack], perm),
                          want)
    torch.cuda.synchronize()
    log(f"  sort_key and gather_planes (pixel and alive from the sorted key, and every "
        f"plane gathered) == their plain versions bit for bit on every lane of the main "
        f"path's sorts after bounces 1 and 2 ({n_full} lanes) and of {SAMPLE_LANES} lanes "
        f"drawn from them, and of the same sorts of the hero plane set (C = 4 and the bins "
        f"plane) and of S = 16")

    # times: the kernels' calls queued behind a spin (the card's time, "ms"),
    # the plain versions by CUDA events (host work included, as the frame
    # paid it), torch.sort queued beside the sort's two kernels
    p = forms["parity"]
    entries = [kernel_entry(
        "shade_bounce", "shade.cu", "tpu_pathtracer/render/wavefront.py:455", 0.0, p["ms"],
        p["plain_ms"], p["full_ms"], p["bound"], plain_full_ms=p["plain_full_ms"],
        full_inline_ms=p["full_inline_ms"], bound_full_ms=p["bound_full"]["bound_ms"],
        bound_full_by=p["bound_full"]["bound_by"], full_pct_of_bound=p["full_pct_of_bound"],
        bound_full_inline_ms=p["bound_full_inline_ms"], registers=registers,
        forms={k: v for k, v in forms.items() if k != "parity"})]
    s = scene.mat_diffuse.shape[0]
    st, pack = sort_args("bounce 2", "full")
    st_s, pack_s = sort_args("bounce 2", SAMPLE_LANES)
    keys = {n: sort.sort_key(x.origin, x.direction, x.alive, x.pixel, wmin, winv)
            for n, x in ((SAMPLE_LANES, st_s), ("full", st))}
    sorted_keys = {n: torch.sort(k, stable=True) for n, k in keys.items()}
    perms = {n: v.indices for n, v in sorted_keys.items()}
    planes = {SAMPLE_LANES: [*st_s, *pack_s], "full": [*st, *pack]}
    times = {}
    for n, x in ((SAMPLE_LANES, st_s), ("full", st)):
        times[n] = {
            "sort_key": queued_ms(lambda x=x: sort.sort_key(x.origin, x.direction, x.alive,
                                                            x.pixel, wmin, winv)),
            "gather_planes": queued_ms(lambda n=n: sort_gather(planes[n], perms[n],
                                                               sorted_keys[n].values)),
            # ATen's gather of the same function: one index_select a plane
            "index_select": queued_ms(lambda n=n: sort.gather_planes_plain(planes[n],
                                                                           perms[n])),
            "torch_sort": cuda_ms(lambda n=n: torch.sort(keys[n], stable=True), iters=10),
            "sort_key_plain": cuda_ms(lambda x=x: sort.sort_key_plain(
                x.origin, x.direction, x.alive, x.pixel, wmin, winv), iters=3),
            "gather_planes_plain": cuda_ms(lambda n=n: sort.gather_planes_plain(
                planes[n], perms[n]), iters=3)}
    sectors = gather_sectors(planes["full"], perms["full"])
    log("  gather_planes, the sort after bounce 1: the 32-byte sectors its reads touch "
        "(a warp's 32 outputs, one row): " + "; ".join(
            f"{e}-byte rows x{d['rows']}: {d['sectors_per_warp']:.2f} sectors, "
            f"{d['lines_per_warp']:.2f} 128-byte lines a warp"
            for e, d in sectors["by_element_size"].items())
        + f"; all warps and rows {sectors['warp_sector_mb']:.1f} MB of sectors for "
        f"{sectors['row_mb']:.1f} MB of rows; the whole pass touches "
        f"{sectors['pass_sector_mb']:.1f} MB of distinct sectors: sector floor "
        f"{sectors['sector_floor_ms']:.4f} ms (those sectors, the writes and the "
        f"permutation over {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    sets_ms = {}
    for label, set_sorts in plane_sets.items():
        for which in ("bounce 1", "bounce 2"):
            x, xp = set_sorts[which]
            skey, perm = torch.sort(sort.sort_key(x.origin, x.direction, x.alive, x.pixel,
                                                  wmin, winv), stable=True)
            items = [*x, *xp]
            ms_k = queued_ms(lambda: sort_gather(items, perm, skey))
            ms_i = queued_ms(lambda: sort.gather_planes_plain(items, perm))
            b = gather_bound(items, perm.shape[0])["bound_ms"]
            sets_ms[f"{label}, sort at {which}"] = {"ms": ms_k, "index_select_ms": ms_i,
                                                    "bound_ms": b}
            log(f"  gather_planes, {label}, sort at {which} ({perm.shape[0]} lanes, "
                f"{sum(1 if y.dim() == 1 else y.shape[0] for y in items if y is not None)} "
                f"rows): {ms_k:.4f} ms (queued), bound {b:.4f} ms = {100.0 * b / ms_k:.1f}%; "
                f"ATen's index_select a plane (queued) {ms_i:.4f} ms")
    for name, line, bfn in (
            ("sort_key", "tpu_pathtracer/render/wavefront.py:122",
             lambda n: bound(n * SORT_KEY_LANE_BYTES, n * OPS_SORT_KEY)),
            ("gather_planes", "tpu_pathtracer/render/wavefront.py:221",
             lambda n: gather_bound(planes[SAMPLE_LANES if n == SAMPLE_LANES else "full"],
                                    n))):
        bnd, bfull = bfn(SAMPLE_LANES), bfn(n_full)
        t_s, t_f = times[SAMPLE_LANES], times["full"]
        extra = {} if name == "sort_key" else {
            "library_ms": t_s["index_select"], "library_full_ms": t_f["index_select"],
            "library_call": "torch.index_select, one call a plane", "sectors": sectors,
            "plane_sets": sets_ms}
        entries.append(kernel_entry(
            name, "wavefront_sort.cu", line, 0.0, t_s[name], t_s[f"{name}_plain"],
            t_f[name], bnd, plain_full_ms=t_f[f"{name}_plain"],
            torch_sort_ms=t_s["torch_sort"], torch_sort_full_ms=t_f["torch_sort"],
            bound_full_ms=bfull["bound_ms"], bound_full_by=bfull["bound_by"],
            full_pct_of_bound=100.0 * bfull["bound_ms"] / t_f[name], **extra))
        log(f"  {name}, the sort after bounce 1 (S = {s}, {len(planes['full'])} planes, "
            f"{sum(x is not None for x in planes['full'])} present), device time a launch "
            f"(queued): {SAMPLE_LANES} lanes {t_s[name]:.4f} ms, bound {bnd['bound_ms']:.4f} "
            f"ms ({bnd['bound_by']}); {n_full} lanes {t_f[name]:.4f} ms, bound "
            f"{bfull['bound_ms']:.4f} ms ({bfull['bound_by']}) = "
            f"{100.0 * bfull['bound_ms'] / t_f[name]:.1f}% of bound.  Plain: "
            f"{t_s[name + '_plain']:.3f} and {t_f[name + '_plain']:.3f} ms.  torch.sort of the "
            f"key (CUDA events over back-to-back calls): {t_s['torch_sort']:.4f} and "
            f"{t_f['torch_sort']:.4f} ms" + ("" if name == "sort_key" else
                                            f".  ATen's index_select a plane (queued): "
                                            f"{t_s['index_select']:.4f} and "
                                            f"{t_f['index_select']:.4f} ms"))
    del sorts, form_sorts, plane_sets, keys, sorted_keys, perms, planes, st, pack, st_s, pack_s

    turns = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (which, kw, want) in SHADE_SORT_TURNS.items():
            turns[label] = shade_sort_turns(label, tmp, scenes[which], kw, want)
    m = phase_parity()["metrics"]
    if float(f"{m['rel_mse']:.4e}") > SELF_GOLDEN_REL_MSE:
        raise AssertionError(f"self-golden gate: rel_mse {m['rel_mse']} above "
                             f"{SELF_GOLDEN_REL_MSE}")
    log(f"  self-golden rel_mse {m['rel_mse']:.7e} (the default path's before: "
        f"{SELF_GOLDEN_REL_MSE})")
    entries[0]["turns"] = turns
    log(f"shade/sort phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


def checkout_package(root: str, alias: str):
    """The tpu_pathtracer_torch package of another checkout of this repo at
    ``root`` (an older commit unpacked with git archive), imported as
    ``alias`` beside this one: its wrappers launch its own kernels, built
    from its own sources into its own _build directory."""
    import importlib.util

    pkg = os.path.join(root, "tpu_pathtracer_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def forms_ab(*roots: str) -> int:
    """The gather and the shading kernel of this tree against those of the
    checkouts at ``roots`` (:func:`checkout_package`; each named by the root
    as given), in turns (the checkouts, then this tree, then back; each call
    queued) on the same whole 1080p wavefronts: the gather on the main path's
    sorts after bounces 1 and 2, the hero plane set's and S = 16's (this tree
    reading pixel and alive from the sorted key, as the frame calls it), the
    shading's parity, env-lit, hero and hero-with-env forms on bounce 1, the
    env-lit form on the camera wavefront, and the env forms with select_p 1;
    every output bit-equal to the plain version's.  Prints an "A/B ..." line each.

        python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.forms_ab('old'))"
    """
    import importlib

    smi = phase_device()
    phase_build()
    if len(set(roots)) < len(roots) or "new" in roots:
        raise ValueError(f"forms_ab: each checkout once, none named 'new' (this tree): {roots}")
    trees = {}
    for i, root in enumerate(roots):
        pkg = checkout_package(root, f"tpu_pathtracer_torch_ab{i}").__name__
        trees[root] = tuple(importlib.import_module(f"{pkg}.{m}")
                            for m in ("ops.wavefront_sort", "ops.shade"))
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.ops import shade
    from tpu_pathtracer_torch.ops import wavefront_sort as sort
    from tpu_pathtracer_torch.render.wavefront import scene_sort_bounds

    log(f"A/B of this tree's gather and shading against {', '.join(roots)} on {smi}")
    scenes = shade_scenes()
    wmin, winv = scene_sort_bounds(scenes["main"])

    def turns_ms(fns: dict) -> dict:
        out = {k: [] for k in fns}
        for k in (*fns, *reversed(fns)):
            out[k].append(queued_ms(fns[k]))
        return out

    def line(what: str, t: dict, bound_ms: float) -> None:
        log(f"  A/B {what} (bound {bound_ms:.4f} ms), ms in turns: " + "; ".join(
            f"{k} {a:.4f}/{b:.4f} ({100.0 * bound_ms / min(a, b):.1f}% of bound)"
            for k, (a, b) in t.items()))

    sets = {}
    for label, (which, kw) in {"S = 3": ("main", {}), "hero C = 4": ("spectral", SPECTRAL),
                               "S = 16": ("spectral", {"spectrum_samples": 16})}.items():
        r = Renderer(scenes[which], WIDTH, HEIGHT, RenderConfig(**kw))
        shading, sorts = shade_inputs(r)
        sets[label] = sorts
        if label != "S = 16":
            sets[f"shading {label}"] = (r.cfg, shading)
        del r
    for label in ("S = 3", "hero C = 4", "S = 16"):
        for which in ("bounce 1", "bounce 2"):
            st, pack = sets[label][which]
            skey, perm = torch.sort(sort.sort_key(st.origin, st.direction, st.alive,
                                                  st.pixel, wmin, winv), stable=True)
            items = [*st, *pack]
            want = sort.gather_planes_plain(items, perm)
            fns = {name: (lambda m=m[0]: m.gather_planes(items, perm))
                   for name, m in trees.items()}
            fns["new"] = lambda: sort_gather(items, perm, skey)
            for k, f in fns.items():
                same_bits(f"A/B gather {k}, {label}, sort at {which}", f(), want)
            line(f"gather_planes, {label}, sort at {which} ({perm.shape[0]} lanes)",
                 turns_ms(fns), gather_bound(items, perm.shape[0])["bound_ms"])
    for label, (which, kw) in (("env-lit", ("env", {})),
                               ("hero env", ("spectral env", SPECTRAL))):
        r = Renderer(scenes[which], WIDTH, HEIGHT, RenderConfig(**kw))
        sets[f"shading {label}"] = (r.cfg, shade_inputs(r)[0])
        del r
    for label, scene in (("env-lit", scenes["env"]), ("hero env", scenes["spectral env"]),
                         ("S = 3", scenes["main"]), ("hero C = 4", scenes["spectral"])):
        cfg, shading = sets[f"shading {label}"]
        cases = [("bounce1", None)]
        if label == "env-lit":
            cases.append(("camera", None))
        if scene.env is not None:
            cases.append(("bounce1", 1.0))  # every lane's NEE picks the env
        for which, sel in cases:
            st, hit, uni, b = shading[which]
            sc = scene if sel is None else scene._replace(env=scene.env._replace(
                select_p=torch.full_like(scene.env.select_p, sel)))
            a = (sc, cfg, b, st, uni, hit, False)
            want = shade.shade_bounce_plain(*a)
            fns = {name: (lambda a=a, sh=m[1]: sh.shade_bounce(*a)) for name, m in trees.items()}
            fns["new"] = lambda a=a: shade.shade_bounce(*a)
            for k, f in fns.items():
                got = f()
                same_bits(f"A/B shade_bounce {k}, {label}, {which}", (got[0][:8], got[1:]),
                          (want[0][:8], want[1:]))
            what = which if sel is None else f"{which}, select_p {sel:g}"
            line(f"shade_bounce, {label} form, {what} wavefront ({st.alive.shape[0]} lanes)",
                 turns_ms(fns),
                 shade_bound(st, hit, uni, sc, False)["bound_ms"])
    log("A/B done")
    return 0


def main() -> int:
    smi = phase_device()
    t_start = time.perf_counter()
    compiler_log = phase_build()
    log(f"build phase: {time.perf_counter() - t_start:.1f} s")

    from tpu_pathtracer_torch import Renderer

    # launches: each kernel's count in the run of its path; per_frame: the
    # same over that run's frames (the counting walk runs once per bench
    # line or utilization block, not per frame)
    renderer = Renderer(SCENE, WIDTH, HEIGHT)
    kernels, priced = phase_kernels(renderer)
    kernels += phase_bench_kernels(renderer, priced)
    phase_edge_shapes(renderer)
    launches, frames = phase_main_path(renderer)
    per_frame = {k: launches[k] / frames for k in MAIN_PATH}
    phase_parity()
    del renderer
    with tempfile.TemporaryDirectory() as tmp:
        launches["anyhit_walk"] = phase_cli_env(tmp)["anyhit_walk"]
        per_frame["anyhit_walk"] = launches["anyhit_walk"] / 5  # the 5-frame run
    phase_env_parity()
    launches.update(phase_bench())
    for variant, (_, kernel) in VARIANTS.items():
        per_frame[kernel] = phase_parity(variant)["launches"][kernel] / PARITY_FRAMES
    for variant, (_, kernel) in MT_VARIANTS.items():
        run = phase_parity(variant)  # "mt" alone: a parity gate; the terrain counts it
        if variant != "mt":
            launches[f"{kernel}_mt"] = run["launches_mt"][kernel]
            per_frame[f"{kernel}_mt"] = launches[f"{kernel}_mt"] / PARITY_FRAMES
    terrains = {}
    for grid in TERRAIN_GRIDS:
        t0 = time.perf_counter()
        terrains[grid] = terrain_scene(grid)
        log(f"terrain grid {grid}: {terrains[grid].num_triangles} triangles, "
            f"build_scene {time.perf_counter() - t0:.2f} s")
    rows = {}
    for grid in TERRAIN_GRIDS:
        r = terrain_renderer(terrains[grid])
        for name, row in phase_terrain_kernels(r, grid).items():
            if name in rows:  # the larger terrain's numbers beside the first's
                rows[name].update({f"{k}_grid{grid}": v for k, v in row.items()
                                   if k in ("max_abs_err", "ms", "plain_ms",
                                            "full_ms", "bound_ms", "bound_by")
                                   or k.endswith("_ms") or "_by" in k
                                   or "pct_of_bound" in k})
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                                row["max_abs_err"])
            else:
                rows[name] = row
        del r
    kernels += list(rows.values())
    small, large = (terrains[g] for g in TERRAIN_GRIDS)
    run, frames = phase_terrain_path(small, "grid 256")
    launches["window_walk_hbm"] = run["launches"]["window_walk_hbm"]
    per_frame["window_walk_hbm"] = launches["window_walk_hbm"] / frames
    run, frames = phase_terrain_path(small, "grid 256, tritest=mt", tritest="mt")
    launches["window_walk_mt"] = run["launches_mt"]["window_walk_hbm"]
    per_frame["window_walk_mt"] = launches["window_walk_mt"] / frames
    phase_terrain_path(large, "grid 724", timed=2)
    launches["window_walk_counts_mt"] = phase_terrain_counts(small)
    for scene in (small, large):
        route_turns(scene)
    phase_lbvh(small, terrain_scene(TERRAIN_GRIDS[0], device="cpu"))
    phase_backend_parity(small)
    renderer = Renderer(SCENE, WIDTH, HEIGHT)
    kernels += phase_sweep_kernels(renderer, small, compiler_log)
    launches.update(phase_split(renderer, small))
    entry, probe = phase_launch_probe(smi)
    kernels.append(entry)
    # the window walk without its epilogue: no frame path launches it, the
    # launch probe does (its all-dead lanes)
    launches.update(noop=probe["noop"], window_walk=probe["window_walk"])
    entry, launches["rowtest_probe"] = phase_rowtest_probe(compiler_log)
    kernels.append(entry)
    del renderer
    with tempfile.TemporaryDirectory() as tmp:
        modes = phase_frame_modes(tmp, smi)
    launches["uniforms_r2"] = modes["uniforms_r2"]["launches"]
    per_frame["uniforms_r2"] = launches["uniforms_r2"] / modes["uniforms_r2"]["frames"]
    with tempfile.TemporaryDirectory() as tmp:
        spectral = phase_spectral(tmp, smi)["launches_per_frame_spectral"]
    with tempfile.TemporaryDirectory() as tmp:
        mesh = phase_multi_device(tmp, smi)["launches_per_frame_mesh2x1"]
    kernels += phase_fused_stages(smi, priced)
    kernels += phase_shade_sort(smi, compiler_log)
    for k in kernels:
        k["launches"] = launches.get(k["name"])
        k["launches_per_frame"] = per_frame.get(k["name"])
        if k["name"] in modes["launches_per_sample_fuse2"]:
            k["launches_per_sample_fuse2"] = modes["launches_per_sample_fuse2"][k["name"]]
        if k["name"] in spectral:
            k["launches_per_frame_spectral"] = spectral[k["name"]]
        if k["name"] in mesh:
            k["launches_per_frame_mesh2x1"] = mesh[k["name"]]
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on their path: {missing}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the device check")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
