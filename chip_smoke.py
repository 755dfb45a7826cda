#!/usr/bin/env python3
"""Smoke test of tpu_pathtracer_torch on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels from tpu_pathtracer_torch/csrc;
3. kernels: each kernel against its plain torch version on the card, on
   65,536 lanes of the real CornellBox-Water-plastic 1080p camera, bounce-1
   and shadow wavefronts; times both at that size and the kernel on the
   full wavefront;
4. main path: Renderer("CornellBox-Water-plastic", 1920, 1080), default
   config, 2 warm-up + 3 timed frames; exact traced rays, a per-stage CUDA
   event breakdown, and each kernel's launch count in that run;
5. parity: 150x200, depth 8, 16 frames against the committed self-golden
   (rel_mse < 1e-3, 0.999 < mean_ratio < 1.001).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SCENE = "CornellBox-Water-plastic"
WIDTH, HEIGHT = 1920, 1080
SAMPLE_LANES = 65536
ID_AGREE = 0.9999      # ids equal, or an equal-t tie, on at least this share
T_RTOL = 1e-6          # t agreement; bit-equal expected under --fmad=false


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_build() -> None:
    from tpu_pathtracer_torch.ops import cuda_build

    path, seconds, compiler_log = cuda_build.build()
    log(f"build: {os.path.relpath(path)} in {seconds:.1f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    cuda_build.load_library()


def wavefronts(scene, layout, layout_occl, cfg):
    """The port's own 1080p frame-0 wavefronts: camera rays, the sorted
    bounce-1 path rays, and bounce 0's shadow rays (after that sort)."""
    from tpu_pathtracer_torch.models.camera import Camera, generate_rays_flat
    from tpu_pathtracer_torch.ops.hopper_traverse import make_cuda_intersector
    from tpu_pathtracer_torch.ops.rng import fold_in, prng_key
    from tpu_pathtracer_torch.render import noise, state, wavefront
    from tpu_pathtracer_torch.render.order import make_order

    dev = scene.p0.device
    key = state.fused_wavefront_key(state.frame_rng_key(prng_key(0), 0))
    order = make_order(HEIGHT, WIDTH, 0, cfg.traversal_tile, device=dev)
    pids = noise.pids_from_order(order, WIDTH)
    jitter = noise.camera_jitter(fold_in(key, 0xC0FFEE), 0, pids)
    o, d = generate_rays_flat(Camera(), order.rows, order.cols, jitter[0:2],
                              HEIGHT, WIDTH)
    st0 = wavefront.initial_path_state(o, d, cfg.spectrum_samples, pids)
    isect = make_cuda_intersector(layout, layout_occl, prepass=cfg.traversal_prepass)
    st1, pack, _ = wavefront.trace_bounce(
        scene, cfg, isect, 0, st0, noise.bounce_uniforms(key, 0, 0, pids),
        coherent=True)
    wmin, winv = wavefront.scene_sort_bounds(scene)
    st1, pack = wavefront.sort_wavefront(st1, wmin, winv, pack)
    return {
        "camera": (o, d, st0.alive),
        "bounce1": (st1.origin.contiguous(), st1.direction.contiguous(), st1.alive),
        "shadow": (st1.origin.contiguous(), pack.to_light.contiguous(), pack.ok,
                   pack.cap.contiguous()),
    }


def draw(arrays, n: int, gen: torch.Generator):
    idx = torch.randperm(arrays[0].shape[-1], generator=gen, device="cpu")[:n]
    idx = idx.to(arrays[0].device)
    return tuple(a.index_select(-1, idx).contiguous() for a in arrays)


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


def phase_kernels(renderer) -> list[dict]:
    from tpu_pathtracer_torch.ops import hopper_traverse as ht

    lay, occl, cfg = renderer.layout, renderer.layout_occl, renderer.cfg
    waves = wavefronts(renderer.scene, lay, occl, cfg)
    gen = torch.Generator().manual_seed(1234)
    prepass = cfg.traversal_prepass
    errs_a = []
    for which in ("camera", "bounce1"):
        o, d, act = draw(waves[which], SAMPLE_LANES, gen)
        t_max = torch.full_like(o[0], torch.inf)
        tk, rk = ht.window_walk(o, d, act, t_max, lay, prepass=prepass)
        tp, rp = ht.window_walk_plain(o, d, act, t_max, lay, prepass=prepass)
        torch.cuda.synchronize()
        errs_a.append(agree(f"window_walk/{which}", tk, rk, tp, rp))
    a_in = (o, d, act, t_max, lay)
    ms_a = cuda_ms(lambda: ht.window_walk(*a_in, prepass=prepass))
    plain_a = cuda_ms(lambda: ht.window_walk_plain(*a_in, prepass=prepass), iters=2)
    o, d, act = waves["camera"]
    full_t = torch.full_like(o[0], torch.inf)
    full_a = cuda_ms(lambda: ht.window_walk(o, d, act, full_t, lay, prepass=prepass))
    log(f"  window_walk at {SAMPLE_LANES} bounce-1 lanes: kernel {ms_a:.3f} ms, "
        f"plain {plain_a:.3f} ms; full camera wavefront ({o.shape[1]} lanes): "
        f"{full_a:.3f} ms")

    o, d, ok, cap = draw(waves["shadow"], SAMPLE_LANES, gen)
    outk = ht.capped_walk(o, d, ok, cap, occl)
    outp = ht.capped_walk_plain(o, d, ok, cap, occl)
    torch.cuda.synchronize()
    miss = lambda out: torch.where(out[0] < cap, out[0], torch.inf)  # noqa: E731
    err_b = agree("capped_walk/shadow", miss(outk), outk[3], miss(outp), outp[3])
    b_in = (o, d, ok, cap, occl)
    ms_b = cuda_ms(lambda: ht.capped_walk(*b_in))
    plain_b = cuda_ms(lambda: ht.capped_walk_plain(*b_in), iters=2)
    o, d, ok, cap = waves["shadow"]
    full_b = cuda_ms(lambda: ht.capped_walk(o, d, ok, cap, occl))
    log(f"  capped_walk at {SAMPLE_LANES} shadow lanes: kernel {ms_b:.3f} ms, "
        f"plain {plain_b:.3f} ms; full shadow wavefront ({o.shape[1]} lanes, "
        f"{int(ok.sum())} live): {full_b:.3f} ms")
    return [
        {"name": "window_walk", "route": "cuda",
         "source": "tpu_pathtracer_torch/csrc/window_walk.cu",
         "replaces": "tpu_pathtracer/ops/pallas_traverse.py:698",
         "max_abs_err": max(errs_a), "ms": ms_a, "plain_ms": plain_a,
         "full_ms": full_a},
        {"name": "capped_walk", "route": "cuda",
         "source": "tpu_pathtracer_torch/csrc/capped_walk.cu",
         "replaces": "tpu_pathtracer/ops/pallas_traverse.py:106",
         "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b,
         "full_ms": full_b},
    ]


def phase_main_path(renderer) -> dict:
    """Drive the main path; returns each kernel's launches in that run."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht
    from tpu_pathtracer_torch.render.state import (frame_rng_key,
                                                   fused_wavefront_key,
                                                   render_frame)
    from tpu_pathtracer_torch.render.timing import StageTimer
    from tpu_pathtracer_torch.render.wavefront import render_sample

    plain_cuda = {"window_walk_plain": 0, "capped_walk_plain": 0}

    def counted(name, fn):
        def wrapper(o, *args, **kw):
            if o.is_cuda:
                plain_cuda[name] += 1
            return fn(o, *args, **kw)
        return wrapper

    saved = {name: getattr(ht, name) for name in plain_cuda}
    for name, fn in saved.items():
        setattr(ht, name, counted(name, fn))
    ht.window_walk.launches = 0
    ht.capped_walk.launches = 0
    try:
        renderer.run(2)                      # warm-up
        t0 = time.perf_counter()
        renderer.run(3)
        ms = (time.perf_counter() - t0) / 3 * 1e3
        key = fused_wavefront_key(frame_rng_key(renderer.state.key,
                                                renderer.state.frame_index))
        _, nrays = render_sample(
            renderer.scene, renderer.cfg, renderer.camera, HEIGHT, WIDTH, key,
            renderer.state.frame_index, renderer._intersect, with_ray_count=True)
        nrays = int(nrays)
        timer = StageTimer()
        renderer.state = render_frame(renderer.state, renderer.scene, renderer.cfg,
                                      renderer.camera, renderer._intersect,
                                      timer=timer)
        stages = timer.totals()
        launches = {"window_walk": ht.window_walk.launches,
                    "capped_walk": ht.capped_walk.launches}
    finally:
        for name, fn in saved.items():
            setattr(ht, name, fn)
    img = renderer.image()
    log(f"main path: {ms:.2f} ms/frame at {WIDTH}x{HEIGHT} depth "
        f"{renderer.cfg.max_path_length}; {nrays} traced rays/frame = "
        f"{nrays / ms / 1e3:.2f} Mrays/s; HUD {renderer.hud()}")
    walks = stages.get("walk_nearest", 0.0) + stages.get("walk_shadow", 0.0)
    other = stages["sample"] - stages.get("sort", 0.0) - walks
    log("  stages (ms, one frame): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(stages.items()))
        + f", shading+rest {other:.2f}")
    log(f"  kernel launches in the main-path run: {launches}; plain versions "
        f"on CUDA tensors: {plain_cuda}")
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
        raise AssertionError(f"main path image not finite / wrong shape {img.shape}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if any(plain_cuda.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain_cuda}")
    return launches


def phase_parity() -> dict:
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.io.exr import read_exr
    from tpu_pathtracer_torch.utils.compare import metrics

    here = os.path.dirname(os.path.abspath(__file__))
    gold, _ = read_exr(os.path.join(here, "assets", "self_golden", f"{SCENE}-8.exr"))
    r = Renderer(SCENE, 200, 150, RenderConfig(samples_per_frame=1, max_path_length=8))
    r.run(16)
    img = r.image()
    m = metrics(img, gold)
    log(f"parity vs self-golden (150x200, depth 8, 16 frames): {m}")
    if not np.isfinite(img).all() or not (m["rel_mse"] < 1e-3 and 0.999 < m["mean_ratio"] < 1.001):
        raise AssertionError(f"self-golden gate failed: {m}")
    return m


def main() -> int:
    smi = phase_device()
    t0 = time.perf_counter()
    phase_build()
    log(f"build phase: {time.perf_counter() - t0:.1f} s")

    from tpu_pathtracer_torch import Renderer

    renderer = Renderer(SCENE, WIDTH, HEIGHT)
    kernels = phase_kernels(renderer)
    launches = phase_main_path(renderer)
    phase_parity()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
