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
   full env-lit pack beside the any-hit walk;
4. main path: Renderer("CornellBox-Water-plastic", 1920, 1080), default
   config, 2 warm-up + 3 timed frames; exact traced rays, a per-stage CUDA
   event breakdown, and each kernel's launch count in that run;
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
   the fused path+shadow walk.

Phase 3 also holds the bench's four kernels against their plain versions
on 65,536 lanes of the same wavefronts: minwalk on camera and bounce-1
lanes (payload to atol 1e-6), the sweep on bounce-1, the window walk with
the original-id latch on bounce-1 paths plus their shadow pack (clear masks
equal), and the counting walk on bounce-1 and the shadow pack (useful rows
equal, spent within its warp bounds).

The line before the last is the kernel table as JSON (launches: the main
path's run for the window, capped and any-hit walks' main paths, the bench
runs for the other four); the last line is {"ok": true, "device": {...}}.
Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SCENE = "CornellBox-Water-plastic"
WIDTH, HEIGHT = 1920, 1080
SAMPLE_LANES = 65536
ID_AGREE = 0.9999      # ids equal, or an equal-t tie, on at least this share
T_RTOL = 1e-6          # t agreement; bit-equal expected under --fmad=false
PARITY = (1e-3, 0.999, 1.001)  # rel_mse <, mean_ratio in (lo, hi)
KERNELS = ("window_walk", "capped_walk", "anyhit_walk", "minwalk", "sweep",
           "window_walk_orig", "window_walk_counts")
PAYLOAD_ATOL = 1e-6    # minwalk's position and normal, kernel vs plain (rsqrt)
VARIANTS = {           # the bench's kernel switches: config and the kernel each adds
    "minwalk": ({"traversal_kernel": "minwalk"}, "minwalk"),
    "sweep": ({"traversal_kernel": "sweep"}, "sweep"),
    "fused": ({"fuse_shadow_walk": True}, "window_walk_orig"),
}


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
    key = state.fused_wavefront_key(state.frame_rng_key(prng_key(0), 0))
    order = make_order(HEIGHT, WIDTH, 0, cfg.traversal_tile, device=dev)
    pids = noise.pids_from_order(order, WIDTH)
    jitter = noise.camera_jitter(fold_in(key, 0xC0FFEE), 0, pids)
    o, d = generate_rays_flat(Camera(), order.rows, order.cols, jitter[0:2],
                              HEIGHT, WIDTH)
    st0 = wavefront.initial_path_state(o, d, cfg.spectrum_samples, pids)
    isect = make_cuda_intersector(layout, layout_occl, prepass=cfg.traversal_prepass)
    uniforms = noise.bounce_uniforms(key, 0, 0, pids, with_env=scene.env is not None)
    st1, pack, _ = wavefront.trace_bounce(scene, cfg, isect, 0, st0, uniforms,
                                          coherent=True)
    wmin, winv = wavefront.scene_sort_bounds(scene)
    st1, pack = wavefront.sort_wavefront(st1, wmin, winv, pack)
    return {
        "camera": (o, d, st0.alive),
        "bounce1": (st1.origin.contiguous(), st1.direction.contiguous(), st1.alive),
        "shadow": (st1.origin.contiguous(), pack.to_light.contiguous(), pack.ok,
                   pack.cap.contiguous(), pack.target.to(torch.int32).contiguous()),
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
    from tpu_pathtracer_torch.scene import attach_env

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

    o, d, ok, cap, _ = draw(waves["shadow"], SAMPLE_LANES, gen)
    outk = ht.capped_walk(o, d, ok, cap, occl)
    outp = ht.capped_walk_plain(o, d, ok, cap, occl)
    torch.cuda.synchronize()
    miss = lambda out: torch.where(out[0] < cap, out[0], torch.inf)  # noqa: E731
    err_b = agree("capped_walk/shadow", miss(outk), outk[3], miss(outp), outp[3])
    b_in = (o, d, ok, cap, occl)
    ms_b = cuda_ms(lambda: ht.capped_walk(*b_in))
    plain_b = cuda_ms(lambda: ht.capped_walk_plain(*b_in), iters=2)
    o, d, ok, cap, _ = waves["shadow"]
    full_b = cuda_ms(lambda: ht.capped_walk(o, d, ok, cap, occl))
    log(f"  capped_walk at {SAMPLE_LANES} shadow lanes: kernel {ms_b:.3f} ms, "
        f"plain {plain_b:.3f} ms; full shadow wavefront ({o.shape[1]} lanes, "
        f"{int(ok.sum())} live): {full_b:.3f} ms")

    # kernel C on the env-lit frame's shadow pack (area-light and env lanes)
    env_scene = attach_env(renderer.scene, sky_map())
    o, d, ok, cap, tgt = wavefronts(env_scene, lay, occl, cfg)["shadow"]
    eps = cfg.distance_epsilon
    live = int(ok.sum())
    env_share = float((ok & (tgt < 0)).sum()) / max(live, 1)
    log(f"  env-lit shadow pack: {o.shape[1]} lanes, {live} live, env share "
        f"{env_share:.4f} (select_p {float(env_scene.env.select_p):.4f})")
    c_in = draw((o, d, ok, cap, tgt), SAMPLE_LANES, gen)
    ck = ht.anyhit_walk(*c_in, occl, eps)
    cp = ht.anyhit_walk_plain(*c_in, occl, eps)
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
        {"name": "anyhit_walk", "route": "cuda",
         "source": "tpu_pathtracer_torch/csrc/anyhit_walk.cu",
         "replaces": "tpu_pathtracer/ops/pallas_traverse.py:274",
         "max_abs_err": float(bad), "ms": ms_c, "plain_ms": plain_c,
         "full_ms": full_c, "capped_full_ms": full_bc, "env_share": env_share},
    ]


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


def phase_bench_kernels(renderer) -> list[dict]:
    """The bench's four kernels against their plain versions on 65,536
    lanes of the 1080p wavefronts, and their times."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht

    lay, cfg = renderer.layout, renderer.cfg
    waves = wavefronts(renderer.scene, lay, renderer.layout_occl, cfg)
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
        outp = ht.minwalk_plain(o, d, act, t_max, lay, prepass=pp_min)
        torch.cuda.synchronize()
        hit = lambda out: torch.where(out[0] < t_max, out[0], torch.inf)  # noqa: E731
        errs.append(agree(f"minwalk/{which}", hit(outk), outk[3], hit(outp), outp[3]))
        same = outk[3] == outp[3]
        pay = max(pay, float((outk[6:] - outp[6:]).abs()[:, same].max()))
    log(f"  minwalk: payload (position, normal) max |diff| {pay:.3g} where ids agree")
    if pay > PAYLOAD_ATOL:
        raise AssertionError(f"minwalk payload differs by {pay} > {PAYLOAD_ATOL}")
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
    b_in = (o, d, act, t_max, lay)
    ms_b = cuda_ms(lambda: ht.sweep(*b_in))
    plain_b = cuda_ms(lambda: ht.sweep_plain(*b_in), iters=2)
    full_b = cuda_ms(lambda: ht.sweep(*waves["bounce1"], inf["bounce1"], lay), iters=2)
    log(f"  sweep at {SAMPLE_LANES} bounce-1 lanes: kernel {ms_b:.3f} ms, plain "
        f"{plain_b:.3f} ms; full bounce-1 ({waves['bounce1'][0].shape[1]} lanes, "
        f"{int(waves['bounce1'][2].sum())} live): {full_b:.3f} ms")

    # kernel c: the fused walk's 2N lanes, bounce-1 paths + bounce-0 shadow pack
    def two_n(o, d, alive, sdir, sok, scap, tgt):
        return (torch.cat([o, o], 1).contiguous(), torch.cat([d, sdir], 1).contiguous(),
                torch.cat([alive, sok]).contiguous(),
                torch.cat([torch.full_like(scap, torch.inf), scap]).contiguous())

    lanes = draw(pair, SAMPLE_LANES, gen)
    c_in = two_n(*lanes)
    tk, rk, ok_ = ht.window_walk_orig(*c_in, lay, prepass=pp_win)
    tp, rp, op = ht.window_walk_orig_plain(*c_in, lay, prepass=pp_win)
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

    # kernel d: the counting walk on bounce-1 lanes and on the shadow pack
    o, d, alive, sdir, sok, scap, _ = draw(pair, SAMPLE_LANES, gen)
    t_max = torch.full_like(scap, torch.inf)
    errs_d = []
    for which, args in (("bounce1", (o, d, alive, t_max)), ("shadow", (o, sdir, sok, scap))):
        got = ht.window_walk_counts(*args, lay, prepass=pp_win)
        plain = ht.window_walk_counts_plain(*args, lay, prepass=pp_win)
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
    src = "tpu_pathtracer_torch/csrc/"
    ref = "tpu_pathtracer/ops/pallas_traverse.py:"
    return [
        {"name": "minwalk", "route": "cuda", "source": src + "minwalk.cu",
         "replaces": ref + "106", "max_abs_err": max(errs), "payload_max_abs_err": pay,
         "ms": ms_a, "plain_ms": plain_a, "full_ms": full_a["bounce1"],
         "full_camera_ms": full_a["camera"], "window_full_bounce1_ms": win_b1},
        {"name": "sweep", "route": "cuda", "source": src + "sweep.cu",
         "replaces": ref + "1152", "max_abs_err": err_b, "ms": ms_b,
         "plain_ms": plain_b, "full_ms": full_b},
        {"name": "window_walk_orig", "route": "cuda", "source": src + "window_walk.cu",
         "replaces": ref + "698", "max_abs_err": err_c, "ms": ms_c,
         "plain_ms": plain_c, "full_ms": full_c},
        {"name": "window_walk_counts", "route": "cuda", "source": src + "window_walk.cu",
         "replaces": ref + "698", "max_abs_err": max(errs_d), "ms": ms_d,
         "plain_ms": plain_d, "full_ms": full_d},
    ]


@contextlib.contextmanager
def counted_run():
    """Zero every kernel's launch count and count plain-version calls on
    CUDA tensors for the run inside; yields {"launches": ..., "plain_cuda":
    ...}, filled in when the run ends."""
    from tpu_pathtracer_torch.ops import hopper_traverse as ht

    plain_cuda = {f"{k}_plain": 0 for k in KERNELS}

    def counted(name, fn):
        def wrapper(o, *args, **kw):
            if o.is_cuda:
                plain_cuda[name] += 1
            return fn(o, *args, **kw)
        return wrapper

    saved = {name: getattr(ht, name) for name in plain_cuda}
    for name, fn in saved.items():
        setattr(ht, name, counted(name, fn))
    for k in KERNELS:
        getattr(ht, k).launches = 0
    out = {"plain_cuda": plain_cuda}
    try:
        yield out
    finally:
        out["launches"] = {k: getattr(ht, k).launches for k in KERNELS}
        for name, fn in saved.items():
            setattr(ht, name, fn)


def timed_frames(renderer) -> tuple[float, dict]:
    """2 warm-up + 3 timed frames (host clock, ending in a synchronize) and
    one more frame under the CUDA-event StageTimer -> (ms/frame, stages)."""
    from tpu_pathtracer_torch.render.state import render_frame
    from tpu_pathtracer_torch.render.timing import StageTimer

    renderer.run(2)
    t0 = time.perf_counter()
    renderer.run(3)
    ms = (time.perf_counter() - t0) / 3 * 1e3
    timer = StageTimer()
    renderer.state = render_frame(renderer.state, renderer.scene, renderer.cfg,
                                  renderer.camera, renderer._intersect, timer=timer)
    return ms, timer.totals()


def stage_line(stages: dict) -> str:
    walks = sum(stages.get(k, 0.0) for k in ("walk_nearest", "walk_shadow", "walk_fused"))
    other = stages["sample"] - stages.get("sort", 0.0) - walks
    return ("  stages (ms, one frame): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(stages.items()))
        + f", shading+rest {other:.2f}")


def phase_main_path(renderer) -> dict:
    """Drive the main path; returns each kernel's launches in that run."""
    from tpu_pathtracer_torch.render.state import (frame_rng_key,
                                                   fused_wavefront_key)
    from tpu_pathtracer_torch.render.wavefront import render_sample

    with counted_run() as run:
        ms, stages = timed_frames(renderer)
        key = fused_wavefront_key(frame_rng_key(renderer.state.key,
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
    if min(launches["window_walk"], launches["capped_walk"]) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    extra = {k: launches[k] for k in KERNELS[2:] if launches[k]}
    if extra:
        raise AssertionError(f"the default main path launched other kernels: {extra}")
    if any(plain_cuda.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain_cuda}")
    return launches


def check_parity(what: str, img, gold) -> dict:
    from tpu_pathtracer_torch.utils.compare import metrics

    m = metrics(img, gold)
    log(f"{what}: {m}")
    rel, lo, hi = PARITY
    if not np.isfinite(img).all() or not (m["rel_mse"] < rel and lo < m["mean_ratio"] < hi):
        raise AssertionError(f"{what} gate failed: {m}")
    return m


def phase_parity(variant: str | None = None) -> dict:
    """The self-golden gate for the default config or one of VARIANTS."""
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.io.exr import read_exr
    from tpu_pathtracer_torch.ops import hopper_traverse as ht

    here = os.path.dirname(os.path.abspath(__file__))
    gold, _ = read_exr(os.path.join(here, "assets", "self_golden", f"{SCENE}-8.exr"))
    kw, kernel = VARIANTS[variant] if variant else ({}, "window_walk")
    n0 = getattr(ht, kernel).launches
    r = Renderer(SCENE, 200, 150, RenderConfig(samples_per_frame=1, max_path_length=8,
                                               **kw))
    r.run(16)
    if getattr(ht, kernel).launches == n0:
        raise AssertionError(f"parity run {variant} never launched {kernel}")
    return check_parity(f"parity{f' ({variant})' if variant else ''} vs self-golden "
                        "(150x200, depth 8, 16 frames)", r.image(), gold)


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

    step, sync = Renderer.step, Renderer.sync
    clock = {"frames": 0, "seconds": 0.0, "t0": None}

    def timed_step(self):
        if clock["t0"] is None:
            clock["t0"] = time.perf_counter()
        clock["frames"] += 1
        step(self)

    def timed_sync(self):
        waited = self._in_flight > 0
        sync(self)
        if waited and clock["t0"] is not None:
            clock["seconds"] = time.perf_counter() - clock["t0"]

    Renderer.step, Renderer.sync = timed_step, timed_sync
    try:
        yield clock
    finally:
        Renderer.step, Renderer.sync = step, sync


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
    if launches["anyhit_walk"] <= 0 or launches["window_walk"] <= 0:
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

    runs = [("default", ["--frames", "5"], ("window_walk", "capped_walk",
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


def main() -> int:
    smi = phase_device()
    t0 = time.perf_counter()
    phase_build()
    log(f"build phase: {time.perf_counter() - t0:.1f} s")

    from tpu_pathtracer_torch import Renderer

    renderer = Renderer(SCENE, WIDTH, HEIGHT)
    kernels = phase_kernels(renderer) + phase_bench_kernels(renderer)
    launches = phase_main_path(renderer)
    phase_parity()
    del renderer
    with tempfile.TemporaryDirectory() as tmp:
        env_launches = phase_cli_env(tmp)
    phase_env_parity()
    launches["anyhit_walk"] = env_launches["anyhit_walk"]
    launches.update(phase_bench())
    for variant in VARIANTS:
        phase_parity(variant)
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
