"""One run of one cell: set-up, the measured window, the traced slice, the
readings and the check.

The window drives the program's own entry, ``Renderer.step()``, at the
default ``frames_in_flight``, and adds no synchronisation of its own: a
frame's completion is a CUDA event recorded after its ``step()`` and read
once the window has closed.  With ``trace`` a slice of whole frames inside
the window runs under torch.profiler (CPU and CUDA activity), between two
``Renderer.sync()`` calls; a slice whose trace holds no kernel is taken
again, up to three times.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, scenes
from .manifest import Bench
from .traces import SLICE, Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pathtracer")
SLICE_TRIES = 3
# settings of every traffic mix; a mix's file sets one only where its cell
# needs another value
WARMUP_FRAMES = 3      # set-up frames at the cell's own shapes
PROFILE_AFTER = 10     # window frames before the traced slice (and between retries)
PROFILE_FRAMES = 20    # whole frames in the traced slice
CHECK_PIXELS = 256     # pixels the check draws from the seed


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    relatives' or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Run:
    def __init__(self, bench: Bench, workload: str, seed: int, device="cuda",
                 size: tuple[int, int] | None = None, t_start: float | None = None):
        self.bench = bench
        self.workload = workload
        self.cell = bench.workload(workload)
        self.config = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.height, self.width = size or (self.config["height"], self.config["width"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.spans: dict[str, float] = {}
        self.trace: Trace | None = None
        self._rays = None

    def setting(self, name: str):
        """A traffic mix's value of ``name``, else the harness's constant."""
        return self.traffic.get(name, globals()[name.upper()])

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        """Kernel library, scene, Renderer, warm-up frames at the cell's own
        shapes; ``setup_s`` runs from process start to here."""
        from tpu_pathtracer_torch import Renderer, RenderConfig

        t = time.perf_counter()
        if self.cuda:
            from tpu_pathtracer_torch.ops import cuda_build

            cuda_build.build()
            cuda_build.load_library()
        self.spans["kernel_load_s"] = time.perf_counter() - t
        t = time.perf_counter()
        render = self.traffic.get("render", {})
        env = self.traffic.get("env")
        self.env_image = (scenes.sky_map(env["height"], env["width"], self.seed)
                          if env else None)
        cfg = RenderConfig(max_path_length=self.config["max_path_length"], **render)
        self.renderer = Renderer(self._scene(cfg.spectrum_samples), self.width, self.height,
                                 cfg, seed=self.seed, device=self.device)
        self.spans["renderer_init_s"] = time.perf_counter() - t
        self.frames = self.setting("warmup_frames")
        for _ in range(self.frames):
            self.renderer.step()
        self.renderer.sync()
        self.spans["setup_s"] = time.perf_counter() - self.t_start

    def _scene(self, samples: int):
        from tpu_pathtracer_torch.scene import attach_dispersion, attach_env, load_scene

        scene = load_scene(scenes.obj_path(self.config["scene"]["obj"]), samples=samples,
                           rough_materials=check.rough_materials(self.config), device=self.device)
        if self.env_image is not None:
            scene = attach_env(scene, self.env_image)
        if self.traffic.get("dispersion") is not None:
            scene = attach_dispersion(scene, self.traffic["dispersion"])
        return scene

    # -- the window --------------------------------------------------------
    def window(self, seconds: float, trace: bool = False) -> None:
        """``step()`` until ``seconds`` have passed, then wait for the queued
        frames; with ``trace`` profile a slice of ``PROFILE_FRAMES``."""
        r = self.renderer
        marks = []
        slice_at, tries = self.setting("profile_after"), 0
        self.window_frames = 0
        start = self._mark()
        t0 = time.perf_counter()
        while True:
            if trace and self.trace is None and tries < SLICE_TRIES \
                    and self.window_frames == slice_at:
                tries += 1
                self._profile_slice()
                slice_at = self.window_frames + self.setting("profile_after")
            r.step()
            marks.append(self._mark())
            self.window_frames += 1
            if time.perf_counter() - t0 >= seconds and not (
                    trace and self.trace is None and tries < SLICE_TRIES):
                break
        r.sync()
        self.window_s = time.perf_counter() - t0
        self.frames += self.window_frames
        self.intervals_ms = self._intervals(start, marks)
        self.memory_peak = torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _intervals(self, start, marks) -> list[float]:
        """Milliseconds between consecutive frame completions."""
        seq = [start, *marks]
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(seq, seq[1:])]
        return [a.elapsed_time(b) for a, b in zip(seq, seq[1:])]

    def _profile_slice(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        r = self.renderer
        n = self.setting("profile_frames")
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        r.sync()
        first = self.frames + self.window_frames
        with profile(activities=activities) as prof:
            with record_function(SLICE):
                for _ in range(n):
                    r.step()
                r.sync()
        self.window_frames += n
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            tr = Trace.load(path)
        finally:
            os.remove(path)
        if tr.kernels() or not self.cuda:
            self.trace, self.slice_first, self.slice_frames = tr, first, n

    # -- readings ----------------------------------------------------------
    def rays_per_frame(self) -> float:
        """Exact traced rays a frame (the program's counter) over two frames
        of the traced slice."""
        if self._rays is None:
            from tpu_pathtracer_torch.render.stats import count_traced_rays_exact

            r = self.renderer
            self._rays = count_traced_rays_exact(
                r.scene, r.cfg, self.height, self.width,
                frame_indices=(self.slice_first, self.slice_first + 1),
                intersect=r._intersect, camera=r.camera, seed=self.seed)
        return self._rays

    def read(self, kind: str) -> dict:
        out = {}
        for m in self.bench.metrics(kind, self.workload):
            value = self.bench.reader(m["name"])(self)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    # -- the check ---------------------------------------------------------
    def program_pixels(self) -> np.ndarray:
        """The accumulated image at the check's pixels, (P, S)."""
        img = self.renderer.image()
        self.pixels = check.sample_pixels(self.seed, self.height * self.width,
                                          self.setting("check_pixels"))
        return img.reshape(self.height * self.width, -1)[self.pixels].astype(np.float64)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.renderer
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference_pixels(self, dtype=torch.float32) -> np.ndarray:
        spec = check.spec_of(self.config, self.traffic, self.height, self.width)
        return check.reference_image(self.config, self.traffic, spec, self.env_image,
                                     self.pixels, self.frames, self.seed, self.device,
                                     dtype=dtype)


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", size=None, t_start=None, log=None) -> dict:
    """One run of a cell -> its result line (a dict)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    run = Run(bench, workload, seed, device=device, size=size, t_start=t_start)
    run.setup()
    log(f"set-up {run.spans['setup_s']:.2f} s (kernels {run.spans['kernel_load_s']:.2f} s, "
        f"renderer {run.spans['renderer_init_s']:.2f} s)")
    run.window(seconds, trace=trace)
    log(f"window {run.window_s:.2f} s, {run.window_frames} frames, "
        f"peak {run.memory_peak} bytes")
    metrics = run.read("per_layer" if trace else "end_to_end")
    got = run.program_pixels()
    run.release()
    t = time.perf_counter()
    want = run.reference_pixels()
    log(f"reference {time.perf_counter() - t:.2f} s over {len(run.pixels)} pixels x "
        f"{run.frames} frames")
    correct, checks = check.verdict(check.numbers(got, want),
                                    bench.limits(workload)["limits"])
    device_info = {"platform": "gpu" if run.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
                   "count": run.cell["chips"], "memory_peak_bytes": int(run.memory_peak)}
    result = {"correct": correct, "attempted": run.window_frames, "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.top_idle_gaps()}
    result["checks"] = checks
    return result
