"""Host orchestrator: progressive renderer with HUD, save and checkpointing.

The port of ``tpu_pathtracer/renderer.py``: owns the scene tensors and both
BVH layouts (fat leaves for nearest-hit queries, small leaves for shadow
queries), drives the frame step on one device or over a ('tiles', 'spp')
mesh (parallel/tiles.py), tracks the EMA performance HUD (reference:
renderer/Renderer.mm:631-637), saves EXR and PNG images and checkpoints
(a ``.npz`` file or a sharded directory), and captures ``torch.profiler``
traces.  A frame stepped while a profiler records, or with a timer, runs
inside named spans and leaves a record in ``frame_records``
(render/timing.py).

Frames in flight: the frame step only enqueues work on the current CUDA
stream; the host waits for the device when ``cfg.frames_in_flight`` steps
are queued, or when an image or the HUD needs the result — the reference's
triple buffering (renderer/Renderer.mm:16,593-600).  Each bounce reads its
live-lane count on the host (the live-prefix ladder), so in this version a
queued frame still waits for the device once per bounce; on one card the
launches between two reads replay as one CUDA graph (render/graphs.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .accel import build_layout
from .config import RenderConfig, check_supported
from .models.camera import Camera
from .parallel.multihost import gather_image
from .parallel.tiles import render_frame_distributed_jit, shard_state, to_device
from .render import timing
from .render.graphs import CudaCapture
from .render.state import init_state, plan_frame, render_frame
from .render.wavefront import WavefrontPlans, make_intersector
from .scene import DEFAULT_SCENE, Scene, load_scene, scene_path


def build_intersector(scene: Scene, cfg: RenderConfig, leaf_size: int | None = None,
                      builder: str = "auto"):
    """The frame's BVH layouts and intersection callable for ``cfg`` ->
    (layout or None, shadow layout or None, intersect), as the reference's
    Renderer builds them: fat leaves for nearest-hit queries, small leaves
    for shadow queries, no layout for the brute backend, and the backend
    and route of render/wavefront.py:make_intersector."""
    leaf = leaf_size if leaf_size is not None else cfg.leaf_size
    occl_leaf = cfg.occlusion_leaf_size
    layout = (None if cfg.intersector == "brute"
              else build_layout(scene, leaf_size=leaf, builder=builder))
    layout_occl = (build_layout(scene, leaf_size=occl_leaf, builder=builder)
                   if layout is not None and occl_leaf not in (None, leaf) else None)
    return layout, layout_occl, make_intersector(scene, cfg, layout, layout_occl)


class Renderer:
    def __init__(
        self,
        scene: Scene | str = DEFAULT_SCENE,
        width: int = 960,
        height: int = 540,
        cfg: RenderConfig | None = None,
        seed: int = 0,
        camera: Camera | None = None,
        leaf_size: int | None = None,
        builder: str = "auto",
        mesh=None,
        device="cuda",
    ):
        """``device``: where every tensor lives; the kernels run for
        "cuda", their plain torch versions for "cpu".  ``scene``: a bundled
        scene's name, or a :class:`Scene` on ``device`` (``load_scene``,
        ``build_scene``).  ``mesh``: a ('tiles', 'spp') mesh
        (parallel/tiles.py:make_mesh, parallel/multihost.py) -- the frame
        shards pixel rows over 'tiles' and samples over 'spp', equal to the
        single-device frame; ``device`` is then the mesh's first device.
        None = one device."""
        self.cfg = cfg or RenderConfig()
        check_supported(self.cfg)
        self.mesh = mesh
        self.device = torch.device(mesh.devices[0][0] if mesh is not None else device)
        self.scene = (
            scene if isinstance(scene, Scene)
            else load_scene(scene_path(scene), samples=self.cfg.spectrum_samples,
                            device=self.device)
        )
        if self.scene.p0.device.type != self.device.type:
            raise ValueError(f"the scene lies on {self.scene.p0.device}, the "
                             f"renderer on {self.device}")
        self.camera = camera or Camera.reference_default()
        self.layout, self.layout_occl, self._intersect = build_intersector(
            self.scene, self.cfg, leaf_size, builder)
        self._seed = seed
        # a single card replays each bounce's launches as a CUDA graph
        # (render/graphs.py); the mesh and the CPU run them eagerly
        self._capture = (CudaCapture(self.device) if mesh is None and self.device.type == "cuda"
                         else None)
        if mesh is not None:
            # each distinct device of the mesh gets the same intersection
            # pipeline, on the layouts built once above and moved there
            cfg_, lay, lay_occl = self.cfg, self.layout, self.layout_occl

            def factory(scene_rep):
                dev = scene_rep.p0.device
                return make_intersector(scene_rep, cfg_, to_device(lay, dev),
                                        to_device(lay_occl, dev))

            self._step = render_frame_distributed_jit(mesh, self.cfg, self.camera,
                                                      factory)
        else:
            self._step = lambda state, scene, trace: render_frame(
                state, scene, self.cfg, self.camera, self._intersect, timer=trace,
                plans=self._plans)
        self.reset(width, height)

    # -- reference: mtkView:drawableSizeWillChange: (Renderer.mm:640-657) --
    def reset(self, width: int | None = None, height: int | None = None) -> None:
        width = width or self.state.width
        height = height or self.state.height
        self.state = init_state(height, width, self._seed,
                                self.cfg.spectrum_samples, self.device)
        if self.mesh is not None:
            self.state = shard_state(self.state, self.mesh)
        else:
            # the wavefronts' frame-invariant inputs, built once a size, and
            # on the card their chain graphs' buffers; a frame rebuilds a
            # plan, and drops its graphs, only when what it was built from
            # changes (a new camera angle)
            self._plans = WavefrontPlans(self._capture)
            plan_frame(self._plans, self.scene, self.cfg, self.camera, height, width)
        self._avg_rays_per_sec = 0.0
        self._avg_frame_time = 0.0
        self._frame_count = 0
        self._in_flight = 0
        self._window_t0 = None
        self._traces: list[timing.FrameTrace] = []

    @property
    def frame_records(self) -> list[dict]:
        """One record a frame traced since the last reset (render/timing.py:
        a frame traces while a torch.profiler records, or when stepped with
        a timer), oldest first: ``frame`` (its index), ``host_reads`` and
        ``host_read_s`` (the host transfers that wait for the device, and
        the host seconds spent in them), ``plan_builds`` (the wavefront
        plans the frame had to build: 0 unless what a plan was built from
        changed, such as :attr:`camera`), ``hbm_route`` (1 when the frame's
        intersector took the HBM route) and ``hbm_walks`` (the queries it
        sent down it), ``traced_rays``, ``launches`` (one
        dict a shading launch: ``bounce``, ``lanes``, ``live`` where the
        ladder read it, ``planes``, ``hero``, ``inline``, ``env``,
        ``dispersion``, ``kernel``, and on env-lit kernel launches
        ``env_picks`` and ``env_misses``), ``graph_replays`` and
        ``graph_captures`` (the bounce chains the frame replayed and
        captured, render/graphs.py) and ``spans`` ([name, start ns,
        end ns] on the host's wall clock).  The device counters are read
        here, the first time a record is asked for."""
        return timing.records(self._traces)

    @property
    def frame_index(self) -> int:
        """Frames completed and visible (waits for queued frames first)."""
        self.sync()
        return self.state.frame_index

    def sync(self) -> None:
        """Wait until every queued frame has run on the device, and fold the
        elapsed window into the HUD EMA."""
        self._sync(timing.frame_trace())

    def _sync(self, trace) -> None:
        if self._in_flight == 0:
            return
        with timing.span(trace, "sync"):
            for dev in self._cards():
                torch.cuda.synchronize(dev)
        frame_time = (time.perf_counter() - self._window_t0) / self._in_flight
        pixels = self.state.height * self.state.width
        # EMA-smoothed HUD, same blend as the reference (Renderer.mm:631-637)
        for _ in range(self._in_flight):
            self._avg_rays_per_sec = 0.5 * (self._avg_rays_per_sec + pixels / frame_time)
            self._avg_frame_time = 0.5 * (self._avg_frame_time + frame_time)
        self._in_flight = 0
        self._window_t0 = None

    def _cards(self) -> list:
        """The distinct CUDA devices the frames run on."""
        devices = ({d for row in self.mesh.devices for d in row} if self.mesh is not None
                   else {self.device})
        return [d for d in devices if d.type == "cuda"]

    def step(self, timer=None) -> None:
        """Queue one progressive frame (respects cfg.max_frames like the
        reference's MAX_FRAMES gate, renderer/Renderer.mm:589-591).
        ``timer`` (render/timing.py:StageTimer) times the frame's spans; with
        it, or while a torch.profiler records, the frame is traced."""
        if self.cfg.max_frames and self._frame_count >= self.cfg.max_frames:
            return
        trace = timing.frame_trace(timer, self.state.frame_index)
        with timing.span(trace, "frame"):
            if self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            self.state = self._step(self.state, self.scene, trace)
            self._frame_count += 1
            self._in_flight += 1
            if self._in_flight >= max(1, self.cfg.frames_in_flight):
                self._sync(trace)
        if trace is not None:
            self._traces.append(trace)

    def run(self, frames: int) -> None:
        for _ in range(frames):
            self.step()
        self.sync()

    def hud(self) -> str:
        """Window-title HUD string (reference: renderer/Renderer.mm:636-637)."""
        return (
            f"Frame: {self.frame_index} "
            f"[{self._avg_rays_per_sec / 1e6:0.2f} Mrays/s, "
            f"{self._avg_frame_time * 1e3:.2f} ms/frame]"
        )

    def image(self, tonemapped: bool = False, rgb: bool = False) -> np.ndarray:
        """(H, W, S) accumulated radiance as numpy, optionally display-
        transformed (exposure tonemap when cfg.enable_tone_mapping, then
        sRGB).  ``rgb`` collapses a spectral accumulator (S > 3) to RGB by
        band averages (core/spectrum.py:to_rgb)."""
        self.sync()
        img = gather_image(self.state)
        if rgb and img.shape[-1] != 3:
            from .core.spectrum import to_rgb

            img = to_rgb(img)
        if tonemapped:
            from .core.color import to_srgb, tonemap_exposure

            if self.cfg.enable_tone_mapping:
                img = tonemap_exposure(img)
            img = to_srgb(img)
        return img

    def save_exr(self, path: str) -> None:
        from .io.exr import write_exr

        write_exr(path, self.image(rgb=True), half=True)

    def save_png(self, path: str) -> None:
        from .io.png import write_png

        write_png(path, self.image(tonemapped=True, rgb=True))

    def save_checkpoint(self, path: str) -> None:
        from .io.checkpoint import save_checkpoint

        self.sync()
        save_checkpoint(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        from .io.checkpoint import load_checkpoint

        self.sync()
        if self.mesh is None:
            self.state = load_checkpoint(path, device=self.device)
        else:
            self.state = shard_state(load_checkpoint(path), self.mesh)
        self._frame_count = self.state.frame_index
        self._in_flight = 0
        self._window_t0 = None

    def profile(self, trace_dir: str, frames: int = 3) -> None:
        """Run ``frames`` frames under ``torch.profiler`` and write a Chrome
        trace into ``trace_dir`` (the counterpart of the reference's
        ``jax.profiler.trace``), ``trace.json``, and beside it ``frames.json``,
        the frames' :attr:`frame_records`."""
        import json
        import os

        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        traced = len(self._traces)
        with profile(activities=activities) as prof:
            self.run(frames)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        with open(os.path.join(trace_dir, "frames.json"), "w") as f:
            json.dump(self.frame_records[traced:], f)
