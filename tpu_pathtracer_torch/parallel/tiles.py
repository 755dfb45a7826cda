"""The multi-device split: pixel-row tiles x sample shards over a device mesh.

The port of ``tpu_pathtracer/parallel/tiles.py``.  A :class:`Mesh` is an
``(n_tiles, n_spp)`` grid of torch devices:

* ``tiles``: each row of the mesh owns a contiguous band of pixel rows of
  the accumulator; no data moves between tiles while a frame renders.
* ``spp``: the entries of a row trace disjoint sample shards of the same
  band, and their sums are added on the row's first device, in ``spp``
  order: the reference's ``psum``, the only reduction of the frame.
* The scene and the BVH layouts are replicated once per distinct device.

Torch has no virtual devices, so a mesh may name one device more than once
(``[torch.device("cpu")] * 8`` in the tests, ``cuda:0`` twice on one card):
its entries then run one after another on that device.  Each entry also
records the ``torch.distributed`` rank of the process that owns it (torch
has nothing like ``jax.process_index``); a process renders only the tiles it
owns (parallel/multihost.py).

The RNG keys on absolute pixel and sample ids, so a tile split is the
single-device frame bit for bit, and a sample split differs only by the
rounding of the sum over ``spp``.
"""

from __future__ import annotations

import contextlib
import logging
from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..models.camera import Camera
from ..render.state import RenderState, accumulate, sample_sum
from ..render.wavefront import make_brute_intersector


class Mesh(NamedTuple):
    """An ``(n_tiles, n_spp)`` grid of devices and of the ranks that own them
    (``devices[t][s]``, ``ranks[t][s]``)."""
    devices: tuple
    ranks: tuple

    axis_names = ("tiles", "spp")

    @property
    def shape(self) -> dict:
        return {"tiles": len(self.devices), "spp": len(self.devices[0])}


class TiledAccum(NamedTuple):
    """A row-sharded accumulator: ``tiles[t]`` holds rows ``t * tile_h ..``
    of the ``shape`` (H, W, S) image on ``mesh.devices[t][0]``, or is None
    where another process owns tile ``t``."""
    tiles: tuple
    shape: tuple
    mesh: Mesh

    @property
    def tile_h(self) -> int:
        return self.shape[0] // len(self.tiles)


def process_rank() -> int:
    """This process's ``torch.distributed`` rank, 0 outside a process group."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_devices() -> list:
    """The local CUDA cards; raises without one (a CPU mesh is only ever asked
    for: ``devices=[torch.device("cpu")] * n``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for the mesh (torch.cuda.is_available() is False); a "
            "CPU mesh is asked for by name: devices=[torch.device('cpu')] * n")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_tiles: int | None = None, n_spp: int = 1, devices=None) -> Mesh:
    """A ('tiles', 'spp') mesh over ``devices`` (default: the local CUDA cards),
    every entry owned by this process.  A device may appear more than once."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else local_devices())]
    if n_tiles is None:
        n_tiles = len(devices) // n_spp
        dropped = len(devices) - n_tiles * n_spp
        if dropped:
            logging.getLogger(__name__).warning(
                "mesh uses %d of %d devices (%d idle: n_spp=%d does not divide "
                "the device count)", n_tiles * n_spp, len(devices), dropped, n_spp)
    if n_tiles < 1 or n_spp < 1:
        raise ValueError(f"mesh axes must be >= 1, got tiles={n_tiles} spp={n_spp}")
    use = n_tiles * n_spp
    if len(devices) < use:
        raise ValueError(
            f"({n_tiles} tiles x {n_spp} spp) mesh needs {use} devices, but only "
            f"{len(devices)} are available ({[str(d) for d in devices]}); for a "
            "virtual mesh name a device more than once, e.g. "
            f"devices=[torch.device('cuda:0')] * {use} (or 'cpu')")
    grid = tuple(tuple(devices[t * n_spp:(t + 1) * n_spp]) for t in range(n_tiles))
    rank = process_rank()
    return Mesh(grid, tuple((rank,) * n_spp for _ in range(n_tiles)))


def to_device(x, device):
    """A tensor, or a NamedTuple of them (nested; None and host values kept),
    on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    return x


def _device_key(device: torch.device) -> torch.device:
    """``cuda`` and ``cuda:<current>`` are one device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on(device: torch.device):
    """The launch context of ``device``: the kernels launch on the current
    CUDA device, which a tile on another card must set."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def local_tiles(mesh: Mesh) -> list[int]:
    """The tiles whose entries this process owns."""
    rank = process_rank()
    return [t for t, row in enumerate(mesh.ranks) if row[0] == rank]


def shard_state(state: RenderState, mesh: Mesh) -> RenderState:
    """The full (H, W, S) accumulator, on any device, split by rows over
    ``tiles``, each local tile on the first device of its mesh row;
    ``frame_index`` and ``key`` stay host values."""
    accum = state.accum
    n_tiles = mesh.shape["tiles"]
    height = accum.shape[0]
    if height % n_tiles:
        raise ValueError(f"height {height} not divisible by {n_tiles} tiles")
    th = height // n_tiles
    mine = set(local_tiles(mesh))
    tiles = tuple(accum[t * th:(t + 1) * th].to(mesh.devices[t][0], copy=True)
                  if t in mine else None for t in range(n_tiles))
    return state._replace(accum=TiledAccum(tiles, tuple(accum.shape), mesh))


def replicate(scene, mesh: Mesh, intersect_factory=None) -> dict:
    """The scene and its intersector on each distinct device of this
    process's tiles -> {device: (scene, intersect)}.  ``intersect_factory``:
    ``scene -> IntersectFn`` for a scene on the device it serves; without
    one, the brute backend (as the reference's shards without a factory)."""
    out = {}
    for t in local_tiles(mesh):
        for dev in mesh.devices[t]:
            key = _device_key(dev)
            if key not in out:
                rep = to_device(scene, key)
                with _on(key):
                    out[key] = (rep, intersect_factory(rep) if intersect_factory
                                else make_brute_intersector(rep))
    return out


def _render_tiles(state: RenderState, cfg: RenderConfig, mesh: Mesh,
                  camera: Camera | None, replicas: dict) -> RenderState:
    camera = camera if camera is not None else Camera.reference_default()
    n_tiles, n_spp = mesh.shape["tiles"], mesh.shape["spp"]
    full_height, full_width = state.height, state.width
    if full_height % n_tiles:
        raise ValueError(f"height {full_height} not divisible by {n_tiles} tiles")
    if cfg.samples_per_frame % n_spp:
        raise ValueError(f"samples_per_frame {cfg.samples_per_frame} not divisible "
                         f"by {n_spp} sample shards")
    tile_h = full_height // n_tiles
    shard_spp = cfg.samples_per_frame // n_spp
    # sequential row tiles within each mesh tile: the single-device path's
    # bounding of a wavefront's lanes, applied to the tile's band
    row_tiles = max(1, cfg.row_tiles)
    if tile_h % row_tiles:
        raise ValueError(
            f"row_tiles {row_tiles} must divide the per-tile height {tile_h} "
            f"(= height {full_height} / {n_tiles} tiles)")
    sub_h = tile_h // row_tiles
    tiles = list(state.accum.tiles)
    for t in local_tiles(mesh):
        home = mesh.devices[t][0]
        total = None
        for s, dev in enumerate(mesh.devices[t]):
            scene, intersect = replicas[_device_key(dev)]
            with _on(dev):
                part = torch.cat([
                    sample_sum(scene, cfg, camera, sub_h, full_width, state.key,
                               state.frame_index, intersect,
                               row0=t * tile_h + r * sub_h, full_height=full_height,
                               full_width=full_width, sample0=s * shard_spp,
                               sample_count=shard_spp)
                    for r in range(row_tiles)])
            part = part.to(home)
            total = part if total is None else total + part  # the sum over spp
        tiles[t] = accumulate(tiles[t], state.frame_index,
                              total / cfg.samples_per_frame, cfg.accumulate_image)
    return RenderState(accum=state.accum._replace(tiles=tuple(tiles)),
                       frame_index=state.frame_index + 1, key=state.key)


def render_frame_distributed(state: RenderState, scene, cfg: RenderConfig, mesh: Mesh,
                             camera: Camera | None = None,
                             intersect_factory=None) -> RenderState:
    """One progressive frame over the mesh: each (tile, spp) entry this
    process owns traces its rows and sample shard on its device, the shard
    sums are added on the tile's device, and the tile's accumulator takes
    the mean.  ``state`` comes from :func:`shard_state`.
    ``intersect_factory``: ``scene -> IntersectFn``, called once per distinct
    device on the scene replicated there."""
    return _render_tiles(state, cfg, mesh, camera,
                         replicate(scene, mesh, intersect_factory))


def render_frame_distributed_jit(mesh: Mesh, cfg: RenderConfig,
                                 camera: Camera | None = None,
                                 intersect_factory=None):
    """The distributed step ``step(state, scene) -> state`` (the reference's
    name; nothing is compiled).  The step keeps the replicas of the last
    scene it was given, so the scene and layouts move once, not every frame."""
    held = {}

    def step(state: RenderState, scene) -> RenderState:
        if held.get("scene") is not scene:
            held.update(scene=scene, replicas=replicate(scene, mesh, intersect_factory))
        return _render_tiles(state, cfg, mesh, camera, held["replicas"])

    return step
