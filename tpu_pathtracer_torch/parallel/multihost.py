"""Meshes across processes: tiles over processes, samples within one, the
image gathered at the edge.

The port of ``tpu_pathtracer/parallel/multihost.py`` on ``torch.distributed``.
Row tiles are embarrassingly parallel, so the ``tiles`` axis is laid out
across processes and the only data that crosses between them is the image,
gathered for display or save.  The ``spp`` axis (the one per-frame sum)
stays within a process.

With one process, or with ``torch.distributed`` not initialised,
``make_multihost_mesh`` is ``make_mesh`` over the local devices and
``gather_image`` a copy of the local tiles to the host.  Across processes
the default process group must be able to move CPU tensors (gloo: the
image travels as host tensors whether the tiles were rendered on a card or
on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..render.state import RenderState
from .tiles import Mesh, TiledAccum, local_devices, make_mesh, process_rank


def _world() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def check_process_layout(ranks, n_spp: int) -> None:
    """The mesh entries' owning ranks, in mesh order: grouped by rank, and
    every rank's count divisible by ``n_spp``, so that no ``spp`` group (the
    entries whose shard sums are added) straddles two processes."""
    counts: dict[int, int] = {}
    last = None
    for p in ranks:
        if p != last and p in counts:
            raise ValueError("device list must be process-contiguous (grouped by "
                             "rank) for the spp sum to stay within a process")
        counts[p] = counts.get(p, 0) + 1
        last = p
    bad = {p: c for p, c in counts.items() if c % n_spp}
    if bad:
        raise ValueError(
            f"n_spp={n_spp} must divide EVERY process's device count (violated by "
            f"rank:count {bad}) so the sample sum stays within a process; use a "
            "smaller n_spp")


def make_multihost_mesh(n_spp: int = 1, devices=None) -> Mesh:
    """('tiles', 'spp') mesh whose ``tiles`` axis spans the ranks of the
    default process group.  Each rank brings ``devices`` (default: its local
    CUDA cards; a device may repeat, as in :func:`make_mesh`), gathered in
    rank order, so each process's entries fill contiguous tile rows and
    every ``spp`` group lies within one process."""
    local = [str(torch.device(d)) for d in (devices if devices is not None
                                            else local_devices())]
    if _world() == 1:
        entries = [(process_rank(), d) for d in local]
    else:
        gathered = [None] * _world()
        torch.distributed.all_gather_object(gathered, local)
        entries = [(r, d) for r, devs in enumerate(gathered) for d in devs]
    ranks = [r for r, _ in entries]
    check_process_layout(ranks, n_spp)
    mesh = make_mesh(len(entries) // n_spp, n_spp, devices=[d for _, d in entries])
    return mesh._replace(ranks=tuple(tuple(ranks[t * n_spp:(t + 1) * n_spp])
                                     for t in range(mesh.shape["tiles"])))


def spans_processes(mesh: Mesh) -> bool:
    return len({r for row in mesh.ranks for r in row}) > 1


def gather_image(state: RenderState) -> np.ndarray:
    """The full (H, W, S) accumulator on THIS host.  One process: its tiles
    copied to the host one by one.  Across processes (every rank must call
    it): each rank's tile rows, on the host, through one ``all_gather``."""
    accum = state.accum
    if not isinstance(accum, TiledAccum):
        return accum.cpu().numpy()
    if not spans_processes(accum.mesh):
        return torch.cat([t.cpu() for t in accum.tiles]).numpy()
    th, (_, width, samples) = accum.tile_h, accum.shape
    owner = [row[0] for row in accum.mesh.ranks]
    per_rank = [[t for t, o in enumerate(owner) if o == r] for r in range(_world())]
    send = torch.zeros((max(map(len, per_rank)) * th, width, samples))
    for i, t in enumerate(per_rank[process_rank()]):
        send[i * th:(i + 1) * th] = accum.tiles[t].cpu()
    recv = [torch.empty_like(send) for _ in per_rank]
    torch.distributed.all_gather(recv, send)
    img = np.empty(accum.shape, np.float32)
    for r, tiles in enumerate(per_rank):
        for i, t in enumerate(tiles):
            img[t * th:(t + 1) * th] = recv[r][i * th:(i + 1) * th].numpy()
    return img
