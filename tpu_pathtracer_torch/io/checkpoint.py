"""Checkpoint/resume of progressive render state.

The port of ``tpu_pathtracer/io/checkpoint.py``, with two forms:

* ``npz`` — one compressed ``.npz`` file with the reference's keys
  (``version``, ``accum``, ``frame_index``, ``key_data``): the full image,
  gathered to the host, so either package resumes the other's file.
* ``dir`` — a directory written tile by tile, with no full-image gather:
  ``manifest.json`` (``version`` 1, the full ``shape`` and ``dtype``,
  ``frame_index``, ``key_data`` and each shard's file and row range) and
  one ``accum.<k>.npy`` per tile of a sharded accumulator (an unsharded one
  is one shard).  Across processes each rank writes its own tiles and rank
  0 the manifest, after a barrier.  It is the port's own layout, not
  Orbax's, which the reference writes for this form.

A path ending in ``.npz`` takes the npz form, any other the directory, or
pass ``backend=``.  Both save to a temp name and swap it in, so a crash
mid-save cannot destroy the previous checkpoint.  Loading returns the whole
image; ``Renderer.load_checkpoint`` reshards it onto its mesh, if any.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..render.state import RenderState

_FORMAT_VERSION = 1


def _pick_backend(path: str, backend: str | None) -> str:
    if backend == "orbax":
        raise ValueError(
            "backend='orbax': tpu_pathtracer_torch writes its own checkpoint "
            "directory (backend='dir'), not Orbax's on-disk format")
    if backend in ("npz", "dir"):
        return backend
    if backend is not None:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    return "npz" if path.endswith(".npz") else "dir"


def save_checkpoint(path: str, state: RenderState, backend: str | None = None) -> None:
    from ..parallel.multihost import gather_image
    from ..parallel.tiles import process_rank

    if _pick_backend(path, backend) == "dir":
        return _save_dir(path, state)
    accum = gather_image(state)  # every rank takes part; rank 0 writes
    if process_rank():
        return
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        version=_FORMAT_VERSION,
        accum=accum,
        frame_index=np.asarray(state.frame_index, np.int32),
        key_data=np.asarray(state.key, np.uint32),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cpu", backend: str | None = None) -> RenderState:
    if _pick_backend(path, backend) == "dir":
        return _load_dir(path, device)
    with np.load(path) as data:
        version = int(data["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        return RenderState(
            accum=torch.tensor(np.asarray(data["accum"], np.float32), device=device),
            frame_index=int(data["frame_index"]),
            key=np.asarray(data["key_data"], np.uint32).reshape(2),
        )


def _save_dir(path: str, state: RenderState) -> None:
    from ..parallel.multihost import spans_processes
    from ..parallel.tiles import TiledAccum, process_rank

    accum = state.accum
    if isinstance(accum, TiledAccum):
        tiles, th, shape = accum.tiles, accum.tile_h, accum.shape
        shared = spans_processes(accum.mesh)
    else:
        tiles, th, shape, shared = (accum,), accum.shape[0], tuple(accum.shape), False
    barrier = torch.distributed.barrier if shared else (lambda: None)
    lead = process_rank() == 0 or not shared
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if lead:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    barrier()
    for k, tile in enumerate(tiles):
        if tile is not None:  # a tile another process owns is None here
            np.save(os.path.join(tmp, f"accum.{k}.npy"), tile.cpu().numpy())
    barrier()
    if lead:
        manifest = {
            "version": _FORMAT_VERSION,
            "shape": list(shape),
            "dtype": "float32",
            "frame_index": int(state.frame_index),
            "key_data": [int(x) for x in np.asarray(state.key, np.uint32)],
            "shards": [{"file": f"accum.{k}.npy", "rows": [k * th, (k + 1) * th]}
                       for k in range(len(tiles))],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    barrier()


def _load_dir(path: str, device) -> RenderState:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {manifest['version']}")
    accum = np.empty(manifest["shape"], np.dtype(manifest["dtype"]))
    for shard in manifest["shards"]:
        r0, r1 = shard["rows"]
        accum[r0:r1] = np.load(os.path.join(path, shard["file"]))
    return RenderState(
        accum=torch.from_numpy(accum).to(device),
        frame_index=int(manifest["frame_index"]),
        key=np.asarray(manifest["key_data"], np.uint32).reshape(2),
    )
