"""Checkpoint/resume of progressive render state: the ``.npz`` form.

The port of ``tpu_pathtracer/io/checkpoint.py``'s single-file backend with
the same keys (``version``, ``accum``, ``frame_index``, ``key_data``), so
either package resumes the other's file.  The save goes to a temp name and
is swapped in, so a crash mid-save cannot destroy the previous checkpoint.
The Orbax directory form (any path without ``.npz``) is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..render.state import RenderState

_FORMAT_VERSION = 1


def _check_npz(path: str) -> None:
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"checkpoint {path!r}: only the .npz form is ported to "
            "tpu_pathtracer_torch; the Orbax directory form is not yet "
            "(ROADMAP.md queue 1 item 9)")


def save_checkpoint(path: str, state: RenderState) -> None:
    _check_npz(path)
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        version=_FORMAT_VERSION,
        accum=state.accum.cpu().numpy(),
        frame_index=np.asarray(state.frame_index, np.int32),
        key_data=np.asarray(state.key, np.uint32),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cpu") -> RenderState:
    _check_npz(path)
    with np.load(path) as data:
        version = int(data["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        return RenderState(
            accum=torch.tensor(np.asarray(data["accum"], np.float32), device=device),
            frame_index=int(data["frame_index"]),
            key=np.asarray(data["key_data"], np.uint32).reshape(2),
        )
