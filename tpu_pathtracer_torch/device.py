"""The device helpers shared by the entry points and the research tools."""

from __future__ import annotations

import subprocess


def device_for(platform: str):
    """``--platform`` -> torch device.  No silent CPU fallback: ``auto`` and
    ``gpu`` raise when no CUDA device is present."""
    import torch

    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--platform {platform}: no CUDA device (torch.cuda.is_available() "
            "is False); pass --platform cpu to run the plain torch versions "
            "on the CPU")
    return torch.device("cuda")


def mesh_for(spec: str | None, device):
    """``--mesh TILESxSPP|auto`` on ``device`` -> a ('tiles', 'spp') mesh, or
    None without a spec.  On the card the mesh takes the local cards
    (``auto``: every card as a tile, 1x1 on one card); under ``--platform
    cpu`` it is a virtual CPU mesh of the asked shape (``auto``: 1x1)."""
    if not spec:
        return None
    from .parallel.tiles import make_mesh

    if spec == "auto":
        tiles, spp = (None, 1) if device.type == "cuda" else (1, 1)
    else:
        t, _, s = spec.lower().partition("x")
        tiles, spp = int(t), int(s or 1)
    return make_mesh(tiles, spp, devices=None if device.type == "cuda"
                     else [device] * (tiles * spp))


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi prints them ("cpu" for
    the CPU), after one op on the device: a missing or broken card fails
    here, not mid-benchmark."""
    import torch

    float(torch.ones((8, 8), device=device).sum())
    if device.type == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device()}"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
