"""Peaks of the card and the work of the kernels the metrics price.

The peaks are NVIDIA's H100 SXM data-sheet figures at its 700 W limit.
``gather_bytes`` is ``chip_smoke.py:gather_bound`` (commit 58fc869) counted
from a cell's shapes instead of the program's tensors: the 8-byte
permutation, and every plane of the sorted wavefront read once and written
once.  A sort carries the path state (origin, direction, C throughput and C
radiance planes, pdf, previous-lobe flag, IoR, the alive flag, the int64
pixel id, and under hero sampling C int64 bins) and the deferred shadow pack
(direction, cap, int64 target light, C contribution planes, the ok flag):
70 + 12 C bytes a lane, 8 C more with hero bins.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def carried_planes(traffic: dict) -> tuple[int, bool]:
    """(C, hero): the spectral planes a lane carries, and whether hero bins
    ride along."""
    render = traffic.get("render", {})
    s = render.get("spectrum_samples", 3)
    hero = render.get("hero_wavelengths", 0) if s > 3 else 0
    return (hero, True) if hero else (s, False)


def sort_lanes(height: int, width: int, traffic: dict) -> int:
    """Lanes of one wavefront sort: the frame's pixels times the samples
    fused into a wavefront."""
    render = traffic.get("render", {})
    spp = render.get("samples_per_frame", 1)
    fuse = max(1, min(render.get("fuse_samples", 2) or 1, spp))
    return height * width * fuse


def gather_bytes(lanes: int, c: int, hero: bool) -> int:
    lane = 70 + 12 * c + (8 * c if hero else 0)
    return lanes * 8 + 2 * lanes * lane


def least_seconds(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)
