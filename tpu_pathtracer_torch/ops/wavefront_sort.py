"""The wavefront sort's key and plane gather (render/wavefront.py:
sort_wavefront), as hand kernels and their plain versions.

``ray_key_plain`` is the port of ``tpu_pathtracer/render/wavefront.py:
ray_sort_key``: 31 bits a lane, the dead bit 30, then the 8^3 origin cell,
a 16x16 octahedral direction bin and the finer 32^3 Morton bits.
``sort_key_plain`` widens it to the one int64 key the port sorts,
``(key << 32) | pixel``; ``gather_planes_plain`` takes every plane of the
state and its shadow pack through the permutation, one ``index_select``
each.

The wrappers ``sort_key`` and ``gather_planes`` launch the kernels of
``csrc/wavefront_sort.cu`` (one launch each, bit-equal to the plain
versions), count their launches in ``.launches`` and raise on CPU tensors:
render/wavefront.py takes the plain versions there.  ``gather_planes``
reads the pixel and alive planes from the sorted key where the caller
passes it (``key_planes_plain`` is that reading in torch).
"""

from __future__ import annotations

import ctypes

import torch

from . import launch_count
from .cuda_build import load_library, plane_address

MAX_PLANES = 16   # the most planes one gather takes (csrc/wavefront_sort.cu:kMaxPlanes)
MAX_ROWS = 96     # the most rows of those planes (csrc/wavefront_sort.cu:kMaxRows)
MAX_LANES = 2 ** 31 - 1
# the source bytes one pass of the gather may read (csrc/wavefront_sort.cu)
PASS_BYTES = 64 << 20


def _morton5(q: torch.Tensor) -> torch.Tensor:
    """Spread 5 bits to every 3rd position (for the 15-bit sort cell)."""
    q = (q | (q << 8)) & 0x100F
    q = (q | (q << 4)) & 0x10C3
    q = (q | (q << 2)) & 0x1249
    return q


def ray_key_plain(origin, direction, alive, wmin, winv) -> torch.Tensor:
    """Wavefront sort key (int64 holding 31 bits): dead bit 30, then the
    8^3 origin cell, a 16x16 octahedral direction bin, and the finer
    32^3 Morton bits.  ``wmin``, ``winv``: the scene box's float32 values
    in Python floats (render/wavefront.py:scene_sort_bounds)."""
    d = direction
    o = origin
    anorm = torch.abs(d[0]) + torch.abs(d[1]) + torch.abs(d[2])
    u = d[0] / anorm
    v = d[1] / anorm
    back = d[2] < 0
    uo = torch.where(back, (1.0 - torch.abs(v)) * torch.sign(u), u)
    vo = torch.where(back, (1.0 - torch.abs(u)) * torch.sign(v), v)
    qu = torch.clamp((uo * 0.5 + 0.5) * 16.0, 0.0, 15.0).to(torch.int64)
    qv = torch.clamp((vo * 0.5 + 0.5) * 16.0, 0.0, 15.0).to(torch.int64)
    octa = (qu << 4) | qv

    mort = torch.zeros_like(octa)
    for axis in range(3):
        q = torch.clamp((o[axis] - wmin[axis]) * winv[axis] * 32.0, 0.0, 31.0)
        mort = mort | (_morton5(q.to(torch.int64)) << (2 - axis))
    coarse = mort >> 6     # top 9 bits: 8^3 cell
    fine = mort & 63       # bottom 6 bits
    dead = (~alive).to(torch.int64)
    return (dead << 30) | (coarse << 20) | (octa << 12) | fine


def sort_key_plain(origin, direction, alive, pixel, wmin, winv) -> torch.Tensor:
    """Plain torch version of ``csrc/wavefront_sort.cu:tpupt_sort_key``:
    the (N,) int64 key ``(ray_key_plain << 32) | pixel``."""
    return (ray_key_plain(origin, direction, alive, wmin, winv) << 32) | pixel


def gather_planes_plain(planes, perm: torch.Tensor, out=None) -> list:
    """Plain torch version of ``csrc/wavefront_sort.cu:tpupt_gather_planes``:
    each plane (..., N) taken through ``perm`` along its last axis, into the
    plane of ``out`` at its index where given; a None plane (no hero bins)
    stays None."""
    out = [None] * len(planes) if out is None else out
    return [None if x is None else torch.index_select(x, -1, perm, out=o)
            for x, o in zip(planes, out)]


def key_planes_plain(key: torch.Tensor):
    """The pixel ids and alive flags of the lanes whose sort keys are ``key``
    (:func:`sort_key_plain`'s layout: the pixel id in the low 32 bits, the
    dead bit at bit 62) -> ((N,) int64, (N,) bool).  Of a sorted key they are
    the gathered pixel and alive planes, as ``gather_planes`` reads them."""
    return key & 0xFFFFFFFF, ((key >> 62) & 1) == 0


# ---------------------------------------------------------------------------
# the kernels (csrc/wavefront_sort.cu) and their wrappers
# ---------------------------------------------------------------------------

class _Plane(ctypes.Structure):
    # csrc/wavefront_sort.cu:Plane
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("rows", ctypes.c_int), ("elem", ctypes.c_int), ("kind", ctypes.c_int)]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sort_key(origin, direction, alive, pixel, wmin, winv) -> torch.Tensor:
    """(3, N) float32 origins and directions, (N,) bool alive and int64
    pixel ids, all contiguous on the card -> (N,) int64 key
    (:func:`sort_key_plain`), one launch of ``tpupt_sort_key``."""
    n, dev = alive.shape[0], alive.device
    if n > MAX_LANES:
        raise ValueError(f"sort_key: {n} lanes, at most {MAX_LANES}")
    ptrs = [plane_address(f"sort_key {name}", t, dtype, shape, dev)
            for name, t, dtype, shape in (("origin", origin, torch.float32, (3, n)),
                                          ("direction", direction, torch.float32, (3, n)),
                                          ("alive", alive, torch.bool, (n,)),
                                          ("pixel", pixel, torch.int64, (n,)))]
    key = torch.empty(n, dtype=torch.int64, device=dev)
    rc = load_library().tpupt_sort_key(
        *ptrs, *(float(x) for x in wmin), *(float(x) for x in winv), n, key.data_ptr(),
        _stream(alive))
    if rc:
        raise RuntimeError(f"sort_key kernel launch failed: cudaError {rc}")
    launch_count.count(sort_key)
    return key


sort_key.launches = 0


def gather_planes(planes, perm: torch.Tensor, key: torch.Tensor | None = None,
                  pixel: int | None = None, alive: int | None = None, out=None) -> list:
    """Every plane of ``planes`` -- contiguous (N,) or (R, N) CUDA tensors of
    1, 4 or 8-byte elements, at most MAX_ROWS rows in all, or None -- taken
    through the (N,) int64 permutation ``perm`` (:func:`gather_planes_plain`),
    in one launch of ``tpupt_gather_planes``, into fresh tensors or, with
    ``out``, into its contiguous plane of the same shape and type at each
    plane's index.  With
    ``key``, the (N,) int64 sorted key (torch.sort's values, in the order of
    ``perm``), the planes at the indices ``pixel`` ((N,) int64) and ``alive``
    ((N,) bool) are read from it (:func:`key_planes_plain`) instead: the
    same values when the key was made from those planes."""
    n, dev = perm.shape[0], perm.device
    if n > MAX_LANES:
        raise ValueError(f"gather_planes: {n} lanes, at most {MAX_LANES}")
    plane_address("gather_planes perm", perm, torch.int64, (n,), dev)
    if key is not None:
        plane_address("gather_planes key", key, torch.int64, (n,), dev)
    kinds = {} if key is None else {k: kind for k, kind in ((pixel, 1), (alive, 2))
                                    if k is not None}
    live = [k for k, x in enumerate(planes) if x is not None]
    if len(live) > MAX_PLANES:
        raise ValueError(f"gather_planes: {len(live)} planes, at most {MAX_PLANES}")
    rows = sum(1 if planes[k].dim() == 1 else planes[k].shape[0] for k in live)
    if rows > MAX_ROWS:
        raise ValueError(f"gather_planes: {rows} rows, at most {MAX_ROWS}")
    outs, table = [], (_Plane * MAX_PLANES)()
    for slot, k in enumerate(live):
        x = planes[k]
        if x.dim() not in (1, 2) or x.shape[-1] != n or x.element_size() not in (1, 4, 8):
            raise ValueError(f"gather_planes: plane {k} of shape {tuple(x.shape)} and "
                             f"{x.dtype}: expected (N,) or (R, N) with N = {n} and "
                             f"1, 4 or 8-byte elements")
        kind = kinds.get(k, 0)
        want = {1: torch.int64, 2: torch.bool}.get(kind, x.dtype)
        plane_address(f"gather_planes plane {k}", x, want, (n,) if kind else tuple(x.shape),
                      dev)
        if out is None:
            dst = torch.empty_like(x)
        else:
            dst = out[k]
            plane_address(f"gather_planes out {k}", dst, x.dtype, tuple(x.shape), dev)
        outs.append(dst)
        table[slot] = _Plane(None if kind else x.data_ptr(), dst.data_ptr(),
                             1 if x.dim() == 1 else x.shape[0], x.element_size(), kind)
    rc = load_library().tpupt_gather_planes(
        ctypes.addressof(table), len(live), perm.data_ptr(),
        None if key is None else key.data_ptr(), n, PASS_BYTES, _stream(perm))
    if rc:
        raise RuntimeError(f"gather_planes kernel launch failed: cudaError {rc}")
    launch_count.count(gather_planes)
    it = iter(outs)
    return [None if x is None else next(it) for x in planes]


gather_planes.launches = 0
