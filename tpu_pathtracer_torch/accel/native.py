"""ctypes bridge to the native (C++) SAH BVH build.

The same ``native/libtpupt.so`` that ``tpu_pathtracer`` uses, built from
``native/sah_bvh.cc`` by ``native/Makefile`` on first use (and again when
the source is newer than the library).  Returns numpy arrays.
:func:`available` says whether the library builds and loads; the layout
builder's "auto" falls back to the LBVH (accel/lbvh.py) when it does not,
as the reference's does.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import NamedTuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libtpupt.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "sah_bvh.cc")


class BVH(NamedTuple):
    """The native SAH tree, triangles in build order; component-major
    ``(3, T)`` vertices like ``tpu_pathtracer.accel.lbvh.BVH``."""
    p0: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    sorted_to_orig: np.ndarray   # (T,) int32
    bmin: np.ndarray             # (3, M)
    bmax: np.ndarray             # (3, M)
    left: np.ndarray             # (M,) int32
    right: np.ndarray
    is_leaf: np.ndarray          # (M,) bool
    first_tri: np.ndarray        # (M,) int32
    tri_count: np.ndarray        # (M,) int32
    root: int = 0


def _stale() -> bool:
    try:
        return os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH)
    except OSError:
        return True


def load_library() -> ctypes.CDLL:
    """Build (if missing or stale) and load the native library; raises
    ``RuntimeError`` when the build fails."""
    if _stale():
        proc = subprocess.run(["make", "-C", _NATIVE_DIR, "-B"],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(
                f"native SAH builder failed to build:\n{proc.stderr}")
    lib = ctypes.CDLL(_LIB_PATH)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.tpupt_build_sah.restype = ctypes.c_int32
    lib.tpupt_build_sah.argtypes = (
        [f32p] * 9
        + [ctypes.c_int32, ctypes.c_int32]
        + [i32p, i32p, i32p, i32p, u8p, f32p, f32p, i32p]
    )
    return lib


def available() -> bool:
    """True when the native library builds (if needed) and loads."""
    try:
        load_library()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def build_sah(p0, p1, p2, leaf_size: int = 4) -> BVH:
    """Native SAH build over (3, T) component-major triangle vertices."""
    lib = load_library()
    p0 = np.ascontiguousarray(p0, np.float32)
    p1 = np.ascontiguousarray(p1, np.float32)
    p2 = np.ascontiguousarray(p2, np.float32)
    num_tris = p0.shape[1]
    max_nodes = max(2 * num_tris - 1, 1)

    left = np.empty(max_nodes, np.int32)
    right = np.empty(max_nodes, np.int32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    leaf = np.empty(max_nodes, np.uint8)
    bmin = np.empty(3 * max_nodes, np.float32)
    bmax = np.empty(3 * max_nodes, np.float32)
    order = np.empty(num_tris, np.int32)

    args = [np.ascontiguousarray(a[c]) for a in (p0, p1, p2) for c in range(3)]
    m = lib.tpupt_build_sah(
        *args, num_tris, leaf_size,
        left, right, first, count, leaf, bmin, bmax, order,
    )
    if m <= 0:
        raise RuntimeError(f"native SAH build failed (rc={m})")

    return BVH(
        p0=p0[:, order], p1=p1[:, order], p2=p2[:, order],
        sorted_to_orig=order,
        bmin=bmin[: 3 * m].reshape(3, -1)[:, :m].copy(),
        bmax=bmax[: 3 * m].reshape(3, -1)[:, :m].copy(),
        left=left[:m],
        right=right[:m],
        is_leaf=leaf[:m].astype(bool),
        first_tri=first[:m],
        tri_count=count[:m],
    )
