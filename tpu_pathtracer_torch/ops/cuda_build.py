"""Build and load the port's CUDA kernels (``tpu_pathtracer_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` into an object, one process per source,
all started together, then links them into one shared library with a plain C
interface, loaded with ctypes.  The library goes into
``tpu_pathtracer_torch/_build/``, named by a hash of the sources and flags,
so an edit rebuilds on first use and an unchanged tree reuses the build.
``--fmad=false`` keeps the kernels' arithmetic bit-comparable with their
plain torch versions.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the kernels' launchers (csrc/*.cu); each returns
# cudaGetLastError() after its launch.
_SIGNATURES = {
    # o, d, active, t_max, nodes_packed, rows, pre, n_prepass, ax, ay, az,
    # num_nodes, num_tris, t_min, n, mt, out_t, out_row, stream (the window
    # walk's two variants append their extra outputs before the stream)
    "tpupt_window_walk": [_P] * 7 + [_I, _F, _F, _F, _I, _I, _F, _I, _I, _P, _P, _P],
    # ... mt, tris (lay.tris: the 24-float MT rows the epilogue resolves),
    # out (12, n), stream
    "tpupt_window_walk_resolve": [_P] * 7 + [_I, _F, _F, _F, _I, _I, _F, _I, _I, _P, _P, _P],
    # ... mt, tris, out (4, n): the capped epilogue, stream
    "tpupt_window_walk_capped": [_P] * 7 + [_I, _F, _F, _F, _I, _I, _F, _I, _I, _P, _P, _P],
    # ... out_t, out_row, out_orig, stream
    "tpupt_window_walk_orig": [_P] * 7 + [_I, _F, _F, _F, _I, _I, _F, _I, _I] + [_P] * 4,
    # ... out_t, out_row, out_spent, out_useful, stream
    "tpupt_window_walk_counts": [_P] * 7 + [_I, _F, _F, _F, _I, _I, _F, _I, _I] + [_P] * 5,
    # o, d, active, t_max, nodes_packed, tris, pre, n_prepass, num_nodes,
    # num_tris, t_min, n, out, stream
    "tpupt_minwalk": [_P] * 7 + [_I, _I, _I, _F, _I, _P, _P],
    # o, d, active, t_max, tris, ax, ay, az, num_tris, t_min, n, mt,
    # with_orig, out_t, out_row, out_orig, stream
    "tpupt_sweep": [_P] * 5 + [_F, _F, _F, _I, _F, _I, _I, _I, _P, _P, _P, _P],
    # o, d, active, cap, nodes_packed, tris, num_nodes, num_tris, t_min, n,
    # out, stream
    "tpupt_capped_walk": [_P] * 6 + [_I, _I, _F, _I, _P, _P],
    # o, d, active, cap, target, nodes_packed, tris, num_nodes, t_min, eps,
    # four_eps, n, out, stream
    "tpupt_anyhit_walk": [_P] * 7 + [_I, _F, _F, _F, _I, _P, _P],
    # o, d, active, leafbox, pre, n_prepass, num_leaves, t_min, tile, blocks,
    # threads, passes, tile_rows, smem (scripts/dense_march.py:march_shape), n,
    # out_count, out_first, stream
    "tpupt_sweep_count": [_P] * 5 + [_I, _I, _F] + [_I] * 7 + [_P] * 3,
    # o, d, active, t_max, leafbox, leafmeta, tris8, pre, n_prepass,
    # num_leaves, num_tris, t_min, threads, tile_rows, smem
    # (scripts/dense_march.py:compact_shape), n, scratch, out_t, out_u, out_v,
    # out_row, out_orig, stream
    "tpupt_sweep1": [_P] * 8 + [_I, _I, _I, _F] + [_I] * 4 + [_P] * 7,
    # pid (int64), keys (a host array: csrc/rng.cu), count, n, out, stream
    "tpupt_uniforms": [_P, _P, _I, _I, _P, _P],
    "tpupt_uniforms_r2": [_P, _P, _I, _I, _P, _P],
    # params (a host csrc/shade.cu:ShadeParams, ops/shade.py:_ShadeParams), stream
    "tpupt_shade_bounce": [_P, _P],
    # origin, direction, alive, pixel, wmin x3, winv x3, n, key, stream
    "tpupt_sort_key": [_P] * 4 + [_F] * 6 + [_I, _P, _P],
    # planes (a host array of csrc/wavefront_sort.cu:Plane), count, perm, key
    # (null: none), n, pass_bytes, stream
    "tpupt_gather_planes": [_P, _I, _P, _P, _I, ctypes.c_longlong, _P],
    # rays, table0..3 (never read; null when absent), tile, n, out, stream
    "tpupt_noop": [_P] * 5 + [_I, _I, _P, _P],
    # rays, tris, variant, nblocks, mtblock, tile, blocks, threads, passes,
    # tile_rows, smem (scripts/dense_march.py:march_shape), n, out_t, out_i, stream
    "tpupt_rowtest_probe": [_P, _P] + [_I] * 10 + [_P] * 3,
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtpupt_cuda_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _run(procs) -> tuple[int, str]:
    """Wait for (cmd, Popen) pairs -> (first failing return code, output)."""
    rc, out = 0, []
    for cmd, proc in procs:
        try:
            text, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
            raise
        out.append(text)
        if proc.returncode and not rc:
            rc = proc.returncode
            out.append(" ".join(cmd))
    return rc, "".join(out)


def build() -> tuple[str, float, str]:
    """Compile the kernels unless this source hash is already built.
    Returns (library path, seconds spent compiling, compiler output);
    raises ``RuntimeError`` with the compiler output when nvcc fails."""
    path = library_path()
    log_path = path + ".log"
    if os.path.exists(path):
        with open(log_path) as f:
            return path, 0.0, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    sources = [s for s in _sources() if s.endswith(".cu")]
    objects = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
    t0 = time.perf_counter()

    def start(cmd):
        return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    try:
        rc, log = _run([start([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src])
                        for src, obj in zip(sources, objects)])
        if not rc:
            rc, link_log = _run([start([_nvcc(), *NVCC_FLAGS[:2], "-shared",
                                        "-o", f"{tmp}.tmp", *objects])])
            log += link_log
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"nvcc failed ({rc}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(f"{tmp}.tmp", path)  # atomic: a concurrent build sees all or nothing
    return path, seconds, log


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' library (once per process)."""
    lib = ctypes.CDLL(build()[0])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def plane_address(what: str, t, dtype, shape: tuple, device) -> int:
    """The address a launcher passes for ``t``, after checking that it is a
    contiguous tensor of ``dtype`` and ``shape`` on ``device`` (a CUDA
    device); raises ``ValueError`` otherwise -- a launcher never copies."""
    if (t.device != device or device.type != "cuda" or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{what}: expected a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device} (a CUDA device), got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}")
    return t.data_ptr()
