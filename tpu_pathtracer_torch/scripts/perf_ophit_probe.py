"""Price the per-row operation components of the leaf intersection test.

    python -m tpu_pathtracer_torch.scripts.perf_ophit_probe          # on the card
    python -m tpu_pathtracer_torch.scripts.perf_ophit_probe --platform cpu \\
        --lanes 256 --rows 64 --reps 1                               # a CPU rehearsal

The counterpart of the reference's ``scripts/perf_ophit_probe.py`` (``_kernel``
via ``run_variant``), on ``tpupt_rowtest_probe`` of ``csrc/probes.cu``.  A
fixed-work dense march: every lane tests every row of a ``(rows, 16)``
float32 table (``--rows`` 7112 by ``--lanes`` 1920x1080 by default), the
same work for every variant, so the difference between two variants is the
cost of the operations one of them drops (unlike a walk, where best_t
feedback changes the work):

  full-bw    the Baldwin-Weber row test + block latch (the anchor)
  nodiv      the reciprocal replaced by a multiply (wrong results, same shape)
  nouv       the u/v plane evaluations and their accepts dropped (t plane only)
  nopick     the block latch keeps the minimum and drops the row-id pick
  rows-latch the full test with a sequential per-row strict-< latch
  mt         the Moller-Trumbore row test (cols 0-8 of the same table)

``--mtblock`` is the block of rows over which ``full-bw``, ``nodiv``,
``nouv``, ``nopick`` and ``mt`` take one minimum and a lowest-row pick
before they update the best record (the reference's ``_argmin_pick``),
against ``rows-latch``'s update per row; ``rows // mtblock`` whole blocks
are marched.  ``--tile`` is the number of lanes one thread block covers (a
multiple of 32), as the reference's tile is the lanes of one grid step; the
block runs K lanes a thread (:mod:`.dense_march`).

Every variant but ``full-bw`` and ``rows-latch`` returns values that mean
nothing as intersections; each is still a deterministic function of its
inputs, and the kernel is held against :func:`rowtest_probe_plain`.  The
inputs are standard-normal draws from a ``torch.Generator`` with a fixed
seed: only their distribution matters to a timing tool.

Lines: ``ROW <variant> <ms> ms <ps> ps/rowtest first=<s>s <delta vs
full-bw>``; ms is the minimum over ``--reps`` launches, by CUDA events on
the card (host clock with ``--platform cpu``); ``first`` is the first
call's wall time, which on the card includes the kernels' build.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..device import device_for, device_label
from ..ops.cuda_build import load_library
from ..ops.hopper_traverse import _bw
from ..ops.traverse import latch, mt_rows
from .dense_march import march_shape

N = 1920 * 1080          # the main path's wavefront lanes
T8 = 7112                # the bench scene's padded BW row count (a multiple of 8)
VARIANTS = ("full-bw", "nodiv", "nouv", "nopick", "rows-latch", "mt")
STAGED_ROW_BYTES = 48  # cols 0-11 of a row: what the kernel stages in shared memory
K_LANES = 2  # the kernel's lanes a thread (csrc/probes.cu:kProbeK)
# float32 operations of one row test and its latch compare, each add, mul,
# div and compare counted once (the count behind chip_smoke.OPS_ROW: a BW
# test 38, an MT test 52).  nodiv drops the divide; nouv keeps den (5), num
# (6), the den != 0 compare, the divide, t, t > 0 and the latch compare.
ROWTEST_OPS = {"full-bw": 38, "nodiv": 37, "nouv": 16, "nopick": 38,
               "rows-latch": 38, "mt": 52}


def _row_test(variant: str, rows, o, d):
    """``rows`` (1, K, 16) against lane columns ``o``/``d`` (3-tuples of
    (L, 1)) -> (t, ok), (L, K): the variant's test with t > 0."""
    if variant == "mt":
        tt, _, _, ok = mt_rows(rows, o, d, 0.0)
        return tt, ok
    if variant in ("full-bw", "nopick", "rows-latch"):
        return _bw(rows, o, d, 0.0)
    ox, oy, oz = o
    dx, dy, dz = d
    den = rows[..., 0] * dx + rows[..., 1] * dy + rows[..., 2] * dz
    num = rows[..., 0] * ox + rows[..., 1] * oy + rows[..., 2] * oz + rows[..., 3]
    nz = den != 0.0
    if variant == "nouv":
        tt = -num * torch.where(nz, 1.0 / den, 0.0)
        return tt, nz & (tt > 0.0)
    tt = -num * den  # nodiv: wrong on purpose, prices the reciprocal
    px = ox + tt * dx
    py = oy + tt * dy
    pz = oz + tt * dz
    u = rows[..., 4] * px + rows[..., 5] * py + rows[..., 6] * pz + rows[..., 7]
    v = rows[..., 8] * px + rows[..., 9] * py + rows[..., 10] * pz + rows[..., 11]
    return tt, nz & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > 0.0)


def rowtest_probe_plain(variant: str, rays, tris, mtblock: int = 16):
    """Plain torch version of ``tpupt_rowtest_probe`` -> (best_t (N,) f32,
    best_i (N,) int32; inf and -1 where nothing was accepted).  A block's
    rows fold in with a first-minimum pick, which is the block latch and
    also equals ``rows-latch``'s sequential strict ``<``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}: expected one of {VARIANTS}")
    n = rays.shape[1]
    o = tuple(rays[k][:, None] for k in range(3))
    d = tuple(rays[k][:, None] for k in range(3, 6))
    best_t = torch.full((n,), torch.inf, device=rays.device)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=rays.device)
    for r0 in range(0, tris.shape[0] // mtblock * mtblock, mtblock):
        tt, ok = _row_test(variant, tris[None, r0:r0 + mtblock], o, d)
        ids = torch.arange(r0, r0 + mtblock, dtype=torch.int32, device=rays.device)
        new_t, new_i, _, _ = latch(tt, ok, best_t, best_i, ids)
        best_t = new_t
        if variant != "nopick":
            best_i = new_i
    return best_t, best_i


def _check_probe_inputs(variant: str, rays, tris, mtblock: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}: expected one of {VARIANTS}")
    for name, t, cols in (("rays", rays, None), ("tris", tris, 16)):
        if (t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous()
                or t.device != rays.device or t.data_ptr() % 16
                or (cols and t.shape[1] != cols)):
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned float32 "
                             f"matrix on {rays.device}, got {t.dtype} {tuple(t.shape)}")
    if rays.shape[0] != 8 or 8 * rays.shape[-1] >= 2 ** 31:
        raise ValueError(f"rays: expected (8, N) with 8 N < 2^31, got {tuple(rays.shape)}")
    if mtblock < 1:
        raise ValueError(f"mtblock={mtblock}: expected >= 1")


def rowtest_probe(variant: str, rays, tris, tile: int = 768, mtblock: int = 16):
    """The dense march -> (best_t (N,) f32, best_i (N,) int32): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  ``rays``:
    (8, N) float32 (rows 0-2 origins, 3-5 directions); ``tris``: (T, 16)
    float32; ``tile``: lanes a block covers."""
    if rays.device.type == "cpu":
        return rowtest_probe_plain(variant, rays, tris, mtblock)
    _check_probe_inputs(variant, rays, tris, mtblock)
    n = rays.shape[-1]
    nblocks = tris.shape[0] // mtblock
    shape = march_shape(n, tile, K_LANES, nblocks * mtblock, STAGED_ROW_BYTES)
    out_t = torch.empty(n, dtype=torch.float32, device=rays.device)
    out_i = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = load_library().tpupt_rowtest_probe(
        rays.data_ptr(), tris.data_ptr(), VARIANTS.index(variant), nblocks, mtblock,
        tile, shape.blocks, shape.threads, shape.passes, shape.tile_rows, shape.smem, n,
        out_t.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rowtest_probe kernel launch failed: cudaError {rc}")
    rowtest_probe.launches += 1
    return out_t, out_i


rowtest_probe.launches = 0


def rowtest_probe_v1(variant: str, rays, tris, tile: int = 768, mtblock: int = 16):
    """The first port's probe (``csrc/march_v1.cu``: one lane a thread, each
    row read with ``__ldg``), kept as the yardstick :func:`rowtest_probe` is
    timed against in turns; on no tool's path.  ``tile``: threads a block (a
    multiple of 32 in [32, 1024]).  Its plain version is
    :func:`rowtest_probe_plain`."""
    if rays.device.type == "cpu":
        return rowtest_probe_plain(variant, rays, tris, mtblock)
    _check_probe_inputs(variant, rays, tris, mtblock)
    if not (32 <= tile <= 1024 and tile % 32 == 0):
        raise ValueError(f"tile={tile}: one thread a lane, so a block's thread count: "
                         "a multiple of 32 in [32, 1024]")
    n = rays.shape[-1]
    out_t = torch.empty(n, dtype=torch.float32, device=rays.device)
    out_i = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = load_library().tpupt_rowtest_probe_v1(
        rays.data_ptr(), tris.data_ptr(), VARIANTS.index(variant),
        tris.shape[0] // mtblock, mtblock, tile, n, out_t.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rowtest_probe_v1 kernel launch failed: cudaError {rc}")
    rowtest_probe_v1.launches += 1
    return out_t, out_i


rowtest_probe_v1.launches = 0


def run_variant(variant, rays, tris, tile, mtblock, reps):
    """-> (ms, the minimum over ``reps`` launches; seconds of the first
    call).  On the card the launches are timed by CUDA events, the sync a
    4-byte pull of a strided sum; on the CPU by the host clock."""
    def sync(out):
        return float(out[0][::4097].sum())

    t0 = time.perf_counter()
    sync(rowtest_probe(variant, rays, tris, tile, mtblock))
    first_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        if rays.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = rowtest_probe(variant, rays, tris, tile, mtblock)
            end.record()
            sync(out)
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            sync(rowtest_probe(variant, rays, tris, tile, mtblock))
            ts.append((time.perf_counter() - t0) * 1e3)
    return min(ts), first_s


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tile", type=int, default=768)
    ap.add_argument("--mtblock", type=int, default=16)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--lanes", type=int, default=N)
    ap.add_argument("--rows", type=int, default=T8)
    ap.add_argument("--platform", choices=("auto", "gpu", "cpu"), default="auto",
                    help="'auto' and 'gpu' need a CUDA device and raise without "
                         "one; 'cpu' runs the kernel's plain torch version")
    return ap


def probe_inputs(lanes: int, rows: int, device, seed: int = 0):
    """Standard-normal (8, lanes) rays and a (rows, 16) table: the 16-column
    rows serve both the BW (cols 0-11) and the MT (cols 0-8) test."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rays = torch.randn((8, lanes), generator=gen, device=device)
    tris = torch.randn((rows, 16), generator=gen, device=device)
    return rays, tris


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    device = device_for(args.platform)
    print(f"device: {device_label(device)}", flush=True)
    rays, tris = probe_inputs(args.lanes, args.rows, device)
    rows_total = (args.rows // args.mtblock) * args.mtblock * args.lanes
    print(f"lanes={args.lanes} rows/lane={args.rows} row-tests={rows_total:.3g}",
          flush=True)

    anchor = None
    for variant in args.variants.split(","):
        ms, first_s = run_variant(variant, rays, tris, args.tile, args.mtblock,
                                  args.reps)
        ps_row = ms * 1e9 / rows_total  # ps per row test
        delta = "" if anchor is None else f"  {100 * (ms - anchor) / anchor:+6.1f}%"
        if variant == "full-bw":
            anchor = ms
        print(f"ROW {variant:10s} {ms:8.1f} ms  {ps_row:6.2f} ps/rowtest  "
              f"first={first_s:5.1f}s{delta}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
