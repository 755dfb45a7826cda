"""BVH traversal on Hopper: the CUDA kernels of the render path, their plain
torch versions, and the intersector the frame uses.

The counterpart of ``tpu_pathtracer/ops/pallas_traverse.py``:

* **window walk** (``csrc/window_walk.cu``, replaces ``_window_kernel``):
  nearest hit over the leaf-56 layout — a 32-row big-triangle prepass, then
  a stackless DFS walk over ``nodes``/``nodes_meta`` with, by ``tritest``,
  Baldwin-Weber tests on the rows of ``tris8bw`` evaluated at
  ``o - anchor`` or Moller-Trumbore tests on the world-space rows of
  ``tris8``.  Returns ``(t, row)``; :func:`resolve_window_payload` then
  recomputes u/v and the shading payload from one row gather of ``tris``
  (plain torch, as the TPU path left it to XLA).  ``window_walk_resolve``
  (the frame's nearest-hit queries, and ``window_walk_hbm(...,
  resolve=True)`` on the HBM route) runs that resolve as an epilogue of the
  same launch and returns minwalk's 12 payload rows, bit-equal to
  :func:`window_payload_rows`.  The HBM route's capped queries take the
  capped epilogue (``window_walk_hbm(..., capped=True)``): t, u, v and the
  original triangle id, the first four of those rows, bit-equal to
  :func:`window_capped_rows`; the fused walk's path half keeps the torch
  resolve.  Two compile-time variants
  of the same source replace the TPU kernel's flags: ``window_walk_orig``
  (``with_orig``, the fused path+shadow walk) also latches the winner's
  original triangle id; ``window_walk_counts`` (``with_counts``, the
  walk-utilization telemetry) also counts the leaf rows each lane tested and
  the row-test slots its 32-lane warp issued.  ``window_walk_hbm`` launches
  the same kernel on the HBM route (``hbm=True``), counted apart.
* **minwalk** (``csrc/minwalk.cu``, replaces ``_traverse_kernel`` with
  ``resolve=True`` and the prepass; cfg.traversal_kernel="minwalk"):
  nearest hit over the leaf-56 layout's Moller-Trumbore rows with the
  shading payload read from the winning row in the kernel.
* **sweep** (``csrc/sweep.cu``, replaces ``_sweep_kernel``;
  cfg.traversal_kernel="sweep"): every active lane against every BW or MT
  row, no navigation, for incoherent nearest-hit queries.
* **capped walk** (``csrc/capped_walk.cu``, replaces ``_traverse_kernel``
  with ``resolve=False, prepass=0``): the range-capped shadow query over the
  leaf-8 layout with Moller-Trumbore rows; returns t, u, v and the original
  triangle id.
* **any-hit walk** (``csrc/anyhit_walk.cu``, replaces
  ``_occlusion_anyhit_kernel``): the shadow query of scenes with an
  environment light, over the leaf-8 layout; a lane leaves the walk at its
  first occluder and returns a clear mask.

The window walk, minwalk and the two shadow walks share one warp-cooperative
walk (``csrc/walk_common.cuh``): each lane steps its own ray through the
packed node table (``lay.nodes_packed``: a node is two 16-byte loads) to the
next leaf it enters, and the warp serves the leaves entered together, one
leaf a step over all 32 lanes, or lane by lane where that takes fewer
row-test slots.  The sweep is one thread per ray.  The
contract is the outputs: the same nearest hit, strict ``<`` in visit order
(prepass rows, then leaf rows in DFS order, ascending within a leaf), which
is the winner the TPU kernels' lowest-row tie-break picks.

Each kernel's wrapper takes its plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel (counting the launch in its
``launches`` attribute, and for the wrappers that take ``tritest`` the
Moller-Trumbore form's launches also in ``launches_mt``) or raises.  The
plain versions walk every running lane one node per step, vectorised across
lanes and across a leaf's rows, with the kernels' operation order; a leaf's
rows fold in with a first-minimum pick, which equals the kernels'
sequential strict-``<`` latch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..accel.layout import BVHLayout
from ..render.timing import span
from . import launch_count
from .cuda_build import load_library
from .intersect import HitShade
from .traverse import Tally, latch, mt_rows, walk

DEFAULT_PREPASS = 32


def _bw(rows, o, d, t_min):
    """Baldwin-Weber rows (..., 16) against broadcastable anchored origins
    ``o`` and directions ``d`` (3-tuples) -> (t, ok)."""
    ox, oy, oz = o
    dx, dy, dz = d
    den = rows[..., 0] * dx + rows[..., 1] * dy + rows[..., 2] * dz
    num = rows[..., 0] * ox + rows[..., 1] * oy + rows[..., 2] * oz + rows[..., 3]
    nz = den != 0.0
    inv = torch.where(nz, 1.0 / den, 0.0)
    tt = -num * inv
    px = ox + tt * dx
    py = oy + tt * dy
    pz = oz + tt * dz
    u = rows[..., 4] * px + rows[..., 5] * py + rows[..., 6] * pz + rows[..., 7]
    v = rows[..., 8] * px + rows[..., 9] * py + rows[..., 10] * pz + rows[..., 11]
    ok = nz & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > t_min)
    return tt, ok


# ---------------------------------------------------------------------------
# Kernel A: nearest-hit window walk (BW or MT rows)
# ---------------------------------------------------------------------------

def _mt_ok(rows, o, d, t_min):
    """Moller-Trumbore rows against world-space rays -> (t, ok)."""
    tt, _, _, ok = mt_rows(rows, o, d, t_min)
    return tt, ok


class _Rows(NamedTuple):
    """The leaf-row form of a ``tritest`` (csrc/walk_common.cuh: Rows)."""
    table: torch.Tensor     # leaf rows, indexed like tris
    prepass: torch.Tensor   # big-triangle rows
    test: Callable          # (rows, o, d, t_min) -> (t, ok)
    index: int              # prepass column holding the global row id
    orig: int               # column holding the original triangle id
    anchor: tuple | None    # origin shift of the row test (BW planes only)

    def origin(self, o):
        """(3, N) origins as the row test takes them: ``o - anchor`` for BW
        planes, ``o`` for the world-space MT rows."""
        if self.anchor is None:
            return o
        ax, ay, az = self.anchor
        return torch.stack([o[0] - ax, o[1] - ay, o[2] - az])


def _rows(lay: BVHLayout, tritest: str) -> _Rows:
    if tritest == "bw":
        return _Rows(lay.tris8bw, lay.prepassbw, _bw, 12, 13, lay.anchor)
    if tritest == "mt":
        return _Rows(lay.tris8, lay.prepass, _mt_ok, 21, 9, None)
    raise ValueError(f"tritest={tritest!r}: expected 'bw' or 'mt'")


def _window_plain(o, d, active, t_max, lay: BVHLayout, t_min: float, prepass: int,
                  tritest: str = "bw", orig: bool = False, counts: bool = False,
                  tally: Tally | None = None):
    """The window walk's plain version and its variants -> (t, row) plus the
    latched original triangle id (int32, -1 on a miss) with ``orig`` and the
    per-lane useful leaf-row count (int32) with ``counts``; ``tally``
    receives the walk's work (prepass rows not included)."""
    n = o.shape[1]
    rs = _rows(lay, tritest)
    best = [t_max.clone(), torch.full_like(t_max, lay.num_tris, dtype=torch.int32)]
    if orig:
        best.append(torch.full((n,), -1, dtype=torch.int32, device=o.device))
    if counts:
        best.append(torch.zeros(n, dtype=torch.int32, device=o.device))
    ob = rs.origin(o)
    act = active.nonzero()[:, 0]
    if prepass and act.numel():
        rows = rs.prepass[:prepass]
        ol = tuple(c[act][:, None] for c in ob)
        dl = tuple(c[act][:, None] for c in d)
        tt, ok = rs.test(rows[None], ol, dl, t_min)
        bt, br, upd, kmin = latch(tt, ok, best[0][act], best[1][act],
                                  rows[:, rs.index].to(torch.int32))
        best[0][act] = bt
        best[1][act] = br
        if orig:
            best[2][act] = torch.where(upd, rows[:, rs.orig].to(torch.int32)[kmin],
                                       best[2][act])

    def leaf_test(lanes, rowid, valid, best):
        rows = rs.table[rowid]
        tt, ok = rs.test(rows, tuple(c[lanes][:, None] for c in ob),
                         tuple(c[lanes][:, None] for c in d), t_min)
        bt, br, upd, kmin = latch(tt, ok & valid, best[0], best[1],
                                  rowid.to(torch.int32))
        new = [bt, br]
        if orig:
            pick = rows[..., rs.orig].gather(1, kmin[:, None])[:, 0].to(torch.int32)
            new.append(torch.where(upd, pick, best[2]))
        if counts:
            new.append(best[-1] + valid.sum(1).to(torch.int32))
        return tuple(new)

    walk(o, d, active, lay, t_min, tuple(best), leaf_test, tally=tally)
    return tuple(best)


def window_walk_plain(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                      prepass: int = DEFAULT_PREPASS, tritest: str = "bw",
                      tally: Tally | None = None):
    """Plain torch version of ``csrc/window_walk.cu`` -> (t (N,) f32, row
    (N,) int32); inactive lanes get (t_max, num_tris).  ``tally``, here and
    in the other plain versions: receives the walk's work
    (ops/traverse.py:Tally)."""
    return _window_plain(o, d, active, t_max, lay, t_min, prepass, tritest, tally=tally)


def _check_window(o, d, active, t_max, lay: BVHLayout, prepass: int, tritest: str,
                  tables: tuple) -> _Rows:
    """Check a window walk's inputs, its ``tritest`` rows and the layout
    ``tables`` it reads besides them -> the rows."""
    n = o.shape[1]
    rs = _rows(lay, tritest)
    _check(o, torch.float32, (3, n), "o")
    _check(d, torch.float32, (3, n), "d")
    _check(active, torch.bool, (n,), "active")
    _check(t_max, torch.float32, (n,), "t_max")
    rows = ("tris8", "prepass") if tritest == "mt" else ("tris8bw", "prepassbw")
    _check_layout(lay, tables + rows, o.device)
    if not 0 <= prepass <= rs.prepass.shape[0]:
        raise ValueError(f"prepass={prepass} outside [0, {rs.prepass.shape[0]}]")
    return rs


def _launch_window(variant: str, o, d, active, t_max, lay: BVHLayout,
                   t_min: float, prepass: int, tritest: str, extra: int):
    """Check the inputs and launch ``tpupt_<variant>`` -> (t, row, *extra
    int32 rows)."""
    n = o.shape[1]
    rs = _check_window(o, d, active, t_max, lay, prepass, tritest, ("nodes_packed",))
    out_t = torch.empty(n, dtype=torch.float32, device=o.device)
    outs = [torch.empty(n, dtype=torch.int32, device=o.device) for _ in range(1 + extra)]
    ax, ay, az = lay.anchor
    rc = getattr(load_library(), f"tpupt_{variant}")(
        o.data_ptr(), d.data_ptr(), active.data_ptr(), t_max.data_ptr(),
        lay.nodes_packed.data_ptr(), rs.table.data_ptr(), rs.prepass.data_ptr(), prepass,
        ax, ay, az, lay.num_nodes, lay.num_tris, t_min, n, int(tritest == "mt"),
        out_t.data_ptr(), *(x.data_ptr() for x in outs),
        torch.cuda.current_stream(o.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{variant} kernel launch failed: cudaError {rc}")
    return (out_t, *outs)


def window_walk(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                prepass: int = DEFAULT_PREPASS, tritest: str = "bw"):
    """Nearest-hit walk -> (t (N,) f32, row (N,) int32): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.

    ``o``/``d``: (3, N) float32; ``active``: (N,) bool; ``t_max``: (N,)
    float32 (best_t seed); ``prepass``: leading rows of the prepass table;
    ``tritest``: "bw" (``tris8bw``/``prepassbw``) or "mt"
    (``tris8``/``prepass``)."""
    if o.device.type == "cpu":
        return window_walk_plain(o, d, active, t_max, lay, t_min, prepass, tritest)
    out = _launch_window("window_walk", o, d, active, t_max, lay, t_min, prepass,
                         tritest, 0)
    launch_count.count(window_walk, mt=tritest == "mt")
    return out


window_walk.launches = window_walk.launches_mt = 0


def window_walk_hbm_plain(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                          prepass: int = DEFAULT_PREPASS, tritest: str = "bw",
                          tally: Tally | None = None, resolve: bool = False,
                          capped: bool = False):
    """Plain version of the HBM route's window walk: the window walk's, or
    with ``resolve`` :func:`window_walk_resolve_plain`, or with ``capped``
    the window walk's then :func:`window_capped_rows`."""
    _check_epilogue(resolve, capped)
    if resolve:
        return window_walk_resolve_plain(o, d, active, t_max, lay, t_min, prepass, tritest,
                                         tally=tally)
    out = _window_plain(o, d, active, t_max, lay, t_min, prepass, tritest, tally=tally)
    return window_capped_rows(lay, *out, t_max, o, d) if capped else out


def window_walk_hbm(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                    prepass: int = DEFAULT_PREPASS, tritest: str = "bw",
                    resolve: bool = False, capped: bool = False):
    """The window walk on the HBM route (replaces ``_window_kernel`` with
    ``hbm=True``): the same kernel as :func:`window_walk` -> (t, row); with
    ``resolve`` (the route's nearest-hit queries) the epilogue form of
    :func:`window_walk_resolve` -> (12, N) payload rows; with ``capped`` (its
    t_max-capped shadow queries) the capped epilogue -> (4, N) rows [t, u,
    v, orig] (:func:`window_capped_rows`).  Counted apart so a run shows
    which route it took (``launches_resolve``, ``launches_capped``: the
    epilogue forms').  The TPU streamed demanded row blocks from HBM through
    VMEM scratch; on the card every table is in device memory already, and
    the walk reads its rows through L1/L2."""
    if o.device.type == "cpu":
        return window_walk_hbm_plain(o, d, active, t_max, lay, t_min, prepass, tritest,
                                     resolve=resolve, capped=capped)
    _check_epilogue(resolve, capped)
    if resolve or capped:
        out = _launch_window_epilogue("window_walk_capped" if capped else
                                      "window_walk_resolve", o, d, active, t_max, lay,
                                      t_min, prepass, tritest)
    else:
        out = _launch_window("window_walk", o, d, active, t_max, lay, t_min, prepass,
                             tritest, 0)
    launch_count.count(window_walk_hbm, mt=tritest == "mt", resolve=resolve, capped=capped)
    return out


window_walk_hbm.launches = window_walk_hbm.launches_mt = 0
window_walk_hbm.launches_resolve = window_walk_hbm.launches_capped = 0


def _check_epilogue(resolve: bool, capped: bool) -> None:
    if resolve and capped:
        raise ValueError("resolve and capped: a launch takes one epilogue")


def window_walk_resolve_plain(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                              prepass: int = DEFAULT_PREPASS, tritest: str = "bw",
                              tally: Tally | None = None):
    """Plain version of the window walk's payload epilogue: the window
    walk's plain version, then :func:`window_payload_rows` -> (12, N)."""
    t, row = _window_plain(o, d, active, t_max, lay, t_min, prepass, tritest, tally=tally)
    return window_payload_rows(lay, t, row, t_max, o, d)


_EPILOGUE_ROWS = {"window_walk_resolve": 12, "window_walk_capped": 4}


def _launch_window_epilogue(variant: str, o, d, active, t_max, lay: BVHLayout,
                            t_min: float, prepass: int, tritest: str):
    """Check the inputs and launch ``tpupt_<variant>``, an epilogue form ->
    (12, N) float32 payload rows (``window_walk_resolve``) or (4, N) capped
    rows (``window_walk_capped``)."""
    n = o.shape[1]
    rs = _check_window(o, d, active, t_max, lay, prepass, tritest, ("nodes_packed", "tris"))
    out = torch.empty((_EPILOGUE_ROWS[variant], n), dtype=torch.float32, device=o.device)
    ax, ay, az = lay.anchor
    rc = getattr(load_library(), f"tpupt_{variant}")(
        o.data_ptr(), d.data_ptr(), active.data_ptr(), t_max.data_ptr(),
        lay.nodes_packed.data_ptr(), rs.table.data_ptr(), rs.prepass.data_ptr(), prepass,
        ax, ay, az, lay.num_nodes, lay.num_tris, t_min, n, int(tritest == "mt"),
        lay.tris.data_ptr(), out.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{variant} kernel launch failed: cudaError {rc}")
    return out


def window_walk_resolve(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                        prepass: int = DEFAULT_PREPASS, tritest: str = "bw"):
    """The window walk with its payload epilogue (replaces ``_window_kernel``
    plus the XLA-fused ``resolve_window_payload``) -> (12, N) float32 rows
    [t, u, v, orig, mat, light+1, pos.xyz, normal.xyz], minwalk's layout (t
    stays at t_max where nothing nearer was hit; such lanes resolve the
    sentinel row, u = v = 0): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Inputs as :func:`window_walk`."""
    if o.device.type == "cpu":
        return window_walk_resolve_plain(o, d, active, t_max, lay, t_min, prepass, tritest)
    out = _launch_window_epilogue("window_walk_resolve", o, d, active, t_max, lay, t_min,
                                  prepass, tritest)
    launch_count.count(window_walk_resolve, mt=tritest == "mt")
    return out


window_walk_resolve.launches = window_walk_resolve.launches_mt = 0


def window_walk_orig_plain(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                           prepass: int = DEFAULT_PREPASS, tritest: str = "bw",
                           tally: Tally | None = None):
    """Plain version of the window walk's ``kOrig`` variant -> (t, row, orig
    (N,) int32, -1 where nothing was latched)."""
    return _window_plain(o, d, active, t_max, lay, t_min, prepass, tritest, orig=True,
                         tally=tally)


def window_walk_orig(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                     prepass: int = DEFAULT_PREPASS, tritest: str = "bw"):
    """The window walk that also latches the winner's original triangle id
    (replaces ``_window_kernel`` with ``with_orig=True``) -> (t, row, orig);
    inputs as :func:`window_walk`."""
    if o.device.type == "cpu":
        return window_walk_orig_plain(o, d, active, t_max, lay, t_min, prepass, tritest)
    out = _launch_window("window_walk_orig", o, d, active, t_max, lay, t_min,
                         prepass, tritest, 1)
    launch_count.count(window_walk_orig, mt=tritest == "mt")
    return out


window_walk_orig.launches = window_walk_orig.launches_mt = 0


def warp_spent_bounds(useful, n_prepass: int):
    """The bounds of the counting walk's ``spent`` per warp of 32 consecutive
    lanes -> (lo, hi) int32.  A slot is one row test on every lane of the
    warp, so with U the sum of ``useful`` over the warp: ``n_prepass +
    ceil(U / 32)`` (no slot tests more than 32 rows: every cooperative step
    full) and ``n_prepass + U`` (no slot without a row some lane needed).  A
    lane's ``spent`` can be below its own ``useful`` (its warp tests its leaf
    32 rows a slot); summed over a whole warp, spent is never below useful."""
    n = useful.shape[0]
    total = torch.nn.functional.pad(useful, (0, (-n) % 32)).view(-1, 32).sum(dim=1)
    lo = ((total + 31) // 32).repeat_interleave(32)[:n] + n_prepass
    hi = total.repeat_interleave(32)[:n] + n_prepass
    return lo.to(torch.int32), hi.to(torch.int32)


def window_walk_counts_plain(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                             prepass: int = DEFAULT_PREPASS, tritest: str = "bw",
                             tally: Tally | None = None):
    """Plain version of the window walk's ``kCounts`` variant -> (t, row,
    useful, spent_lo, spent_hi).  ``useful`` is exact; ``spent`` depends on
    how the card schedules a warp, so the plain version returns its bounds
    (:func:`warp_spent_bounds`)."""
    t, row, useful = _window_plain(o, d, active, t_max, lay, t_min, prepass, tritest,
                                   counts=True, tally=tally)
    return (t, row, useful, *warp_spent_bounds(useful, prepass))


def window_walk_counts(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                       prepass: int = DEFAULT_PREPASS, tritest: str = "bw"):
    """The window walk with lane-op telemetry (replaces ``_window_kernel``
    with ``with_counts=True``) -> (t, row, useful, spent), all per lane;
    ``useful`` = leaf rows this lane tested, ``spent`` = ``prepass`` + the
    leaf-row test slots its warp issued (csrc/window_walk.cu).  A CPU has no
    warps: for CPU tensors ``spent`` is the plain version's lower bound, the
    slots of a warp whose every step tests 32 needed rows (``prepass`` +
    ceil(the warp's useful rows / 32))."""
    if o.device.type == "cpu":
        t, row, useful, lo, _ = window_walk_counts_plain(o, d, active, t_max, lay,
                                                         t_min, prepass, tritest)
        return t, row, useful, lo
    t, row, spent, useful = _launch_window("window_walk_counts", o, d, active,
                                           t_max, lay, t_min, prepass, tritest, 2)
    launch_count.count(window_walk_counts, mt=tritest == "mt")
    return t, row, useful, spent


window_walk_counts.launches = window_walk_counts.launches_mt = 0


def _resolved_uv(lay: BVHLayout, t_raw, row, t_max, o, d):
    """The resolve's first half -> (t, the winning rows of ``lay.tris``
    (N, 24), u, v): t = ``t_raw`` where it beats ``t_max``, else inf; u/v
    recomputed with Moller-Trumbore (the sentinel row is all zeros, so
    misses get u = v = 0) and clamped to [0, 1] on hits."""
    t = torch.where(t_raw < t_max, t_raw, torch.inf)
    rows = lay.tris[row.to(torch.int64)]                 # (N, 24)

    def col(k):
        return rows[:, k]

    e1 = (col(3), col(4), col(5))
    e2 = (col(6), col(7), col(8))
    pvx = d[1] * e2[2] - d[2] * e2[1]
    pvy = d[2] * e2[0] - d[0] * e2[2]
    pvz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
    inv = torch.where(det != 0.0, 1.0 / det, 0.0)
    tx = o[0] - col(0)
    ty = o[1] - col(1)
    tz = o[2] - col(2)
    u = (tx * pvx + ty * pvy + tz * pvz) * inv
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
    hit_ok = torch.isfinite(t)
    u = torch.where(hit_ok, torch.clamp(u, 0.0, 1.0), 0.0)
    v = torch.where(hit_ok, torch.clamp(v, 0.0, 1.0), 0.0)
    return t, rows, u, v


def window_payload_rows(lay: BVHLayout, t_raw, row, t_max, o, d) -> torch.Tensor:
    """Kernel rows (t, row) -> the (12, N) float32 payload rows of minwalk's
    layout (:func:`minwalk_plain`): t_raw, u, v, orig, material, light+1,
    position (3) and unit normal (3), interpolated from one row gather of
    ``lay.tris`` (the arithmetic of the reference's
    ``resolve_window_payload``; ``csrc/window_walk.cu``'s epilogue mirrors
    it)."""
    _, rows, u, v = _resolved_uv(lay, t_raw, row, t_max, o, d)

    def col(k):
        return rows[:, k]

    w0 = 1.0 - u - v
    px = col(0) + u * col(3) + v * col(6)
    py = col(1) + u * col(4) + v * col(7)
    pz = col(2) + u * col(5) + v * col(8)
    nx = col(10) * w0 + col(13) * u + col(16) * v
    ny = col(11) * w0 + col(14) * u + col(17) * v
    nz = col(12) * w0 + col(15) * u + col(18) * v
    rlen = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    return torch.stack([t_raw, u, v, col(9), col(19), col(20), px, py, pz,
                        nx * rlen, ny * rlen, nz * rlen])


def window_capped_rows(lay: BVHLayout, t_raw, row, t_max, o, d) -> torch.Tensor:
    """Kernel rows (t, row) -> the (4, N) float32 rows of the capped
    epilogue, the capped walk's layout: t_raw, u, v and the original
    triangle id (col 9 of the winning row of ``lay.tris``: 0 on a miss),
    :func:`_resolved_uv`'s values (``csrc/window_walk.cu``'s kCapped form
    mirrors it)."""
    _, rows, u, v = _resolved_uv(lay, t_raw, row, t_max, o, d)
    return torch.stack([t_raw, u, v, rows[:, 9]])


def payload_hit(out: torch.Tensor, t_max) -> HitShade:
    """(12, N) payload rows (minwalk's, or the window walk's epilogue) ->
    HitShade: t beyond ``t_max`` a miss (inf), the ids as int64, light+1
    back to the light-table index."""
    return HitShade(t=torch.where(out[0] < t_max, out[0], torch.inf), u=out[1],
                    v=out[2], tri=out[3].to(torch.int64), mat=out[4].to(torch.int64),
                    light=out[5].to(torch.int64) - 1, pos=out[6:9], normal=out[9:12])


def capped_hit(out: torch.Tensor, t_max) -> HitShade:
    """(4, N) capped rows (the window walk's capped epilogue) -> HitShade: t
    beyond ``t_max`` a miss (inf), the id as int64, and for the payload a
    shadow query does not resolve the reference's fill values: mat 0, light
    -1, position and normal 0."""
    n = out.shape[1]
    dev = out.device
    return HitShade(
        t=torch.where(out[0] < t_max, out[0], torch.inf), u=out[1], v=out[2],
        tri=out[3].to(torch.int64),
        mat=torch.zeros(n, dtype=torch.int64, device=dev),
        light=torch.full((n,), -1, dtype=torch.int64, device=dev),
        pos=torch.zeros((3, n), device=dev),
        normal=torch.zeros((3, n), device=dev),
    )


def resolve_window_payload(lay: BVHLayout, t_raw, row, t_max, o, d) -> HitShade:
    """Kernel rows (t, row) -> HitShade through the torch resolve
    (:func:`window_payload_rows`, then :func:`payload_hit`)."""
    return payload_hit(window_payload_rows(lay, t_raw, row, t_max, o, d), t_max)


def intersect_bvh_window(o, d, lay: BVHLayout, t_min: float = 0.0, active=None,
                         t_max=None, prepass: int = DEFAULT_PREPASS,
                         tritest: str = "bw", hbm: bool = False,
                         resolve: bool = True, trace=None) -> HitShade:
    """(3, N) rays -> nearest-hit HitShade.  Nearest-hit queries
    (``resolve``) take the window walk with its payload epilogue
    (:func:`window_walk_resolve`, or on the HBM route ``window_walk_hbm(...,
    resolve=True)``).  ``resolve=False``, the HBM route's t_max-capped
    shadow queries (``hbm`` only), takes ``window_walk_hbm(...,
    capped=True)``: u, v and the original triangle id come from the walk's
    capped epilogue, and :func:`capped_hit` builds the HitShade inside
    ``trace``'s "resolve" span (render/timing.py) when a frame traces.
    ``hbm`` launches through :func:`window_walk_hbm`, the HBM route's
    wrapper."""
    if not (resolve or hbm):
        raise ValueError("resolve=False is the HBM route's capped query: pass hbm=True")
    o, d, active, t_max = _nearest_inputs(o, d, active, t_max)
    pp = window_prepass(lay, prepass)
    if resolve:
        out = (window_walk_hbm(o, d, active, t_max, lay, t_min, pp, tritest, resolve=True)
               if hbm else window_walk_resolve(o, d, active, t_max, lay, t_min, pp, tritest))
        return payload_hit(out, t_max)
    out = window_walk_hbm(o, d, active, t_max, lay, t_min, pp, tritest, capped=True)
    with span(trace, "resolve"):
        return capped_hit(out, t_max)


def _nearest_inputs(o, d, active, t_max):
    """Contiguous (o, d, active, t_max) for a nearest-hit kernel; ``active``
    None = every lane, ``t_max`` None = unbounded."""
    n = o.shape[1]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=o.device)
    t_max = (torch.full((n,), torch.inf, device=o.device) if t_max is None
             else torch.broadcast_to(t_max, (n,)).to(torch.float32).contiguous())
    return o.contiguous(), d.contiguous(), active.contiguous(), t_max


def window_prepass(lay: BVHLayout, prepass: int) -> int:
    """Prepass rows the window walk tests: whole 8-row blocks, as the
    reference's window kernel."""
    prepass = min(prepass, lay.prepassbw.shape[0], lay.num_tris)
    return prepass - prepass % 8


# ---------------------------------------------------------------------------
# Kernel D: minwalk, nearest hit on MT rows with the payload resolved in-kernel
# ---------------------------------------------------------------------------

def minwalk_plain(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                  prepass: int = DEFAULT_PREPASS, tally: Tally | None = None):
    """Plain torch version of ``csrc/minwalk.cu`` -> (12, N) float32 rows
    [t, u, v, orig, mat, light+1, pos.xyz, normal.xyz]; t stays at t_max
    where nothing nearer was hit, and such lanes resolve the sentinel row."""
    n = o.shape[1]
    zeros = torch.zeros(n, device=o.device)
    best_t, best_u, best_v = t_max.clone(), zeros.clone(), zeros.clone()
    best_row = torch.full((n,), lay.num_tris, dtype=torch.int64, device=o.device)

    act = active.nonzero()[:, 0]
    if prepass and act.numel():
        rows = lay.prepass[:prepass]
        tt, u, v, ok = mt_rows(rows[None], tuple(c[act][:, None] for c in o),
                           tuple(c[act][:, None] for c in d), t_min)
        bt, br, upd, kmin = latch(tt, ok, best_t[act], best_row[act],
                                   rows[:, 21].to(torch.int64))
        pick = lambda x: x.gather(1, kmin[:, None])[:, 0]  # noqa: E731
        best_u[act] = torch.where(upd, pick(u), best_u[act])
        best_v[act] = torch.where(upd, pick(v), best_v[act])
        best_t[act] = bt
        best_row[act] = br

    def leaf_test(lanes, rowid, valid, best):
        tt, u, v, ok = mt_rows(lay.tris[rowid], tuple(c[lanes][:, None] for c in o),
                           tuple(c[lanes][:, None] for c in d), t_min)
        bt, br, upd, kmin = latch(tt, ok & valid, best[0], best[1], rowid)
        pick = lambda x: x.gather(1, kmin[:, None])[:, 0]  # noqa: E731
        return (bt, br, torch.where(upd, pick(u), best[2]),
                torch.where(upd, pick(v), best[3]))

    walk(o, d, active, lay, t_min, (best_t, best_row, best_u, best_v), leaf_test,
         tally=tally)
    rows = lay.tris[best_row]
    u, v = best_u, best_v
    w0 = 1.0 - u - v
    pos = [rows[:, k] + u * rows[:, k + 3] + v * rows[:, k + 6] for k in range(3)]
    nrm = [rows[:, 10 + k] * w0 + rows[:, 13 + k] * u + rows[:, 16 + k] * v
           for k in range(3)]
    rlen = torch.rsqrt(torch.clamp(nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2],
                                   min=1e-20))
    return torch.stack([best_t, u, v, rows[:, 9], rows[:, 19], rows[:, 20], *pos,
                        *(c * rlen for c in nrm)])


def minwalk(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
            prepass: int = DEFAULT_PREPASS):
    """Nearest hit with the in-kernel payload resolve -> (12, N) float32
    rows (see :func:`minwalk_plain`): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  ``prepass``: leading rows of
    ``lay.prepass`` (MT rows, col 21 = the global row id)."""
    if o.device.type == "cpu":
        return minwalk_plain(o, d, active, t_max, lay, t_min, prepass)
    out = _launch_minwalk(o, d, active, t_max, lay, t_min, prepass)
    launch_count.count(minwalk)
    return out


minwalk.launches = 0


def _launch_minwalk(o, d, active, t_max, lay: BVHLayout, t_min: float, prepass: int):
    """Check the inputs and launch ``tpupt_minwalk`` -> (12, N) float32."""
    n = o.shape[1]
    _check(o, torch.float32, (3, n), "o")
    _check(d, torch.float32, (3, n), "d")
    _check(active, torch.bool, (n,), "active")
    _check(t_max, torch.float32, (n,), "t_max")
    _check_layout(lay, ("nodes_packed", "tris", "prepass"), o.device)
    if not 0 <= prepass <= lay.prepass.shape[0]:
        raise ValueError(f"prepass={prepass} outside [0, {lay.prepass.shape[0]}]")
    out = torch.empty((12, n), dtype=torch.float32, device=o.device)
    rc = load_library().tpupt_minwalk(
        o.data_ptr(), d.data_ptr(), active.data_ptr(), t_max.data_ptr(),
        lay.nodes_packed.data_ptr(), lay.tris.data_ptr(), lay.prepass.data_ptr(), prepass,
        lay.num_nodes, lay.num_tris, t_min, n, out.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    if rc:
        raise RuntimeError(f"minwalk kernel launch failed: cudaError {rc}")
    return out


def intersect_bvh_minwalk(o, d, lay: BVHLayout, t_min: float = 0.0, active=None,
                          t_max=None, prepass: int = DEFAULT_PREPASS) -> HitShade:
    """(3, N) rays -> fully resolved nearest-hit HitShade through the
    minwalk kernel (the reference's ``intersect_bvh_pallas`` with
    ``resolve=True``)."""
    o, d, active, t_max = _nearest_inputs(o, d, active, t_max)
    prepass = min(prepass, lay.prepass.shape[0], lay.num_tris)
    return payload_hit(minwalk(o, d, active, t_max, lay, t_min, prepass), t_max)


# ---------------------------------------------------------------------------
# Kernel E: dense sweep (BW or MT rows), incoherent nearest-hit queries
# ---------------------------------------------------------------------------

SWEEP_CHUNK = 256  # rows per step of the plain version


def sweep_plain(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
                with_orig: bool = False, tritest: str = "bw"):
    """Plain torch version of ``csrc/sweep.cu`` -> (t, row[, orig]): every
    active lane against rows 0 .. num_tris-1 of the ``tritest`` rows in
    ascending order (chunks of rows folded with a first-minimum pick, which
    equals the kernel's sequential strict-< latch)."""
    n = o.shape[1]
    rs = _rows(lay, tritest)
    best_t = t_max.clone()
    best_row = torch.full((n,), lay.num_tris, dtype=torch.int32, device=o.device)
    best_orig = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    act = active.nonzero()[:, 0]
    ol = tuple(c[act][:, None] for c in rs.origin(o))
    dl = tuple(c[act][:, None] for c in d)
    bt, br, bo = best_t[act], best_row[act], best_orig[act]
    for r0 in range(0, lay.num_tris, SWEEP_CHUNK):
        rows = rs.table[r0:min(r0 + SWEEP_CHUNK, lay.num_tris)]
        tt, ok = rs.test(rows[None], ol, dl, t_min)
        ids = torch.arange(r0, r0 + rows.shape[0], dtype=torch.int32, device=o.device)
        bt, br, upd, kmin = latch(tt, ok, bt, br, ids)
        bo = torch.where(upd, rows[:, rs.orig].to(torch.int32)[kmin], bo)
    best_t[act], best_row[act], best_orig[act] = bt, br, bo
    return (best_t, best_row, best_orig) if with_orig else (best_t, best_row)


def sweep(o, d, active, t_max, lay: BVHLayout, t_min: float = 0.0,
          with_orig: bool = False, tritest: str = "bw"):
    """Dense sweep -> (t (N,) f32, row (N,) int32[, orig (N,) int32]): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.  Inputs
    as :func:`window_walk`."""
    if o.device.type == "cpu":
        return sweep_plain(o, d, active, t_max, lay, t_min, with_orig, tritest)
    n = o.shape[1]
    rs = _rows(lay, tritest)
    _check(o, torch.float32, (3, n), "o")
    _check(d, torch.float32, (3, n), "d")
    _check(active, torch.bool, (n,), "active")
    _check(t_max, torch.float32, (n,), "t_max")
    _check_layout(lay, ("tris8" if tritest == "mt" else "tris8bw",), o.device)
    out_t = torch.empty(n, dtype=torch.float32, device=o.device)
    out_row = torch.empty(n, dtype=torch.int32, device=o.device)
    out_orig = torch.empty(n if with_orig else 0, dtype=torch.int32, device=o.device)
    ax, ay, az = lay.anchor
    rc = load_library().tpupt_sweep(
        o.data_ptr(), d.data_ptr(), active.data_ptr(), t_max.data_ptr(),
        rs.table.data_ptr(), ax, ay, az, lay.num_tris, t_min, n,
        int(tritest == "mt"), int(with_orig), out_t.data_ptr(), out_row.data_ptr(),
        out_orig.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    if rc:
        raise RuntimeError(f"sweep kernel launch failed: cudaError {rc}")
    launch_count.count(sweep, mt=tritest == "mt")
    return (out_t, out_row, out_orig) if with_orig else (out_t, out_row)


sweep.launches = sweep.launches_mt = 0


def intersect_bvh_sweep(o, d, lay: BVHLayout, t_min: float = 0.0, active=None,
                        t_max=None, tritest: str = "bw") -> HitShade:
    """(3, N) rays -> fully resolved nearest-hit HitShade through the dense
    sweep and :func:`resolve_window_payload`."""
    o, d, active, t_max = _nearest_inputs(o, d, active, t_max)
    t, row = sweep(o, d, active, t_max, lay, t_min, tritest=tritest)
    return resolve_window_payload(lay, t, row, t_max, o, d)


# ---------------------------------------------------------------------------
# Kernel B: range-capped walk (MT rows), the shadow query
# ---------------------------------------------------------------------------

def capped_walk_plain(o, d, active, cap, lay: BVHLayout, t_min: float = 0.0,
                      tally: Tally | None = None):
    """Plain torch version of ``csrc/capped_walk.cu`` -> (4, N) float32
    rows [t, u, v, orig]; t stays at ``cap`` where nothing nearer was hit."""
    n = o.shape[1]
    best = (cap.clone(),) + tuple(torch.zeros(n, device=o.device) for _ in range(3))

    def leaf_test(lanes, rowid, valid, best):
        rows = lay.tris[rowid]
        tt, u, v, ok = mt_rows(rows, tuple(c[lanes][:, None] for c in o),
                           tuple(c[lanes][:, None] for c in d), t_min)
        bt, orig, upd, kmin = latch(tt, ok & valid, best[0], best[3], rows[..., 9])
        pick = lambda x: x.gather(1, kmin[:, None])[:, 0]  # noqa: E731
        return (bt, torch.where(upd, pick(u), best[1]),
                torch.where(upd, pick(v), best[2]), orig)

    walk(o, d, active, lay, t_min, best, leaf_test, tally=tally)
    return torch.stack(best)


def _launch_capped(o, d, active, cap, lay: BVHLayout, t_min: float):
    """Check the inputs and launch ``tpupt_capped_walk`` -> (4, N) float32."""
    n = o.shape[1]
    _check(o, torch.float32, (3, n), "o")
    _check(d, torch.float32, (3, n), "d")
    _check(active, torch.bool, (n,), "active")
    _check(cap, torch.float32, (n,), "cap")
    _check_layout(lay, ("nodes_packed", "tris"), o.device)
    out = torch.empty((4, n), dtype=torch.float32, device=o.device)
    rc = load_library().tpupt_capped_walk(
        o.data_ptr(), d.data_ptr(), active.data_ptr(), cap.data_ptr(),
        lay.nodes_packed.data_ptr(), lay.tris.data_ptr(), lay.num_nodes, lay.num_tris,
        t_min, n, out.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    if rc:
        raise RuntimeError(f"capped_walk kernel launch failed: cudaError {rc}")
    return out


def capped_walk(o, d, active, cap, lay: BVHLayout, t_min: float = 0.0):
    """Range-capped walk -> (4, N) float32 rows [t, u, v, orig]: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if o.device.type == "cpu":
        return capped_walk_plain(o, d, active, cap, lay, t_min)
    out = _launch_capped(o, d, active, cap, lay, t_min)
    launch_count.count(capped_walk)
    return out


capped_walk.launches = 0


def intersect_bvh_capped(o, d, lay: BVHLayout, active, t_max,
                         t_min: float = 0.0) -> HitShade:
    """Range-capped nearest hit (shadow rays): t (inf at or beyond the cap),
    u, v and the original triangle id; no shading payload."""
    n = o.shape[1]
    cap = torch.broadcast_to(t_max, (n,)).to(torch.float32).contiguous()
    out = capped_walk(o.contiguous(), d.contiguous(), active.contiguous(), cap,
                      lay, t_min)
    return HitShade(t=torch.where(out[0] < cap, out[0], torch.inf), u=out[1],
                    v=out[2], tri=out[3].to(torch.int64), mat=None, light=None,
                    pos=None, normal=None)


# ---------------------------------------------------------------------------
# Kernel C: any-hit occlusion walk (MT rows), the env-lit shadow query
# ---------------------------------------------------------------------------

def anyhit_walk_plain(o, d, active, cap, target, lay: BVHLayout, eps: float,
                      t_min: float = 0.0, tally: Tally | None = None):
    """Plain torch version of ``csrc/anyhit_walk.cu`` -> (N,) uint8 clear
    mask: ``target >= 0 ? (target hit and no occluder) : no occluder``, 0 on
    inactive lanes.  Occluders are non-target hits nearer than
    ``cap - 4*eps``; the target counts when ``eps <= t < cap``."""
    n = o.shape[1]
    # float32 constants, as the kernel receives them
    eps32 = torch.tensor(eps, dtype=torch.float32, device=o.device)
    thresh = cap - torch.tensor(4.0 * eps, dtype=torch.float32, device=o.device)
    best = (cap.clone(), torch.zeros(n, dtype=torch.bool, device=o.device),
            torch.zeros(n, dtype=torch.bool, device=o.device))

    def leaf_test(lanes, rowid, valid, best):
        rows = lay.tris[rowid]
        tt, _, _, ok = mt_rows(rows, tuple(c[lanes][:, None] for c in o),
                           tuple(c[lanes][:, None] for c in d), t_min)
        acc = ok & valid
        is_tgt = rows[..., 9].to(torch.int32) == target[lanes][:, None]
        c = cap[lanes][:, None]
        occ = (acc & ~is_tgt & (tt < thresh[lanes][:, None])).any(dim=1)
        tgt = (acc & is_tgt & (tt >= eps32) & (tt < c)).any(dim=1)
        return best[0], best[1] | occ, best[2] | tgt

    walk(o, d, active, lay, t_min, best, leaf_test, stop=best[1], tally=tally)
    _, occ, tgt = best
    clear = active & torch.where(target >= 0, tgt & ~occ, ~occ)
    return clear.to(torch.uint8)


def _launch_anyhit(o, d, active, cap, target, lay: BVHLayout, eps: float, t_min: float):
    """Check the inputs and launch ``tpupt_anyhit_walk`` -> (N,) uint8."""
    n = o.shape[1]
    _check(o, torch.float32, (3, n), "o")
    _check(d, torch.float32, (3, n), "d")
    _check(active, torch.bool, (n,), "active")
    _check(cap, torch.float32, (n,), "cap")
    _check(target, torch.int32, (n,), "target")
    _check_layout(lay, ("nodes_packed", "tris"), o.device)
    out = torch.empty(n, dtype=torch.uint8, device=o.device)
    rc = load_library().tpupt_anyhit_walk(
        o.data_ptr(), d.data_ptr(), active.data_ptr(), cap.data_ptr(), target.data_ptr(),
        lay.nodes_packed.data_ptr(), lay.tris.data_ptr(), lay.num_nodes, t_min, eps,
        4.0 * eps, n, out.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    if rc:
        raise RuntimeError(f"anyhit_walk kernel launch failed: cudaError {rc}")
    return out


def anyhit_walk(o, d, active, cap, target, lay: BVHLayout, eps: float,
                t_min: float = 0.0):
    """Any-hit clear mask -> (N,) uint8: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.

    ``o``/``d``: (3, N) float32; ``active``: (N,) bool; ``cap``: (N,)
    float32 range cap; ``target``: (N,) int32 original triangle id of the
    sampled light, -1 for environment samples."""
    if o.device.type == "cpu":
        return anyhit_walk_plain(o, d, active, cap, target, lay, eps, t_min)
    out = _launch_anyhit(o, d, active, cap, target, lay, eps, t_min)
    launch_count.count(anyhit_walk)
    return out


anyhit_walk.launches = 0


def occlusion_clear_anyhit(o, d, lay: BVHLayout, active, t_max, target,
                           eps: float, t_min: float = 0.0) -> torch.Tensor:
    """Shadow visibility through the any-hit walk -> (N,) bool ``clear``
    (False on inactive lanes).  ``target``: the sampled light's original
    triangle id, or -1 for environment samples (clear iff nothing is hit)."""
    n = o.shape[1]
    cap = torch.broadcast_to(t_max, (n,)).to(torch.float32).contiguous()
    clear = anyhit_walk(o.contiguous(), d.contiguous(), active.contiguous(), cap,
                        target.to(torch.int32).contiguous(), lay, eps, t_min)
    return clear.to(torch.bool)


def fused_clear(ts, origs, sok, scap, target, eps: float):
    """The shadow half of the fused walk -> (N,) bool clear: live, and the
    nearest hit inside the cap is the target light triangle (nothing hit
    for target -1) -- pallas_traverse.py's fused rule, gather-free from the
    latched original id."""
    s_hit = ts < scap  # a nearest hit latched inside the range cap
    return sok & torch.where(target >= 0, s_hit & (ts >= eps) & (origs == target),
                             ~s_hit)


def make_cuda_intersector(lay: BVHLayout, lay_occl: BVHLayout | None = None,
                          t_min: float = 0.0, prepass: int = DEFAULT_PREPASS,
                          anyhit: bool = False, eps: float = 1e-4,
                          kernel: str = "window", hbm: bool = False,
                          tritest: str = "bw"):
    """The frame's intersection callable, ``fn(o, d, active, t_max=None,
    coherent=False) -> HitShade`` (the contract of the reference's
    ``make_pallas_intersector``, routed as it routes).  ``tritest`` picks
    the leaf rows of the window walk and the sweep ("bw" or "mt").

    The whole-table route (``hbm`` False): ``t_max``-capped queries take the
    capped walk on ``lay_occl`` (the small-leaf shadow layout; ``lay`` when
    None); nearest-hit queries on ``lay`` take, by ``kernel``
    (cfg.traversal_kernel):

    * ``"window"``: the window walk;
    * ``"minwalk"``: the minwalk kernel (MT rows, payload in-kernel);
    * ``"sweep"``: the dense sweep for incoherent queries, the window walk
      for ``coherent`` ones (camera rays).

    The HBM route (``hbm``, render/wavefront.py:make_intersector picks it
    for scenes past the table budget): every query takes the window walk on
    ``lay`` through :func:`window_walk_hbm` -- nearest hits as above with
    ``minwalk`` and ``sweep`` giving way, capped queries with ``t_max`` as
    the best_t seed, the prepass, and the capped epilogue's t, u, v and
    original id, the rest of the payload unresolved (``resolve=False``) --
    and there is no any-hit hook.  ``fn`` takes the frame's trace
    (render/timing.py:FrameTrace.intersector passes it on this route): each
    query counts in its ``hbm_walks``, and a capped query's HitShade is
    built in its "resolve" span.

    ``fn.fused(o, d, alive, sdir, sok, scap, target) -> (HitShade, clear)``
    is the fused path+shadow walk (cfg.fuse_shadow_walk): one 2N-lane launch
    of the window walk with the original-id latch (the sweep's, with
    ``kernel="sweep"`` off the HBM route) serves the bounce's nearest hit and
    the previous bounce's shadow query from the same origins.  The TPU
    interleaved the two halves in half-tile blocks so each tile's union
    stayed small; a thread walks its own lane, so ``[path | shadow]``
    concatenated gives the same per-lane results.  ``clear``: the nearest
    hit inside the cap must be the target light triangle (no hit at all for
    target -1), as :func:`render.wavefront.occlusion_clear`.

    With ``anyhit`` (off the HBM route), ``fn.occlusion(o, d, active, t_max,
    target) -> clear`` answers shadow queries through the any-hit walk on
    the same shadow layout (render/wavefront.py:occlusion_clear uses it when
    present).  ``fn.hbm`` records the route."""
    if kernel not in ("window", "minwalk", "sweep"):
        raise ValueError(f"kernel={kernel!r}: expected window, minwalk or sweep")
    _rows(lay, tritest)  # validates tritest
    occl = lay_occl if lay_occl is not None else lay
    use_sweep = kernel == "sweep" and not hbm

    def fn(o, d, active, t_max=None, coherent=False, trace=None):
        if hbm and trace is not None:
            trace.hbm_walks += 1
        if t_max is not None:
            if hbm:
                return intersect_bvh_window(o, d, lay, t_min, active, t_max=t_max,
                                            prepass=prepass, tritest=tritest,
                                            hbm=True, resolve=False, trace=trace)
            return intersect_bvh_capped(o, d, occl, active, t_max, t_min)
        if kernel == "minwalk" and not hbm:
            return intersect_bvh_minwalk(o, d, lay, t_min, active, prepass=prepass)
        if use_sweep and not coherent:
            return intersect_bvh_sweep(o, d, lay, t_min, active, tritest=tritest)
        return intersect_bvh_window(o, d, lay, t_min, active, prepass=prepass,
                                    tritest=tritest, hbm=hbm)

    def fused(o, d, alive, sdir, sok, scap, target):
        n = o.shape[1]
        inf = torch.full((n,), torch.inf, device=o.device)
        scap = torch.broadcast_to(scap, (n,)).to(torch.float32)
        o2 = torch.cat([o, o], dim=1).contiguous()
        d2 = torch.cat([d, sdir], dim=1).contiguous()
        act2 = torch.cat([alive, sok]).contiguous()
        cap2 = torch.cat([inf, scap]).contiguous()
        if use_sweep:
            t2, row2, orig2 = sweep(o2, d2, act2, cap2, lay, t_min, with_orig=True,
                                    tritest=tritest)
        else:
            t2, row2, orig2 = window_walk_orig(o2, d2, act2, cap2, lay, t_min,
                                               window_prepass(lay, prepass), tritest)
        hit = resolve_window_payload(lay, t2[:n], row2[:n], inf, o.contiguous(),
                                     d.contiguous())
        return hit, fused_clear(t2[n:], orig2[n:], sok, scap, target, eps)

    fn.fused = fused
    fn.hbm = hbm
    if anyhit and not hbm:
        def occlusion(o, d, active, t_max, target):
            return occlusion_clear_anyhit(o, d, occl, active, t_max, target,
                                          eps, t_min)

        fn.occlusion = occlusion
    return fn


# the most lane planes a walk kernel indexes with one int32 offset: the 12
# payload rows of minwalk and the window walk's epilogue
# (csrc/walk_common.cuh:write_payload)
MAX_PLANES = 12


def _check(t: torch.Tensor, dtype, shape, name: str) -> None:
    if MAX_PLANES * t.shape[-1] >= 2 ** 31:
        raise ValueError(f"{name}: {t.shape[-1]} lanes overflow the kernels' "
                         "int32 plane offsets")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _check_layout(lay: BVHLayout, names, device) -> None:
    for name in names:
        t = getattr(lay, name)
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"layout.{name}: expected a contiguous, 16-byte "
                             f"aligned tensor on {device}")
