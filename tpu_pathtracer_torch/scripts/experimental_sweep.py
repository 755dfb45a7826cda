"""Candidate-sweep kernels: split traversal by per-ray leaf-candidate count.

The counterpart of the reference's ``scripts/experimental_pallas_sweep.py``
(``_count_kernel`` via ``sweep_count``, ``_mt1_kernel`` via
``intersect_sweep1``), on ``csrc/candidate_sweep.cu``.

The idea under test: the big-triangle prepass primes ``best_t``, and the
segment ``[t_min, prime_t)`` of most rays then crosses few leaf boxes.  A
box sweep with no tree walk (every lane against every leaf AABB of
``BVHLayout.leafbox``) classifies rays by that candidate count.  A ray with
at most one candidate needs the Moller-Trumbore test of that one leaf only
(:func:`intersect_sweep1`); only the rays with more candidates need the full
window walk.  The results equal the walk's: after the prime, the candidate
set is the set of leaves the walk could test, and both test a leaf's rows
in ascending order with a strict ``<`` latch.

* :func:`sweep_count` -> ``(count, first_leaf)`` int32 per ray: the leaf
  AABBs crossed by ``[t_min, prime_t)`` and the lowest such row of
  ``lay.leafbox`` (``lay.num_leaves`` when none);
* :func:`intersect_sweep1` -> ``(raw, t_max_arr)``: the prime plus the
  Moller-Trumbore test of the lowest candidate leaf; ``raw`` holds the
  reference's raw rows ``[t, u, v, row, orig]`` as :class:`SweepRaw` (the
  reference's three zero pad rows, there to fill an 8-row TPU tile, are
  gone; ``row`` and ``orig`` are int32 where the reference codes them in
  float32).  Resolve with ``resolve_window_payload(lay, raw[0], raw[3],
  t_max_arr, o, d)``.  A lane with several candidates still gets only its
  lowest leaf tested, as in the reference: callers select the lanes with
  ``count <= 1`` through ``active``.

The composition (count, then the targeted kernel on the ``count <= 1``
lanes, then the MT window walk on the rest) is not a function of the
package, as it is none of the reference's: it lives in
``tests/test_torch_sweep_tools.py`` and in a phase of ``chip_smoke.py``.

Both wrappers launch their CUDA kernels for CUDA tensors (counting the
launches in ``.launches``: one for the count, :data:`SWEEP1_LAUNCHES` for the
targeted kernel) or raise; CPU tensors take the plain versions
(:func:`sweep_count_plain`, :func:`intersect_sweep1_plain`), which keep the
kernels' operation order: the prime and the leaf's rows fold in with a
first-minimum pick, which equals the kernels' sequential strict-``<`` latch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.layout import BVHLayout
from ..ops import launch_count
from ..ops.cuda_build import load_library
from ..ops.hopper_traverse import (DEFAULT_PREPASS, _check, _check_layout,
                                   _nearest_inputs, window_prepass)
from ..ops.traverse import Tally, _slab, latch, mt_rows, safe_inverse
from .dense_march import compact_shape, march_shape

LEAF_CHUNK = 256  # leaf boxes per step of the plain versions
COUNT_TILE = 512  # lanes a block of the count kernel covers
K_LANES = 4       # the count kernel's lanes a thread (csrc/candidate_sweep.cu:kCountK)
BOX_BYTES = 32    # a leaf box as both kernels stage it: one leafbox row
PRE_BYTES = 48    # a prepass row as both kernels stage it: cols 0-11
SWEEP1_THREADS = 512  # threads a block of the targeted kernel's march: the
                      # fastest of 128-512 on whole wavefronts (PERF.md section 6)
SWEEP1_K = 2      # its list entries a thread (csrc/candidate_sweep.cu:kSweep1K)
SWEEP1_LAUNCHES = 3  # the targeted kernel's launches a call: tally, list, march


class SweepRaw(NamedTuple):
    """The targeted kernel's raw rows, indexable as the reference's
    ``raw[k]``."""
    t: torch.Tensor     # (N,) float32; t_max where nothing nearer was hit
    u: torch.Tensor     # (N,) float32
    v: torch.Tensor     # (N,) float32
    row: torch.Tensor   # (N,) int32 row of tris8 (num_tris on a miss)
    orig: torch.Tensor  # (N,) int32 original triangle id (0 on a miss)


def _lane_columns(x, lanes):
    """(3, N) -> three (L, 1) columns of the given lanes."""
    return tuple(c[lanes][:, None] for c in x)


def _prime(ol, dl, rows, t_min, best):
    """The big-triangle prepass over ``rows`` of ``lay.prepass`` -> best
    ``(t, u, v, row, orig)`` per lane; the winning row's col 21 (its global
    row id) lands in ``row``, col 9 in ``orig``."""
    if not rows.shape[0]:
        return best
    tt, u, v, ok = mt_rows(rows[None], ol, dl, t_min)
    bt, brow, upd, kmin = latch(tt, ok, best[0], best[3], rows[:, 21].to(torch.int32))
    pick = lambda x: x.gather(1, kmin[:, None])[:, 0]  # noqa: E731
    return (bt, torch.where(upd, pick(u), best[1]), torch.where(upd, pick(v), best[2]),
            brow, torch.where(upd, rows[:, 9].to(torch.int32)[kmin], best[4]))


def _leaf_candidates(ol, dl, lay: BVHLayout, t_min, best_t):
    """Every lane against every leaf AABB -> (count, first) int32 per lane:
    the boxes entered before ``best_t`` and left after ``t_min``, and the
    lowest such row (``num_leaves`` when none).  The pad rows past
    ``num_leaves`` can never pass, so the sweep stops there."""
    il = safe_inverse(*dl)
    n = best_t.shape[0]
    count = torch.zeros(n, dtype=torch.int32, device=best_t.device)
    first = torch.full((n,), lay.num_leaves, dtype=torch.int32, device=best_t.device)
    for j0 in range(0, lay.num_leaves, LEAF_CHUNK):
        rows = lay.leafbox[j0:min(j0 + LEAF_CHUNK, lay.num_leaves)]
        hit = _slab(rows, ol, il, t_min, best_t[:, None])          # (L, K)
        count += hit.sum(1).to(torch.int32)
        ids = torch.arange(j0, j0 + rows.shape[0], dtype=torch.int32,
                           device=best_t.device)
        cand = torch.where(hit, ids[None], lay.num_leaves).min(dim=1).values
        first = torch.minimum(first, cand.to(torch.int32))
    return count, first


def _fresh_best(lanes, t_max, lay: BVHLayout):
    """The best record a lane starts from: (t_max, 0, 0, num_tris, 0)."""
    n = lanes.shape[0]
    zf = torch.zeros(n, device=t_max.device)
    return (t_max[lanes], zf, zf.clone(),
            torch.full((n,), lay.num_tris, dtype=torch.int32, device=t_max.device),
            torch.zeros(n, dtype=torch.int32, device=t_max.device))


def sweep_count_plain(o, d, lay: BVHLayout, active=None, t_min: float = 0.0,
                      prepass: int = DEFAULT_PREPASS):
    """Plain torch version of ``tpupt_sweep_count`` -> (count, first_leaf)
    int32; inactive lanes get (0, num_leaves)."""
    o, d, active, t_max = _nearest_inputs(o, d, active, None)
    n = o.shape[1]
    lanes = active.nonzero()[:, 0]
    ol, dl = _lane_columns(o, lanes), _lane_columns(d, lanes)
    best = _prime(ol, dl, lay.prepass[:window_prepass(lay, prepass)], t_min,
                  _fresh_best(lanes, t_max, lay))
    count = torch.zeros(n, dtype=torch.int32, device=o.device)
    first = torch.full((n,), lay.num_leaves, dtype=torch.int32, device=o.device)
    count[lanes], first[lanes] = _leaf_candidates(ol, dl, lay, t_min, best[0])
    return count, first


def _count_inputs(o, d, lay: BVHLayout, active):
    o, d, active, _ = _nearest_inputs(o, d, active, None)
    n = o.shape[1]
    _check(o, torch.float32, (3, n), "o")
    _check(d, torch.float32, (3, n), "d")
    _check(active, torch.bool, (n,), "active")
    _check_layout(lay, ("leafbox", "prepass"), o.device)
    return o, d, active, n


def sweep_count(o, d, lay: BVHLayout, active=None, t_min: float = 0.0,
                prepass: int = DEFAULT_PREPASS):
    """(count, first_leaf) int32 per ray: the leaf AABBs crossed by
    ``[t_min, prime_t)``, and the lowest of them as a row of ``lay.leafbox``
    (``lay.num_leaves`` when none).  The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    ``o``/``d``: (3, N) float32; ``active``: (N,) bool or None for every
    lane; ``prepass``: leading rows of ``lay.prepass`` that prime best_t
    (clamped to whole 8-row blocks, as the window walk's)."""
    if o.device.type == "cpu":
        return sweep_count_plain(o, d, lay, active, t_min, prepass)
    o, d, active, n = _count_inputs(o, d, lay, active)
    pp = window_prepass(lay, prepass)
    shape = march_shape(n, COUNT_TILE, K_LANES, lay.num_leaves, BOX_BYTES, pp * PRE_BYTES)
    count = torch.empty(n, dtype=torch.int32, device=o.device)
    first = torch.empty(n, dtype=torch.int32, device=o.device)
    rc = load_library().tpupt_sweep_count(
        o.data_ptr(), d.data_ptr(), active.data_ptr(), lay.leafbox.data_ptr(),
        lay.prepass.data_ptr(), pp, lay.num_leaves, t_min, COUNT_TILE, shape.blocks,
        shape.threads, shape.passes, shape.tile_rows, shape.smem, n, count.data_ptr(),
        first.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    if rc:
        raise RuntimeError(f"sweep_count kernel launch failed: cudaError {rc}")
    launch_count.count(sweep_count)
    return count, first


sweep_count.launches = 0


def intersect_sweep1_plain(o, d, lay: BVHLayout, active=None, t_min: float = 0.0,
                           prepass: int = DEFAULT_PREPASS, t_max=None,
                           tally: Tally | None = None):
    """Plain torch version of ``tpupt_sweep1`` -> (:class:`SweepRaw`,
    t_max_arr); inactive lanes get (t_max, 0, 0, num_tris, 0).  ``tally``:
    when given, its ``tests`` receives the leaf rows tested (the prime's
    rows not included) and its ``visits`` the leaf boxes a sweep that ends
    at its lowest candidate tests: first + 1 on a lane that has one, every
    leaf on a lane that has none."""
    o, d, active, t_max = _nearest_inputs(o, d, active, t_max)
    lanes = active.nonzero()[:, 0]
    ol, dl = _lane_columns(o, lanes), _lane_columns(d, lanes)
    best = _prime(ol, dl, lay.prepass[:window_prepass(lay, prepass)], t_min,
                  _fresh_best(lanes, t_max, lay))
    _, first = _leaf_candidates(ol, dl, lay, t_min, best[0])
    # the Moller-Trumbore test of the lowest candidate leaf's rows of tris8
    has = (first < lay.num_leaves).nonzero()[:, 0]
    if tally is not None:
        tally.visits += int(torch.clamp(first.to(torch.int64) + 1, max=lay.num_leaves).sum())
    if has.numel():
        meta = lay.leafmeta[first[has].to(torch.int64)]
        k = torch.arange(lay.max_leaf, device=o.device)
        valid = k[None] < meta[:, 1:2]
        rowid = torch.where(valid, meta[:, 0:1].to(torch.int64) + k[None], lay.num_tris)
        if tally is not None:
            tally.tests += int(valid.sum())
        rows = lay.tris8[rowid]
        tt, u, v, ok = mt_rows(rows, tuple(c[has] for c in ol), tuple(c[has] for c in dl),
                               t_min)
        bt, brow, upd, kmin = latch(tt, ok & valid, best[0][has], best[3][has],
                                    rowid.to(torch.int32))
        pick = lambda x: x.gather(1, kmin[:, None])[:, 0]  # noqa: E731
        new = (bt, torch.where(upd, pick(u), best[1][has]),
               torch.where(upd, pick(v), best[2][has]), brow,
               torch.where(upd, pick(rows[..., 9]).to(torch.int32), best[4][has]))
        for b, nb in zip(best, new):
            b[has] = nb
    raw = _fresh_best(torch.arange(o.shape[1], device=o.device), t_max, lay)
    for r, b in zip(raw, best):
        r[lanes] = b
    return SweepRaw(*raw), t_max


def _sweep1_inputs(o, d, lay: BVHLayout, active, t_max):
    o, d, active, t_max = _nearest_inputs(o, d, active, t_max)
    n = o.shape[1]
    _check(o, torch.float32, (3, n), "o")
    _check(d, torch.float32, (3, n), "d")
    _check(active, torch.bool, (n,), "active")
    _check(t_max, torch.float32, (n,), "t_max")
    _check_layout(lay, ("leafbox", "leafmeta", "tris8", "prepass"), o.device)
    outs = ([torch.empty(n, dtype=torch.float32, device=o.device) for _ in range(3)]
            + [torch.empty(n, dtype=torch.int32, device=o.device) for _ in range(2)])
    return o, d, active, t_max, n, outs


def intersect_sweep1(o, d, lay: BVHLayout, active=None, t_min: float = 0.0,
                     prepass: int = DEFAULT_PREPASS, t_max=None):
    """Nearest hit for rays with at most one candidate leaf (``active``
    selects them): the prepass prime plus the Moller-Trumbore test of the
    lowest candidate leaf -> (:class:`SweepRaw`, t_max_arr).  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  ``t_max``:
    None (unbounded) or a best_t seed broadcastable to (N,).  The kernel
    lists the active lanes on the card and marches only those
    (``scripts/dense_march.py:compact_shape``), in three launches, each
    counted."""
    if o.device.type == "cpu":
        return intersect_sweep1_plain(o, d, lay, active, t_min, prepass, t_max)
    o, d, active, t_max, n, outs = _sweep1_inputs(o, d, lay, active, t_max)
    pp = window_prepass(lay, prepass)
    shape = compact_shape(n, SWEEP1_THREADS, SWEEP1_K, lay.num_leaves, BOX_BYTES,
                          pp * PRE_BYTES)
    scratch = torch.empty(shape.blocks + 2 + n, dtype=torch.int32, device=o.device)
    rc = load_library().tpupt_sweep1(
        o.data_ptr(), d.data_ptr(), active.data_ptr(), t_max.data_ptr(),
        lay.leafbox.data_ptr(), lay.leafmeta.data_ptr(), lay.tris8.data_ptr(),
        lay.prepass.data_ptr(), pp, lay.num_leaves, lay.num_tris, t_min, shape.threads,
        shape.tile_rows, shape.smem, n, scratch.data_ptr(), *(x.data_ptr() for x in outs),
        torch.cuda.current_stream(o.device).cuda_stream)
    if rc:
        raise RuntimeError(f"sweep1 kernel launch failed: cudaError {rc}")
    launch_count.count(intersect_sweep1, SWEEP1_LAUNCHES)
    return SweepRaw(*outs), t_max


intersect_sweep1.launches = 0
