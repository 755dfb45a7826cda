"""Stackless BVH traversal in plain torch.

The port of ``tpu_pathtracer/ops/traverse.py``: the portable walker
(:func:`intersect_bvh`, the reference's ``use_pallas=False`` backend) over
the DFS-threaded layout (accel/layout.py), and the arithmetic it shares with
the plain versions of the CUDA kernels (ops/hopper_traverse.py).  Every ray
carries a single node pointer: hit an internal node -> ``node + 1`` (DFS
first child), otherwise -> the node's escape link.  No per-ray stack.

The walker is plain torch because the reference's is plain JAX; only
``RenderConfig(use_pallas=False)`` (the CLI's ``--no-pallas``) selects it,
and it never stands in for a kernel.  ``Hit.tri`` is reported in ORIGINAL
triangle indexing.
"""

from __future__ import annotations

import torch

from ..accel.layout import BVHLayout
from .intersect import Hit, shade_from_scene

TINY = 1e-30


def safe_inverse(dx, dy, dz):
    """Component inverses, nudging |x| < 1e-30 to +-1e-30 so 0 * inf never
    makes NaNs in the slab test."""
    def inv(x):
        return 1.0 / torch.where(torch.abs(x) < TINY,
                                 torch.where(x < 0, -TINY, TINY), x)
    return inv(dx), inv(dy), inv(dz)


def latch(tt, ok, best_t, best_id, ids):
    """Fold (L, K) candidate rows into per-lane bests: the first of the
    minimal accepted t, if it beats best_t (a sequential strict-< latch)."""
    ttm = torch.where(ok, tt, torch.inf)
    tmin, kmin = torch.min(ttm, dim=1)
    upd = tmin < best_t
    pick = ids.gather(1, kmin[:, None])[:, 0] if ids.dim() == 2 else ids[kmin]
    return torch.where(upd, tmin, best_t), torch.where(upd, pick, best_id), upd, kmin


def _slab(rows, o, inv, t_min, best_t):
    """(L, 8) node rows against L rays -> hit_box (L,)."""
    t0x = (rows[:, 0] - o[0]) * inv[0]
    t1x = (rows[:, 3] - o[0]) * inv[0]
    t0y = (rows[:, 1] - o[1]) * inv[1]
    t1y = (rows[:, 4] - o[1]) * inv[1]
    t0z = (rows[:, 2] - o[2]) * inv[2]
    t1z = (rows[:, 5] - o[2]) * inv[2]
    enter = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.minimum(t0z, t1z),
    )
    exit_ = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z),
    )
    return (enter <= exit_) & (exit_ > t_min) & (enter < best_t)


def mt_rows(rows, o, d, t_min):
    """Moller-Trumbore rows (..., 24) [p0, e1, e2, orig, ...] against
    broadcastable rays (3-tuples) -> (t, u, v, ok), in _mt_row's order."""
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * rows[..., 8] - dz * rows[..., 7]
    py = dz * rows[..., 6] - dx * rows[..., 8]
    pz = dx * rows[..., 7] - dy * rows[..., 6]
    det = rows[..., 3] * px + rows[..., 4] * py + rows[..., 5] * pz
    nz = det != 0.0
    inv = torch.where(nz, 1.0 / det, 0.0)
    tx = ox - rows[..., 0]
    ty = oy - rows[..., 1]
    tz = oz - rows[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * rows[..., 5] - tz * rows[..., 4]
    qy = tz * rows[..., 3] - tx * rows[..., 5]
    qz = tx * rows[..., 4] - ty * rows[..., 3]
    v = (dx * qx + dy * qy + dz * qz) * inv
    tt = (rows[..., 6] * qx + rows[..., 7] * qy + rows[..., 8] * qz) * inv
    ok = nz & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > t_min)
    return tt, u, v, ok


class Tally:
    """The work of the walks handed this tally, summed over them: node
    visits and leaf-row tests over lanes, and bool masks of the distinct
    nodes and leaf rows read (None until a lane walks)."""

    def __init__(self):
        self.visits = self.tests = 0
        self.nodes = self.rows = None


def walk(o, d, active, lay: BVHLayout, t_min, best, leaf_test, stop=None,
         tally: Tally | None = None):
    """The stackless DFS walk of the portable walker and the kernels' plain
    versions: every running lane one node per step.

    ``best``: per-lane tensors whose first entry is best_t; ``leaf_test(lanes,
    rowid, valid, best)`` folds one leaf's rows (L, max_leaf) into ``best``
    for the given lanes and returns the updated per-lane tuple.  ``stop``:
    one of the ``best`` tensors (bool); a lane whose entry turns true ends
    its walk after that node.  ``tally``: when given, receives the work the
    walk did (:class:`Tally`), which is the work a kernel does on the same
    inputs."""
    if tally is not None and tally.nodes is None:
        tally.nodes = torch.zeros(lay.num_nodes, dtype=torch.bool, device=o.device)
        tally.rows = torch.zeros(lay.num_tris, dtype=torch.bool, device=o.device)
    lanes = active.nonzero()[:, 0]
    inv = safe_inverse(d[0], d[1], d[2])
    inv = torch.stack(inv)
    cur = torch.zeros(o.shape[1], dtype=torch.int64, device=o.device)
    k = torch.arange(lay.max_leaf, device=o.device)
    while lanes.numel():
        c = cur[lanes]
        if tally is not None:
            tally.visits += lanes.numel()
            tally.nodes[c] = True
        hit = _slab(lay.nodes[c], o[:, lanes], inv[:, lanes], t_min, best[0][lanes])
        meta = lay.nodes_meta[c]
        count = meta[:, 1] & 63
        leaf = hit & (count > 0)
        if bool(leaf.any()):
            leaf_lanes = lanes[leaf]
            rowid = (meta[leaf, 1] >> 6).to(torch.int64)[:, None] + k[None]
            valid = k[None] < count[leaf][:, None]
            rowid = torch.where(valid, rowid, lay.num_tris)  # zero row: no hit
            if tally is not None:
                tally.tests += int(valid.sum())
                tally.rows[rowid[valid]] = True
            new = leaf_test(leaf_lanes, rowid, valid,
                            tuple(b[leaf_lanes] for b in best))
            for b, nb in zip(best, new):
                b[leaf_lanes] = nb
        nxt = torch.where(hit & (count == 0), c + 1, meta[:, 0].to(torch.int64))
        if stop is not None:
            nxt = torch.where(stop[lanes], lay.num_nodes, nxt)
        cur[lanes] = nxt
        lanes = lanes[nxt < lay.num_nodes]


def intersect_bvh(o, d, lay: BVHLayout, t_min: float = 0.0, active=None) -> Hit:
    """Nearest-hit walk -> :class:`Hit`.  ``o``/``d``: (3, N) rays;
    ``active``: (N,) bool lanes to trace (the others return a miss without
    walking).  Leaf rows are tested with Moller-Trumbore on ``lay.tris``
    (p0, e1, e2), the winner latched with strict ``<`` in visit order, and
    u/v recomputed against the winning row, as the reference's
    ``finalize_hit``."""
    n = o.shape[1]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=o.device)
    best = (torch.full((n,), torch.inf, device=o.device),
            torch.zeros(n, dtype=torch.int64, device=o.device))

    def leaf_test(lanes, rowid, valid, best):
        tt, _, _, ok = mt_rows(lay.tris[rowid], tuple(c[lanes][:, None] for c in o),
                               tuple(c[lanes][:, None] for c in d), t_min)
        bt, br, _, _ = latch(tt, ok & valid, best[0], best[1], rowid)
        return bt, br

    walk(o, d, active, lay, t_min, best, leaf_test)
    best_t, best_i = best
    _, u, v, _ = mt_rows(lay.tris[best_i], tuple(o), tuple(d), t_min)
    return Hit(t=best_t, tri=lay.sorted_to_orig[best_i].to(torch.int64), u=u, v=v)


def make_bvh_intersector(lay: BVHLayout, scene, t_min: float = 0.0):
    """The portable walker as the frame's intersection callable (the
    reference's ``make_bvh_intersector``): ``t_max`` and ``coherent`` are
    performance hints it does not need."""
    def fn(o, d, active, t_max=None, coherent=False):
        del t_max, coherent
        return shade_from_scene(scene, intersect_bvh(o, d, lay, t_min, active))

    return fn
