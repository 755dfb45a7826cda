"""DFS-threaded BVH layout.

The port of ``tpu_pathtracer/accel/layout.py:dfs_layout`` (host-side numpy,
one-shot at scene load — the analog of the reference's startup ``rebuild``,
renderer/Renderer.mm:456-462).  It renumbers the leaf-collapsed tree in DFS
preorder, so ``first_child == node + 1`` and every ``miss`` (escape) link
points forward; the sentinel M means done.  That is all a per-thread
stackless walk needs: enter a hit internal node at ``node + 1``, otherwise
follow its ``miss`` link.

Tables (identical to the reference's; integer fields in float tables are
exact small floats):

  * ``nodes`` (M, 8) f32 [bmin.xyz, bmax.xyz, pad2] and ``nodes_meta`` (M, 2)
    i32 [miss, first_tri*64 + tri_count] (tri_count 0 = internal node);
  * ``tris`` (T+1, 24) f32 [p0.xyz, e1.xyz, e2.xyz, orig_id, n0.xyz, n1.xyz,
    n2.xyz, material_id, light_index+1, leaf_id, pad2], rows in DFS leaf
    order, plus an all-zero miss row at T;
  * ``prepass`` (64, 24): the largest-area rows, col 21 = their row index;
  * ``tris8bw`` (T8, 16) / ``prepassbw`` (64, 16) Baldwin-Weber plane rows
    [n0 d0 | n1 d1 | n2 d2 | leaf_id, orig_id, pad2] anchored at ``anchor``
    (the scene-AABB centre; col 12 of ``prepassbw`` is the row index);
  * ``tris8`` (T8, 24): ``tris`` padded with zero rows to a multiple of 8
    plus 72, col 21 = the DFS leaf id owning the row: the Moller-Trumbore
    rows of the window walk and the sweep with ``tritest="mt"``;
  * ``nodes8`` / ``meta4``: the TPU window kernel's padded node tables
    (the same rows as ``nodes``/``nodes_meta`` plus ``tri_start``), kept so
    the layout round-trips with the reference's (and its byte counts,
    render/wavefront.py:layout_vmem_bytes, match);
  * ``leafbox`` (L16, 8) f32 [bmin.xyz, bmax.xyz, pad2] / ``leafmeta``
    (L16, 4) i32 [first_tri, tri_count, dfs_node_id, 0]: one row per leaf in
    DFS order, padded to a multiple of 16 rows, for the candidate-sweep
    kernels (scripts/experimental_sweep.py); ``num_leaves`` counts the real
    rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .native import BVH

MAX_LEAF = 63  # tri_count field width (6 bits)
PREPASS_MAX = 64  # rows in the big-triangle pre-pass block

# (field, kind) of every table; "i" tables are int32, "f" float32.
_TABLES = (
    ("nodes", "f"), ("nodes_meta", "i"), ("tris", "f"), ("sorted_to_orig", "i"),
    ("prepass", "f"), ("nodes8", "f"), ("meta4", "i"), ("tris8", "f"),
    ("tris8bw", "f"), ("prepassbw", "f"), ("leafbox", "f"), ("leafmeta", "i"),
)


class BVHLayout(NamedTuple):
    nodes: torch.Tensor           # (M, 8) float32
    nodes_meta: torch.Tensor      # (M, 2) int32
    tris: torch.Tensor            # (T+1, 24) float32
    sorted_to_orig: torch.Tensor  # (T,) int32
    prepass: torch.Tensor         # (PREPASS_MAX, 24) float32
    nodes8: torch.Tensor          # (M8, 8) float32
    meta4: torch.Tensor           # (M8 + 8, 4) int32
    tris8: torch.Tensor           # (T8, 24) float32
    tris8bw: torch.Tensor         # (T8, 16) float32
    prepassbw: torch.Tensor       # (PREPASS_MAX, 16) float32
    leafbox: torch.Tensor         # (L16, 8) float32
    leafmeta: torch.Tensor        # (L16, 4) int32
    nodes_packed: torch.Tensor    # (M, 8) float32, cols 6-7 = nodes_meta's bits
    anchor: tuple                 # (ax, ay, az) floats of the BW planes
    num_nodes: int                # M (sentinel id == M)
    num_tris: int
    max_leaf: int                 # max tri_count over leaves
    num_leaves: int               # real rows of leafbox / leafmeta


def layout_arrays(bvh: BVH, normals, material_id, light_index) -> dict:
    """Flatten the effective (leaf-collapsed) tree into DFS preorder ->
    numpy arrays of every :class:`BVHLayout` field.  ``bvh``: the native SAH
    tree or the LBVH's (accel/lbvh.py), as numpy arrays; ``normals`` ((3, T)
    x3), ``material_id`` and ``light_index`` are in ORIGINAL triangle
    order."""
    left, right, is_leaf = bvh.left, bvh.right, bvh.is_leaf
    first_tri, tri_count = bvh.first_tri, bvh.tri_count

    # Iterative DFS preorder over the effective tree; post-order accumulation
    # of subtree sizes gives the escape links: miss[pos] = pos + subtree_size.
    order: list[int] = []
    sizes: list[int] = []
    stack: list[tuple[int, bool]] = [(int(bvh.root), False)]
    open_pos: list[int] = []  # positions awaiting their post-visit size fix-up
    while stack:
        node, post = stack.pop()
        if post:
            p = open_pos.pop()
            sizes[p] = len(order) - p
            continue
        order.append(node)
        sizes.append(1)
        if not is_leaf[node]:
            open_pos.append(len(order) - 1)
            stack.append((node, True))  # post-visit marker
            stack.append((int(right[node]), False))
            stack.append((int(left[node]), False))

    m = len(order)
    order_arr = np.asarray(order, np.int64)
    new_miss = (np.arange(m) + np.asarray(sizes)).astype(np.int32)

    out_bmin = bvh.bmin[:, order_arr]
    out_bmax = bvh.bmax[:, order_arr]
    out_first = first_tri[order_arr].astype(np.int32)
    counts = np.where(is_leaf[order_arr], tri_count[order_arr], 0).astype(np.int32)
    max_leaf = int(counts.max()) if m else 1
    if max_leaf > MAX_LEAF:
        raise ValueError(f"leaf size {max_leaf} exceeds packable {MAX_LEAF}")

    # Leaf triangle runs must appear in DFS leaf order; remap when the
    # SAH build's partition order differs.
    p0, p1, p2 = bvh.p0, bvh.p1, bvh.p2
    num_tris = p0.shape[1]
    s2o = np.asarray(bvh.sorted_to_orig, np.int64)
    leaf_pos = np.flatnonzero(counts > 0)
    firsts = out_first[leaf_pos]
    cnts = counts[leaf_pos]
    contiguous = (
        len(leaf_pos) > 0
        and firsts[0] == 0
        and np.all(firsts[1:] == firsts[:-1] + cnts[:-1])
        and firsts[-1] + cnts[-1] == num_tris
    )
    if not contiguous:
        perm = np.concatenate(
            [np.arange(f, f + c) for f, c in zip(firsts, cnts)]
        ) if len(leaf_pos) else np.arange(0)
        if perm.size != num_tris:
            raise ValueError("BVH leaves must partition the triangles")
        p0, p1, p2 = p0[:, perm], p1[:, perm], p2[:, perm]
        s2o = s2o[perm]
        out_first[leaf_pos] = np.cumsum(np.concatenate([[0], cnts[:-1]]))

    meta = ((out_first.astype(np.uint32) << 6) | counts.astype(np.uint32)).astype(np.int32)
    nodes = np.zeros((m, 8), np.float32)
    nodes[:, 0:3] = out_bmin.T
    nodes[:, 3:6] = out_bmax.T
    nodes_meta = np.stack([new_miss, meta], axis=1).astype(np.int32)
    tris = np.zeros((num_tris + 1, 24), np.float32)  # +1: all-zeros miss row
    tris[:num_tris, 0:3] = p0.T
    tris[:num_tris, 3:6] = (p1 - p0).T
    tris[:num_tris, 6:9] = (p2 - p0).T
    tris[:num_tris, 9] = s2o.astype(np.float32)
    n0, n1, n2 = (np.asarray(n)[:, s2o] for n in normals)
    tris[:num_tris, 10:13] = n0.T
    tris[:num_tris, 13:16] = n1.T
    tris[:num_tris, 16:19] = n2.T
    tris[:num_tris, 19] = np.asarray(material_id)[s2o].astype(np.float32)
    # stored +1 so the sentinel row's 0 decodes to light_index = -1
    tris[:num_tris, 20] = np.asarray(light_index)[s2o].astype(np.float32) + 1.0

    # Big-triangle pre-pass block: the PREPASS_MAX largest-area triangles,
    # tested before the walk to prime best_t; padded with the all-zero row.
    e1 = tris[:num_tris, 3:6]
    e2 = tris[:num_tris, 6:9]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    by_area = np.argsort(-area)[:PREPASS_MAX]
    prepass = np.zeros((PREPASS_MAX, 24), np.float32)
    prepass[: by_area.size] = tris[by_area]
    prepass[: by_area.size, 21] = by_area.astype(np.float32)

    # col 21 of the main table = DFS leaf node id owning the row
    leaf_ids = np.zeros(num_tris, np.float32)
    for pos in leaf_pos:
        f, c = out_first[pos], counts[pos]
        leaf_ids[f:f + c] = pos
    tris[:num_tris, 21] = leaf_ids

    # ---- the TPU window kernel's padded node tables ----
    m8 = max(-(-m // 32) * 32, 32)
    nodes8 = np.zeros((m8, 8), np.float32)
    nodes8[:m] = nodes
    nodes8[m:, 0:3] = 1e30    # pad rows: an inverted box
    nodes8[m:, 3:6] = -1e30
    # tri_start[n]: first DFS-ordered triangle at-or-after node n
    tri_start = np.full(m8 + 8, num_tris, np.int32)
    for n in range(m - 1, -1, -1):
        tri_start[n] = out_first[n] if counts[n] > 0 else tri_start[n + 1]
    meta4 = np.zeros((m8 + 8, 4), np.int32)
    meta4[:m, 0] = new_miss
    meta4[m:, 0] = m          # sentinel (never followed)
    meta4[:m, 1] = meta
    meta4[:, 2] = tri_start
    # +72 pad rows, as the reference's window kernel fetches past the end
    t8 = -(-(num_tris + 1) // 8) * 8 + 72
    tris8 = np.zeros((t8, 24), np.float32)
    tris8[: num_tris + 1] = tris

    # ---- Baldwin-Weber plane rows (same indexing as tris8) ----
    # Anchor the plane constants at the scene-AABB centre: d = -(n . (p0-a))
    # evaluated at (o - a) keeps the n.o + d cancellation at scene scale.
    if num_tris:
        vmin = np.minimum(np.minimum(p0.min(1), p1.min(1)), p2.min(1))
        vmax = np.maximum(np.maximum(p0.max(1), p1.max(1)), p2.max(1))
        anchor = ((vmin + vmax) * 0.5).astype(np.float32)
    else:
        anchor = np.zeros(3, np.float32)

    def bw_rows(tri_rows: np.ndarray, leaf_col: np.ndarray) -> np.ndarray:
        """(R, 24) MT rows -> (R, 16) BW rows [n0 d0 n1 d1 n2 d2 leaf orig
        pad2].  Degenerate rows (zero normal) give all-zero planes: den == 0
        is the reject test, like det == 0 in MT."""
        p0r = tri_rows[:, 0:3].astype(np.float64) - anchor.astype(np.float64)
        e1r = tri_rows[:, 3:6].astype(np.float64)
        e2r = tri_rows[:, 6:9].astype(np.float64)
        n = np.cross(e1r, e2r)
        c1 = np.cross(e2r, n)
        c2 = np.cross(n, e1r)
        s1 = (c1 * e1r).sum(1, keepdims=True)
        s2 = (c2 * e2r).sum(1, keepdims=True)
        ok = (np.abs(s1) > 0) & (np.abs(s2) > 0)
        n1 = np.where(ok, c1 / np.where(s1 == 0, 1, s1), 0.0)
        n2 = np.where(ok, c2 / np.where(s2 == 0, 1, s2), 0.0)
        n = np.where(ok, n, 0.0)
        out = np.zeros((tri_rows.shape[0], 16), np.float32)
        out[:, 0:3] = n
        out[:, 3] = -(n * p0r).sum(1)
        out[:, 4:7] = n1
        out[:, 7] = -(n1 * p0r).sum(1)
        out[:, 8:11] = n2
        out[:, 11] = -(n2 * p0r).sum(1)
        out[:, 12] = leaf_col
        out[:, 13] = tri_rows[:, 9]
        return out

    tris8bw = bw_rows(tris8, tris8[:, 21])
    tris8bw[num_tris:] = 0.0  # sentinel + pad rows can never hit (den == 0)
    tris8bw[num_tris:, 12] = -1.0
    tris8bw[num_tris:, 13] = -1.0
    prepassbw = bw_rows(prepass, prepass[:, 21])
    prepassbw[by_area.size:] = 0.0

    # ---- leaf-box tables (candidate-sweep kernels) ----
    num_leaves = len(leaf_pos)
    l16 = max(-(-num_leaves // 16) * 16, 16)
    leafbox = np.zeros((l16, 8), np.float32)
    # pad rows: a degenerate far point-box with alternating axis signs: its
    # slab enter is +inf (or enter > exit) for every combination of direction
    # signs, so ``enter < best_t`` can never pass.  (An inverted box, bmin =
    # +B / bmax = -B, is not safe here: with mixed direction signs each axis
    # interval becomes [-inf, +inf] and the test passes.)
    leafbox[:, 0:3] = (1e30, -1e30, 1e30)
    leafbox[:, 3:6] = (1e30, -1e30, 1e30)
    leafbox[:num_leaves, 0:3] = out_bmin[:, leaf_pos].T
    leafbox[:num_leaves, 3:6] = out_bmax[:, leaf_pos].T
    leafmeta = np.zeros((l16, 4), np.int32)
    leafmeta[:num_leaves, 0] = out_first[leaf_pos]
    leafmeta[:num_leaves, 1] = counts[leaf_pos]
    leafmeta[:num_leaves, 2] = leaf_pos

    return dict(
        nodes=nodes, nodes_meta=nodes_meta, tris=tris,
        sorted_to_orig=s2o.astype(np.int32), prepass=prepass,
        nodes8=nodes8, meta4=meta4, tris8=tris8, tris8bw=tris8bw,
        prepassbw=prepassbw, leafbox=leafbox, leafmeta=leafmeta,
        anchor=tuple(float(a) for a in anchor),
        num_nodes=m, num_tris=num_tris, max_leaf=max_leaf,
        num_leaves=num_leaves,
    )


def pack_nodes(nodes: torch.Tensor, nodes_meta: torch.Tensor) -> torch.Tensor:
    """``nodes`` (M, 8) f32 and ``nodes_meta`` (M, 2) i32 -> the packed node
    table (M, 8) f32: the int32 bits of [miss, first_tri*64 + tri_count] in
    the two pad columns, so a walk reads a node as two 16-byte loads."""
    packed = nodes.clone()
    packed.view(torch.int32)[:, 6:8] = nodes_meta
    return packed


def unpack_nodes(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed node table -> (``nodes`` with zero pads, ``nodes_meta``)."""
    nodes = packed.clone()
    nodes[:, 6:8] = 0.0
    return nodes, packed.view(torch.int32)[:, 6:8].clone()


def layout_to(arrays: dict, device) -> BVHLayout:
    """numpy layout arrays -> a :class:`BVHLayout` on ``device``; the packed
    node table is derived there."""
    dtypes = {"f": torch.float32, "i": torch.int32}
    tables = {
        name: torch.tensor(np.ascontiguousarray(arrays[name]),
                           dtype=dtypes[kind], device=device)
        for name, kind in _TABLES
    }
    return BVHLayout(
        **tables,
        nodes_packed=pack_nodes(tables["nodes"], tables["nodes_meta"]),
        anchor=tuple(float(a) for a in arrays["anchor"]),
        num_nodes=int(arrays["num_nodes"]),
        num_tris=int(arrays["num_tris"]),
        max_leaf=int(arrays["max_leaf"]),
        num_leaves=int(arrays["num_leaves"]),
    )
