"""LBVH construction: Morton sort + Karras-style hierarchy, in torch.

The port of ``tpu_pathtracer/accel/lbvh.py``, on the scene's device:

  1. 30-bit Morton codes of triangle centroids in the centroid AABB;
  2. a stable sort of the codes (``torch.sort(stable=True)``, as
     ``jnp.argsort``): equal codes keep triangle order;
  3. binary radix tree topology per Karras, "Maximally Parallel
     Construction of Linear BVHs" (HPG 2012): every internal node's range
     and split by vectorized prefix-length binary searches on (code, index)
     pairs, so duplicate codes are handled;
  4. bottom-up AABB fitting by fixed-point iteration over tree levels;
  5. subtree-size-based leaf collapse to ``leaf_size`` triangles;
  6. top-down ``miss`` (escape) links by fixed-point iteration.

torch has no ``clz`` and little uint32 arithmetic: the codes, ``clz`` and
the bit spreading run in int64 with explicit 32-bit masks.  The two
fixed-point loops read their "changed" flag on the host once per
iteration, which is fine for a build that runs once per scene.

Node ids: internal nodes are 0..N-2, leaf slots N-1..2N-2 hold the sorted
singleton leaves; the *effective* tree treats the topmost nodes with
subtree size <= leaf_size as leaves.  Arrays are int32 / float32 / bool,
as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_MASK32 = 0xFFFFFFFF


class BVH(NamedTuple):
    # geometry, in morton-sorted triangle order, component-major (3, T)
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    sorted_to_orig: torch.Tensor  # (T,) int32: sorted slot -> original tri index
    # nodes (M = 2T - 1)
    bmin: torch.Tensor        # (3, M) float32
    bmax: torch.Tensor        # (3, M) float32
    left: torch.Tensor        # (M,) int32 left child (internal nodes)
    right: torch.Tensor       # (M,) int32 right child (internal nodes)
    miss: torch.Tensor        # (M,) int32 escape link; M == done sentinel
    is_leaf: torch.Tensor     # (M,) bool (effective leaves after collapse)
    first_tri: torch.Tensor   # (M,) int32 first sorted triangle of the subtree
    tri_count: torch.Tensor   # (M,) int32 subtree triangle count
    root: int = 0


def morton_codes(cx, cy, cz) -> torch.Tensor:
    """(N,) float32 centroid components in [0, 1] -> (N,) int64 30-bit
    interleaved Morton codes (the reference's uint32 values)."""

    def expand_bits(v):
        # 10 input bits spread to every 3rd position (Karras 2012 fig. 4);
        # each product wraps to 32 bits as the reference's uint32 does
        v = ((v * 0x00010001) & _MASK32) & 0xFF0000FF
        v = ((v * 0x00000101) & _MASK32) & 0x0F00F00F
        v = ((v * 0x00000011) & _MASK32) & 0xC30C30C3
        v = ((v * 0x00000005) & _MASK32) & 0x49249249
        return v

    def quantize(c):
        return torch.clamp(c * 1024.0, 0.0, 1023.0).to(torch.int64)

    return ((expand_bits(quantize(cx)) << 2) | (expand_bits(quantize(cy)) << 1)
            | expand_bits(quantize(cz)))


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of int64 values in [0, 2^32) read as uint32 (32 for 0)."""
    n = torch.full_like(x, 32)
    for s in (16, 8, 4, 2, 1):
        t = x >> s
        nz = t != 0
        n = torch.where(nz, n - s, n)
        x = torch.where(nz, t, x)
    return n - x


def _delta(codes, i, j):
    """Common-prefix length of keys i and j; -1 outside [0, N-1].  Keys are
    (morton, index) pairs: equal codes add 32 + the index prefix, Karras's
    augmented-key trick."""
    n = codes.shape[0]
    valid = (j >= 0) & (j <= n - 1)
    j_safe = torch.clamp(j, 0, n - 1)
    ci, cj = codes[i], codes[j_safe]
    prefix = torch.where(ci == cj, 32 + clz32(i ^ j_safe), clz32(ci ^ cj))
    return torch.where(valid, prefix, -1)


def build(p0, p1, p2, leaf_size: int = 4) -> BVH:
    """Construct the LBVH over (3, T) float32 triangle vertex tensors, on
    their device."""
    dev = p0.device
    num_tris = p0.shape[1]
    i32 = torch.int32
    if num_tris < 2:
        # degenerate single-triangle scene: one leaf node
        return BVH(
            p0=p0, p1=p1, p2=p2,
            sorted_to_orig=torch.arange(num_tris, dtype=i32, device=dev),
            bmin=torch.minimum(torch.minimum(p0, p1), p2),
            bmax=torch.maximum(torch.maximum(p0, p1), p2),
            left=torch.zeros(1, dtype=i32, device=dev),
            right=torch.zeros(1, dtype=i32, device=dev),
            miss=torch.ones(1, dtype=i32, device=dev),
            is_leaf=torch.ones(1, dtype=torch.bool, device=dev),
            first_tri=torch.zeros(1, dtype=i32, device=dev),
            tri_count=torch.full((1,), num_tris, dtype=i32, device=dev),
        )

    # --- 1-2: morton codes of centroids, stable sort ---
    centroid = (p0 + p1 + p2) / 3.0                     # (3, T)
    lo = centroid.amin(dim=1, keepdim=True)
    hi = centroid.amax(dim=1, keepdim=True)
    unit = (centroid - lo) / torch.clamp(hi - lo, min=1e-12)
    codes = morton_codes(unit[0], unit[1], unit[2])
    codes, order = torch.sort(codes, stable=True)
    p0s, p1s, p2s = p0[:, order], p1[:, order], p2[:, order]

    n = num_tris
    num_internal = n - 1
    num_nodes = 2 * n - 1
    leaf_base = num_internal  # leaf slot for sorted tri k: leaf_base + k

    # --- 3: Karras topology for internal nodes ---
    i = torch.arange(num_internal, device=dev)
    d = torch.sign(_delta(codes, i, i + 1) - _delta(codes, i, i - 1))
    delta_min = _delta(codes, i, i - d)

    lmax = torch.full_like(i, 2)  # upper bound of the range length
    for _ in range(32):
        lmax = torch.where(_delta(codes, i, i + lmax * d) > delta_min, lmax * 2, lmax)

    l = torch.zeros_like(i)  # noqa: E741 -- Karras's name; binary search of the far end
    for step in range(32):
        t = lmax >> (step + 1)
        cond = (t >= 1) & (_delta(codes, i, i + (l + t) * d) > delta_min)
        l = torch.where(cond, l + t, l)  # noqa: E741
    j = i + l * d
    delta_node = _delta(codes, i, j)

    s = torch.zeros_like(i)  # binary search of the split position
    div = torch.full_like(i, 2)
    for _ in range(32):
        t = (l + div - 1) // div  # ceil(l / div)
        cond = (t >= 1) & (_delta(codes, i, i + (s + t) * d) > delta_node)
        s = torch.where(cond, s + t, s)
        div = torch.clamp(div * 2, max=1 << 30)
    gamma = i + s * d + torch.clamp(d, max=0)

    range_lo = torch.minimum(i, j)
    range_hi = torch.maximum(i, j)
    left_child = torch.where(range_lo == gamma, leaf_base + gamma, gamma)
    right_child = torch.where(range_hi == gamma + 1, leaf_base + gamma + 1, gamma + 1)

    zeros_n = torch.zeros(n, dtype=torch.int64, device=dev)
    left = torch.cat([left_child, zeros_n])
    right = torch.cat([right_child, zeros_n])
    first_tri = torch.cat([range_lo, torch.arange(n, device=dev)])
    tri_count = torch.cat([range_hi - range_lo + 1, torch.ones(n, dtype=torch.int64,
                                                              device=dev)])

    parent = torch.zeros(num_nodes, dtype=torch.int64, device=dev)
    parent[left_child] = i
    parent[right_child] = i

    # --- 4: AABB fit, bottom-up fixed point ---
    big = 3.4e38
    bmin = torch.cat([torch.full((3, num_internal), big, device=dev),
                      torch.minimum(torch.minimum(p0s, p1s), p2s)], dim=1)
    bmax = torch.cat([torch.full((3, num_internal), -big, device=dev),
                      torch.maximum(torch.maximum(p0s, p1s), p2s)], dim=1)
    for _ in range(num_internal + 1):
        new_min = torch.minimum(bmin[:, left_child], bmin[:, right_child])
        new_max = torch.maximum(bmax[:, left_child], bmax[:, right_child])
        changed = bool(((new_min != bmin[:, :num_internal]).any()
                        | (new_max != bmax[:, :num_internal]).any()))
        bmin[:, :num_internal] = new_min
        bmax[:, :num_internal] = new_max
        if not changed:
            break

    # --- 5: leaf collapse: topmost nodes with subtree size <= leaf_size ---
    small = tri_count <= leaf_size
    is_leaf = small & ~small[parent]
    is_leaf[0] = is_leaf[0] | small[0]

    # --- 6: miss links (escape pointers), top-down fixed point ---
    miss = torch.full((num_nodes,), num_nodes, dtype=torch.int64, device=dev)
    for _ in range(num_internal + 1):
        new_miss = miss.clone()
        new_miss[left_child] = right_child
        new_miss[right_child] = new_miss[:num_internal].clone()
        changed = bool((new_miss != miss).any())
        miss = new_miss
        if not changed:
            break

    return BVH(
        p0=p0s, p1=p1s, p2=p2s,
        sorted_to_orig=order.to(i32),
        bmin=bmin, bmax=bmax,
        left=left.to(i32), right=right.to(i32), miss=miss.to(i32),
        is_leaf=is_leaf,
        first_tri=first_tri.to(i32), tri_count=tri_count.to(i32),
    )
