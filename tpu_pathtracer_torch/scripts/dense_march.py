"""The launch shape of the dense march (``csrc/dense_march.cuh``), shared by
the row-test probe's and the two candidate sweeps' wrappers.

A block covers ``tile`` lanes with ``threads`` threads of ``k`` lanes each
(the kernel's constant, ``K_LANES`` beside its wrapper), in ``passes``
passes of ``threads * k`` lanes: slot ``j`` of thread ``t`` in pass ``p`` of
block ``b`` is lane ``b * tile + (p * k + j) * threads + t``, live when that
offset is below ``tile`` and the lane below ``n`` (:func:`march_lanes`
enumerates them).  ``threads`` is ``ceil(tile / k)``
rounded up to a warp, at most :data:`MAX_THREADS`; ``passes`` is 1 unless
that cap bites.

The table, ``rows`` rows of ``row_bytes`` staged bytes each, goes to shared
memory after ``head_bytes`` of rows staged once (the count's prepass
block): all of it in one buffer when it fits :data:`ONE_TILE_BYTES`, else
``tile_rows`` rows at a time (a multiple of 16, so the probe's unrolled
16-row latch blocks stay whole) in two buffers.

The targeted candidate sweep marches a list of the active lanes instead
(:func:`compact_shape`): its first two launches list them in ascending order,
:data:`LIST_TILE` lanes a block, and the march takes passes of the list from
a counter, ``threads * k`` entries a pass (a warp's ``32 * k`` where the
table is one tile): entry ``p * per_pass + t * k + j`` goes to slot ``j`` of
thread ``t`` (:func:`compact_lanes` enumerates them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_THREADS = 512             # csrc/dense_march.cuh:kMarchMaxThreads
LIST_TILE = 1024              # csrc/candidate_sweep.cu:kListTile
ONE_TILE_BYTES = 48 * 1024    # a table up to this size is staged once
TILE_BYTES = 16 * 1024        # else: one buffer of a double-buffered tile
SHARED_LIMIT = 232448         # bytes of shared memory a block may ask for on an H100


class MarchShape(NamedTuple):
    blocks: int
    threads: int
    passes: int
    tile_rows: int   # table rows a shared-memory buffer holds
    smem: int        # dynamic shared memory a block asks for, bytes


def march_shape(n: int, tile: int, k: int, rows: int, row_bytes: int,
                head_bytes: int = 0) -> MarchShape:
    """The launch of a dense march over ``n`` lanes at ``k`` lanes a thread;
    raises ``ValueError`` for a ``tile`` that is not a positive multiple of
    32 or a table that cannot be staged."""
    if tile < 32 or tile % 32:
        raise ValueError(f"tile={tile}: the lanes a block covers, a positive "
                         "multiple of 32")
    per_thread = -(-tile // k)
    threads = min(MAX_THREADS, -(-per_thread // 32) * 32)
    passes = -(-tile // (threads * k))
    tile_rows, smem = _staging(rows, row_bytes, head_bytes)
    return MarchShape(-(-n // tile), threads, passes, tile_rows, _fits(smem))


def _staging(rows: int, row_bytes: int, head_bytes: int) -> tuple[int, int]:
    """(tile_rows, bytes) of the staged head and table."""
    if rows * row_bytes <= ONE_TILE_BYTES:
        return max(rows, 1), head_bytes + max(rows, 1) * row_bytes
    tile_rows = TILE_BYTES // row_bytes // 16 * 16
    return tile_rows, head_bytes + 2 * tile_rows * row_bytes


def _fits(smem: int) -> int:
    if smem > SHARED_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory a block, past the "
                         f"card's {SHARED_LIMIT}")
    return smem


def march_lanes(shape: MarchShape, n: int, tile: int, k: int) -> torch.Tensor:
    """The lane of every (block, pass, slot, thread) of ``shape``, -1 where
    the slot is masked: the kernels' mapping, for the tests."""
    b = torch.arange(shape.blocks)[:, None, None, None]
    p = torch.arange(shape.passes)[None, :, None, None]
    j = torch.arange(k)[None, None, :, None]
    t = torch.arange(shape.threads)[None, None, None, :]
    off = (p * k + j) * shape.threads + t
    lane = b * tile + off
    return torch.where((off < tile) & (lane < n), lane, -1)


def compact_shape(n: int, threads: int, k: int, rows: int, row_bytes: int,
                  head_bytes: int = 0) -> MarchShape:
    """The launches of the targeted sweep over ``n`` lanes: ``blocks`` of
    the two list launches (one a :data:`LIST_TILE` lanes), the march's
    ``threads`` at ``k`` entries a thread, ``passes`` the most block passes
    it can take (every lane active), its table staging.  Raises
    ``ValueError`` for a ``threads`` that is not a multiple of 32 up to
    :data:`MAX_THREADS` or a table that cannot be staged."""
    if threads < 32 or threads % 32 or threads > MAX_THREADS:
        raise ValueError(f"threads={threads}: a multiple of 32 up to {MAX_THREADS}")
    tile_rows, smem = _staging(rows, row_bytes, head_bytes)
    return MarchShape(-(-n // LIST_TILE), threads, -(-n // (threads * k)), tile_rows,
                      _fits(smem))


def compact_lanes(active: torch.Tensor, per_pass: int, k: int) -> torch.Tensor:
    """The lane of every (pass, thread, slot) of the targeted sweep's march
    over the (n,) bool ``active`` at ``per_pass`` entries a pass, -1 where
    the slot is past the list: the kernels' list and mapping, for the
    tests."""
    lanes = active.nonzero()[:, 0]  # the list: ascending
    passes = -(-lanes.numel() // per_pass)
    out = torch.full((passes * per_pass,), -1, dtype=torch.int64)
    out[:lanes.numel()] = lanes
    return out.view(passes, per_pass // k, k)
