"""Isolate the fixed cost of a kernel launch: tables vs grid vs kernel body.

    python -m tpu_pathtracer_torch.scripts.perf_launch              # on the card
    python -m tpu_pathtracer_torch.scripts.perf_launch --platform cpu \\
        --lanes 4096 --reps 2                                       # a CPU rehearsal

The counterpart of the reference's ``scripts/perf_launch.py`` (``noop_kernel``
via ``run_noop``), on ``tpupt_noop`` of ``csrc/probes.cu``.  It prints the
card's name and power limit, the bytes of the v1 (``nodes``, ``nodes_meta``,
``tris``) and v2 (``nodes8``, ``meta4``, ``tris8``) table sets, then per
``tile`` the time of a no-op launch over ``--lanes`` lanes (1920x1080 by
default) with no tables, with the v1 and with the v2 tables as arguments,
and then the all-dead launches (every lane inactive) of the two walk
kernels: ``capped_walk`` (the counterpart of ``intersect_bvh_pallas``) and
``window_walk`` (of ``intersect_bvh_window``).

``tile`` on this card is the number of lanes one thread block covers: the
grid is ``ceil(lanes / tile)`` blocks of 256 threads, as the TPU grid is
``lanes / tile`` programs.  The walk kernels have one fixed shape (128
threads a block, one thread a lane), so their all-dead launch is one line
each, not one per tile.

On the TPU every table argument of a ``pallas_call`` was copied into on-chip
memory per launch, and the "+tables" columns priced that copy.  On this card
a table is a pointer in the kernel's argument block, so the columns are
expected to equal the bare no-op; they are printed as measured, and the last
line says which it was.

Every time is the minimum over ``--reps`` launches, taken twice: with CUDA
events around the launch alone ("ev"), and with the host clock around the
launch plus a 4-byte pull of ``out[0, ::997].sum()``, reduced on the device
("host": launch + sync + the reduce).  With ``--platform cpu`` the plain
versions run and only the host clock is read.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..accel import build_layout
from ..device import device_for, device_label
from ..ops import hopper_traverse as ht
from ..ops import launch_count
from ..ops.cuda_build import load_library
from ..scene import load_scene, scene_path

N = 1920 * 1080
SCENE = "CornellBox-Water-plastic"  # its tables are passed and walked
TILES = (768, 1536, 3072, 6144)
MAX_TABLES = 4
TABLES_EQUAL_RTOL = 0.10  # "+tables" within this share of the bare no-op = equal


def noop_plain(rays, tables=(), tile: int = 768):
    """Plain torch version of ``tpupt_noop`` -> (8, N): row 0 = rays row 0,
    rows 1-7 = 0.  ``tables`` and ``tile`` change nothing."""
    del tables, tile
    out = torch.zeros_like(rays)
    out[0] = rays[0]
    return out


def noop(rays, tables=(), tile: int = 768):
    """The no-op launch -> (8, N) float32: row 0 = rays row 0, rows 1-7 = 0.
    The CUDA kernel for a CUDA tensor (one block per ``tile`` lanes, up to
    four ``tables`` passed as pointers it never reads), the plain version
    for a CPU tensor."""
    if rays.device.type == "cpu":
        return noop_plain(rays, tables, tile)
    n = rays.shape[-1]
    if (rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 8
            or not rays.is_contiguous()):
        raise ValueError(f"rays: expected contiguous float32 (8, N), got "
                         f"{rays.dtype} {tuple(rays.shape)}")
    if 8 * n >= 2 ** 31 or not 0 < tile < 2 ** 20:
        raise ValueError(f"{n} lanes at tile {tile}: outside the kernel's int32 offsets")
    if len(tables) > MAX_TABLES or any(t.device != rays.device for t in tables):
        raise ValueError(f"tables: at most {MAX_TABLES} tensors on {rays.device}")
    out = torch.empty_like(rays)
    ptrs = [t.data_ptr() for t in tables] + [None] * (MAX_TABLES - len(tables))
    rc = load_library().tpupt_noop(rays.data_ptr(), *ptrs, tile, n, out.data_ptr(),
                                   torch.cuda.current_stream(rays.device).cuda_stream)
    if rc:
        raise RuntimeError(f"noop kernel launch failed: cudaError {rc}")
    launch_count.count(noop)
    return out


noop.launches = 0


def _reduce(out):
    """A plane reduced to a scalar on the device, so the pull is 4 bytes."""
    return out[0, ::997].sum()


def run_noop(rays, tables, tile):
    """The reference's ``run_noop``: the no-op launch, reduced to a scalar
    on the device."""
    return _reduce(noop(rays, tables, tile))


def run_noop_plain(rays, tables, tile):
    """Plain version of :func:`run_noop`."""
    return _reduce(noop_plain(rays, tables, tile))


def timeit(launch, finish, reps: int = 7):
    """Minimum over ``reps`` runs after one warm-up -> (event ms or None,
    host ms).  ``launch()`` returns the kernel's output; ``finish(out)``
    reduces it to a device scalar whose ``float()`` is the sync.  Events
    bracket ``launch`` alone; the host clock brackets launch + finish +
    pull.  A launch on CPU tensors has no events."""
    out = launch()
    cuda = (out[0] if isinstance(out, tuple) else out).is_cuda
    float(finish(out))
    ev, host = [], []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        out = launch()
        if cuda:
            end.record()
        float(finish(out))
        host.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            ev.append(start.elapsed_time(end))
    return (min(ev) if ev else None), min(host)


def _ms(pair) -> str:
    ev, host = pair
    return f"{'   n/a' if ev is None else f'{ev:7.3f}'} ms (host {host:7.3f})"


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--platform", choices=("auto", "gpu", "cpu"), default="auto",
                    help="'auto' and 'gpu' need a CUDA device and raise without "
                         "one; 'cpu' runs the kernels' plain torch versions")
    ap.add_argument("--lanes", type=int, default=N, help="lanes per launch")
    ap.add_argument("--reps", type=int, default=7)
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    device = device_for(args.platform)
    print(f"device: {device_label(device)}", flush=True)
    n = args.lanes
    lay = build_layout(load_scene(scene_path(SCENE), device=device))
    rays = torch.zeros((8, n), device=device)  # active = 0 everywhere

    tbl_v1 = [lay.nodes, lay.nodes_meta, lay.tris]
    tbl_v2 = [lay.nodes8, lay.meta4, lay.tris8]
    for nm, t in (("v1", tbl_v1), ("v2", tbl_v2)):
        tot = sum(x.numel() * x.element_size() for x in t)
        print(f"{nm} tables: {[tuple(x.shape) for x in t]} = {tot / 1024:.0f} KB")

    worst = 0.0
    for tile in TILES:
        bare, with_v1, with_v2 = (
            timeit(lambda: noop(rays, tables, tile), _reduce, args.reps)
            for tables in ([], tbl_v1, tbl_v2))
        pick = 0 if bare[0] is not None else 1   # events on the card, host on the CPU
        worst = max(worst, *(abs(x[pick] - bare[pick]) / bare[pick]
                             for x in (with_v1, with_v2)))
        print(f"tile={tile:5d} blocks={-(-n // tile):5d}  noop={_ms(bare)}"
              f"  +v1 tables={_ms(with_v1)}  +v2 tables={_ms(with_v2)}", flush=True)
    same = worst <= TABLES_EQUAL_RTOL
    print(f"tables (pointer arguments on this card): the +tables launches "
          f"{'equal' if same else 'differ from'} the bare no-op; largest difference "
          f"{worst:.1%} of it (equal means within {TABLES_EQUAL_RTOL:.0%})", flush=True)

    o = rays[0:3].contiguous()
    d = torch.ones((3, n), device=device)
    dead = torch.zeros(n, dtype=torch.bool, device=device)
    inf = torch.full((n,), torch.inf, device=device)
    pp = ht.window_prepass(lay, ht.DEFAULT_PREPASS)
    t_v1 = timeit(lambda: ht.capped_walk(o, d, dead, inf, lay),
                  lambda out: out[1, ::997].sum(), args.reps)
    print(f"v1 all-dead (capped_walk, {n} lanes): {_ms(t_v1)}", flush=True)
    t_v2 = timeit(lambda: ht.window_walk(o, d, dead, inf, lay, prepass=pp),
                  lambda out: out[1][::997].sum(), args.reps)
    print(f"v2 all-dead (window_walk, {n} lanes): {_ms(t_v2)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
