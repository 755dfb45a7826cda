"""Run one cell of tpu_pathtracer_torch's benchmark once.

    python3 ptbench/run.py --workload water-plastic.rgb --seed 7 --seconds 10 --trace 0

Prints progress and, as its last lines, each number that decided
``correct`` beside its limit on standard error, and one JSON result line
as the last line of standard output (BENCHMARK.json names the cells and
metrics).  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics, read from a profiled slice of the window.  Needs
as many CUDA devices as the cell's ``chips``; exits non-zero with no result
line without them, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from ptbench.harness import forbidden_modules, run_cell
    from ptbench.manifest import Bench

    bench = Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
