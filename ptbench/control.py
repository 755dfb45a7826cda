"""Readings that set a cell's limits: the program's numbers and the
control's, over several seeds in one process.

    python3 ptbench/control.py --workload water-plastic.rgb --seconds 10 --seeds 11,12,13

For each seed: the cell's set-up and a window of ``--seconds`` (so as many
frames accumulate as in a run), the program's image at the check's pixels
against the reference, and the control -- the reference itself in bfloat16,
in the program's place -- against the same reference.  One JSON line a
seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(bench, workload: str, seed: int, seconds: float, device="cuda", size=None,
             control_dtype=torch.bfloat16) -> dict:
    from ptbench import check
    from ptbench.harness import Run

    run = Run(bench, workload, seed, device=device, size=size)
    run.setup()
    run.window(seconds)
    got = run.program_pixels()
    run.release()
    want = run.reference_pixels()
    ctrl = run.reference_pixels(dtype=control_dtype)
    return {"workload": workload, "seed": seed, "frames": run.frames,
            "program": check.numbers(got, want), "control": check.numbers(ctrl, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    from ptbench.manifest import Bench

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(bench, args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
