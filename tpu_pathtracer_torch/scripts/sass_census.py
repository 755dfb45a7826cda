"""Count the instructions the dense marches issue a test, from the SASS of
the built kernel library.

    python -m tpu_pathtracer_torch.scripts.sass_census   # needs nvcc and cuobjdump

Builds the library (``ops/cuda_build.py``), lists it with ``cuobjdump
-sass`` and reads the innermost loops of the candidate count and the
targeted kernel (``csrc/candidate_sweep.cu``: their box loops and primes,
and the targeted kernel's leaf rows, served by the warp or lane by lane)
and of the row-test probe's unrolled instances (``csrc/probes.cu``, mtblock
16, every variant with a reciprocal).  A kernel's issue ceiling is the
operations its bound counts a test over the instructions it issues a test
on its fast path: the share of the float32 bound that an issue-bound kernel
can reach.  No card is needed.

Lines: ``SASS <kernel> <loop>: <issued> instructions a test for <ops>
operations, issue ceiling <pct>%``.  Raises when the toolkit has no
cuobjdump, the listing lacks a kernel, or a kernel has no loop of the
expected shape.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

from ..ops import cuda_build
from .perf_ophit_probe import ROWTEST_OPS, VARIANTS

# float32 operations of one test, as the bounds count them (chip_smoke.py):
BOX_TEST_OPS = 27    # the slab test's 25, the first leaf's select, the count's add
LEAF_BOX_OPS = 26    # the targeted kernel's: no count
PRIME_TEST_OPS = 52  # a Moller-Trumbore row test and its latch compare
# instructions of one lane test that mark its loop: the slab test's
# min / max, a row test's reciprocal
FMNMX_A_BOX = 10
MUFU_A_ROW = 1
COUNT_SYMBOL = "18sweep_count_kernelE"  # not a template: kCountK is a constant
SWEEP1_SYMBOL = "13sweep1_kernelE"      # nor kSweep1K


def probe_symbol(variant: str) -> str:
    """The mangled-name part of the probe's unrolled instance (mtblock 16)."""
    return f"20rowtest_probe_kernelILi{VARIANTS.index(variant)}ELi16EE"


def library_sass(library: str) -> str:
    """``cuobjdump -sass`` of ``library``; raises without cuobjdump."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"no cuobjdump beside nvcc ({tool})")
    return subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def sass_loops(sass: str, symbol: str) -> list[dict]:
    """The innermost loops of the one kernel whose mangled name holds
    ``symbol`` -> [{"issued": m, "ops": {opcode: k}}]: ``issued`` counts the
    instructions one trip issues on its fast path, every forward branch
    over a CALL and no MUFU taken (the rare slow path of an IEEE 1 / x, not
    a guarded row test that holds one).  Raises when no kernel, or more than
    one, matches."""
    funcs = [f for f in re.split(r"\n\s+Function : ", sass)[1:]
             if symbol in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        raise RuntimeError(f"{len(funcs)} kernels of the listing match {symbol!r}")
    ins = [(int(m[1], 16), m[2].strip())
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", funcs[0])]
    where = {a: i for i, (a, _) in enumerate(ins)}

    def target(op):
        m = re.search(r"BRA (?:`\()?(0x[0-9a-f]+)", op)
        return int(m[1], 16) if m and int(m[1], 16) in where else None

    back = [(where[t], i) for i, (a, op) in enumerate(ins)
            if (t := target(op)) is not None and t < a]
    loops = []
    for lo, hi in back:
        if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi) for l2, h2 in back):
            continue  # not innermost
        ops, i = {}, lo
        while i <= hi:
            op = ins[i][1]
            name = re.sub(r"^@!?U?P[T0-9] ", "", op).split()[0].split(".")[0]
            ops[name] = ops.get(name, 0) + 1
            t = target(op)
            if t is not None and i < hi and t > ins[i][0]:
                j = where[t]
                skipped = [x for _, x in ins[i:j]]
                if not op.startswith("@") or (any("CALL" in x for x in skipped)
                                              and not any("MUFU" in x for x in skipped)):
                    i = j
                    continue
            i += 1
        loops.append({"issued": sum(ops.values()), "ops": ops})
    return loops


def issue_ceiling(sass: str, symbol: str, marker: str, per_test: int,
                  ops_per_test: int, having: tuple = (), lacking: tuple = ()) -> dict:
    """The issue ceiling of the innermost loop of kernel ``symbol`` with the
    most ``marker`` instructions (``per_test`` of them a lane test), among
    the loops that issue every opcode of ``having`` and none of ``lacking``
    -> {"issued_per_test", "ops_per_test", "issue_ceiling_pct"}; raises when
    the kernel has no such loop."""
    loops = [x for x in sass_loops(sass, symbol)
             if x["ops"].get(marker) and all(x["ops"].get(h) for h in having)
             and not any(x["ops"].get(h) for h in lacking)]
    if not loops:
        raise RuntimeError(f"{symbol}: no innermost loop issues {marker}")
    hot = max(loops, key=lambda x: x["ops"][marker])
    issued = hot["issued"] * per_test / hot["ops"][marker]
    return {"issued_per_test": issued, "ops_per_test": ops_per_test,
            "issue_ceiling_pct": 100.0 * ops_per_test / issued}


def census(sass: str) -> dict:
    """Every loop this tool reads -> {(kernel, loop): issue_ceiling(...)}."""
    out = {("sweep_count", "box"): issue_ceiling(sass, COUNT_SYMBOL, "FMNMX", FMNMX_A_BOX,
                                                 BOX_TEST_OPS),
           ("sweep_count", "prime"): issue_ceiling(sass, COUNT_SYMBOL, "MUFU", MUFU_A_ROW,
                                                   PRIME_TEST_OPS),
           ("sweep1", "box"): issue_ceiling(sass, SWEEP1_SYMBOL, "FMNMX", FMNMX_A_BOX,
                                            LEAF_BOX_OPS),
           # the prime reads its rows from shared memory, the leaf rows from
           # device memory; the warp's service shuffles, the per-lane loop not
           ("sweep1", "prime"): issue_ceiling(sass, SWEEP1_SYMBOL, "MUFU", MUFU_A_ROW,
                                              PRIME_TEST_OPS, having=("LDS",),
                                              lacking=("LDG",)),
           ("sweep1", "leaf rows, warp"): issue_ceiling(sass, SWEEP1_SYMBOL, "MUFU",
                                                        MUFU_A_ROW, PRIME_TEST_OPS,
                                                        having=("LDG", "SHFL")),
           ("sweep1", "leaf rows, lane"): issue_ceiling(sass, SWEEP1_SYMBOL, "MUFU",
                                                        MUFU_A_ROW, PRIME_TEST_OPS,
                                                        having=("LDG",), lacking=("SHFL",))}
    for v in VARIANTS:
        if v != "nodiv":  # the one variant without a reciprocal to mark its tests
            out[("rowtest_probe/" + v, "row")] = issue_ceiling(
                sass, probe_symbol(v), "MUFU", MUFU_A_ROW, ROWTEST_OPS[v])
    return out


def main(argv=None) -> int:
    del argv
    path, seconds, _ = cuda_build.build()
    print(f"library: {os.path.relpath(path)} (built in {seconds:.1f} s)", flush=True)
    for (kernel, loop), x in census(library_sass(path)).items():
        print(f"SASS {kernel} {loop}: {x['issued_per_test']:.2f} instructions a test for "
              f"{x['ops_per_test']} operations, issue ceiling "
              f"{x['issue_ceiling_pct']:.1f}%", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
