"""A rehearsal of the harness's plumbing loads no module of JAX or of the
JAX package (top-level names compared whole: tpu_pathtracer_torch is the
program, tpu_pathtracer is not), and the entry refuses to run without a
card."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REHEARSAL = """
import sys
sys.path.insert(0, {root!r})
from ptbench import harness
from ptbench.harness import forbidden_modules, run_cell
from ptbench.manifest import Bench
bench = Bench({root!r})
harness.WARMUP_FRAMES = harness.PROFILE_AFTER = harness.PROFILE_FRAMES = 1
traffic = bench.traffic
def small(name):
    t = dict(traffic(name))
    t.update(env=t["env"] and {{"height": 8, "width": 16}})
    return t
bench.traffic = small
res = run_cell(bench, "water-plastic.spectral-env", 12345, 0.1, True, device="cpu",
               size=(4, 6), log=lambda m: None)
assert res["correct"], res
assert "tpu_pathtracer_torch" in sys.modules
print("FORBIDDEN", forbidden_modules())
"""


def test_no_jax_in_a_run():
    out = subprocess.run([sys.executable, "-c", REHEARSAL.format(root=ROOT)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-2000:]


def test_forbidden_names_compare_whole(monkeypatch):
    from ptbench.harness import forbidden_modules

    monkeypatch.setitem(sys.modules, "tpu_pathtracer_torch_fixture", object())
    assert "tpu_pathtracer_torch_fixture" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_pathtracer.fixture", object())
    assert "tpu_pathtracer.fixture" in forbidden_modules()


def test_entry_needs_a_card():
    code = ("import torch; torch.cuda.is_available = lambda: False; import runpy, sys; "
            "sys.argv = ['ptbench/run.py', '--workload', 'water-plastic.rgb', '--seed', '1', "
            "'--seconds', '1']; runpy.run_path('ptbench/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr
