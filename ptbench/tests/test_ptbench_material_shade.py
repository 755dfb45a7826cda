"""material_shade_roofline_pct and its pricing (ptbench/material_shade_bounds.py)
on synthetic records and a synthetic trace: the work of a launch by hand,
the reading by hand, nothing to read on a parity slice or on a program
whose records carry no GGX or texel counts; and the manifest finds the new
configuration, cell, limits and metric, listed for the new cell alone."""

from types import SimpleNamespace

import pytest
import torch

from ptbench import material_shade_bounds as bounds
from ptbench import shade_bounds
from ptbench.traces import SLICE, Trace

CELL = "water-ggx-textured.rgb"
METRIC = "material_shade_roofline_pct"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _trace(*kernel_us):
    """A slice 0..1000 us with one shading kernel a duration, back to back
    from 100 us."""
    ev, t = [_x("user_annotation", SLICE, 0.0, 1000.0)], 100.0
    for k, dur in enumerate(kernel_us):
        ev += [_x("cuda_runtime", "cudaLaunchKernel", t - 50.0, 1.0, correlation=k + 1),
               _x("kernel", "void (anonymous namespace)::shade_bounce_kernel<false, false, "
                  "false, true>(ShadeParams)", t, dur, tid=7, correlation=k + 1)]
        t += dur
    return Trace(ev)


LAUNCH = dict(planes=3, hero=False, inline=False, env=False, dispersion=False, kernel=True,
              env_picks=None, env_misses=None, bounce=1, live=700)


def _launch(**kw):
    return {**LAUNCH, "lanes": 1000, "rough": True, "textured": True, "ggx_lanes": 300,
            "tex_lanes": 200, **kw}


def _run(launches, trace, scene=None):
    recs = [{"frame": 40, "launches": launches[:1]}, {"frame": 41, "launches": launches[1:]}]
    scene = scene or SimpleNamespace(**dict.fromkeys(bounds.TABLES))
    return SimpleNamespace(cuda=True, trace=trace, slice_first=40, slice_frames=2,
                           renderer=SimpleNamespace(scene=scene, frame_records=recs))


def test_material_work_by_hand():
    """A launch of 1,000 lanes at C = 3 moves 235 bytes a lane, its 300 GGX
    lanes add 275 operations each and its 200 textured lanes 56 operations
    and 40 bytes each; the env and dispersion arms are shade_bounds'."""
    got = bounds.material_work(_launch(), 100)
    assert got == (1000 * 235 + 100 + 200 * 40, 1000 * 390 + 300 * 275 + 200 * 56)
    plain = dict(_launch(), rough=False, textured=False)
    assert bounds.material_work(plain, 100) == bounds.shade_work(plain, 100)
    env = _launch(env=True, env_picks=30, env_misses=20, dispersion=True, planes=4, hero=True)
    assert bounds.shade_work(env, 7) == shade_bounds.shade_work(env, 7)
    # bytes bound it: 243,100 bytes at 3.35 TB/s against 997,600 flops at 67 TFLOP/s
    assert bounds.least_material_seconds(_launch(), 100) == pytest.approx(243_100 / 3.35e12)


def test_reading_by_hand(bench):
    """Two priced launches over their two kernels' 10 + 30 us."""
    scene = SimpleNamespace(**{**dict.fromkeys(bounds.TABLES),
                               "mat_ior": torch.zeros(5), "mat_type": torch.zeros(5).long()})
    launches = [_launch(), _launch(lanes=500, ggx_lanes=100, tex_lanes=400, inline=True)]
    least = sum(bounds.least_material_seconds(x, 60) for x in launches)
    got = bench.reader(METRIC)(_run(launches, _trace(10.0, 30.0), scene))
    assert got == pytest.approx(100.0 * least / 40e-6)
    assert 0.0 < got < 100.0


@pytest.mark.parametrize("case", ["parity", "older-program", "counts-unread",
                                  "kernels-unmatched"])
def test_nothing_to_read(bench, case):
    """None on a parity slice (no launch's scene has a roughness table or
    textures), on records of a program without the materials' keys, on
    launches whose counts were never read, and where the trace's shading
    kernels are not the recorded launches."""
    launches = {
        "parity": [dict(_launch(), rough=False, textured=False)] * 2,
        "older-program": [dict(LAUNCH, lanes=1000)] * 2,
        "counts-unread": [_launch(ggx_lanes=None, tex_lanes=None)] * 2,
        "kernels-unmatched": [_launch()] * 3,
    }[case]
    assert bench.reader(METRIC)(_run(launches, _trace(10.0, 30.0))) is None


def test_manifest_finds_the_configuration_cell_and_metric(bench):
    """The new configuration names its material model and its scene, the
    cell runs it under the rgb mix on one chip with limits of its own, and
    the metric's reader is found and listed for the new cell alone."""
    cell = bench.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("water-ggx-textured", "rgb", 1)
    config = bench.config("water-ggx-textured")
    assert config["scene"] == {"obj": "water-ggx-textured", "rough_materials": True}
    assert config["reduced"] == [] and config["max_path_length"] == 8
    assert (config["width"], config["height"]) == (1920, 1080)
    limits = bench.limits(CELL)["limits"]
    assert set(limits) == {"rel_l1", "bad_px_share", "nonfinite_share"}
    assert callable(bench.reader(METRIC))
    entry = next(m for m in bench.doc["per_layer"] if m["name"] == METRIC)
    assert entry["workloads"] == [CELL] and entry["moves"] == "frame_ms"
    for w in bench.doc["workloads"]:
        listed = METRIC in [m["name"] for m in bench.metrics("per_layer", w["name"])]
        assert listed == (w["name"] == CELL), w["name"]
    # the shading's own metrics read in every cell, this one too
    names = [m["name"] for m in bench.metrics("per_layer", CELL)]
    assert "shade_ms_per_frame" in names and "shade_roofline_pct" in names
