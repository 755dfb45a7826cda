"""BENCHMARK.json loads, and every name it gives is found as a file; a cell
and a metric added as new files are picked up with no file edited."""

import json
import os
import shutil

import pytest

from ptbench import harness
from ptbench.harness import Run
from ptbench.manifest import Bench


def test_every_name_is_found(bench):
    doc = bench.doc
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    for w in doc["workloads"]:
        cell = bench.workload(w["name"])
        config = bench.config(cell["config"])
        assert config["name"] == cell["config"]
        assert cell["chips"] == 1
        bench.traffic(cell["traffic"])
        limits = bench.limits(w["name"])["limits"]
        assert set(limits) == {"rel_l1", "bad_px_share", "nonfinite_share"}
        assert limits["nonfinite_share"] == 0.0
        for kind in ("end_to_end", "per_layer"):
            assert bench.metrics(kind, w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in doc[kind]:
            assert callable(bench.reader(m["name"]))
    assert "setup_s" in {m["name"] for m in doc["end_to_end"]}


def test_unknown_names_are_refused(bench):
    with pytest.raises(KeyError, match="no workload named"):
        bench.workload("no-such.cell")
    with pytest.raises(KeyError, match="no config named"):
        bench.config("no-such")


def test_new_cell_and_metric_are_files(bench, tmp_path):
    """A later PR's cell and metric: new files and new manifest entries."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(bench.root, "ptbench"), root / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    doc = json.loads(json.dumps(bench.doc))
    doc["workloads"].append({"name": "water-plastic.fixture", "config": "water-plastic",
                             "traffic": "fixture", "chips": 1, "why": "a fixture"})
    doc["per_layer"].append({"name": "fixture_count", "unit": "n", "better": "lower",
                             "source": "program_counter", "layer": "frame loop",
                             "moves": "frame_ms", "workloads": ["water-plastic.fixture"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    (root / "ptbench" / "traffic" / "fixture.json").write_text(json.dumps(
        {"render": {"samples_per_frame": 3}, "warmup_frames": 1}))
    (root / "ptbench" / "metrics" / "fixture_count.py").write_text(
        "def read(run):\n    return 42.0\n")
    b = Bench(str(root))
    cell = b.workload("water-plastic.fixture")
    assert b.traffic(cell["traffic"])["render"] == {"samples_per_frame": 3}
    # a mix's file sets a run setting for its cell; other cells keep the harness's
    assert Run(b, "water-plastic.fixture", 1, device="cpu").setting("warmup_frames") == 1
    assert Run(b, "water-plastic.rgb", 1, device="cpu").setting("warmup_frames") == \
        harness.WARMUP_FRAMES
    names = [m["name"] for m in b.metrics("per_layer", "water-plastic.fixture")]
    assert "fixture_count" in names
    assert "fixture_count" not in [m["name"] for m in b.metrics("per_layer",
                                                                 "water-plastic.rgb")]
    assert b.reader("fixture_count")(None) == 42.0
