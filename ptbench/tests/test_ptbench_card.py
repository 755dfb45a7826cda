"""On the card: a short run of each cell at a reduced size reads every metric
and is correct."""

import pytest

from ptbench.harness import run_cell

CELLS = ["water-plastic.rgb", "water-plastic.spectral-env", "water-plastic.spp2-fuse2"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_short_run(card, bench, workload, trace):
    res = run_cell(bench, workload, 2 ** 31 + 7, 1.0, trace, size=(270, 480),
                   log=lambda m: None)
    assert res["correct"], res["checks"]
    kind = "per_layer" if trace else "end_to_end"
    assert set(res["metrics"]) == {m["name"] for m in bench.metrics(kind, workload)}
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
