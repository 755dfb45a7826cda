"""graph_replays_per_frame (ptbench/metrics/graph_replays_per_frame.py): the
mean of the slice records' ``graph_replays``; nothing to read where the
program's records hold no such counter (a program without chain graphs),
where a record misses a slice frame, or off the card; its per_layer entry
moves frame_ms in every cell."""

import os
from types import SimpleNamespace

METRIC = "graph_replays_per_frame"


def _run(records, cuda=True, first=40):
    renderer = SimpleNamespace()
    if records is not None:
        renderer.frame_records = records
    return SimpleNamespace(cuda=cuda, trace=object(), renderer=renderer, slice_first=first,
                           slice_frames=2)


def _records(replays):
    return [{"frame": 40 + k, "graph_replays": n, "graph_captures": 0}
            for k, n in enumerate(replays)]


def test_reads_the_mean_replays_a_frame(bench):
    read = bench.reader(METRIC)
    assert read(_run(_records([8, 8]))) == 8.0
    assert read(_run(_records([8, 6]))) == 7.0


def test_nothing_to_read_without_the_counter(bench):
    read = bench.reader(METRIC)
    older = [{k: v for k, v in r.items() if not k.startswith("graph")}
             for r in _records([8, 8])]
    for run in (_run(None), _run(older), _run(_records([8, 8]), cuda=False),
                _run(_records([8, 8]), first=41)):
        assert read(run) is None


def test_declared_in_every_cell(bench):
    entry = next(e for e in bench.doc["per_layer"] if e["name"] == METRIC)
    assert entry == {"name": METRIC, "unit": "replays", "better": "higher",
                     "source": "program_counter",
                     "layer": "frame loop (renderer, render/state)", "moves": "frame_ms"}
    assert os.path.exists(os.path.join(bench.here, "metrics", f"{METRIC}.py"))
    for w in bench.doc["workloads"]:
        assert METRIC in {m["name"] for m in bench.metrics("per_layer", w["name"])}
