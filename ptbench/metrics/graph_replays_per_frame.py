"""graph_replays_per_frame: the bounce chains a frame of the traced slice
replayed as CUDA graphs, from ``Renderer.frame_records`` (``graph_replays``:
one a bounce in a steady frame whose bounces run as graphs,
tpu_pathtracer_torch/render/graphs.py); None where the program's records
hold no such counter."""

from ptbench import spans


def read(run):
    recs = spans.slice_records(run)
    if recs is None or any("graph_replays" not in r for r in recs):
        return None
    return sum(r["graph_replays"] for r in recs) / len(recs)
