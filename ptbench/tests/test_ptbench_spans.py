"""The program's spans and counters in the benchmark: a synthetic trace with
the program's ranges added reads as before; device idle inside host spans
and the five readers of the frame records, against hand-computed values;
nothing to read without records; and on a real CPU profile the records'
spans land on the trace's own ranges."""

import json
import os
import statistics
from types import SimpleNamespace

import pytest
import torch

from ptbench import shade_bounds, spans
from ptbench.traces import SLICE, Trace

READERS = ("host_reads_per_frame", "prepare_idle_ms_per_frame", "read_idle_ms_per_frame",
           "lane_occupancy_pct", "shade_roofline_pct")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _base():
    """A slice 100..200 us: two sort kernels launched under aten::sort, a
    shading kernel under no op."""
    return [_x("user_annotation", SLICE, 100.0, 100.0),
            _x("cpu_op", "aten::sort", 105.0, 10.0),
            _x("cpu_op", "aten::copy_", 107.0, 2.0),
            _x("cuda_runtime", "cudaLaunchKernel", 108.0, 1.0, correlation=1),
            _x("cuda_runtime", "cudaLaunchKernel", 112.0, 1.0, correlation=2),
            _x("cuda_runtime", "cudaLaunchKernel", 150.0, 1.0, correlation=3),
            _x("kernel", "void cub::RadixKernel<int, 4>(int*)", 120.0, 10.0, tid=7,
               correlation=1),
            _x("kernel", "void cub::Scan(float)", 125.0, 10.0, tid=7, correlation=2),
            _x("kernel", "void (anonymous namespace)::shade_bounce_kernel<false, false, "
               "false>(ShadeParams)", 160.0, 20.0, tid=7, correlation=3)]


# the program's spans of that slice, on the trace's clock (us): one frame
PROGRAM = [("frame", 101.0, 190.0), ("prepare", 102.0, 104.0), ("host_read", 131.0, 140.0),
           ("bounce", 104.0, 189.0), ("shade", 149.0, 152.0), ("prepare", 152.0, 158.0)]


def _with_program(events):
    """The base trace with the program's ranges and their device shadows."""
    return events + [_x("user_annotation", n, a, b - a) for n, a, b in PROGRAM] + [
        _x("gpu_user_annotation", n, a + 15.0, b - a, tid=7) for n, a, b in PROGRAM]


def test_program_ranges_leave_every_reading():
    """The program's user_annotation ranges (and gpu_user_annotation ones)
    are neither device activities nor ops of a host stack: every reading of
    Trace is the same with them."""
    a, b = Trace(_base()), Trace(_with_program(_base()))
    assert a.device == b.device and a.stacks == b.stacks
    assert a.busy() == b.busy() and a.busy_s() == b.busy_s()
    assert a.top_idle_gaps() == b.top_idle_gaps()
    assert a.top_device_ops() == b.top_device_ops()
    for name, under in ((r"shade_bounce_kernel", None), (None, "aten::sort")):
        assert a.device_s(name, under=under) == b.device_s(name, under=under)
    assert (a.t0, a.t1, a.main_tid) == (b.t0, b.t1, b.main_tid)


def test_idle_inside_spans_by_hand():
    """Busy 120-135 and 160-180: idle 100-120, 135-160, 180-200."""
    tr = Trace(_with_program(_base()))
    assert spans.idle_gaps(tr) == [(100.0, 120.0), (135.0, 160.0), (180.0, 200.0)]
    # prepare 102-104 (2 us idle) and 152-158 (6 us); overlapping spans once
    assert spans.idle_within(tr, [(102.0, 104.0), (152.0, 158.0)]) == pytest.approx(8e-6)
    assert spans.idle_within(tr, [(150.0, 158.0), (152.0, 165.0)]) == pytest.approx(10e-6)
    assert spans.idle_within(tr, [(95.0, 205.0)]) == pytest.approx(65e-6)
    assert spans.idle_within(tr, [(125.0, 130.0)]) == 0.0
    # the gap 135-160 begins inside the read 131-140: counted whole
    assert spans.gaps_begun_in(tr, [(131.0, 140.0)]) == pytest.approx(25e-6)
    assert spans.gaps_begun_in(tr, [(136.0, 140.0), (170.0, 175.0)]) == 0.0


def _records(first: int):
    """Two frames' records; their spans on a host clock 5 ms (in ns) past
    the trace's, the first frame starting where the slice does."""
    def ns(t):
        return int((t + 5000.0) * 1e3)

    launch = dict(planes=3, hero=False, inline=False, env=False, dispersion=False,
                  kernel=True, env_picks=None, env_misses=None)
    frame0 = {"frame": first, "host_reads": 9, "host_read_s": 1e-5, "traced_rays": 10,
              "launches": [dict(launch, bounce=0, lanes=1000, live=1000),
                           dict(launch, bounce=1, lanes=500, live=400)],
              "spans": [[n, ns(a - 1.0), ns(b)] for n, a, b in PROGRAM]}
    frame1 = {"frame": first + 1, "host_reads": 7, "host_read_s": 1e-5, "traced_rays": 10,
              "launches": [dict(launch, bounce=1, lanes=250, live=100,
                                env=True, env_picks=30, env_misses=20)],
              "spans": [["frame", ns(190.0), ns(199.0)], ["prepare", ns(190.0), ns(192.0)],
                        ["host_read", ns(182.0), ns(186.0)]]}
    return [frame0, frame1]


def _scene(**tables):
    return SimpleNamespace(**{**dict.fromkeys(shade_bounds.TABLES), **tables})


def _run(records, trace, first=40, cuda=True, scene=None):
    renderer = SimpleNamespace(scene=scene or _scene())
    if records is not None:
        renderer.frame_records = records
    return SimpleNamespace(cuda=cuda, trace=trace, renderer=renderer, slice_first=first,
                           slice_frames=2)


def test_clock_offset_from_the_launches():
    """The shading kernel was launched at 150 us on the trace's clock, inside
    the record's shade span 5,148-5,152 us: the offset window is
    [-5,002, -4,998], its middle -5,000.  A sort span whose sort_key kernel
    was launched 3 us after its start narrows the window from above; no
    offset without an anchor whose launches and spans pair up, and the
    pairs' median where no one offset fits them all."""
    tr = Trace(_with_program(_base()))
    recs = _records(40)
    assert spans.clock_offset(tr, recs) == pytest.approx(-5000.0)
    assert spans.span_intervals(recs, "prepare", -5000.0) == [
        (101.0, 104.0), (151.0, 158.0), (190.0, 192.0)]
    two = [recs[0], dict(recs[1], spans=recs[1]["spans"] + [["shade", 1, 2]])]
    assert spans.clock_offset(tr, two) is None
    key = [_x("cuda_runtime", "cudaLaunchKernel", 170.0, 1.0, correlation=4),
           _x("kernel", "sort_key_kernel", 185.0, 2.0, tid=7, correlation=4)]
    # launched at 170 us in a sort span from 5,168.5 us: offsets -4,998.5 ..
    sort = [recs[0], dict(recs[1], spans=recs[1]["spans"] + [["sort", 5_168_500, 5_180_000]])]
    lo, hi, _ = spans.offset_window(Trace(_with_program(_base()) + key), sort)
    assert (lo, hi) == pytest.approx((-5002.0, -4998.5))
    late = [recs[0], dict(recs[1], spans=recs[1]["spans"] + [["sort", 5_200_000, 5_210_000]])]
    # the second pair allows -5,040 .. -5,030 only: no common window
    assert spans.clock_offset(Trace(_with_program(_base()) + key), late) == \
        pytest.approx((-5000.0 - 5035.0) / 2)


def test_readers_by_hand(bench):
    """The five readers on two frames' records over the synthetic slice
    (busy 120-135 and 160-180 us).  The spans move onto the trace's clock
    by the shading launch (each span of frame 0 starts 1 us before its
    range in PROGRAM), so
      host reads (9 + 7) / 2 = 8;
      prepare idle 101-104 (3 us) + 151-158 (7 us) + 190-192 (2 us) = 12 us
        over 2 frames = 0.006 ms;
      the reads 130-140 and 182-186: the gap 135-160 begins in the first,
        none in the second: 25 us / 2 = 0.0125 ms;
      occupancy of bounces 1..: (400 + 100) / (500 + 250) = 66.67%;
      roofline: none where the trace's shading kernels (one) are not the
        recorded launches (three); with the bounce-1 launch alone, its
        500 x 235 bytes and the scene's 80 bytes of tables at 3.35 TB/s
        over the kernel's 20 us."""
    tr = Trace(_with_program(_base()))
    recs = _records(40)
    got = {m: bench.reader(m)(_run(recs, tr)) for m in READERS}
    assert got["host_reads_per_frame"] == 8.0
    assert got["prepare_idle_ms_per_frame"] == pytest.approx(0.006)
    assert got["read_idle_ms_per_frame"] == pytest.approx(0.0125)
    assert got["lane_occupancy_pct"] == pytest.approx(100.0 * 500 / 750)
    assert got["shade_roofline_pct"] is None  # three launches, one kernel
    one = [dict(recs[0], launches=recs[0]["launches"][1:]), dict(recs[1], launches=[])]
    scene = _scene(mat_ior=torch.zeros(10), mat_type=torch.zeros(5, dtype=torch.int64))
    least = (500 * 235 + 80) / 3.35e12
    assert bench.reader("shade_roofline_pct")(_run(one, tr, scene=scene)) == \
        pytest.approx(100.0 * least / 20e-6)
    env = recs[1]["launches"][0]
    assert shade_bounds.shade_work(env, 0) == (250 * (235 + 16) + 30 * 28 + 20 * 16,
                                               250 * (390 + 60) + 30 * 80)


def test_nothing_to_read_without_records(bench):
    """A program that keeps no records (as before them), a slice not run on
    the card, a run without a trace, and records that miss a slice frame
    give no reading."""
    tr = Trace(_with_program(_base()))
    for run in (_run(None, tr), _run(_records(40), tr, cuda=False),
                _run(_records(40), None), _run(_records(41), tr)):
        assert {m: bench.reader(m)(run) for m in READERS} == dict.fromkeys(READERS)


def test_every_new_metric_is_declared(bench):
    """Each reader has its per_layer entry, moving frame_ms in every cell."""
    for m in READERS:
        entry = next(e for e in bench.doc["per_layer"] if e["name"] == m)
        assert entry["moves"] == "frame_ms" and "workloads" not in entry
        assert os.path.exists(os.path.join(bench.here, "metrics", f"{m}.py"))


def test_record_spans_are_the_trace_ranges(tmp_path):
    """On a real CPU profile of two frames, the records' spans are the
    trace's own ranges of the same names, once the frames' median offset is
    taken out (the host's wall clock and the profiler's tick at one rate):
    each start and end within 300 us of theirs.  The program reads its clock
    just inside each range, and the profiler's range ends trail that read by
    up to ~150 us on a loaded CPU host; the bounces, walks and shading are
    each a millisecond or more here."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_pathtracer_torch import Renderer, RenderConfig

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = Renderer("cornellbox", 64, 48, RenderConfig(max_path_length=3, secondary_tile=16),
                     device="cpu")
        r.step()
        r.sync()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(SLICE):
                r.step()
                r.step()
                r.sync()
    finally:
        torch.set_num_threads(n)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    recs = r.frame_records
    frames = spans.span_intervals(recs, "frame", 0.0)
    want = sorted(float(e["ts"]) for e in events if e["name"] == "frame")
    off = statistics.median(w - a for w, (a, _) in zip(want, frames))
    for name in ("frame", "prepare", "host_read", "bounce", "shade"):
        want = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                      if e["name"] == name)
        got = spans.span_intervals(recs, name, off)
        assert len(got) == len(want) > 0
        for (a, b), (c, d) in zip(got, want):
            assert abs(a - c) < 300.0 and abs(b - d) < 300.0
