"""The trace reader on a synthetic torch.profiler trace: kernels by name and
by the op that launched them, the busy union, and idle gaps named by what
the host was doing."""

import pytest

from ptbench.traces import SLICE, Trace, short_name


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _trace():
    ev = [_x("user_annotation", SLICE, 100.0, 100.0),
          # aten::sort launches two kernels; a ctypes launch under no op
          _x("cpu_op", "aten::sort", 105.0, 10.0),
          _x("cpu_op", "aten::copy_", 107.0, 2.0),
          _x("cuda_runtime", "cudaLaunchKernel", 108.0, 1.0, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernel", 112.0, 1.0, correlation=2),
          _x("cuda_runtime", "cudaLaunchKernel", 150.0, 1.0, correlation=3),
          _x("kernel", "void cub::RadixKernel<int, 4>(int*)", 120.0, 10.0, tid=7,
             correlation=1),
          _x("kernel", "void cub::Scan(float)", 125.0, 10.0, tid=7, correlation=2),
          _x("kernel", "void (anonymous namespace)::gather_planes_kernel<6>(Table)",
             160.0, 20.0, tid=7, correlation=3),
          # outside the slice: not read
          _x("kernel", "void gather_planes_kernel<6>(Table)", 230.0, 5.0, tid=7,
             correlation=9)]
    return Trace(ev)


def test_device_time_by_name_and_by_launching_op():
    tr = _trace()
    assert len(tr.device) == 3
    assert tr.device_s(r"gather_planes_kernel") == (pytest.approx(20e-6), 1)
    assert tr.device_s(None, under="aten::sort") == (pytest.approx(20e-6), 2)
    assert tr.device_s(r"gather_planes_kernel", under="aten::sort")[1] == 3
    assert tr.device_s(r"no_such_kernel") == (0.0, 0)


def test_busy_union_and_gaps():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy() == [[120.0, 135.0], [160.0, 180.0]]
    assert tr.busy_s() == pytest.approx(35e-6)
    gaps = dict(tr.top_idle_gaps())
    assert gaps["python -> aten::copy_"] == pytest.approx(20e-6)
    assert gaps["python -> (anonymous namespace)::gather_planes_kernel<6>"] == \
        pytest.approx(25e-6)
    assert gaps["python -> end of slice"] == pytest.approx(20e-6)
    ops = dict(tr.top_device_ops())
    assert ops["cub::RadixKernel<int, 4>"] == pytest.approx(10e-6)


def test_short_name():
    assert short_name("void foo<(bool)1, bar<2>>(Args, int)") == "foo<(bool)1, bar<2>>"
    assert short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"


def test_a_trace_without_the_slice_is_refused():
    with pytest.raises(ValueError, match=SLICE):
        Trace([_x("kernel", "k", 1.0, 1.0)])
