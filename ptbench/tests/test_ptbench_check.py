"""The check that decides ``correct`` fails what it must: the control (the
reference in bfloat16 in the program's place) and a run whose timed path is
broken underneath, at sizes a test run holds (the harness's look for a card
skipped, the program on its plain CPU versions)."""

import numpy as np
import pytest

from ptbench import check, harness
from ptbench.control import readings
from ptbench.harness import run_cell

SIZE = (8, 12)


def _small(bench, monkeypatch):
    """Two warm-up frames, a short profiled slice, and every traffic mix with
    a small sky map."""
    monkeypatch.setattr(harness, "WARMUP_FRAMES", 2)
    monkeypatch.setattr(harness, "PROFILE_AFTER", 1)
    monkeypatch.setattr(harness, "PROFILE_FRAMES", 2)
    traffic = bench.traffic

    def small(name):
        t = dict(traffic(name))
        t.update(env=t["env"] and {"height": 16, "width": 32})
        return t

    monkeypatch.setattr(bench, "traffic", small)


def test_numbers():
    want = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0], [4.0, 4.0, 4.0]])
    assert check.numbers(want, want) == {"rel_l1": 0.0, "bad_px_share": 0.0,
                                         "nonfinite_share": 0.0}
    got = want.copy()
    got[2, 0] = 4.2
    v = check.numbers(got, want)
    assert v["rel_l1"] == pytest.approx(0.2 / 18)
    assert v["bad_px_share"] == pytest.approx(1 / 3)
    assert v["nonfinite_share"] == 0.0
    # a value that is not finite reads as 0 in the first two numbers and
    # fails the third, even in a black pixel
    got[1, 0] = np.nan
    v = check.numbers(got, want)
    assert v["rel_l1"] == pytest.approx(0.2 / 18) and v["nonfinite_share"] == pytest.approx(1 / 3)
    correct, checks = check.verdict(v, {"rel_l1": 1.0, "bad_px_share": 1.0,
                                        "nonfinite_share": 0.0})
    assert not correct and set(checks) == {"rel_l1", "bad_px_share", "nonfinite_share"}


def test_reference_models_only_path_neutral_settings():
    with pytest.raises(ValueError, match="does not model"):
        check.spec_of({"max_path_length": 8}, {"render": {"refract_dielectric": True}}, 4, 4)


@pytest.mark.parametrize("workload", ["water-plastic.rgb", "water-plastic.spectral-env"])
def test_control_fails_the_limits(bench, monkeypatch, workload):
    _small(bench, monkeypatch)
    r = readings(bench, workload, 41, 0.2, device="cpu", size=SIZE)
    limits = bench.limits(workload)["limits"]
    assert check.verdict(r["program"], limits)[0], r
    assert not check.verdict(r["control"], limits)[0], r


def _unchanged(monkeypatch):
    """A frame step that renders its frame and returns its state unchanged."""
    from tpu_pathtracer_torch import renderer

    render_frame = renderer.render_frame

    def unchanged(state, *a, **k):
        render_frame(state, *a, **k)
        return state

    monkeypatch.setattr(renderer, "render_frame", unchanged)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: one of two
    samples a frame, or (1 spp) every other pixel row copied from the row
    traced above it."""
    from tpu_pathtracer_torch.render import state as st

    sample_sum = st.sample_sum

    def half(scene, cfg, *a, **k):
        if cfg.samples_per_frame > 1:
            return sample_sum(scene, cfg, *a, sample_count=1, **k) * cfg.samples_per_frame
        out = sample_sum(scene, cfg, *a, **k)
        out[1::2] = out[0::2][:out[1::2].shape[0]]
        return out

    monkeypatch.setattr(st, "sample_sum", half)


def _altered(monkeypatch):
    """A pixel's radiance altered where it is produced: one in eight
    doubled in every sample."""
    from tpu_pathtracer_torch.render import state as st

    render_sample = st.render_sample

    def altered(*a, **k):
        img = render_sample(*a, **k)
        flat = img.reshape(-1, img.shape[-1])
        flat[::8] *= 2.0
        return img

    monkeypatch.setattr(st, "render_sample", altered)


@pytest.mark.parametrize("workload,fault", [
    ("water-plastic.rgb", _unchanged), ("water-plastic.rgb", _half_batch),
    ("water-plastic.rgb", _altered), ("water-plastic.spp2-fuse2", _half_batch),
    ("water-plastic.spectral-env", _altered)])
def test_broken_timed_path_is_not_correct(bench, monkeypatch, workload, fault):
    _small(bench, monkeypatch)
    fault(monkeypatch)
    res = run_cell(bench, workload, 2 ** 31 + 99, 0.2, False, device="cpu", size=SIZE,
                   log=lambda msg: None)
    assert res["correct"] is False, res["checks"]


def test_sound_run_is_correct(bench, monkeypatch):
    _small(bench, monkeypatch)
    res = run_cell(bench, "water-plastic.spp2-fuse2", 2 ** 31 + 99, 0.2, True,
                   device="cpu", size=SIZE, log=lambda msg: None)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"renderer_init_s", "kernel_load_s"}
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
