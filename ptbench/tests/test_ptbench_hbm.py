"""The HBM route's cell: its configuration against the committed scene,
and the reference against the program's frames there (CPU)."""

import numpy as np

from ptbench import check, reference, scenes

CELL = "spd-tetra8.rgb"


def test_the_configuration_is_the_committed_scene(bench):
    """The configuration names the committed scene at 1080p, depth 8, and
    the scene holds its triangles; the cell runs the rgb mix on one chip."""
    cfg = bench.config("spd-tetra8")
    assert (cfg["width"], cfg["height"], cfg["max_path_length"]) == (1920, 1080, 8)
    assert cfg["reduced"] == [] and cfg["size_factor"] == 8
    mesh = reference.parse_obj(scenes.obj_path(cfg["scene"]["obj"]))
    assert len(mesh["mat"]) == cfg["triangles"] == 4 ** 9 + 12
    cell = bench.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("spd-tetra8", "rgb", 1)
    limits = bench.limits(CELL)
    assert set(limits["limits"]) == {"rel_l1", "bad_px_share", "nonfinite_share"}


def test_reference_follows_the_program(bench, monkeypatch):
    """The program's frames of the cell at a test size (CPU: the kernels'
    plain versions, the HBM route) at the check's pixels against the
    reference: the same paths, to rounding."""
    from ptbench import harness

    monkeypatch.setattr(harness, "WARMUP_FRAMES", 2)
    run = harness.Run(bench, CELL, 2 ** 31 + 5, device="cpu", size=(8, 12))
    run.setup()
    assert run.renderer._intersect.hbm
    got = run.program_pixels()
    run.release()
    want = run.reference_pixels()
    values = check.numbers(got, want)
    assert values["rel_l1"] < 1e-5 and values["bad_px_share"] == 0.0, values
    assert np.abs(want).sum() > 0
