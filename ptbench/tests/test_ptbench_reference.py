"""The plain reference: a small frozen case, and agreement with the
program's frames (its plain CPU versions) for every traffic mix."""

import numpy as np
import pytest
import torch

from ptbench import check, reference, scenes


def _scene(s=3, **kw):
    return reference.Scene(reference.parse_obj(scenes.obj_path("CornellBox-Water-plastic")),
                           s, "cpu", **kw)


def test_frozen_case():
    got = reference.render_pixels(_scene(), dict(height=12, width=16, spp=1, depth=8, hero=0),
                                  np.array([5, 77, 150]), 2, 3)
    want = [[0.0, 0.0, 0.0],
            [0.027726975735276937, 0.02135457727126777, 0.06532478146255016],
            [0.27498864382505417, 0.24390374682843685, 0.23681057384237647]]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_frozen_case_spectral_env():
    sc = _scene(16, dispersion=0.0042, env_image=scenes.sky_map(8, 16, 4))
    got = reference.render_pixels(sc, dict(height=12, width=16, spp=2, depth=8, hero=4),
                                  np.array([21, 130]), 2, 4)[:, ::5]
    want = [[2.3385947942733765, 0.0, 0.0, 0.3652101457118988],
            [0.0, 0.0, 0.6438341066241264, 0.0]]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_bvh_against_every_triangle():
    sc = _scene()
    g = torch.Generator().manual_seed(1)
    n = 4000
    o = torch.rand(3, n, generator=g) * 1.8 - torch.tensor([[0.9], [0.0], [0.9]])
    d = torch.nn.functional.normalize(torch.randn(3, n, generator=g), dim=0)
    cap = torch.full((n,), 1e30)
    t, tri, _, _ = sc.bvh.nearest(o, d, torch.ones(n, dtype=torch.bool), cap)
    e1, e2 = sc.p[1] - sc.p[0], sc.p[2] - sc.p[0]
    rows = torch.cat([sc.p[0], e1, e2]).T[None].expand(n, -1, -1)
    tt, _, _ = reference._mt(o, d, rows)
    want_t, want_tri = torch.min(tt, dim=1)
    assert torch.equal(t, want_t)
    hit = torch.isfinite(want_t)
    assert torch.equal(tri[hit], want_tri[hit]) and (tri[~hit] == -1).all()
    # a cap below the nearest hit hides it
    t2, tri2, _, _ = sc.bvh.nearest(o, d, torch.ones(n, dtype=torch.bool), want_t * 0.5)
    assert torch.isinf(t2).all() and (tri2 == -1).all()


@pytest.mark.parametrize("workload", ["water-plastic.rgb", "water-plastic.spectral-env",
                                      "water-plastic.spp2-fuse2"])
def test_reference_follows_the_program(bench, monkeypatch, workload):
    """The program's frames (CPU: the kernels' plain versions) at the check's
    pixels against the reference: the same paths, to rounding."""
    from ptbench import harness

    monkeypatch.setattr(harness, "WARMUP_FRAMES", 2)
    run = harness.Run(bench, workload, 2 ** 31 + 5, device="cpu", size=(8, 12))
    run.traffic = {**run.traffic, "env": run.traffic["env"] and {"height": 16, "width": 32}}
    run.setup()
    got = run.program_pixels()
    run.release()
    want = run.reference_pixels()
    values = check.numbers(got, want)
    assert values["rel_l1"] < 1e-5 and values["bad_px_share"] == 0.0, values
    assert np.abs(want).sum() > 0
