"""The reference's estimator gates held on tpu_pathtracer_torch: Mitsuba
goldens (assets/reference/) against port frames at the reference's sizes
and limits (tests/test_render_golden.py:36-56): 75x100, 48 spp in one frame
(fused two samples a wavefront, the default), rel_mse < 0.05 and 0.95 <
mean_ratio < 1.05.  The port renders on the CPU through its kernels' plain
versions, the default configuration otherwise."""

import numpy as np
import pytest

from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.io.exr import read_exr
from tpu_pathtracer_torch.scene.assets import golden_path
from tpu_pathtracer_torch.utils.compare import downsample, metrics
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 75, 100  # 600/8, 800/8


def _render(scene_name: str, depth: int, spp: int, **cfg_kw):
    cfg = RenderConfig(samples_per_frame=spp, max_path_length=depth, **cfg_kw)
    r = Renderer(scene_name, W, H, cfg, device="cpu")
    r.run(1)
    return r.image()


def _golden(scene_name: str, depth: int):
    gold, _ = read_exr(golden_path(scene_name, depth))
    return downsample(gold, H, W)


@pytest.mark.parametrize("depth", [2, 8])
def test_cornellbox_matches_mitsuba(depth):
    img = _render("cornellbox", depth, spp=48)
    m = metrics(img, _golden("cornellbox", depth))
    assert np.isfinite(img).all()
    assert m["rel_mse"] < 0.05, m
    assert 0.95 < m["mean_ratio"] < 1.05, m


def test_whitebox_direct():
    img = _render("white-box", 2, spp=48)
    m = metrics(img, _golden("white-box", 2))
    assert m["rel_mse"] < 0.05, m
    assert 0.95 < m["mean_ratio"] < 1.05, m


@pytest.mark.slow
def test_quirk_free_estimator_also_matches():
    img = _render("cornellbox", 8, spp=48, reference_quirks=False)
    m = metrics(img, _golden("cornellbox", 8))
    assert m["rel_mse"] < 0.05, m
