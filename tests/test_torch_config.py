"""tpu_pathtracer_torch's config against the reference's, its JAX-free
import, every configuration the port covers, and the NotImplementedError of
the entry points it does not cover yet."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_pathtracer import config as jcfg
from tpu_pathtracer_torch import config as tcfg
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_fields_and_defaults_match_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.RenderConfig)]
    assert tf == jf
    assert (tcfg.PI, tcfg.IOR_AIR) == (jcfg.PI, jcfg.IOR_AIR)
    assert list(tcfg.NoiseMode) == list(jcfg.NoiseMode)
    assert list(tcfg.ComparisonMode) == list(jcfg.ComparisonMode)
    tcfg.check_supported(tcfg.RenderConfig())  # the main path is covered


def test_config_validation_matches_reference():
    for kw in ({"tritest": "nope"}, {"sort_bounce_skip": "9"},
               {"sort_bounce_skip": "1", "prefix_sort": True}):
        with pytest.raises(ValueError):
            jcfg.RenderConfig(**kw)
        with pytest.raises(ValueError):
            tcfg.RenderConfig(**kw)


def test_port_imports_without_jax():
    """Every module of the port imports with jax made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import tpu_pathtracer_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("kw", [
    {"spectrum_samples": 8}, {"spectrum_samples": 16, "hero_wavelengths": 4},
    {"refract_dielectric": True}, {"bake_materials": True},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_spectral_material_configs_are_supported(kw):
    """The spectral and material configurations are ported: check_supported
    passes (nothing is left in _UNSUPPORTED) and a Renderer frame is finite
    with the accumulator's S bins (tests/test_torch_spectral.py and
    tests/test_torch_materials.py hold each against the reference)."""
    from tpu_pathtracer_torch import Renderer

    assert tcfg._UNSUPPORTED == ()
    cfg = tcfg.RenderConfig(max_path_length=2, **kw)
    tcfg.check_supported(cfg)
    r = Renderer("cornellbox", 8, 8, cfg, device="cpu")
    r.run(1)
    img = r.image()
    assert img.shape == (8, 8, cfg.spectrum_samples) and np.isfinite(img).all()
    assert r.image(rgb=True).shape == (8, 8, 3)


@pytest.mark.parametrize("kw", [
    {"noise_mode": tcfg.NoiseMode.TILED}, {"sampler": "r2"}, {"samples_per_frame": 2},
    {"row_tiles": 2}, {"prefix_sort": True}, {"sort_bounce_skip": "1"},
    {"cull_zero_nee": True}, {"sort_rays": False},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_frame_mode_configs_are_supported(kw):
    """The frame modes are ported: check_supported passes and a Renderer
    frame in the mode is finite (tests/test_torch_frame_modes.py holds each
    against the reference)."""
    from tpu_pathtracer_torch import Renderer

    cfg = tcfg.RenderConfig(max_path_length=2, **kw)
    tcfg.check_supported(cfg)
    r = Renderer("cornellbox", 8, 8, cfg, device="cpu")
    r.run(1)
    img = r.image()
    assert img.shape == (8, 8, 3) and (img == img).all()


@pytest.mark.parametrize("kw", [
    {"fuse_shadow_walk": True}, {"traversal_kernel": "minwalk"},
    {"traversal_kernel": "sweep"},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_traversal_switches_are_supported(kw):
    """The bench's kernel switches are ported: check_supported passes and
    the Renderer's intersector carries the fused walk."""
    from tpu_pathtracer_torch import Renderer

    cfg = tcfg.RenderConfig(**kw)
    tcfg.check_supported(cfg)
    r = Renderer("cornellbox", 8, 8, cfg, device="cpu")
    assert callable(r._intersect.fused)


@pytest.mark.parametrize("kw", [
    {"tritest": "mt"}, {"intersector": "brute"}, {"use_pallas": False},
    {"hbm_tables": "on"},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_backend_configs_are_supported(kw):
    """The production-scale path's configurations are ported: check_supported
    passes and the Renderer builds the backend the reference's
    make_intersector picks (brute: no layout; the walker: no fused walk;
    the kernels: the route hbm_tables gives)."""
    from tpu_pathtracer_torch import Renderer

    cfg = tcfg.RenderConfig(**kw)
    tcfg.check_supported(cfg)
    r = Renderer("cornellbox", 8, 8, cfg, device="cpu")
    kernels = cfg.intersector == "bvh" and cfg.use_pallas
    assert (r.layout is None) == (cfg.intersector == "brute")
    assert hasattr(r._intersect, "fused") == kernels
    if kernels:
        assert r._intersect.hbm == (cfg.hbm_tables == "on")
    r.run(1)
    assert r.image().shape == (8, 8, 3)


def test_unsupported_entry_points_raise():
    from tpu_pathtracer_torch import Renderer
    from tpu_pathtracer_torch.models.camera import Camera, generate_rays_flat
    from tpu_pathtracer_torch.scene import load_scene, scene_path

    match = r"ROADMAP\.md queue 1: (multi-device|the directory checkpoint form)\)"
    with pytest.raises(NotImplementedError, match=match):
        Renderer("cornellbox", 8, 8, mesh=object(), device="cpu")
    # the spectral and material entry points are ported: each call succeeds
    Renderer("cornellbox", 8, 8, tcfg.RenderConfig(bake_materials=True), device="cpu")
    assert load_scene(scene_path("cornellbox"), rough_materials=True,
                      device="cpu").mat_roughness is None  # no rough MTL record
    assert load_scene(scene_path("cornellbox"), samples=8,
                      device="cpu").mat_diffuse.shape[0] == 8
    scene = load_scene(scene_path("cornellbox"), device="cpu")
    from tpu_pathtracer_torch.accel import build_layout
    assert build_layout(scene).num_tris == scene.p0.shape[1]
    with pytest.raises(ValueError, match="lies on"):
        Renderer(scene, 8, 8, device="meta")
    # the thin lens is ported: an aperture renders, and the Orbax checkpoint
    # directory form still raises
    import torch
    z = torch.zeros(4)
    o, _ = generate_rays_flat(Camera(aperture=0.1), z, z, torch.zeros(2, 4), 2, 2,
                              lens_u=torch.full((2, 4), 0.5))
    assert not torch.equal(o, generate_rays_flat(Camera(), z, z, torch.zeros(2, 4),
                                                 2, 2)[0])
    from tpu_pathtracer_torch.io.checkpoint import load_checkpoint
    with pytest.raises(NotImplementedError, match=match):
        load_checkpoint("state_dir")
