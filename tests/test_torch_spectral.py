"""The spectral extensions of tpu_pathtracer_torch against the reference's, on
the CPU: true spectra (S > 3), hero wavelengths, dispersion, the spectral
save, and the spectral CLI flags.

Tolerances, each with its reason:
  * bin wavelengths, the RGB lift, Cauchy IoR bins, apply_bins and hero
    bins: bit-equal (the same float32 arithmetic, or a selection);
  * to_rgb: rtol 1e-6 (the reference's band average is an XLA dot, whose
    CPU library sums the S products in its own order: 1 ulp);
  * dispersion weights: rtol/atol 1e-6 (torch_parity.py's band: XLA
    contracts multiply-adds, torch does not);
  * frames: atol 1e-5 on every pixel but 3 (torch_parity.py:
    assert_frames_agree, the one-lane band of ROADMAP.md queue 3), 2
    frames; the reference's frames take its CPU path (render_frame_jit with
    the brute intersector and the pipeline its RenderConfig picks), the
    port's run its kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.core import spectrum as jspec
from tpu_pathtracer.models import bsdf as jbsdf
from tpu_pathtracer.render import init_state as jinit_state
from tpu_pathtracer.render import noise as jnoise
from tpu_pathtracer.render import render_frame_jit as jrender_frame_jit
from tpu_pathtracer.scene import attach_dispersion as jattach_dispersion
from tpu_pathtracer.scene import attach_env as jattach_env
from tpu_pathtracer.scene import load_scene as jload_scene
from tpu_pathtracer.scene import scene_path
from tpu_pathtracer_torch import Renderer, RenderConfig, cli
from tpu_pathtracer_torch.core import spectrum as tspec
from tpu_pathtracer_torch.io.exr import read_exr, write_exr
from tpu_pathtracer_torch.models import bsdf as tbsdf
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.render import noise as tnoise
from tpu_pathtracer_torch.render import wavefront as twf
from tpu_pathtracer_torch.scene import attach_dispersion, attach_env, load_scene
from torch_parity import assert_frames_agree, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
H, W = 24, 32
SPECTRA = (3, 4, 8, 16, 31)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("s", SPECTRA)
def test_bin_wavelengths_and_rgb_lift_match_reference(s):
    """bin_wavelengths equals jnp.linspace(400, 700, S) bit for bit (at S =
    31 bin 9 is 490.0 exactly, so an ulp decides the band), the RGB lift
    is bit-equal, the band average within 1 ulp, and the Cauchy bins
    bit-equal."""
    np.testing.assert_array_equal(_bits(tspec.bin_wavelengths(s)),
                                  _bits(jspec.bin_wavelengths(s)))
    rng = np.random.default_rng(s)
    rgb = rng.uniform(0.0, 2.0, (40, 3)).astype(np.float32)
    want = _bits(jspec.from_rgb(jnp.asarray(rgb), s))
    np.testing.assert_array_equal(_bits(tspec.from_rgb(rgb, s)), want)
    np.testing.assert_array_equal(_bits(tspec.from_rgb(torch.from_numpy(rgb), s)), want)
    spec = rng.uniform(0.0, 2.0, (5, 7, s)).astype(np.float32)
    want = np.asarray(jspec.to_rgb(jnp.asarray(spec)))
    np.testing.assert_allclose(tspec.to_rgb(spec), want, rtol=1e-6, atol=0)
    for ior, b in ((1.5, 0.0042), (1.33333, 0.0031)):
        np.testing.assert_array_equal(_bits(tspec.cauchy_ior_bins(ior, b, s)),
                                      _bits(jspec.cauchy_ior_bins(ior, b, s)))


def test_band_edges_match_reference_for_every_spectrum_size():
    """The band each bin falls in (what from_rgb and to_rgb key on) equals
    the reference's for every S from 4 to 64."""
    for s in range(4, 65):
        lam = np.asarray(jnp.linspace(jspec.LAMBDA_MIN, jspec.LAMBDA_MAX, s))
        want = (lam < 490.0, (lam >= 490.0) & (lam < 580.0), lam >= 580.0)
        for got, ref in zip(tspec._bands(s), want):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("s,c", [(8, 3), (16, 4), (4, 6)])
def test_apply_bins_matches_reference(s, c):
    """apply_bins as one gather == the reference's chain of S selects, bit
    for bit (C > S too: a lane may draw one bin twice)."""
    rng = np.random.default_rng(c)
    vals = rng.uniform(-1.0, 2.0, (s, 300)).astype(np.float32)
    bins = rng.integers(0, s, (c, 300))
    want = jspec.apply_bins(jnp.asarray(vals), jnp.asarray(bins, jnp.int32))
    got = tspec.apply_bins(torch.from_numpy(vals), torch.from_numpy(bins))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    t = torch.from_numpy(vals)
    assert tspec.apply_bins(t, None) is t


@pytest.mark.parametrize("s,c", [(8, 2), (8, 3), (16, 4), (16, 5), (31, 7), (4, 6)])
def test_hero_bins_match_reference(s, c):
    """hero_bins (the stratified rotation of C bins over S) equals the
    reference's bin for bin, over frames and virtual pixel ids."""
    pids = np.concatenate([np.arange(0, 2000, 3), 2 ** 31 + np.arange(50)]).astype(np.uint32)
    key = jax.random.PRNGKey(7)
    for frame in (0, 5):
        jcfg = JConfig(spectrum_samples=s, hero_wavelengths=c)
        want = np.asarray(jnoise.hero_bins(jcfg, key, jnp.int32(frame), jnp.asarray(pids)))
        got = tnoise.hero_bins(RenderConfig(spectrum_samples=s, hero_wavelengths=c),
                               np.asarray(jax.random.key_data(key)), frame,
                               torch.from_numpy(pids.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int64 and ((got >= 0) & (got < s)).all()


@pytest.mark.parametrize("hero", [0, 4])
def test_dispersion_weights_match_reference(hero):
    """The per-bin lobe weights of every material type, on the bounce arm
    (the tracked ray IoR) and the NEE arm (eta_out 1.0), full spectrum and
    hero view: rtol/atol 1e-6 where the ray meets the front of the surface;
    rtol 1e-5 where it meets the back (the one-sided Fresnel's denominators
    nearly cancel there, F reaches the hundreds, and the ratio F_b/F_h
    magnifies the multiply-add ulp tenfold)."""
    rng = np.random.default_rng(5 + hero)
    n = 256
    s = 16
    w_i = rng.normal(size=(3, n)).astype(np.float32)
    w_i /= np.linalg.norm(w_i, axis=0, keepdims=True)
    nrm = rng.normal(size=(3, n)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    mtype = rng.integers(0, 7, n).astype(np.int32)
    ior = rng.uniform(1.1, 1.8, n).astype(np.float32)
    cur = np.where(rng.random(n) < 0.5, np.float32(1.00029), ior).astype(np.float32)
    ior_bins = np.stack([jspec.cauchy_ior_bins(float(x), 0.0042, s) for x in ior], 1)
    ior_bins = np.asarray(ior_bins, np.float32)
    if hero:
        bins = rng.integers(0, s, (hero, n))
        ior_bins = np.take_along_axis(ior_bins, bins, 0)
    lobe = rng.random(n).astype(np.float32)
    for eta in (cur, 1.0):
        want = jbsdf.dispersion_weights(jnp.asarray(mtype), jnp.asarray(ior),
                                        jnp.asarray(ior_bins), jnp.asarray(w_i),
                                        jnp.asarray(nrm), jnp.asarray(lobe),
                                        jnp.asarray(eta) if eta is cur else eta)
        t = torch.from_numpy
        got = tbsdf.dispersion_weights(t(mtype.astype(np.int64)), t(ior), t(ior_bins),
                                       t(w_i), t(nrm), t(lobe),
                                       t(eta) if eta is cur else eta)
        front = (nrm * w_i).sum(0) < 0
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[:, front], want[:, front], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[:, ~front], want[:, ~front], rtol=1e-5, atol=1e-6)


def _reference(scene, kw, frames=2, h=H, w=W):
    state = jinit_state(h, w, 0, kw.get("spectrum_samples", 3))
    for _ in range(frames):
        state = jrender_frame_jit(state, scene, JConfig(**kw))
    return np.asarray(state.accum)


def _port(scene, kw, frames=2, h=H, w=W):
    before = (ht.window_walk.launches, ht.capped_walk.launches)
    r = Renderer(scene, w, h, RenderConfig(**kw), device="cpu")
    r.run(frames)
    assert (ht.window_walk.launches, ht.capped_walk.launches) == before
    return r.image()


# the ladder cases cut 768 lanes to 384 and 192 (secondary_tile 32)
LADDER = {"secondary_tile": 32, "live_ladder": 3}


@pytest.mark.parametrize("kw", [
    {"spectrum_samples": 8},
    {"spectrum_samples": 8, "hero_wavelengths": 4},
    {"spectrum_samples": 8, "hero_wavelengths": 4, **LADDER},
    {"spectrum_samples": 8, "hero_wavelengths": 4, "prefix_sort": True, **LADDER},
    {"spectrum_samples": 8, "hero_wavelengths": 4, "sort_rays": False},
    {"spectrum_samples": 16, "hero_wavelengths": 4, "samples_per_frame": 2,
     "fuse_samples": 2},
    {"spectrum_samples": 4, "hero_wavelengths": 6},
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_spectral_frame_matches_reference(kw):
    """A cornellbox frame (24x32, depth 3) at S > 3, full spectrum or hero
    sampled -- through the sort, the live-prefix ladder, the prefix sorts,
    the unsorted pipeline and fused samples, and C > S (a lane hitting a bin
    twice adds twice) -- equals the reference's frame."""
    kw = {"max_path_length": 3, **kw}
    s = kw["spectrum_samples"]
    ref = _reference(jload_scene(scene_path("cornellbox"), samples=s), kw)
    got = _port(load_scene(scene_path("cornellbox"), samples=s, device="cpu"), kw)
    assert got.shape == (H, W, s)
    assert_frames_agree(got, ref)


@pytest.mark.parametrize("kw", [
    {"spectrum_samples": 16, "hero_wavelengths": 4},
    {"spectrum_samples": 8},
], ids=("S16-hero4", "S8"))
def test_dispersion_frame_matches_reference(kw):
    """Water-plastic with Cauchy dispersion (B = 0.0042 um^2 on its plastic
    materials), depth 4: the NEE and bounce arms' per-bin weights."""
    kw = {"max_path_length": 4, **kw}
    s = kw["spectrum_samples"]
    jscene = jattach_dispersion(
        jload_scene(scene_path("CornellBox-Water-plastic"), samples=s), 0.0042)
    scene = attach_dispersion(
        load_scene(scene_path("CornellBox-Water-plastic"), samples=s, device="cpu"), 0.0042)
    np.testing.assert_array_equal(scene.mat_ior_bins.numpy(), np.asarray(jscene.mat_ior_bins))
    assert_frames_agree(_port(scene, kw), _reference(jscene, kw))


def test_hero_env_frame_matches_reference():
    """An env-lit cornellbox at S = 8 with hero 4: the env's NEE and
    BSDF-arm reads take the lanes' bins (the any-hit walk's plain version
    answers the shadow queries)."""
    rng = np.random.default_rng(3)
    env = rng.uniform(0.05, 1.0, (8, 16, 3)).astype(np.float32)
    kw = {"max_path_length": 3, "spectrum_samples": 8, "hero_wavelengths": 4}
    jscene = jattach_env(jload_scene(scene_path("cornellbox"), samples=8), env)
    scene = attach_env(load_scene(scene_path("cornellbox"), samples=8, device="cpu"), env)
    np.testing.assert_array_equal(scene.env.radiance.numpy(), np.asarray(jscene.env.radiance))
    assert_frames_agree(_port(scene, kw), _reference(jscene, kw))


def test_hero_sort_carries_bins():
    """sort_wavefront moves the (C, N) bins with their lanes, and the
    ladder's prefix and splice pass None and (C, N) bins through."""
    rng = np.random.default_rng(1)
    n = 64
    st = twf.initial_path_state(torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)),
                                torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)),
                                3, torch.arange(n), torch.from_numpy(rng.integers(0, 8, (3, n))))
    st = st._replace(alive=torch.from_numpy(rng.random(n) < 0.6))
    pack = twf.ShadowPack(torch.zeros(3, n), torch.zeros(n), torch.zeros(n, dtype=torch.int64),
                          torch.zeros(3, n), torch.zeros(n, dtype=torch.bool))
    sst, _ = twf.sort_wavefront(st, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), pack)
    np.testing.assert_array_equal(sst.bins.numpy(), st.bins[:, sst.pixel].numpy())
    pre = twf._prefix(sst, 16)
    assert pre.bins.shape == (3, 16)
    pre = pre._replace(bins=pre.bins.flip(1))
    out = twf._splice(sst, pre)
    assert torch.equal(out.bins[:, :16], pre.bins)
    plain = twf._prefix(st._replace(bins=None), 16)
    assert plain.bins is None and twf._splice(st._replace(bins=None), plain).bins is None


def test_spectral_save_collapses_to_rgb(tmp_path):
    """The CLI at --spectrum 8 --hero 4 --dispersion writes an RGB EXR and
    PNG (the band-average collapse), equal to the renderer's rgb image."""
    exr, png = str(tmp_path / "s.exr"), str(tmp_path / "s.png")
    assert cli.main(["--platform", "cpu", "--scene", "CornellBox-Water-plastic",
                     "--width", "16", "--height", "12", "--depth", "3", "--frames", "2",
                     "--spectrum", "8", "--hero", "4", "--dispersion", "0.0042",
                     "-o", exr, "--png", png]) == 0
    img, _ = read_exr(exr)
    assert img.shape == (12, 16, 3) and np.isfinite(img).all() and img.mean() > 0
    spec = np.random.default_rng(0).uniform(0, 1, (4, 5, 8)).astype(np.float32)
    write_exr(str(tmp_path / "r.exr"), tspec.to_rgb(spec), half=False)
    np.testing.assert_allclose(read_exr(str(tmp_path / "r.exr"))[0],
                               np.asarray(jspec.to_rgb(jnp.asarray(spec))), rtol=1e-6)


def test_refract_with_dispersion_raises_as_the_reference():
    """refract_dielectric with a dispersive scene raises NotImplementedError
    in both packages (the per-bin reweighting is exact only for
    straight-through transmission); the CLI's --refract --dispersion too."""
    kw = {"max_path_length": 2, "spectrum_samples": 8, "refract_dielectric": True}
    jscene = jattach_dispersion(jload_scene(scene_path("cornellbox"), samples=8), 0.004)
    with pytest.raises(NotImplementedError, match="refract_dielectric"):
        _reference(jscene, kw, frames=1, h=4, w=4)
    scene = attach_dispersion(load_scene(scene_path("cornellbox"), samples=8,
                                         device="cpu"), 0.004)
    with pytest.raises(NotImplementedError, match="refract_dielectric"):
        _port(scene, kw, frames=1, h=4, w=4)
    with pytest.raises(NotImplementedError, match="refract_dielectric"):
        cli.main(["--platform", "cpu", "--width", "4", "--height", "4", "--frames", "1",
                  "--depth", "2", "--spectrum", "8", "--refract", "--dispersion", "0.004"])
