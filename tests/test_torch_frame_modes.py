"""The frame modes of tpu_pathtracer_torch against the reference's: fused
multi-sample wavefronts, row tiles, the unsorted pipeline, prefix sorts,
sort skips, zero-NEE culling, TILED noise, the r2 sampler and the
quirk-free estimator, on frames of 24x32 to 48x64.

Tolerances: frames against the reference to atol 1e-5, as
tests/test_torch_frame.py holds the default path (the port's plain kernel
versions test Baldwin-Weber planes where the reference's CPU frame tests
every triangle with Moller-Trumbore, and XLA contracts multiply-adds);
frames of the port against the port at the bounds of the reference's own
tests of the same modes (tests/test_modes.py); schedules and ray counts
exactly.  The reference's frames take its CPU path: ``render_frame_jit``
with the brute intersector and the pipeline its RenderConfig picks.
"""

import jax
import numpy as np
import pytest

from tpu_pathtracer.config import NoiseMode as JNoise
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.render import init_state as jinit_state
from tpu_pathtracer.render import render_frame_jit as jrender_frame_jit
from tpu_pathtracer.render import state as jstate
from tpu_pathtracer.render import stats as jstats
from tpu_pathtracer.render import wavefront as jwf
from tpu_pathtracer.renderer import Renderer as JRenderer
from tpu_pathtracer.scene import load_scene, scene_path
from tpu_pathtracer_torch import Renderer, RenderConfig, interop
from tpu_pathtracer_torch.config import NoiseMode
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.render import state as tstate
from tpu_pathtracer_torch.render import stats as tstats
from tpu_pathtracer_torch.render import wavefront as twf
from torch_parity import arrays, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
H, W = 24, 32
KERNELS = ("window_walk", "window_walk_orig", "capped_walk", "anyhit_walk", "minwalk")


def _launches():
    return tuple(getattr(ht, k).launches for k in KERNELS)


def _configs(kw):
    """The same fields as a reference and a port RenderConfig."""
    noise = kw.get("noise_mode")
    jkw = {**kw, **({"noise_mode": JNoise(noise)} if noise is not None else {})}
    tkw = {**kw, **({"noise_mode": NoiseMode(noise)} if noise is not None else {})}
    return JConfig(**jkw), RenderConfig(**tkw)


def _reference(scene_name, kw, frames, h=H, w=W):
    jcfg, _ = _configs(kw)
    scene = load_scene(scene_path(scene_name))
    state = jinit_state(h, w)
    for _ in range(frames):
        state = jrender_frame_jit(state, scene, jcfg)
    return np.asarray(state.accum)


def _port(scene_name, kw, frames, h=H, w=W):
    _, cfg = _configs(kw)
    r = Renderer(scene_name, w, h, cfg, device="cpu")
    before = _launches()
    r.run(frames)
    assert _launches() == before  # CPU tensors: plain versions only
    img = r.image()
    assert np.isfinite(img).all() and img.max() > 0
    return img


@pytest.mark.parametrize("spp,budget", [(1, 2), (2, 2), (5, 2), (5, 3), (4, 4), (3, 8),
                                        (6, 0), (7, 1)])
def test_fuse_schedule_matches_reference(spp, budget):
    jcfg, cfg = _configs({"samples_per_frame": spp, "fuse_samples": budget})
    assert tstate.fuse_schedule(cfg, spp) == jstate.fuse_schedule(jcfg, spp)


@pytest.mark.parametrize("kw,frames", [
    ({"samples_per_frame": 4, "fuse_samples": 4}, 2),
    ({"samples_per_frame": 5, "fuse_samples": 2}, 2),
    ({"sort_rays": False}, 2),
    ({"noise_mode": 1}, 4),
    ({"noise_mode": 1, "animate_noise": False}, 4),
    ({"sampler": "r2"}, 2),
    ({"reference_quirks": False}, 2),
], ids=lambda v: ",".join(f"{k}={x}" for k, x in v.items()) if isinstance(v, dict) else str(v))
def test_frame_mode_matches_reference(kw, frames):
    """A cornellbox frame (24x32, depth 3) in each mode == the reference's
    frame in the same mode, atol 1e-5 (TILED: 4 frames, so that the
    frame//3 lookup offset moves)."""
    kw = {"max_path_length": 3, **kw}
    ref = _reference("cornellbox", kw, frames)
    got = _port("cornellbox", kw, frames)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [{"samples_per_frame": 5, "fuse_samples": 2},
                                {"samples_per_frame": 2, "row_tiles": 2}],
                         ids=("spp5-fuse2", "spp2-row-tiles2"))
def test_count_traced_rays_exact_matches_reference(kw):
    """count_traced_rays_exact follows fuse_schedule and the row tiles as
    the reference's does: the same count, exactly, over frames 0 and 4 (the
    brute intersector on both sides, as the reference's count takes by
    default)."""
    jcfg, cfg = _configs({"max_path_length": 3, **kw})
    scene = load_scene(scene_path("cornellbox"))
    tscene = interop.scene_from_arrays(arrays(scene))
    want = jstats.count_traced_rays_exact(scene, jcfg, H, W, frame_indices=(0, 4))
    got = tstats.count_traced_rays_exact(tscene, cfg, H, W, frame_indices=(0, 4),
                                         intersect=twf.make_brute_intersector(tscene))
    assert got == want > H * W * cfg.samples_per_frame


@pytest.mark.parametrize("kw", [{"intersector": "brute"}, {"use_pallas": False}],
                         ids=("brute", "walker"))
def test_portable_backends_take_the_unsorted_pipeline(kw, monkeypatch):
    """The reference's pipeline rule: off the kernel path (intersector
    "brute", or use_pallas False) pixels run row-major, unsorted, with each
    bounce's shadow query traced in the bounce and no live-prefix ladder.
    sort_wavefront and the ladder's prefix cut raise if called; the image
    equals the reference's (atol 1e-5) and the exact traced-ray count the
    reference's exactly."""
    def refuse(*a, **k):
        raise AssertionError("the unsorted pipeline sorted or cut a prefix")

    orders = []
    make_order = twf.make_order

    def order(*a, **k):
        orders.append(a[3] if len(a) > 3 else k.get("tile"))
        return make_order(*a, **k)

    monkeypatch.setattr(twf, "sort_wavefront", refuse)
    monkeypatch.setattr(twf, "_prefix", refuse)
    monkeypatch.setattr(twf, "make_order", order)
    kw = {"max_path_length": 3, "secondary_tile": 16, **kw}
    jcfg, cfg = _configs(kw)
    jr = JRenderer("cornellbox", W, H, jcfg)
    r = Renderer("cornellbox", W, H, cfg, device="cpu")
    # frame 0's sample with its exact ray count, one compile of the
    # reference's render_sample on its backend
    jkey = jstate.fused_wavefront_key(jstate.frame_rng_key(jcfg, jr.state.key, 0))
    ref, want = jax.jit(lambda: jwf.render_sample(
        jr.scene, jcfg, jr.camera, H, W, jkey, 0, jr._intersect, with_ray_count=True))()
    key = tstate.fused_wavefront_key(tstate.frame_rng_key(cfg, r.state.key, 0))
    got, n = twf.render_sample(r.scene, cfg, r.camera, H, W, key, 0, r._intersect,
                               with_ray_count=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert orders and all(t is None for t in orders)  # row-major
    assert int(n) == int(want) > H * W


def test_kernel_path_still_sorts(monkeypatch):
    """The kernel path (the default) sorts before each secondary bounce;
    sort_rays=False there does not: the rule above is not a blanket
    switch-off."""
    calls = []
    sort = twf.sort_wavefront
    monkeypatch.setattr(twf, "sort_wavefront",
                        lambda *a, **k: calls.append(1) or sort(*a, **k))
    Renderer("cornellbox", W, H, RenderConfig(max_path_length=3), device="cpu").run(1)
    assert len(calls) == 2
    calls.clear()
    Renderer("cornellbox", W, H, RenderConfig(max_path_length=3, sort_rays=False),
             device="cpu").run(1)
    assert not calls


@pytest.mark.parametrize("spp,fuse,size,frames", [(4, 1, (32, 48), 2), (5, 1, (24, 32), 1)],
                         ids=("spp4", "spp5-odd-chunks"))
def test_fused_samples_match_per_sample_loop(spp, fuse, size, frames):
    """Fusion changes only the wavefront grouping: fuse 1 against fuse 4
    (spp 4) and fuse 2 (spp 5: chunks 2 + 2 + 1), the bound of the
    reference's tests/test_modes.py:395,410 (atol 1e-6, rtol 1e-5)."""
    base = {"samples_per_frame": spp, "max_path_length": 4 if spp == 4 else 3}
    a = _port("cornellbox", {**base, "fuse_samples": fuse}, frames, *size)
    b = _port("cornellbox", {**base, "fuse_samples": 4 if spp == 4 else 2}, frames, *size)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_row_tiles_match_untiled():
    """cfg.row_tiles 4 and 24 against the untiled frame (spp 2, depth 3, 2
    frames; the reference's tests/test_modes.py:438 bound, atol 2e-6), and
    the ValueError when the tiles do not divide the height."""
    base = {"samples_per_frame": 2, "max_path_length": 3}
    a = _port("cornellbox", base, 2)
    for tiles in (4, 24):
        np.testing.assert_allclose(_port("cornellbox", {**base, "row_tiles": tiles}, 2),
                                   a, atol=2e-6)
    r = Renderer("cornellbox", W, 25, RenderConfig(row_tiles=4, **base), device="cpu")
    with pytest.raises(ValueError, match="row_tiles"):
        r.run(1)


@pytest.mark.parametrize("kw", [{"prefix_sort": True}, {"sort_bounce_skip": "1,4,5"}],
                         ids=("prefix-sort", "sort-skip-1,4,5"))
def test_sort_modes_match_default(kw, monkeypatch):
    """cfg.prefix_sort (the sort at the ladder rung's width) and
    cfg.sort_bounce_skip="1,4,5" (the first and the last bounces keep the
    last sort's order and rung) against the default sorts: cornellbox
    48x64, depth 6 (the skip list needs 6), secondary_tile 256 and
    live_ladder 2 (rungs 3072, 1536), 2 frames; the reference's
    tests/test_modes.py:330,489 bound (atol 2e-6, rtol 1e-5).  The sorts
    run at the widths the modes give."""
    base = {"max_path_length": 6, "secondary_tile": 256, "live_ladder": 2}
    a = _port("cornellbox", base, 2, 48, 64)
    widths = []
    sort = twf.sort_wavefront
    monkeypatch.setattr(twf, "sort_wavefront",
                        lambda st, *a, **k: widths.append(st.alive.shape[0])
                        or sort(st, *a, **k))
    b = _port("cornellbox", {**base, **kw}, 2, 48, 64)
    np.testing.assert_allclose(b, a, atol=2e-6, rtol=1e-5)
    if "prefix_sort" in kw:
        assert len(widths) == 2 * 5 and 1536 in widths
    else:
        assert widths == [3072, 3072] * 2  # bounces 2 and 3 of each frame


def test_cull_zero_nee_bit_identical():
    """cfg.cull_zero_nee skips shadow walks whose contribution is exactly
    zero: the same image bit for bit (the reference's
    tests/test_modes.py:551, Water-plastic, 48x64, depth 5), with fewer
    traced rays."""
    base = {"max_path_length": 5, "secondary_tile": 256, "live_ladder": 2}
    a = _port("CornellBox-Water-plastic", base, 2, 48, 64)
    b = _port("CornellBox-Water-plastic", {**base, "cull_zero_nee": True}, 2, 48, 64)
    np.testing.assert_array_equal(a, b)
    scene = Renderer("CornellBox-Water-plastic", 8, 8, device="cpu").scene
    counts = [tstats.count_traced_rays_exact(scene, RenderConfig(**base, cull_zero_nee=c),
                                             48, 64) for c in (False, True)]
    assert counts[1] < counts[0]


def test_samples_guard_and_tiled_fusion():
    """The uint32 virtual-id guard (samples_per_frame * pixels <= 2**32) of
    sample_sum, and render_sample's refusal to fuse samples under TILED
    noise (it decodes the pixel from the id)."""
    r = Renderer("cornellbox", 8, 8, RenderConfig(max_path_length=1), device="cpu")
    big = RenderConfig(samples_per_frame=2**26 + 1, max_path_length=1)
    with pytest.raises(ValueError, match="uint32"):
        tstate.sample_sum(r.scene, big, r.camera, 8, 8, r.state.key, 0, r._intersect)
    tiled = RenderConfig(noise_mode=NoiseMode.TILED, max_path_length=1)
    with pytest.raises(ValueError, match="PRNG"):
        twf.render_sample(r.scene, tiled, r.camera, 8, 8, r.state.key, 0, r._intersect,
                          samples=2)


def test_count_traced_rays_probe_matches_reference():
    """count_traced_rays, the reference's scaled brute-force probe (1-spp
    frame 0 at a quarter of the resolution, scaled by area and spp), gives
    the reference's estimate exactly."""
    scene = load_scene(scene_path("cornellbox"))
    tscene = interop.scene_from_arrays(arrays(scene))
    for kw in ({"max_path_length": 3}, {"max_path_length": 4, "samples_per_frame": 3}):
        jcfg, cfg = _configs(kw)
        want = jstats.count_traced_rays(scene, jcfg, 48, 64)
        assert tstats.count_traced_rays(tscene, cfg, 48, 64) == want > 0


def test_lane_guard_raises_before_int32_wrap():
    """The kernel wrappers refuse a lane count whose widest plane offset
    (minwalk's 12 output rows) would wrap an int32, before touching the
    device; a fused 4-spp 1080p wavefront through the fused walk (16,588,800
    lanes) is far inside it."""
    import torch

    n = (2 ** 31) // ht.MAX_PLANES + 1
    with pytest.raises(ValueError, match="int32 plane offsets"):
        ht._check(torch.empty((3, n), device="meta"), torch.float32, (3, n), "o")
    assert ht.MAX_PLANES * 2 * 4 * 1920 * 1080 < 2 ** 31
