"""tpu_pathtracer_torch's CLI and I/O against the reference's, on the CPU:
the thin-lens camera, color transfer and PNG encoding, npz checkpoints
(each package resumes the other's), the CLI with an environment map, and
the live viewer.

Tolerances, each with its reason:
  * thin-lens rays: atol 1e-6 (XLA's and torch's sqrt, sin, cos and rsqrt
    differ by an ulp);
  * to_srgb / tonemap_exposure: atol 1e-6 (pow and exp differ by an ulp);
    to_linear also rtol 1e-6 (one ulp of pow on values above 1);
  * PNG bytes, checkpoint arrays: exact.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.core import color as jcolor
from tpu_pathtracer.io import checkpoint as jckpt
from tpu_pathtracer.io import png as jpng
from tpu_pathtracer.models import camera as jcam
from tpu_pathtracer.render.state import RenderState as JState
from tpu_pathtracer_torch import Renderer, RenderConfig, cli
from tpu_pathtracer_torch.core import color as tcolor
from tpu_pathtracer_torch.io import checkpoint as tckpt
from tpu_pathtracer_torch.io import png as tpng
from tpu_pathtracer_torch.io.exr import read_exr, write_exr
from tpu_pathtracer_torch.models import camera as tcam
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.render.state import RenderState
from tpu_pathtracer_torch.viewer import ViewerServer
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_thin_lens_rays_match_reference():
    """(e) Camera rays with aperture 0.05 == the reference's thin lens."""
    h, w = 24, 32
    rng = np.random.default_rng(4)
    rows = np.repeat(np.arange(h, dtype=np.int32), w)
    cols = np.tile(np.arange(w, dtype=np.int32), h)
    u = rng.random((4, h * w)).astype(np.float32)
    jo, jd = jcam.generate_rays_flat(
        jcam.Camera(t=jnp.float32(0.0), aperture=0.05, focus=2.5), jnp.asarray(rows),
        jnp.asarray(cols), jnp.asarray(u[0:2]), h, w, lens_u=jnp.asarray(u[2:4]))
    to, td = tcam.generate_rays_flat(
        tcam.Camera(aperture=0.05, focus=2.5), torch.from_numpy(rows),
        torch.from_numpy(cols), torch.from_numpy(u[0:2]), h, w,
        lens_u=torch.from_numpy(u[2:4]))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert np.ptp(to.numpy(), axis=1).max() > 0.01  # the lens spreads origins


def test_color_and_png_match_reference(tmp_path):
    """(f) to_linear / to_srgb / tonemap_exposure, png_bytes byte for byte,
    and read_png decodes what write_png wrote."""
    rng = np.random.default_rng(6)
    img = rng.uniform(-0.2, 3.0, (9, 13, 3)).astype(np.float32)
    for fn, rtol in (("to_linear", 1e-6), ("to_srgb", 0), ("tonemap_exposure", 0)):
        ref = np.asarray(getattr(jcolor, fn)(jnp.asarray(img)))
        np.testing.assert_allclose(getattr(tcolor, fn)(img), ref, rtol=rtol,
                                   atol=1e-6, err_msg=fn)
    disp = tcolor.to_srgb(tcolor.tonemap_exposure(img))
    assert tpng.png_bytes(disp) == jpng.png_bytes(disp)
    assert tpng.png_bytes(img[..., 0]) == jpng.png_bytes(img[..., 0])
    path = str(tmp_path / "d.png")
    tpng.write_png(path, disp)
    np.testing.assert_array_equal(tpng.read_png(path), jpng.read_png(path))
    # 8-bit sRGB codes decode back to within a code of the image
    np.testing.assert_allclose(tcolor.to_srgb(tpng.read_png(path)), disp, atol=1 / 255)


def test_npz_checkpoint_round_trips_between_packages(tmp_path):
    """(g) A checkpoint the port writes resumes in the reference with equal
    arrays, and the other way round; a path without .npz takes the port's
    directory form, which round-trips the same arrays."""
    rng = np.random.default_rng(8)
    accum = rng.random((6, 5, 3)).astype(np.float32)
    key = np.asarray([123, 4567], np.uint32)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, RenderState(torch.from_numpy(accum), 7, key))
    ref = jckpt.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(ref.accum), accum)
    assert int(ref.frame_index) == 7
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(ref.key)), key)

    path = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(path, JState(jnp.asarray(accum * 2), jnp.int32(11),
                                       jax.random.PRNGKey(42)))
    got = tckpt.load_checkpoint(path)
    np.testing.assert_array_equal(got.accum.numpy(), accum * 2)
    assert got.frame_index == 11
    np.testing.assert_array_equal(got.key, np.asarray(jax.random.key_data(
        jax.random.PRNGKey(42))))
    tckpt.save_checkpoint(str(tmp_path / "dir"), got)
    assert os.path.isfile(tmp_path / "dir" / "manifest.json")
    back = tckpt.load_checkpoint(str(tmp_path / "dir"))
    np.testing.assert_array_equal(back.accum.numpy(), accum * 2)
    assert back.frame_index == 11 and np.array_equal(back.key, got.key)


def test_cli_env_render_and_resume(tmp_path):
    """(h) The CLI on the CPU with an env map: EXR, PNG and checkpoint
    written, the image finite and lit, the resumed run continues at the
    saved frame; the live viewer (--serve) and the profiler also run."""
    rng = np.random.default_rng(12)
    env = rng.uniform(0.1, 2.0, (8, 16, 3)).astype(np.float32)
    write_exr(str(tmp_path / "env.exr"), env, half=False)
    p = {k: str(tmp_path / k) for k in ("o.exr", "o.png", "ck.npz", "r.png", "prof")}
    base = ["--platform", "cpu", "--scene", "cornellbox", "--width", "32",
            "--height", "24", "--depth", "3", "--env", str(tmp_path / "env.exr")]
    n0 = (ht.window_walk.launches, ht.capped_walk.launches, ht.anyhit_walk.launches)
    assert cli.main(base + ["--frames", "2", "-o", p["o.exr"], "--png", p["o.png"],
                            "--checkpoint", p["ck.npz"], "--hud-every", "1"]) == 0
    img, _ = read_exr(p["o.exr"])
    assert img.shape == (24, 32, 3) and np.isfinite(img).all() and img.mean() > 0
    assert tpng.read_png(p["o.png"]).shape == (24, 32, 3)
    assert tckpt.load_checkpoint(p["ck.npz"]).frame_index == 2
    assert cli.main(base + ["--frames", "1", "--resume", p["ck.npz"], "--png", p["r.png"],
                            "--checkpoint", p["ck.npz"], "--profile-dir", p["prof"],
                            "--serve", "0", "--aperture", "0.05"]) == 0
    # 2 saved + min(frames, 3) = 1 profiled + 1 served frame
    assert tckpt.load_checkpoint(p["ck.npz"]).frame_index == 4
    assert os.path.exists(os.path.join(p["prof"], "trace.json"))
    assert (ht.window_walk.launches, ht.capped_walk.launches,
            ht.anyhit_walk.launches) == n0


@pytest.mark.parametrize("flags", [["--mesh", "2x1"], ["--checkpoint", "state_dir"]],
                         ids=" ".join)
def test_cli_unported_flag_raises(flags, tmp_path):
    """The two flags that raised until the multi-device split and the
    directory checkpoint were ported now run: --mesh 2x1 (a virtual CPU
    mesh under --platform cpu) renders the single-device image bit for bit,
    and --checkpoint with a directory writes the sharded form, which
    --resume continues."""
    base = ["--platform", "cpu", "--width", "8", "--height", "8", "--frames", "1",
            "--depth", "1"]
    flags = [str(tmp_path / f) if f == "state_dir" else f for f in flags]
    assert cli.main(base + ["-o", str(tmp_path / "a.exr")] + flags) == 0
    assert cli.main(base + ["-o", str(tmp_path / "b.exr")]) == 0
    np.testing.assert_array_equal(read_exr(str(tmp_path / "a.exr"))[0],
                                  read_exr(str(tmp_path / "b.exr"))[0])
    if "--checkpoint" in flags:
        state_dir = flags[-1]
        assert os.path.isfile(os.path.join(state_dir, "manifest.json"))
        assert cli.main(base + ["--resume", state_dir, "--checkpoint", state_dir]) == 0
        assert tckpt.load_checkpoint(state_dir).frame_index == 2


@pytest.mark.parametrize("flags,want", [
    (["--noise", "tiled"], {"noise_mode": 1, "sampler": "prng"}),
    (["--noise", "r2"], {"noise_mode": 0, "sampler": "r2"}),
    (["--spp-per-frame", "3"], {"samples_per_frame": 3, "fuse_samples": 2}),
    (["--spp-per-frame", "2", "--fuse-samples", "1"],
     {"samples_per_frame": 2, "fuse_samples": 1}),
    (["--row-tiles", "2"], {"row_tiles": 2}), (["--prefix-sort"], {"prefix_sort": True}),
    (["--cull-zero-nee"], {"cull_zero_nee": True}),
    (["--sort-skip", "1"], {"sort_bounce_skip": "1"}),
    (["--spectrum", "8"], {"spectrum_samples": 8, "hero_wavelengths": 0}),
    (["--spectrum", "8", "--hero", "3"], {"spectrum_samples": 8, "hero_wavelengths": 3}),
    (["--refract"], {"refract_dielectric": True}),
    (["--spectrum", "8", "--dispersion", "0.004"], {"mat_ior_bins": (8, 9)}),
    (["--rough-materials"], {"rough_materials": True}),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_cli_frame_mode_flags(flags, want, tmp_path, monkeypatch):
    """The frame-mode, spectral and material flags map to the RenderConfig
    fields the reference's cli.py:174-221 sets (--dispersion: the scene's
    per-bin IoR table, by its shape; --rough-materials: load_scene's
    argument), and the run writes its PNG."""
    from tpu_pathtracer_torch import renderer, scene

    seen, loads = [], []
    step = renderer.Renderer.step
    monkeypatch.setattr(renderer.Renderer, "step",
                        lambda self: seen.append(self) or step(self))
    load = scene.load_scene
    monkeypatch.setattr(scene, "load_scene", lambda *a, **kw: loads.append(kw) or load(*a, **kw))
    png = str(tmp_path / "x.png")
    assert cli.main(["--platform", "cpu", "--width", "8", "--height", "8", "--frames",
                     "1", "--depth", "2", "--png", png] + flags) == 0
    assert seen and loads
    got = {}
    for k in want:
        if k == "mat_ior_bins":
            got[k] = tuple(seen[0].scene.mat_ior_bins.shape)
        elif k == "rough_materials":
            got[k] = loads[0]["rough_materials"]
        else:
            got[k] = getattr(seen[0].cfg, k)
    assert got == want
    assert tpng.read_png(png).shape == (8, 8, 3)


@pytest.mark.parametrize("flags", [["--builder", "lbvh"], ["--no-pallas"],
                                   ["--intersector", "brute"]],
                         ids=lambda f: " ".join(f))
def test_cli_backends(flags, tmp_path):
    """The CLI's builder and backend flags on the CPU: --builder lbvh (the
    torch LBVH), --no-pallas (the portable walker) and --intersector brute
    render a finite, lit image; the backends launch no kernel."""
    png = str(tmp_path / "x.png")
    n0 = tuple(getattr(ht, k).launches for k in ("window_walk", "capped_walk"))
    assert cli.main(["--platform", "cpu", "--scene", "cornellbox", "--width", "16",
                     "--height", "12", "--depth", "3", "--frames", "1", "--png", png,
                     "-o", str(tmp_path / "x.exr")] + flags) == 0
    img, _ = read_exr(str(tmp_path / "x.exr"))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all() and img.mean() > 0
    assert tpng.read_png(png).shape == (12, 16, 3)
    assert tuple(getattr(ht, k).launches for k in ("window_walk", "capped_walk")) == n0


@pytest.mark.parametrize("platform", ["auto", "gpu"])
def test_cli_needs_cuda_unless_cpu(platform, tmp_path, monkeypatch):
    """--platform auto / gpu without a CUDA device raise and render nothing
    (no silent CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--platform", platform, "--width", "8", "--height", "8",
                  "--frames", "1", "--png", str(tmp_path / "x.png")])
    assert not os.path.exists(tmp_path / "x.png")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _renderer(**kw):
    return Renderer("cornellbox", 32, 24,
                    RenderConfig(max_path_length=2, **kw), device="cpu")


def test_viewer_serves_progressive_render():
    """(i) tests/test_viewer.py's first case, against the port."""
    r = _renderer()
    server = ViewerServer(r, scene_name="cornellbox", host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_while_rendering, kwargs={"frames": 0},
                         daemon=True)
    t.start()
    try:
        status, ctype, body = _get(server.port, "/")
        assert status == 200 and "text/html" in ctype and b"frame.png" in body
        status, ctype, body = _get(server.port, "/frame.png")
        assert status == 200 and ctype == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        stats = json.loads(_get(server.port, "/stats.json")[2])
        assert stats["width"] == 32 and stats["height"] == 24
        assert stats["frame"] >= 0 and stats["scene"] == "cornellbox"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.port, "/nope")
        assert e.value.code == 404
    finally:
        server.stop()
        t.join(timeout=60)
    assert not t.is_alive()
    assert r.frame_index >= 1
    assert np.isfinite(r.image()).all()


def test_viewer_compare_endpoint():
    """(i) tests/test_viewer.py's second case, against the port: the live
    golden diff is served and cached per (frame, mode, scale); without a
    golden it is a 404."""
    r = _renderer(max_frames=1)
    r.run(1)
    golden = np.full((24, 32, 3), 0.25, np.float32)
    server = ViewerServer(r, scene_name="cornellbox", host="127.0.0.1", port=0,
                          golden=golden)
    t = threading.Thread(target=server.serve_while_rendering, kwargs={"frames": 0},
                         daemon=True)
    t.start()
    try:
        status, ctype, body = _get(server.port, "/compare.png?mode=1&scale=4")
        assert status == 200 and ctype == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        assert _get(server.port, "/compare.png?mode=1&scale=4")[2] == body
        assert _get(server.port, "/compare.png?mode=4&scale=4")[2][:8] == body[:8]
        assert json.loads(_get(server.port, "/stats.json")[2])["has_golden"] is True
    finally:
        server.stop()
        t.join(timeout=60)
    assert not t.is_alive()

    server2 = ViewerServer(r, scene_name="cornellbox", host="127.0.0.1", port=0)
    server2.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server2.port, "/compare.png?mode=1")
        assert e.value.code == 404
        assert json.loads(_get(server2.port, "/stats.json")[2])["has_golden"] is False
    finally:
        server2.stop()
