"""Shared helpers of the tests that hold tpu_pathtracer_torch against
tpu_pathtracer: numpy views of the reference's pytrees, seeded rays, the
SPD scene generator, the nearest-hit agreement rule, a span log, and the
fixture of the tests that need a card."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch


def arrays(nt) -> dict:
    """A reference NamedTuple (Scene, BVHLayout) -> dict of numpy arrays
    (non-array fields as they are), for tpu_pathtracer_torch.interop."""
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in nt._asdict().items()}


def load_reference_script(name: str):
    """The reference's ``scripts/<name>.py`` as a module (the scripts are
    not a package), with the JAX compilation-cache settings that its import
    overwrites put back."""
    import importlib.util
    import os

    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def spd_generator():
    """The SPD ``tetra`` scene's generator, ``scripts/spd_tetra.py`` (numpy
    only), as a module: ``write(level, stem)`` -> (OBJ path, MTL path)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "spd_tetra", os.path.join(root, "scripts", "spd_tetra.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_rays(n: int, seed: int):
    """(3, n) float32 origins inside the Cornell box and unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (3, n)).astype(np.float32)
    o[1] += 1.0
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d


def assert_hits_agree(t_a, id_a, t_b, id_b, rtol: float = 1e-6, atol: float = 1e-6,
                      min_agree: float = 0.999) -> np.ndarray:
    """Same hit/miss per lane and t to ``rtol`` or ``atol``; triangle ids
    equal except equal-t ties (a ray through a shared edge hits both
    triangles at the same t, and an ulp decides which one wins), and equal
    or tied on at least ``min_agree`` of the hits.  Returns the lanes whose
    ids agree.

    Why the absolute floor: XLA's CPU compiler contracts ``a * b + c`` into
    one FMA inside the reference's jitted kernels, torch's CPU ops do not,
    so the same test order differs by an ulp per multiply-add; a grazing
    hit's 1/den (or 1/det) amplifies that, up to ~3e-7 on a scene 2 units
    across.  1e-6 is half a millionth of the scene's extent."""
    t_a, t_b = np.asarray(t_a), np.asarray(t_b)
    id_a, id_b = np.asarray(id_a), np.asarray(id_b)
    fin = np.isfinite(t_a)
    np.testing.assert_array_equal(fin, np.isfinite(t_b))
    np.testing.assert_allclose(t_a[fin], t_b[fin], rtol=rtol, atol=atol)
    same = id_a == id_b
    ties = ~same & fin & np.isclose(t_a, t_b, rtol=rtol, atol=atol)
    assert (same | ties | ~fin).all()
    assert (same | ties)[fin].mean() >= min_agree
    return same & fin


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread for a module's tests, restored after:
    the suite runs several pytest workers on a few cores, and each worker's
    own thread pool the width of the machine oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class SpanLog:
    """A CPU stand-in for render/timing.StageTimer: records the span names
    in the order they open."""

    def __init__(self):
        self.names = []

    @contextlib.contextmanager
    def span(self, name):
        self.names.append(name)
        yield


@pytest.fixture
def cuda_device():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def nee_shadow_rays(scene, n: int, seed: int, eps: float = 1e-4,
                    env_every: int = 5):
    """NEE-shaped shadow queries in a port ``Scene`` (the pattern of
    tests/test_accel.py's any-hit test): origins on surface points (brute
    hits of random rays, backed off by ``eps`` along the ray), directions to
    a random point of a random light triangle, caps at that distance +
    4*eps, targets the light's triangle id; every ``env_every``-th lane is
    an environment sample (a random direction, target -1, cap 1e30).  Lanes whose ray missed
    are inactive.  Returns numpy (o, d, active, cap, target int32)."""
    from tpu_pathtracer_torch.ops.intersect import intersect_brute

    o0, d0 = random_rays(n, seed)
    p = [x.cpu() for x in (scene.p0, scene.p1, scene.p2)]
    t = intersect_brute(torch.from_numpy(o0), torch.from_numpy(d0), *p).t.numpy()
    active = np.isfinite(t)
    origin = o0 + np.where(active, t, 1.0)[None] * d0 - d0 * np.float32(eps)
    rng = np.random.default_rng(seed + 1)
    lights = scene.light_tri.cpu().numpy()[:-1]
    tgt = lights[rng.integers(0, len(lights), n)]
    r1, r2 = rng.random(n), rng.random(n)
    su, sv = 1.0 - np.sqrt(r1), np.sqrt(r1) * r2
    v0, v1, v2 = (x.numpy()[:, tgt] for x in p)
    lp = v0 + su[None] * (v1 - v0) + sv[None] * (v2 - v0)
    delta = lp - origin
    dist = np.linalg.norm(delta, axis=0)
    d = delta / np.maximum(dist, 1e-12)[None]
    cap = dist + 4.0 * eps
    env = np.arange(n) % env_every == 0
    d_env = rng.normal(size=(3, n))
    d = np.where(env[None], d_env / np.linalg.norm(d_env, axis=0, keepdims=True), d)
    return (origin.astype(np.float32), d.astype(np.float32), active,
            np.where(env, 1e30, cap).astype(np.float32),
            np.where(env, -1, tgt).astype(np.int32))


def assert_frames_agree(got, want, atol: float = 1e-5, allowed: int = 3) -> None:
    """Two accumulated frames (H, W, S): the same shape, finite, and within
    ``atol`` on every pixel but at most ``allowed``.  The handful of pixels
    is the one-lane band of ROADMAP.md queue 3: a NEE lane whose shadow
    query flips at a triangle boundary (the port tests Baldwin-Weber
    planes where the reference's CPU frame tests Moller-Trumbore, and XLA
    contracts multiply-adds), moving one pixel by up to its whole NEE term."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    off = np.abs(got - want).max(axis=-1) > atol
    assert off.sum() <= allowed, (int(off.sum()), float(np.abs(got - want).max()))


def shading_inputs(scene, n: int, seed: int, hero: int = 0):
    """Seeded inputs of one bounce's shading on a port ``Scene`` on the CPU
    -> numpy {"state": PathState fields, "hit": HitShade fields, "u": (6, n)
    uniform rows in the PRNG order (light_select, light_bary x2, lobe,
    bounce_dir x2)}.  Lanes: brute hits of random rays inside the Cornell
    box (emitter hits among them) and misses; every 13th hit moved nearer
    than the default eps (t = 5e-5), every 11th lane dead; drawn
    throughputs, radiance, pdfs (every third exactly 1), previous-lobe
    flags and IoRs (every seventh 1.33); every 17th hemisphere uniform 1e-8
    (a pdf under a raised pdf_floor) and every 19th light uniform the
    largest float32 below 1 (the sentinel row past the CDF).

    With ``hero`` = C > 0 the state carries C planes and drawn (C, n) int64
    bins over the scene's S.  A scene with an environment light adds four
    rows to "u" (env_select, env_alias, env_jit x2): every 23rd select
    exactly select_p (the area arm), every 29th alias uniform the largest
    float32 below 1 (the last slot); and every 31st lane looks straight up,
    every 37th straight down (the lat-long poles)."""
    from tpu_pathtracer_torch.ops.intersect import intersect_brute, shade_from_scene

    o, d = random_rays(n, seed)
    p = [x.cpu() for x in (scene.p0, scene.p1, scene.p2)]
    hit = shade_from_scene(scene, intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                                                  *p))
    hit = {k: v.numpy().copy() for k, v in hit._asdict().items()}
    lane = np.arange(n)
    hit["t"][(lane % 13 == 5) & np.isfinite(hit["t"])] = np.float32(5e-5)
    rng = np.random.default_rng(seed + 2)
    s = scene.mat_diffuse.shape[0]
    planes = hero or s
    state = {
        "origin": o, "direction": d,
        "throughput": rng.uniform(0.05, 1.0, (planes, n)).astype(np.float32),
        "radiance": rng.uniform(0.0, 2.0, (planes, n)).astype(np.float32),
        "pdf": np.where(lane % 3 == 0, 1.0, rng.uniform(0.01, 1.0, n)).astype(np.float32),
        "prev_diffuse": (rng.random(n) < 0.5).astype(np.float32),
        "ior": np.where(lane % 7 == 2, 1.33, 1.00029).astype(np.float32),
        "alive": lane % 11 != 3,
        "pixel": lane.astype(np.int64),
    }
    u = rng.random((6, n), dtype=np.float32)
    u[5, lane % 17 == 0] = np.float32(1e-8)
    u[0, lane % 19 == 0] = np.nextafter(np.float32(1.0), np.float32(0.0))
    if hero:
        state["bins"] = rng.integers(0, s, (hero, n))
    if scene.env is not None:
        ue = rng.random((4, n), dtype=np.float32)
        ue[0, lane % 23 == 0] = np.float32(scene.env.select_p.cpu())
        ue[1, lane % 29 == 0] = np.nextafter(np.float32(1.0), np.float32(0.0))
        u = np.concatenate([u, ue])
        d[:, lane % 31 == 0] = np.float32([[0.0], [1.0], [0.0]])
        d[:, lane % 37 == 0] = np.float32([[0.0], [-1.0], [0.0]])
    return {"state": state, "hit": hit, "u": u}


def frames_against_reference(ref_scene, kw: dict, renderer_kw: dict, depth: int = 4,
                             h: int = 24, w: int = 32, frames: int = 2, scene=None):
    """(the port's image, the reference's) after ``frames`` frames of one
    configuration: both Renderers on the CPU, ``kw`` RenderConfig fields and
    ``renderer_kw`` Renderer arguments on both (``"camera"``: a dict of
    Camera fields -- t, aperture, focus -- made into each package's
    Camera); ``ref_scene`` a bundled scene's name or the reference's Scene,
    ``scene`` the port's when the name is not shared."""
    import jax.numpy as jnp

    from tpu_pathtracer.config import RenderConfig as JConfig
    from tpu_pathtracer.models.camera import Camera as JCamera
    from tpu_pathtracer.renderer import Renderer as JRenderer
    from tpu_pathtracer_torch import Renderer, RenderConfig
    from tpu_pathtracer_torch.models.camera import Camera

    kw = {"max_path_length": depth, **kw}
    renderer_kw = dict(renderer_kw)
    cam = renderer_kw.pop("camera", None)
    ref_cam = port_cam = {}
    if cam is not None:
        ref_cam = {"camera": JCamera(**{**cam, "t": jnp.float32(cam.get("t", 0.0))})}
        port_cam = {"camera": Camera(**cam)}
    ref = JRenderer(ref_scene, w, h, JConfig(**kw), **renderer_kw, **ref_cam)
    ref.run(frames)
    got = Renderer(ref_scene if scene is None else scene, w, h, RenderConfig(**kw),
                   device="cpu", **renderer_kw, **port_cam)
    got.run(frames)
    img = got.image()
    assert np.isfinite(img).all() and img.max() > 0
    return img, np.asarray(ref.image())


def sort_inputs(n: int, seed: int):
    """Seeded inputs of the wavefront sort -> numpy (origins, directions,
    alive, pixel ids): unit directions with exact zeros and negative z,
    origins in and beyond the box, dead lanes, pixel ids up to 2^32 - 1."""
    gen = np.random.default_rng(seed)
    o = gen.uniform(-1.5, 2.5, (3, n)).astype(np.float32)
    d = gen.normal(size=(3, n)).astype(np.float32)
    d[:, ::7] = 0.0
    d[2, ::7] = -1.0
    d[0, 3::11] = 0.0
    d[1, 5::13] = -0.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    alive = gen.random(n) < 0.7
    pixel = gen.integers(0, 2 ** 32, n).astype(np.int64)
    return o, d, alive, pixel
