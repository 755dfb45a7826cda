"""Shared helpers of the tests that hold tpu_pathtracer_torch against
tpu_pathtracer: numpy views of the reference's pytrees, seeded rays, the
nearest-hit agreement rule, and the fixture of the tests that need a card."""

from __future__ import annotations

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
