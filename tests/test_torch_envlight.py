"""The environment light and the any-hit shadow walk of tpu_pathtracer_torch
against the reference's, on the CPU.

Tolerances, each with its reason:
  * alias tables, pdfs, radiance, select_p: bit-equal (the same numpy build);
  * env directions and eval values: atol 1e-6 (XLA's and torch's sin, cos,
    atan2 and arccos differ by an ulp);
  * any-hit clear masks: equal on >= 99.8% of active lanes (the reference
    kernel in interpret mode runs under XLA's FMA contraction, the plain
    version does not, and an occluder within roundoff of the light distance
    may flip; tests/test_accel.py bounds the same band at 2e-3);
  * whole env frames: atol 2e-5, the bound tests/test_accel.py holds the
    Pallas frame to against pure JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer.accel import build_layout as jbuild_layout
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.models import envlight as jenv
from tpu_pathtracer.models.camera import Camera as JCamera
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.render import noise as jnoise
from tpu_pathtracer.render.state import init_state as jinit_state
from tpu_pathtracer.render.state import render_frame as jrender_frame
from tpu_pathtracer.scene import attach_env as jattach_env
from tpu_pathtracer.scene import load_scene as jload_scene
from tpu_pathtracer.scene import scene_path
from tpu_pathtracer_torch import Renderer, RenderConfig, interop
from tpu_pathtracer_torch.models import envlight as tenv
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.ops import rng as trng
from tpu_pathtracer_torch.render import noise as tnoise
from tpu_pathtracer_torch.render.state import frame_rng_key, fused_wavefront_key
from tpu_pathtracer_torch.render.wavefront import render_sample
from tpu_pathtracer_torch.scene import attach_env, load_scene
from torch_parity import SpanLog, arrays, nee_shadow_rays, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EPS = 1e-4


def env_map(eh: int, ew: int, seed: int) -> np.ndarray:
    """A seeded lat-long map with one hot texel."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.05, 1.0, (eh, ew, 3)).astype(np.float32)
    img[eh // 4, ew // 3] = 40.0
    return img


def launches():
    return ht.window_walk.launches, ht.capped_walk.launches, ht.anyhit_walk.launches


@pytest.mark.parametrize("alp", [0.0, 3.7], ids=["env-only", "with-area-lights"])
def test_build_sample_eval_env(alp):
    """(a) The port's build_env tables are bit-equal to the reference's, and
    sample_env / eval_env agree on 512 seeded uniforms and directions."""
    img = env_map(16, 32, seed=3)
    ref = jenv.build_env(img, strength=1.5, rotation=0.4, area_light_power=alp)
    got = tenv.build_env(img, strength=1.5, rotation=0.4, area_light_power=alp,
                         device="cpu")
    for name in ("alias_p", "alias_i", "pdf_sa", "radiance", "select_p", "rotation"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)

    rng = np.random.default_rng(11)
    u = rng.random((3, 512)).astype(np.float32)
    rd, rpdf, rrad = jenv.sample_env(ref, jnp.asarray(u[0]), jnp.asarray(u[1:3]))
    td, tpdf, trad = tenv.sample_env(got, torch.from_numpy(u[0]),
                                     torch.from_numpy(u[1:3]))
    # pdf and radiance are gathers of the chosen texel: bit-equal
    np.testing.assert_array_equal(tpdf.numpy(), np.asarray(rpdf))
    np.testing.assert_array_equal(trad.numpy(), np.asarray(rrad))
    np.testing.assert_allclose(td.numpy(), np.asarray(rd), rtol=0, atol=1e-6)

    d = rng.normal(size=(3, 512)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    rrad, rpdf = jenv.eval_env(ref, jnp.asarray(d))
    trad, tpdf = tenv.eval_env(got, torch.from_numpy(d))
    # the reference's nearest-texel index, from its own formula
    phi = np.asarray(jnp.arctan2(d[2], d[0]) - ref.rotation)
    uu = (phi + np.pi) / (2 * np.pi)
    uu = uu - np.floor(uu)
    vv = np.arccos(np.clip(d[1], -1, 1)) / np.pi
    idx = (np.clip((vv * 16).astype(np.int32), 0, 15) * 32
           + np.clip((uu * 32).astype(np.int32), 0, 31))
    np.testing.assert_array_equal(tenv.texel_index(got, torch.from_numpy(d)).numpy(), idx)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(rpdf), rtol=0, atol=1e-6)
    np.testing.assert_allclose(trad.numpy(), np.asarray(rrad), rtol=0, atol=1e-6)


def test_attach_env_matches_reference():
    """attach_env on a scene with area lights: select_p from the same
    area-light power, every table bit-equal; interop carries the
    reference's env across unchanged."""
    img = env_map(8, 16, seed=5)
    ref = jattach_env(jload_scene(scene_path("cornellbox")), img, strength=2.0)
    got = attach_env(load_scene(scene_path("cornellbox"), device="cpu"), img,
                     strength=2.0)
    carried = interop.scene_from_arrays(arrays(ref))
    for env in (got.env, carried.env):
        for name, want in ref.env._asdict().items():
            np.testing.assert_array_equal(getattr(env, name).numpy(),
                                          np.asarray(want), err_msg=name)
    assert 0.1 <= float(got.env.select_p) <= 0.9


@pytest.mark.parametrize("frame,bounce", [(0, 0), (5, 3), (2**31 + 1, 7)])
def test_bounce_uniforms_with_env(frame, bounce):
    """(b) bounce_uniforms(with_env=True) is bit-equal to the reference's,
    and its first six rows are the with_env=False draw."""
    rng = np.random.default_rng(bounce)
    pid = rng.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32)
    key = trng.fold_in(trng.prng_key(9), frame)
    tp = torch.as_tensor(pid.astype(np.int64))
    ref = jnoise.bounce_uniforms(JConfig(), jnp.asarray(key), frame, bounce,
                                 jnp.asarray(pid), 1, 1, with_env=True)
    cfg = RenderConfig()
    got = tnoise.bounce_uniforms(cfg, key, frame, bounce, tp, 1, 1, with_env=True)
    plain = tnoise.bounce_uniforms(cfg, key, frame, bounce, tp, 1, 1)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in plain:
        np.testing.assert_array_equal(got[k].numpy(), plain[k].numpy(), err_msg=k)


@pytest.mark.parametrize("name", ["cornellbox", "CornellBox-Water-plastic"])
def test_anyhit_plain_matches_pallas(name):
    """(c) anyhit_walk_plain through occlusion_clear_anyhit == the reference's
    occlusion_clear_anyhit in interpret mode, on NEE-shaped shadow rays with
    every fifth lane an environment sample, on the leaf-8 layout."""
    scene = jload_scene(scene_path(name))
    lay = jbuild_layout(scene, leaf_size=8)
    tscene = interop.scene_from_arrays(arrays(scene))
    o, d, act, cap, tgt = nee_shadow_rays(tscene, 512, seed=17)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pt.occlusion_clear_anyhit(
            jnp.asarray(o), jnp.asarray(d), lay, jnp.asarray(act),
            jnp.asarray(cap), jnp.asarray(tgt), eps=EPS, tile=128)) & act
    before = launches()
    got = ht.occlusion_clear_anyhit(
        torch.from_numpy(o), torch.from_numpy(d), interop.layout_from_arrays(arrays(lay)),
        torch.from_numpy(act), torch.from_numpy(cap), torch.from_numpy(tgt), EPS).numpy()
    assert launches() == before
    assert not got[~act].any()
    env = tgt < 0
    # both outcomes occur among area-light lanes and among env lanes
    for lanes in (act & env, act & ~env):
        assert 0 < got[lanes].sum() < lanes.sum()
    assert (got != ref)[act].mean() <= 2e-3


def test_timed_frame_keeps_anyhit():
    """A timed frame takes the same shadow route as an untimed one: the
    timer wrapper passes intersect.occlusion through as "walk_shadow", so the
    capped walk never runs, and the image is the same bit for bit."""
    scene = attach_env(load_scene(scene_path("cornellbox"), device="cpu"),
                       env_map(8, 16, seed=2))
    r = Renderer(scene, 24, 16, RenderConfig(max_path_length=3), device="cpu")
    calls = {"occlusion": 0, "capped": 0}
    base, occl = r._intersect, r._intersect.occlusion

    def isect(o, d, active, t_max=None, coherent=False):
        calls["capped"] += t_max is not None
        return base(o, d, active, t_max=t_max, coherent=coherent)

    def occlusion(*a):
        calls["occlusion"] += 1
        return occl(*a)

    isect.occlusion = occlusion
    key = fused_wavefront_key(frame_rng_key(r.cfg, r.state.key, 0))
    plain = render_sample(r.scene, r.cfg, r.camera, 16, 24, key, 0, isect)
    untimed = dict(calls)
    timer = SpanLog()
    timed = render_sample(r.scene, r.cfg, r.camera, 16, 24, key, 0, isect, timer=timer)
    assert untimed["occlusion"] > 0 and calls["capped"] == 0
    assert calls["occlusion"] == 2 * untimed["occlusion"]
    assert timer.names.count("walk_shadow") == untimed["occlusion"]
    np.testing.assert_array_equal(timed.numpy(), plain.numpy())


@pytest.mark.parametrize("anyhit", ["auto", "off"])
def test_env_frame_matches_pallas_interpret(anyhit):
    """(d) One env-lit cornellbox frame (8x16 map, 24x32, depth 3, leaf 4)
    through Renderer(device="cpu") == the reference's render_frame with its
    Pallas intersector in interpret mode.  "auto" takes the any-hit walk on
    both sides; "off" holds the repaired occlusion_clear (nearest hit, env
    lanes clear iff nothing is hit) against the reference's."""
    img = env_map(8, 16, seed=7)
    jscene = jattach_env(jload_scene(scene_path("cornellbox")), img)
    lay = jbuild_layout(jscene, leaf_size=4)
    jcfg = JConfig(max_path_length=3, traversal_tile=128, occlusion_tile=128,
                   traversal_prepass=8, occlusion_anyhit=anyhit)
    isect = pt.make_pallas_intersector(
        lay, anyhit=anyhit == "auto", eps=jcfg.distance_epsilon, tile=128,
        occlusion_tile=128, secondary_tile=128, prepass=8)
    assert hasattr(isect, "occlusion") == (anyhit == "auto")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jrender_frame(jinit_state(24, 32), jscene, jcfg,
                                       JCamera.reference_default(), isect).accum)

    scene = attach_env(load_scene(scene_path("cornellbox"), device="cpu"), img)
    cfg = RenderConfig(max_path_length=3, traversal_tile=128, traversal_prepass=8,
                       occlusion_leaf_size=None, occlusion_anyhit=anyhit)
    r = Renderer(scene, 32, 24, cfg, leaf_size=4, device="cpu")
    assert hasattr(r._intersect, "occlusion") == (anyhit == "auto")
    before = launches()
    r.run(1)
    assert launches() == before
    got = r.image()
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
