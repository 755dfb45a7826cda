"""The shading and the wavefront sort of tpu_pathtracer_torch on the CPU:
the rule that routes frames to csrc/shade.cu, the host's constant folding,
the wrappers' refusal of CPU tensors, the kernel's parameter struct
against its ctypes mirror, the plain shading held against the reference's
trace_bounce through the same hit (the parity materials, the environment
light, hero bins and dispersion), and the plain sort against the
reference's key and sort.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).

Tolerance of the shading against the reference: atol 1e-6 (XLA's CPU cos,
sin, atan2, acos and rsqrt and torch's differ by an ulp or so), and the
shadow pack also rtol 1e-6 (its cap is a distance, up to ~35 on the
sentinel light row, where an ulp is 4e-6, and 1e30 on an env sample);
flags, ids and counts exactly.  The sort keys and the sorted planes
exactly."""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.ops.intersect import HitShade as JHitShade
from tpu_pathtracer.render import wavefront as jwf
from tpu_pathtracer.scene import attach_dispersion as jattach_dispersion
from tpu_pathtracer.scene import attach_env as jattach_env
from tpu_pathtracer.scene import load_scene as jload_scene
from tpu_pathtracer.scene import scene_path
from tpu_pathtracer_torch import RenderConfig, interop
from tpu_pathtracer_torch.config import PI
from tpu_pathtracer_torch.models.envlight import PI as ENV_PI
from tpu_pathtracer_torch.models.envlight import (ALIAS_WORDS, TABLES, build_env, env_to,
                                                  radiance_max, record_layout, texel_layout)
from tpu_pathtracer_torch.ops import shade as tshade
from tpu_pathtracer_torch.ops import wavefront_sort as tsort
from tpu_pathtracer_torch.ops.intersect import HitShade
from tpu_pathtracer_torch.render import wavefront as twf
from tpu_pathtracer_torch.parallel.tiles import to_device
from torch_parity import arrays, one_torch_thread, shading_inputs, sort_inputs  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SCENE = "CornellBox-Water-plastic"
LANES = 2048


@pytest.fixture(scope="module")
def scenes():
    """(S, env map shape or None, dispersion) -> (the reference's scene with
    the four parity types in turn over its materials, with a seeded
    environment map and Cauchy IoR bins on its plastic and dielectric
    materials where asked, the port's scene of the same arrays)."""
    out = {}

    def get(s, env=None, dispersion=False):
        if (s, env, dispersion) not in out:
            js = jload_scene(scene_path(SCENE), samples=s)
            js = js._replace(mat_type=jnp.arange(js.mat_type.shape[0],
                                                 dtype=js.mat_type.dtype) % 4)
            if env is not None:
                img = np.random.default_rng(env[0] * env[1]).uniform(0.2, 2.0, (*env, 3))
                img[1, 2] = (40.0, 30.0, 20.0)  # a bright texel the alias table favours
                js = jattach_env(js, img.astype(np.float32))
            if dispersion:
                js = jattach_dispersion(js, 0.0042)
            out[s, env, dispersion] = (js, interop.scene_from_arrays(arrays(js)))
        return out[s, env, dispersion]

    return get


@pytest.mark.parametrize("change,covered", [
    ({}, True),
    ({"env": object()}, True),
    ({"textures": object()}, True),
    ({"mat_roughness": object()}, True),
    ({"mat_ior_bins": object()}, True),
    ({"cfg": {"spectrum_samples": 16, "hero_wavelengths": 4}}, True),
    ({"cfg": {"spectrum_samples": 3, "hero_wavelengths": 2}}, True),
    ({"cfg": {"spectrum_samples": 16}}, True),
    ({"cfg": {"spectrum_samples": 17}}, False),
    ({"cfg": {"spectrum_samples": 17, "hero_wavelengths": 4}}, True),
    ({"cfg": {"spectrum_samples": 32, "hero_wavelengths": 17}}, False),
    ({"env": object(), "mat_ior_bins": object(),
      "cfg": {"spectrum_samples": 8, "hero_wavelengths": 2}}, True),
    ({"env": object(), "textures": object()}, True),
    ({"cfg": {"reference_quirks": False, "refract_dielectric": True,
              "cull_zero_nee": True, "sort_rays": False}}, True),
], ids=("parity", "env", "textures", "roughness", "dispersion", "hero", "hero-at-S3",
        "S16", "S17", "S17-hero4", "hero-C17", "env-hero-dispersion", "env-textures",
        "modes"))
def test_shade_kernel_covers(change, covered, scenes):
    """The one routing rule: every scene field and config field it reads.
    The environment light, dispersion, hero bins, textures and a roughness
    table are covered; more than MAX_SPECTRUM carried planes are not: C
    under hero sampling (S = 17 with hero 4 carries 4; hero 17 carries 17),
    S otherwise.  A hero config at S = 3 traces every bin
    (render_sample's rule), so it carries 3; the frame modes do not change
    the rule."""
    change = dict(change)
    cfg = RenderConfig(**change.pop("cfg", {}))
    scene = scenes(3)[1]._replace(**change)
    assert tshade.shade_kernel_covers(cfg, scene) is covered


def _c_fields(path: str, struct: str) -> list[tuple[str, str]]:
    """(name, "pointer" | "int" | "float") of each field of a C struct, in
    declaration order, parsed from the source."""
    with open(path) as f:
        src = f.read()
    body = re.search(r"struct " + struct + r" \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        head, *rest = decl.split(",")
        kind = ("pointer" if "*" in head else "float" if head.split()[0] == "float"
                else "int")
        assert kind != "int" or head.split()[0] == "int", decl
        names = [re.search(r"(\w+)$", head).group(1)] + [x.strip() for x in rest]
        fields += [(name, kind) for name in names]
    return fields


def test_shade_params_mirror_the_kernel_struct():
    """ops/shade.py:_ShadeParams has csrc/shade.cu:ShadeParams's fields in
    the same order with the same kinds: a field out of order would corrupt
    every launch without an error."""
    import ctypes

    path = os.path.join(os.path.dirname(tshade.__file__), "..", "csrc", "shade.cu")
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
    mirror = [(name, kinds[t]) for name, t in tshade._ShadeParams._fields_]
    assert mirror == _c_fields(path, "ShadeParams")
    assert len(mirror) > 80
    # the env map's check: its largest entry, +inf where the check fails;
    # the materials' fields after it, so the other instances' offsets stay
    assert ("env_radiance_max", "float") in mirror
    assert mirror[-1] == ("tex_hf", "float")


@pytest.mark.parametrize("eps,aeps,floor,env_shape", [
    (1e-4, 0.00003807693583, 1e-20, (1024, 2048)), (3e-3, 1e-2, 1e-3, (12, 20)),
    (1e-7, 0.1, 0.3, (7, 13))])
def test_folded_constants_equal_torch(eps, aeps, floor, env_shape):
    """Each constant the host folds for the kernel is the float32 torch
    computes from the same Python scalar on a float32 tensor: the products
    and sums, the selects, the clamp's floor, the comparisons (made in
    float32 too), and the reciprocals that ATen multiplies by on CUDA where
    a float32 tensor is divided by a Python scalar (each the float32
    quotient of 1 by the rounded scalar, as the CPU's true division of a
    one gives it; the card tests hold the multiply itself)."""
    cfg = RenderConfig(distance_epsilon=eps, angle_epsilon=aeps, pdf_floor=floor)
    tex_shape = (env_shape[0] + 5, env_shape[1] * 3)
    c = tshade.folded_constants(cfg, env_shape, tex_shape)
    eh, ew = env_shape
    one, zero = torch.ones(1), torch.zeros(1)
    assert float(one * (1.0 / PI)) == c["inv_pi"]
    assert float(one * (PI * 2.0)) == c["two_pi"] == float(one * (2.0 * PI))
    assert float(zero + 4.0 * eps) == c["four_eps"]
    assert float(one * eps) == c["eps"]
    assert float(torch.where(torch.tensor([False]), one, floor)) == c["pdf_floor"]
    # the env's PI is numpy's (models/envlight.py), not config.py's 3.1415926
    assert ENV_PI != PI and float(one * ENV_PI) == c["env_pi"] == -float(zero - ENV_PI)
    assert float(one * (2.0 * ENV_PI)) == c["env_two_pi"]
    assert float(one / (2.0 * ENV_PI)) == c["env_inv_two_pi"]
    assert float(one / ENV_PI) == c["env_pi_recip"]
    assert (float(one / eh), float(one / ew)) == (c["inv_env_h"], c["inv_env_w"])
    assert (float(one * eh), float(one * ew), float(one * (eh * ew))) == (
        c["env_hf"], c["env_wf"], c["env_kf"])
    assert float(torch.where(torch.tensor([True]), 1e30, one)) == c["env_cap"]
    assert float(torch.clamp(zero, min=1e-6)) == c["disp_floor"]
    # models/ggx.py's math.pi (not config.py's PI), 2.0 * math.pi, _EPS and
    # _EPS * _EPS, _conductor_albedo's floor, sample_bilinear's u * tw and
    # (1 - v) * th
    assert math.pi != PI and float(one * math.pi) == c["ggx_pi"]
    assert float(one * (2.0 * math.pi)) == c["ggx_two_pi"]
    assert float(torch.clamp(zero, min=1e-7)) == c["ggx_eps"]
    assert float(torch.clamp(zero, min=1e-7 * 1e-7)) == c["ggx_eps2"] != c["ggx_eps"] ** 2
    assert float(torch.clamp(zero, min=1e-12)) == c["albedo_floor"]
    assert (float(one * tex_shape[1]), float(one * tex_shape[0])) == (c["tex_wf"], c["tex_hf"])
    for name, v in (("eps", eps), ("aeps", aeps), ("pdf_floor", floor)):
        near = torch.from_numpy(np.nextafter(np.float32(c[name]),
                                             np.float32([0.0, np.inf, c[name]])))
        near = torch.cat([near, torch.tensor([c[name]], dtype=torch.float32)])
        assert torch.equal(near < v, near < c[name])
        assert torch.equal(near >= v, near >= c[name])


@pytest.mark.parametrize("s", [3, 4, 8, 16, 31])
def test_texel_bands_are_from_rgbs(s):
    """ops/shade.py:texel_bands, the kernel's rule for the channel a bin of an
    S-bin table takes from a texel: bin c reads channel c at S = 3, else
    blue below the first edge, green below the second, red after; the
    channel core/spectrum.py:from_rgb lifts to each bin."""
    from tpu_pathtracer_torch.core.spectrum import from_rgb

    rgb = torch.tensor([[0.25, 0.5, 0.75]])
    lifted = from_rgb(rgb, s)[0].tolist()
    b0, b1 = tshade.texel_bands(s)
    for row in range(s):
        ch = row if b0 < 0 else 2 if row < b0 else 1 if row < b1 else 0
        assert lifted[row] == rgb[0, ch], (s, row)
    assert (b0 < 0) == (s == 3)


def test_wrappers_raise_on_cpu(scenes):
    """The kernel wrappers take CUDA tensors only; render/wavefront.py
    routes CPU tensors to the plain versions."""
    scene = scenes(3)[1]
    inp = shading_inputs(scene, 8, seed=1)
    st = twf.PathState(**{k: torch.from_numpy(v) for k, v in inp["state"].items()})
    hit = HitShade(**{k: torch.from_numpy(v) for k, v in inp["hit"].items()})
    u = torch.from_numpy(inp["u"])
    uni = {"light_select": u[0], "light_bary": u[1:3], "lobe": u[3], "bounce_dir": u[4:6]}
    n = (tshade.shade_bounce.launches, tsort.sort_key.launches, tsort.gather_planes.launches)
    with pytest.raises(ValueError):
        tshade.shade_bounce(scene, RenderConfig(), 0, st, uni, hit, False)
    with pytest.raises(ValueError):
        tsort.sort_key(st.origin, st.direction, st.alive, st.pixel, (0.0,) * 3, (1.0,) * 3)
    with pytest.raises(ValueError):
        tsort.gather_planes([st.pdf], torch.arange(8))
    assert n == (tshade.shade_bounce.launches, tsort.sort_key.launches,
                 tsort.gather_planes.launches)


class _Occlusion:
    """A fixed shadow answer for both packages' trace_bounce: clear on even
    lanes; records the shadow origins it was asked about."""

    def __init__(self, to):
        self.to = to
        self.origins = None

    def __call__(self, *args, **kw):
        raise AssertionError("only the occlusion hook is queried")

    def occlusion(self, o, d, ok, cap, target):
        self.origins = np.asarray(o)
        return self.to(np.arange(ok.shape[0]) % 2 == 0)


# case -> (config fields, the deferred form, the bounce, the scene's extensions:
# "env" the seeded map's (Eh, Ew), "dispersion" Cauchy IoR bins)
SHADE_CASES = {
    "deferred": ({}, True, 2, {}),
    "inline": ({}, False, 2, {}),
    "last-bounce": ({"max_path_length": 3}, True, 2, {}),
    "no-quirks": ({"reference_quirks": False}, True, 1, {}),
    "refract": ({"refract_dielectric": True}, False, 1, {}),
    "refract-no-quirks": ({"refract_dielectric": True, "reference_quirks": False}, True, 1,
                          {}),
    "cull-zero-nee": ({"cull_zero_nee": True, "pdf_floor": 0.3}, True, 1, {}),
    "S16": ({"spectrum_samples": 16}, False, 1, {}),
    "env": ({}, True, 2, {"env": (12, 20)}),
    "env-inline-no-quirks-cull": ({"reference_quirks": False, "cull_zero_nee": True}, False,
                                  1, {"env": (12, 20)}),
    "hero": ({"spectrum_samples": 16, "hero_wavelengths": 4}, True, 1, {}),
    "dispersion": ({"spectrum_samples": 16}, True, 1, {"dispersion": True}),
    "env-hero-dispersion": ({"spectrum_samples": 8, "hero_wavelengths": 2}, True, 1,
                            {"env": (16, 32), "dispersion": True}),
}


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_plain_matches_reference(case, scenes):
    """The port's trace_bounce through the same hit (so its shading,
    render/wavefront.py:_shade_plain) == the reference's trace_bounce, on
    seeded lanes of every parity material: real hits and misses, hits
    nearer than eps, dead lanes, emitter hits, the sentinel light row,
    pdfs under a raised pdf floor; quirks, refraction, zero-NEE culling, the
    last bounce's gate and S = 16; the environment light's two arms (env
    and area picks, the last alias slot, the poles), hero bins (S = 16, C
    = 4), dispersion (S = 16), and all three at once (S = 8, C = 2); the
    deferred form's shadow pack, and the inline form's shadow origin and
    resolved radiance."""
    kw, defer, bounce, ext = SHADE_CASES[case]
    s = kw.get("spectrum_samples", 3)
    hero = kw.get("hero_wavelengths", 0) if s > 3 else 0
    jscene, tscene = scenes(s, ext.get("env"), ext.get("dispersion", False))
    inp = shading_inputs(tscene, LANES, seed=17 + bounce, hero=hero)
    rows = {"light_select": 0, "light_bary": slice(1, 3), "lobe": 3,
            "bounce_dir": slice(4, 6)}
    if "env" in ext:
        rows.update(env_select=6, env_alias=7, env_jit=slice(8, 10))

    jst = jwf.PathState(**{k: jnp.asarray(v.astype(np.uint32) if k == "pixel" else
                                          v.astype(np.int32) if k == "bins" else v)
                           for k, v in inp["state"].items()})
    jhit = JHitShade(**{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                        for k, v in inp["hit"].items()})
    jocc = _Occlusion(jnp.asarray)
    ref = jwf.trace_bounce(jscene, JConfig(**kw), jocc, bounce, jst,
                           {k: jnp.asarray(inp["u"][r]) for k, r in rows.items()},
                           with_stats=True, defer_shadow=defer, hit=jhit)

    tst = twf.PathState(**{k: torch.from_numpy(v) for k, v in inp["state"].items()})
    thit = HitShade(**{k: torch.from_numpy(v) for k, v in inp["hit"].items()})
    tocc = _Occlusion(torch.from_numpy)
    u = torch.from_numpy(inp["u"])
    got = twf.trace_bounce(tscene, RenderConfig(**kw), tocc, bounce, tst,
                           {k: u[r] for k, r in rows.items()}, with_stats=True,
                           defer_shadow=defer, hit=thit)

    assert len(got) == len(ref)
    for name in ("origin", "direction", "throughput", "radiance", "pdf", "prev_diffuse",
                 "ior"):
        np.testing.assert_allclose(getattr(got[0], name).numpy(),
                                   np.asarray(getattr(ref[0], name)), rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(got[0].alive.numpy(), np.asarray(ref[0].alive))
    alive = got[0].alive.numpy()
    assert 0 < alive.sum() < LANES
    if defer:
        for name in ("to_light", "cap", "contrib"):
            np.testing.assert_allclose(getattr(got[1], name).numpy(),
                                       np.asarray(getattr(ref[1], name)), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        for name in ("target", "ok"):
            np.testing.assert_array_equal(getattr(got[1], name).numpy(),
                                          np.asarray(getattr(ref[1], name)), err_msg=name)
        assert (0 < int(got[1].ok.sum()) < LANES) == (case != "last-bounce")
        if "env" in ext:
            # both arms of the NEE pick, and env samples that pass the gate
            env_lanes = got[1].target.numpy() == -1
            assert 0 < env_lanes.sum() < LANES and got[1].ok.numpy()[env_lanes].any()
    else:
        np.testing.assert_allclose(tocc.origins, jocc.origins, rtol=0, atol=1e-6)
    assert [int(x) for x in got[-1].values()] == [int(x) for x in ref[-1].values()]
    if "env" in ext:
        # live lanes that escaped see the env
        assert (inp["state"]["alive"] & ~np.isfinite(inp["hit"]["t"])).sum() > 10


def test_sort_key_plain_matches_reference():
    """The plain int64 key's high word == the reference's ray_sort_key as
    integers, its low word the pixel id, on every lane."""
    o, d, alive, pixel = sort_inputs(4096, seed=5)
    wmin, winv = (-1.0, 0.0, -1.0), (0.5, 0.5, 0.5)
    jst = jwf.initial_path_state(jnp.asarray(o), jnp.asarray(d), 3,
                                 jnp.asarray(pixel.astype(np.uint32)))
    ref = np.asarray(jwf.ray_sort_key(jst._replace(alive=jnp.asarray(alive)), wmin, winv))
    key = tsort.sort_key_plain(torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(alive), torch.from_numpy(pixel), wmin,
                               winv).numpy()
    np.testing.assert_array_equal(key >> 32, ref.astype(np.int64))
    np.testing.assert_array_equal(key & 0xFFFFFFFF, pixel)
    assert len(np.unique(ref)) > 100 and (ref >> 30 == 1).sum() == (~alive).sum()


def test_sort_wavefront_matches_reference():
    """sort_wavefront (the plain key, torch.sort, the plane gathers) puts
    every lane of the state and its shadow pack where the reference's
    sort_wavefront ("gather" lowering) puts it, exactly."""
    n = 3000
    o, d, alive, pixel = sort_inputs(n, seed=9)
    gen = np.random.default_rng(10)
    f = lambda *shape: gen.random(shape, dtype=np.float32)  # noqa: E731
    # prev_diffuse is 0 or 1 (the reference packs it as a bit of one plane)
    st = dict(origin=o, direction=d, throughput=f(3, n), radiance=f(3, n), pdf=f(n),
              prev_diffuse=(f(n) < 0.5).astype(np.float32), ior=f(n), alive=alive,
              pixel=pixel)
    pk = dict(to_light=f(3, n), cap=f(n), target=gen.integers(-1, 36, n), contrib=f(3, n),
              ok=gen.random(n) < 0.5)
    wmin, winv = (-1.0, 0.0, -1.0), (0.5, 0.5, 0.5)
    jst, jpk = jwf.sort_wavefront(
        jwf.PathState(**{k: jnp.asarray(v.astype(np.uint32) if k == "pixel" else v)
                         for k, v in st.items()}),
        wmin, winv,
        jwf.ShadowPack(**{k: jnp.asarray(v.astype(np.int32) if k == "target" else v)
                          for k, v in pk.items()}), lowering="gather")
    tst, tpk = twf.sort_wavefront(twf.PathState(**{k: torch.from_numpy(v)
                                                   for k, v in st.items()}),
                                  wmin, winv,
                                  twf.ShadowPack(**{k: torch.from_numpy(v)
                                                    for k, v in pk.items()}))
    for got, want in ((tst, jst), (tpk, jpk)):
        for name in got._fields:
            a, b = getattr(got, name), getattr(want, name)
            if a is None:
                assert b is None
                continue
            np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype),
                                          err_msg=name)


@pytest.mark.parametrize("n", [1, 33, 4096])
def test_key_planes_equal_gathered_pixel_and_alive(n):
    """ops/wavefront_sort.py:key_planes_plain on the sorted key (what the
    gather kernel reads for the pixel and alive planes) == the pixel and
    alive planes gathered by the permutation (index_select), on
    torch_parity.sort_inputs with pixel ids 0, 2^31 and up to 2^32 - 1
    and dead lanes."""
    o, d, alive, pixel = sort_inputs(n, seed=n + 3)
    top = np.array([2 ** 32 - 1, 2 ** 32 - 2, 0, 2 ** 31, 2 ** 31 - 1], np.int64)
    pixel[:min(n, top.size)] = top[:n]
    alive[:min(n, 2)] = (False, True)[:n]
    t = [torch.from_numpy(x) for x in (o, d, alive, pixel)]
    key = tsort.sort_key_plain(*t, (-1.0, 0.0, -1.0), (0.5, 0.5, 0.5))
    skey, perm = torch.sort(key, stable=True)
    got_pixel, got_alive = tsort.key_planes_plain(skey)
    want_pixel, want_alive = tsort.gather_planes_plain([t[3], t[2]], perm)
    assert got_pixel.dtype == torch.int64 and got_alive.dtype == torch.bool
    assert torch.equal(got_pixel, want_pixel) and torch.equal(got_alive, want_alive)
    if n > 2:
        assert int(got_pixel.max()) == 2 ** 32 - 1 and not bool(got_alive.all())
        # dead lanes sort last
        assert not bool(got_alive[-1]) and bool(got_alive[0])


_F32_MAX = float(np.finfo(np.float32).max)


@pytest.mark.parametrize("bad,value", [(None, None), ("nan", np.nan), ("+inf", np.inf),
                                       ("-inf", -np.inf), ("negative", -1e-3),
                                       ("-0", -0.0), ("zeros", 0.0)])
def test_env_radiance_max_checks_the_map(bad, value):
    """models/envlight.py: env_to derives radiance_max once from the map --
    its largest entry when every entry is finite with its sign bit clear,
    else None (a NaN, an infinity, a negative texel or a -0: the shading
    kernel then reads the texel on every lane, as the plain version) -- and
    build_env's and the reference's tables on a clean map pass the check."""
    rad = np.random.default_rng(5).uniform(0.0, 3.0, (3, 4, 8)).astype(np.float32)
    rad[1, 2, 3] = 7.5
    if bad == "zeros":
        rad[:] = value
    elif bad is not None:
        rad[2, 1, 5] = value
    fields = {"radiance": rad, "pdf_sa": np.ones((4, 8), np.float32),
              "alias_p": np.ones(32, np.float32), "alias_i": np.arange(32),
              "select_p": np.float32(0.5), "rotation": np.float32(0.0)}
    env = env_to(fields, "cpu")
    want = {None: 7.5, "zeros": 0.0}.get(bad)
    assert env.radiance_max == want == radiance_max(env.radiance.numpy())
    assert np.array_equal(env.radiance.numpy().view(np.uint32), rad.view(np.uint32))
    if bad is None:
        sky = np.random.default_rng(2).uniform(0.0, 40.0, (8, 16, 3)).astype(np.float32)
        for s in (3, 16):
            e = build_env(sky, samples=s, device="cpu")
            assert e.radiance_max == float(e.radiance.max())
        ref = jattach_env(jload_scene(scene_path("cornellbox")), sky).env
        carried = interop.scene_from_arrays(arrays(
            jload_scene(scene_path("cornellbox"))._replace(env=ref))).env
        assert carried.radiance_max == float(np.asarray(ref.radiance).max())


def test_env_zero_weight_term_is_throughput_times_zero():
    """The identity the env-lit shading kernel relies on to read no texel on
    a lane whose ray did not miss (csrc/shade.cu): there the BSDF arm adds
    ``rad * thr * w`` with the weight w = +0.  For every radiance 0 <= rad
    <= M with its sign bit clear (M the map's radiance_max) and every
    throughput thr with ``M * thr`` finite -- the kernel's test -- that term
    equals ``thr * 0`` bit for bit: ``rad * thr`` is then finite with thr's
    sign, so the product is +0 or -0 as thr's sign says.  Checked case by
    case in float32 over +-0, denormals, the float maximum, M from 0 to the
    float maximum; and for infinite and NaN throughputs (which the kernel
    sends to the texel anyway) the two are the same NaN.  Without the test
    on M * thr the identity fails: rad * thr overflows to infinity and the
    term becomes NaN where thr * 0 is a zero."""
    f32 = np.float32
    tiny = np.finfo(np.float32).smallest_subnormal
    maxes = [0.0, float(tiny), 1e-30, 0.5, 1.0, 2.0, 825.65185546875, 1e30, _F32_MAX]
    thrs = [0.0, -0.0, tiny, -tiny, 1e-38, -1e-38, 1e-30, 0.25, -1.0, 3.0, 1e20, -1e30,
            1.7e38, -_F32_MAX, _F32_MAX, np.inf, -np.inf, np.nan, -np.nan]
    bits = lambda x: np.asarray(x, f32).view(np.uint32)  # noqa: E731
    zero = f32(0.0)
    checked = overflowed = 0
    with np.errstate(all="ignore"):
        for m in map(f32, maxes):
            rads = {f32(0.0), f32(tiny), m, m * f32(0.5), np.nextafter(m, f32(0.0))}
            for rad in (r for r in map(f32, rads) if r <= m):
                assert not np.signbit(rad)
                for thr in map(f32, thrs):
                    term = rad * thr * zero
                    if np.isfinite(m * thr) or not np.isfinite(thr):
                        assert bits(term) == bits(thr * zero), (m, rad, thr)
                        checked += 1
                    elif bits(term) != bits(thr * zero):
                        overflowed += 1
                        assert np.isfinite(thr) and np.isinf(rad * thr)
    assert checked > 300 and overflowed > 0
    # the same in torch's float32 arithmetic, the plain version's
    rad = torch.tensor([0.0, float(tiny), 1.0, 825.65185546875], dtype=torch.float32)
    thr = torch.tensor([0.0, -0.0, float(-tiny), 2.0, -1e30, float("inf"), float("nan")],
                       dtype=torch.float32)
    term = rad[:, None] * thr[None] * torch.zeros(())
    want = (thr * torch.zeros(()))[None].expand_as(term)
    assert torch.equal(term.view(torch.int32), want.contiguous().view(torch.int32))


def _bits32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _assert_records(env, src: dict) -> None:
    """env's records hold ``src``'s tables (numpy, the reference's fields)
    bit for bit, laid out as models/envlight.py:env_records says, and env's
    own fields are ``src``'s."""
    for name in TABLES:
        got, want = getattr(env, name).cpu().numpy().reshape(-1), np.asarray(src[name])
        if got.dtype == np.float32:
            got, want = got.view(np.int32), _bits32(want).reshape(-1)
        np.testing.assert_array_equal(got, want.reshape(-1), err_msg=name)
    rad = np.asarray(src["radiance"], np.float32)
    s = rad.shape[0]
    pdf = np.asarray(src["pdf_sa"], np.float32).reshape(-1)
    k = pdf.size
    alias = np.asarray(src["alias_i"]).reshape(-1)
    tex, rec = env.texel_rec.cpu().numpy(), env.alias_rec.cpu().numpy()
    t, pdf_col = texel_layout(s)
    assert record_layout(env, s) == (t, pdf_col)
    assert tex.dtype == np.float32 and tex.shape == (k, t) and env.texel_rec.is_contiguous()
    assert rec.dtype == np.int32 and rec.shape == (k, ALIAS_WORDS)
    assert np.array_equal(tex[:, :s].view(np.int32), _bits32(rad.reshape(s, k).T))
    if pdf_col >= 0:
        assert np.array_equal(tex[:, pdf_col].view(np.int32), _bits32(pdf))
    assert not tex[:, s + 1:].any()
    assert np.array_equal(rec[:, 0], _bits32(src["alias_p"]).reshape(-1))
    assert np.array_equal(rec[:, 1], alias)
    assert np.array_equal(rec[:, 2], _bits32(pdf))
    assert np.array_equal(rec[:, 3], _bits32(pdf[alias]))


@pytest.mark.parametrize("case", ["S3", "S16", "interop", "to_device", "nan-texel"])
def test_env_records_equal_their_tables(case):
    """models/envlight.py:env_to derives the shading kernel's records once a
    map -- each texel's S radiance bins side by side with its pdf where the
    record has room, each alias slot's threshold and alias (int32) with the
    pdf of the slot's texel and of its alias -- and they equal the tables
    they come from on every texel and slot: build_env at S = 3 and 16, the
    reference's EnvLight carried by interop, a scene moved by
    parallel/tiles.to_device, and a map with a NaN texel (which the records
    carry, so the kernel's every-lane path reads it)."""
    sky = np.random.default_rng(4).uniform(0.0, 40.0, (8, 16, 3)).astype(np.float32)
    sky[2, 5] = (900.0, 800.0, 700.0)
    if case in ("S3", "S16"):
        env = build_env(sky, samples=int(case[1:]), device="cpu")
        src = {name: getattr(env, name).numpy() for name in TABLES}
    elif case == "interop":
        ref = jattach_env(jload_scene(scene_path("cornellbox"), samples=16), sky).env
        src = {name: np.asarray(getattr(ref, name)) for name in TABLES}
        carried = interop.scene_from_arrays(arrays(
            jload_scene(scene_path("cornellbox"), samples=16)._replace(env=ref)))
        env = carried.env
    elif case == "to_device":
        scene = interop.scene_from_arrays(arrays(
            jattach_env(jload_scene(scene_path("cornellbox")), sky)))
        src = {name: getattr(scene.env, name).numpy() for name in TABLES}
        env = to_device(scene, torch.device("cpu")).env
    else:
        env = build_env(sky, device="cpu")
        src = {name: getattr(env, name).numpy() for name in TABLES}
        src["radiance"] = src["radiance"].copy()
        src["radiance"][:, 3, 7] = np.nan
        env = env_to(src, "cpu")
        assert env.radiance_max is None
        assert np.isnan(env.texel_rec[3 * 16 + 7, :3].numpy()).all()
    assert env.texel_rec is not None and env.alias_rec is not None
    _assert_records(env, src)


@pytest.mark.parametrize("s,want", [(1, (4, 1)), (3, (4, 3)), (4, (4, -1)), (5, (8, 5)),
                                    (16, (16, -1)), (17, (20, 17))])
def test_texel_layout(s, want):
    """A texel's record: its S bins rounded up to 16 bytes, its pdf at
    column S where that leaves room (the kernel then reads no pdf plane)."""
    assert texel_layout(s) == want


def test_env_records_refuse_what_the_kernel_cannot_read():
    """env_records raises on an alias outside the table, and record_layout
    (which the shading wrapper calls) on a map of another spectrum than the
    frame's, on records of another layout and on a map without records:
    the kernel reads the records unchecked.  An env made at S = 16 in a
    frame of S = 3 would read a radiance bin as the pdf; one made at S = 3
    in a frame of S = 4 the pdf as a radiance bin (the same 16-byte
    record)."""
    from tpu_pathtracer_torch.models.envlight import env_records

    rad, pdf = np.ones((3, 2, 4), np.float32), np.ones((2, 4), np.float32)
    with pytest.raises(ValueError):
        env_records(rad, pdf, np.ones(8, np.float32), np.arange(8) + 1)
    sky = np.random.default_rng(5).uniform(0.0, 4.0, (2, 4, 3)).astype(np.float32)
    env3, env16 = (build_env(sky, samples=s, device="cpu") for s in (3, 16))
    assert record_layout(env3, 3) == (4, 3) and record_layout(env16, 16) == (16, -1)
    for env, s in ((env16, 3), (env3, 4), (env3, 16)):
        with pytest.raises(ValueError):
            record_layout(env, s)
    for bad in (env3._replace(texel_rec=env3.texel_rec[:, :3].contiguous()),
                env3._replace(alias_rec=env3.alias_rec[:, :2].contiguous()),
                env3._replace(texel_rec=None)):
        with pytest.raises(ValueError):
            record_layout(bad, 3)


@pytest.mark.parametrize("spectrum,hero", [(3, 0), (16, 4)])
def test_env_sectors_by_layout(spectrum, hero):
    """chip_smoke.env_sectors: the distinct 32-byte sectors a lane's env
    reads touch, by layout.  A pick reads, plane-major, alias_p, alias_i,
    pdf_sa and one radiance row a carried plane (3 + C); in the records,
    the alias slot's record (with the pdf) and the texel's: one 16-byte load
    at S = 3; at S = 16 hero bins (h + 4j) mod 16 span every quarter of the
    texel, 2 sectors of the 64-byte record.  A miss reads the texel (1 + C
    plane-major; 1 at S = 3; 3 at S = 16, with pdf_sa beside the 64-byte
    record)."""
    import chip_smoke
    from tpu_pathtracer_torch.scene import attach_env, load_scene

    scene = load_scene(scene_path(SCENE), samples=spectrum, device="cpu")
    sky = np.random.default_rng(6).uniform(0.2, 2.0, (8, 16, 3)).astype(np.float32)
    scene = attach_env(scene, sky)
    n = 640
    inp = shading_inputs(scene, n, seed=3, hero=hero)
    if hero:
        h = np.random.default_rng(7).integers(0, spectrum, n)
        inp["state"]["bins"] = (h[None] + np.arange(hero)[:, None] * (spectrum // hero)) % \
            spectrum
    st = twf.PathState(**{k: torch.from_numpy(v) for k, v in inp["state"].items()})
    hit = HitShade(**{k: torch.from_numpy(v) for k, v in inp["hit"].items()})
    u = torch.from_numpy(inp["u"])
    uni = {"light_select": u[0], "light_bary": u[1:3], "lobe": u[3], "bounce_dir": u[4:6],
           "env_select": u[6], "env_alias": u[7], "env_jit": u[8:10]}
    got = chip_smoke.env_sectors(scene, st, hit, uni)
    c = hero or spectrum
    miss = st.alive & ~torch.isfinite(hit.t)
    assert got["misses"] == got["texel_reads"] == int(miss.sum()) > 0
    assert 0 < got["picks"] < n
    want = {"plane-major": (3 + c, 1 + c), "records": (2, 1) if spectrum == 3 else (3, 3)}
    for name, (pick, miss_sectors) in want.items():
        d = got[name]
        assert (d["sectors_per_pick"], d["sectors_per_miss"]) == (pick, miss_sectors), name
        assert d["launch_sector_mb"] <= d["warp_sector_mb"]


def test_kernel_registers_reads_bool_template_arguments():
    """chip_smoke.kernel_registers keys each instance by its template
    arguments, bools (the shading kernel's) as ints (the marches')."""
    import chip_smoke

    entry = "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{}' for 'sm_90a'"
    log = "\n".join([
        entry.format("19shade_bounce_kernelILb1ELb1ELb0EEEv11ShadeParams"),
        "    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers, 24 bytes cumulative stack size",
        entry.format("19shade_bounce_kernelILb0ELb0ELb0EEEv11ShadeParams"),
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 0 barriers",
        entry.format("18sweep_count_kernelILi4EEEvPKf"),
        "ptxas info    : Used 112 registers"])
    assert chip_smoke.kernel_registers(log, "shade_bounce_kernel") == {
        "1,1,0": {"registers": 64, "spill_bytes": 40},
        "0,0,0": {"registers": 56, "spill_bytes": 0}}
    assert chip_smoke.kernel_registers(log, "sweep_count_kernel") == {
        "4": {"registers": 112, "spill_bytes": 0}}
