"""The shading and the wavefront sort of tpu_pathtracer_torch on the CPU:
the rule that routes frames to csrc/shade.cu, the host's constant folding,
the wrappers' refusal of CPU tensors, the plain shading held against the
reference's trace_bounce through the same hit, and the plain sort against
the reference's key and sort.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).

Tolerance of the shading against the reference: atol 1e-6 (XLA's CPU cos,
sin and rsqrt and torch's differ by an ulp or so), and the shadow pack also
rtol 1e-6 (its cap is a distance, up to ~35 on the sentinel light row,
where an ulp is 4e-6); flags, ids and counts exactly.  The sort keys and
the sorted planes exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.ops.intersect import HitShade as JHitShade
from tpu_pathtracer.render import wavefront as jwf
from tpu_pathtracer.scene import load_scene as jload_scene
from tpu_pathtracer.scene import scene_path
from tpu_pathtracer_torch import RenderConfig, interop
from tpu_pathtracer_torch.config import PI
from tpu_pathtracer_torch.ops import shade as tshade
from tpu_pathtracer_torch.ops import wavefront_sort as tsort
from tpu_pathtracer_torch.ops.intersect import HitShade
from tpu_pathtracer_torch.render import wavefront as twf
from torch_parity import arrays, one_torch_thread, shading_inputs, sort_inputs  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SCENE = "CornellBox-Water-plastic"
LANES = 2048


@pytest.fixture(scope="module")
def scenes():
    """S -> (the reference's scene with the four parity types in turn over
    its materials, the port's scene of the same arrays)."""
    out = {}
    for s in (3, 16):
        js = jload_scene(scene_path(SCENE), samples=s)
        js = js._replace(mat_type=jnp.arange(js.mat_type.shape[0], dtype=js.mat_type.dtype)
                         % 4)
        out[s] = (js, interop.scene_from_arrays(arrays(js)))
    return out


@pytest.mark.parametrize("change,covered", [
    ({}, True),
    ({"env": object()}, False),
    ({"textures": object()}, False),
    ({"mat_roughness": object()}, False),
    ({"mat_ior_bins": object()}, False),
    ({"cfg": {"spectrum_samples": 16, "hero_wavelengths": 4}}, False),
    ({"cfg": {"spectrum_samples": 3, "hero_wavelengths": 2}}, True),
    ({"cfg": {"spectrum_samples": 16}}, True),
    ({"cfg": {"spectrum_samples": 17}}, False),
    ({"cfg": {"reference_quirks": False, "refract_dielectric": True,
              "cull_zero_nee": True, "sort_rays": False}}, True),
], ids=("parity", "env", "textures", "roughness", "dispersion", "hero", "hero-at-S3",
        "S16", "S17", "modes"))
def test_shade_kernel_covers(change, covered, scenes):
    """The one routing rule: every scene field and config field it reads.
    A hero config at S = 3 traces every bin (render_sample's rule), so the
    kernel covers it; the frame modes do not change the rule."""
    change = dict(change)
    cfg = RenderConfig(**change.pop("cfg", {}))
    scene = scenes[3][1]._replace(**change)
    assert tshade.shade_kernel_covers(cfg, scene) is covered


@pytest.mark.parametrize("eps,aeps,floor", [(1e-4, 0.00003807693583, 1e-20),
                                            (3e-3, 1e-2, 1e-3), (1e-7, 0.1, 0.3)])
def test_folded_constants_equal_torch(eps, aeps, floor):
    """Each constant the host folds for the kernel is the float32 torch
    computes from the same Python scalar on a float32 tensor: the products
    and sums, the selects, and the comparisons (made in float32 too)."""
    cfg = RenderConfig(distance_epsilon=eps, angle_epsilon=aeps, pdf_floor=floor)
    c = tshade.folded_constants(cfg)
    one, zero = torch.ones(1), torch.zeros(1)
    assert float(one * (1.0 / PI)) == c["inv_pi"]
    assert float(one * (PI * 2.0)) == c["two_pi"]
    assert float(zero + 4.0 * eps) == c["four_eps"]
    assert float(one * eps) == c["eps"]
    assert float(torch.where(torch.tensor([False]), one, floor)) == c["pdf_floor"]
    for name, v in (("eps", eps), ("aeps", aeps), ("pdf_floor", floor)):
        near = torch.from_numpy(np.nextafter(np.float32(c[name]),
                                             np.float32([0.0, np.inf, c[name]])))
        near = torch.cat([near, torch.tensor([c[name]], dtype=torch.float32)])
        assert torch.equal(near < v, near < c[name])
        assert torch.equal(near >= v, near >= c[name])


def test_wrappers_raise_on_cpu(scenes):
    """The kernel wrappers take CUDA tensors only; render/wavefront.py
    routes CPU tensors to the plain versions."""
    scene = scenes[3][1]
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


SHADE_CASES = {
    "deferred": ({}, True, 2),
    "inline": ({}, False, 2),
    "last-bounce": ({"max_path_length": 3}, True, 2),
    "no-quirks": ({"reference_quirks": False}, True, 1),
    "refract": ({"refract_dielectric": True}, False, 1),
    "refract-no-quirks": ({"refract_dielectric": True, "reference_quirks": False}, True, 1),
    "cull-zero-nee": ({"cull_zero_nee": True, "pdf_floor": 0.3}, True, 1),
    "S16": ({"spectrum_samples": 16}, False, 1),
}


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_plain_matches_reference(case, scenes):
    """The port's trace_bounce through the same hit (so its shading,
    render/wavefront.py:_shade_plain) == the reference's trace_bounce, on
    seeded lanes of every parity material: real hits and misses, hits
    nearer than eps, dead lanes, emitter hits, the sentinel light row,
    pdfs under a raised pdf floor; quirks, refraction, zero-NEE culling, the
    last bounce's gate and S = 16; the deferred form's shadow pack, and the
    inline form's shadow origin and resolved radiance."""
    kw, defer, bounce = SHADE_CASES[case]
    s = kw.get("spectrum_samples", 3)
    jscene, tscene = scenes[s]
    inp = shading_inputs(tscene, LANES, seed=17 + bounce)
    rows = {"light_select": 0, "light_bary": slice(1, 3), "lobe": 3,
            "bounce_dir": slice(4, 6)}

    jst = jwf.PathState(**{k: jnp.asarray(v.astype(np.uint32) if k == "pixel" else v)
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
    else:
        np.testing.assert_allclose(tocc.origins, jocc.origins, rtol=0, atol=1e-6)
    assert [int(x) for x in got[-1].values()] == [int(x) for x in ref[-1].values()]


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
