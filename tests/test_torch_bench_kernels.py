"""The plain torch versions of the bench's four traversal kernels (minwalk,
sweep, the window walk's original-id and counting variants) against the
reference's Pallas kernels in interpret mode, on the reference's own layout
tables (cornellbox and Water-plastic at leaf 4, 256 rays, as
tests/test_accel.py), and whole frames with each traversal switch.

Tolerances, each with its reason:
  * t to rtol 1e-6 or atol 1e-6, triangle ids equal except equal-t ties
    (torch_parity.assert_hits_agree: XLA contracts multiply-adds into FMAs,
    torch does not);
  * minwalk's payload (u, v, position, normal) to atol 1e-5 where the ids
    agree, material and light exact;
  * the fused walk's hit record exactly the port's separate walk; its clear
    mask against the reference's capped nearest-hit query on all but 2e-3
    of the lanes (the boundary band of tests/test_accel.py's fused test);
  * frames to atol 2e-5, the bound tests/test_accel.py holds the fused and
    sweep frames to against the window frame.
On CPU tensors no kernel launches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer.accel import build_layout
from tpu_pathtracer.config import RenderConfig as JConfig
from tpu_pathtracer.models.camera import Camera as JCamera
from tpu_pathtracer.ops import pallas_traverse as pt
from tpu_pathtracer.render.state import init_state as jinit_state
from tpu_pathtracer.render.state import render_frame as jrender_frame
from tpu_pathtracer.scene import load_scene, scene_path
from tpu_pathtracer_torch import RenderConfig, interop
from tpu_pathtracer_torch.models.camera import Camera
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.render.state import init_state, render_frame
from torch_parity import arrays, assert_hits_agree, nee_shadow_rays, random_rays

KERNELS = ("window_walk", "window_walk_orig", "window_walk_counts", "minwalk", "sweep")


@pytest.fixture(scope="module", params=["cornellbox", "CornellBox-Water-plastic"])
def setup(request):
    """(reference scene and leaf-4 layout, port copies)."""
    scene = load_scene(scene_path(request.param))
    lay = build_layout(scene, leaf_size=4)
    return {"scene": scene, "lay": lay,
            "tscene": interop.scene_from_arrays(arrays(scene)),
            "tlay": interop.layout_from_arrays(arrays(lay))}


def _launches():
    return tuple(getattr(ht, k).launches for k in KERNELS)


def _rays(seed, n=256):
    """Seeded rays with every 7th lane inactive and every 3rd capped at 1.5."""
    o, d = random_rays(n, seed)
    active = np.arange(n) % 7 != 3
    t_max = np.where(np.arange(n) % 3 == 0, 1.5, np.inf).astype(np.float32)
    return o, d, active, t_max


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def test_minwalk_matches_pallas(setup):
    """Kernel a's plain version == _traverse_kernel(resolve=True) with an
    8-row prepass: all 12 output rows."""
    o, d, active, t_max = _rays(5)
    with pltpu.force_tpu_interpret_mode():
        ref = pt.intersect_bvh_pallas(jnp.asarray(o), jnp.asarray(d), setup["lay"],
                                      tile=128, active=jnp.asarray(active),
                                      t_max=jnp.asarray(t_max), prepass=8)
    before = _launches()
    got = ht.intersect_bvh_minwalk(*_t(o, d), setup["tlay"],
                                   active=torch.from_numpy(active),
                                   t_max=torch.from_numpy(t_max), prepass=8)
    assert _launches() == before
    same = assert_hits_agree(ref.t, ref.tri, got.t, got.tri)
    assert np.isfinite(got.t.numpy()).any() and not np.isfinite(got.t.numpy()[~active]).any()
    for name in ("u", "v", "pos", "normal"):
        np.testing.assert_allclose(getattr(got, name).numpy()[..., same],
                                   np.asarray(getattr(ref, name))[..., same],
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("mat", "light"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[same],
                                      np.asarray(getattr(ref, name))[same])


@pytest.mark.parametrize("with_orig", [False, True])
def test_sweep_matches_pallas(setup, with_orig):
    """Kernel b's plain version == _sweep_kernel (bw rows) raw: t, the
    winning row and, with_orig, the latched original triangle id."""
    o, d, active, t_max = _rays(31)
    with pltpu.force_tpu_interpret_mode():
        raw, _ = pt.intersect_bvh_sweep(
            jnp.asarray(o), jnp.asarray(d), setup["lay"], tile=128, mtblock=16,
            active=jnp.asarray(active), t_max=jnp.asarray(t_max), raw=True,
            with_orig=with_orig)
    raw = np.asarray(raw)
    before = _launches()
    out = ht.sweep(*_t(o, d, active, t_max), setup["tlay"], with_orig=with_orig)
    assert _launches() == before and len(out) == 2 + with_orig
    hit = lambda t: np.where(t < t_max, t, np.inf)  # noqa: E731
    same = assert_hits_agree(hit(raw[0]), raw[1].astype(np.int32), hit(out[0].numpy()),
                             out[1].numpy())
    assert (out[1].numpy()[~active] == setup["tlay"].num_tris).all()
    if with_orig:
        np.testing.assert_array_equal(out[2].numpy()[same], raw[2][same].astype(np.int32))
        assert (out[2].numpy()[~np.isfinite(hit(out[0].numpy()))] == -1).all()


@pytest.mark.parametrize("kernel", ["window", "sweep"])
def test_fused_matches_reference(setup, kernel):
    """Kernel c: fn.fused's hit record == the port's separate nearest-hit
    walk exactly, and its clear mask == the reference's capped nearest-hit
    query (intersect_bvh_pallas, resolve=False) on all but 2e-3 of the
    lanes, and == the reference's own fn.fused on the same share."""
    eps, n = 1e-4, 256
    origin, nee_d, alive, cap, tgt = nee_shadow_rays(setup["tscene"], n, seed=41)
    _, d1 = random_rays(n, seed=43)
    sok = alive & (np.arange(n) % 7 != 0)
    fn = ht.make_cuda_intersector(setup["tlay"], prepass=8, eps=eps, kernel=kernel)
    before = _launches()
    hit_f, clear_f = fn.fused(*_t(origin, d1, alive, nee_d, sok, cap, tgt))
    hit_s = fn(*_t(origin, d1, alive))
    assert _launches() == before
    for a, b in zip(hit_f, hit_s):
        assert torch.equal(a, b)

    jfn = pt.make_pallas_intersector(
        setup["lay"], tile=128, occlusion_tile=128, secondary_tile=128, prepass=8,
        anyhit=False, eps=eps, kernel=kernel, sweep_tile=128, sweep_mtblock=16)
    j = [jnp.asarray(x) for x in (origin, d1, alive, nee_d, sok, cap, tgt)]
    with pltpu.force_tpu_interpret_mode():
        _, jclear = jfn.fused(*j)
        occ = pt.intersect_bvh_pallas(j[0], j[3], setup["lay"], tile=128, t_max=j[5],
                                      active=j[4], resolve=False, prepass=0)
    valid = np.isfinite(np.asarray(occ.t))
    clear_near = sok & np.where(tgt >= 0, valid & (np.asarray(occ.t) >= eps)
                                & (np.asarray(occ.tri) == tgt), ~valid)
    clear_f = clear_f.numpy()
    assert clear_f.any() and (clear_f <= sok).all()
    assert (clear_f != clear_near).mean() < 2e-3
    assert (clear_f != np.asarray(jclear)).mean() < 2e-3


def test_window_counts_against_reference(setup):
    """Kernel d's plain version: hits unchanged, useful = the leaf rows the
    lane's own walk tested, never more than the reference's row 7, and the
    warp bounds of spent (prepass + ceil(the warp's useful rows / 32) and
    prepass + the warp's useful rows: a slot is one row test on 32 lanes).

    Not equal to row 7 lane by lane: the TPU tile walk tests a window's
    leaves against best_t as it stood when the window was fetched, and tests
    the leaves its lanes reached in the last chain round without a box test,
    so it enters a superset of the leaves a per-thread walk (with best_t
    updated after every leaf) enters."""
    o, d, active, t_max = _rays(53)
    with pltpu.force_tpu_interpret_mode():
        raw, _ = pt.intersect_bvh_window(
            jnp.asarray(o), jnp.asarray(d), setup["lay"], tile=128, raw=True,
            with_counts=True, prepass=8, active=jnp.asarray(active),
            t_max=jnp.asarray(t_max))
    raw = np.asarray(raw)
    args = (*_t(o, d, active, t_max), setup["tlay"])
    before = _launches()
    t, row, useful, lo, hi = ht.window_walk_counts_plain(*args, prepass=8)
    tw, rw = ht.window_walk_plain(*args, prepass=8)
    assert torch.equal(t, tw) and torch.equal(row, rw)
    t4, _, u4, spent = ht.window_walk_counts(*args, prepass=8)
    assert _launches() == before
    assert torch.equal(t4, t) and torch.equal(u4, useful) and torch.equal(spent, lo)
    hit = lambda x: np.where(x < t_max, x, np.inf)  # noqa: E731
    assert_hits_agree(hit(raw[0]), raw[1].astype(np.int32), hit(t.numpy()), row.numpy())
    useful = useful.numpy()
    assert useful.sum() > 0 and (useful[~active] == 0).all()
    assert (useful <= raw[7]).all()
    lo, hi = lo.numpy().reshape(-1, 32), hi.numpy().reshape(-1, 32)
    u32 = useful.reshape(-1, 32)
    total = u32.sum(1, keepdims=True)
    np.testing.assert_array_equal(lo, 8 + (total + 31) // 32 + 0 * u32)
    np.testing.assert_array_equal(hi, 8 + total + 0 * u32)


VARIANTS = {
    "minwalk": dict(traversal_kernel="minwalk"),
    "sweep": dict(traversal_kernel="sweep"),
    "fused": dict(fuse_shadow_walk=True),
    "sweep+fused": dict(traversal_kernel="sweep", fuse_shadow_walk=True),
}


@pytest.fixture(scope="module")
def frames():
    """The cornellbox leaf-4 scene, the port's window frame (24x32, depth 3)
    and a frame function for either package."""
    scene = load_scene(scene_path("cornellbox"))
    lay = build_layout(scene, leaf_size=4)
    tscene = interop.scene_from_arrays(arrays(scene))
    tlay = interop.layout_from_arrays(arrays(lay))

    def port(**kw):
        cfg = RenderConfig(max_path_length=3, traversal_tile=128, **kw)
        isect = ht.make_cuda_intersector(tlay, prepass=8,
                                         kernel=cfg.traversal_kernel)
        return render_frame(init_state(24, 32, device="cpu"), tscene, cfg, Camera(),
                            isect).accum.numpy()

    def ref(**kw):
        cfg = JConfig(max_path_length=3, traversal_tile=128, occlusion_tile=128,
                      secondary_tile=128, sweep_tile=128, sweep_mtblock=16, **kw)
        isect = pt.make_pallas_intersector(
            lay, tile=128, occlusion_tile=128, secondary_tile=128, prepass=8,
            kernel=cfg.traversal_kernel, sweep_tile=128, sweep_mtblock=16)
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(jrender_frame(jinit_state(24, 32), scene, cfg,
                                            JCamera.reference_default(), isect).accum)

    return {"port": port, "ref": ref, "base": port(), "tlay": tlay}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_frame_variant_matches(frames, variant):
    """One 24x32, depth-3 cornellbox frame per traversal switch == the
    port's window frame and == the reference's frame with the same switch
    (interpret mode), both to atol 2e-5."""
    before = _launches()
    got = frames["port"](**VARIANTS[variant])
    assert _launches() == before
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, frames["base"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, frames["ref"](**VARIANTS[variant]), rtol=0,
                               atol=2e-5)


def test_timed_frame_keeps_fused_walk(frames):
    """A frame timed by a stage timer takes the fused walk as the untimed
    frame does (the wrapper passes ``fused`` through as "walk_fused"), and a
    fused config with an intersector that has no fused walk raises instead
    of walking separately."""
    import contextlib

    from tpu_pathtracer_torch.ops.rng import prng_key
    from tpu_pathtracer_torch.render.state import frame_rng_key, fused_wavefront_key
    from tpu_pathtracer_torch.render.wavefront import render_sample

    class Names:
        def __init__(self):
            self.names = []

        @contextlib.contextmanager
        def span(self, name):
            self.names.append(name)
            yield

    scene = interop.scene_from_arrays(arrays(load_scene(scene_path("cornellbox"))))
    cfg = RenderConfig(max_path_length=3, fuse_shadow_walk=True)
    isect = ht.make_cuda_intersector(frames["tlay"], prepass=8)
    key = fused_wavefront_key(frame_rng_key(prng_key(0), 0))
    timer = Names()
    timed = render_sample(scene, cfg, Camera(), 24, 32, key, 0, isect, timer=timer)
    plain = render_sample(scene, cfg, Camera(), 24, 32, key, 0, isect)
    assert torch.equal(timed, plain)
    assert timer.names.count("walk_fused") == 2 and "walk_shadow" not in timer.names
    with pytest.raises(ValueError, match="fused walk"):
        render_sample(scene, cfg, Camera(), 24, 32, key, 0,
                      lambda o, d, active, t_max=None, coherent=False: isect(o, d, active))
