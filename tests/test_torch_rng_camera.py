"""tpu_pathtracer_torch's RNG streams, key schedule, pixel order and camera
rays against the reference's: bit-equal where the reference is exact
(threefry keys, PCG4D uniforms, orders), rays to atol 1e-6 (normalize's
rsqrt rounds differently in XLA and in torch, by at most an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.models import camera as jcam
from tpu_pathtracer.ops import rng as jrng
from tpu_pathtracer.render import noise as jnoise
from tpu_pathtracer.render import order as jorder
from tpu_pathtracer.render import state as jstate
from tpu_pathtracer_torch.config import RenderConfig as TConfig
from tpu_pathtracer_torch.models import camera as tcam
from tpu_pathtracer_torch.ops import rng as trng
from tpu_pathtracer_torch.render import noise as tnoise
from tpu_pathtracer_torch.render import order as torder
from tpu_pathtracer_torch.render import state as tstate
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 + 5, 2**40 + 3])
def test_threefry_key_schedule_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    tk = trng.prng_key(seed)
    np.testing.assert_array_equal(trng.key_data(tk), np.asarray(jax.random.key_data(jk)))
    for frame in (0, 1, 2, 17, 1000, 2**31 + 9):
        jf = jstate.fused_wavefront_key(jstate.frame_rng_key(RenderConfig(), jk, frame))
        tf = tstate.fused_wavefront_key(tstate.frame_rng_key(TConfig(), tk, frame))
        np.testing.assert_array_equal(tf, np.asarray(jax.random.key_data(jf)))
        # the camera stream's fold and the salts derived from both keys
        jc = jax.random.fold_in(jf, 0xC0FFEE)
        tc = trng.fold_in(tf, 0xC0FFEE)
        np.testing.assert_array_equal(tc, np.asarray(jax.random.key_data(jc)))
        assert tnoise.key_salt(tc) == int(jnoise.key_salt(jc))
        assert tnoise.key_salt(tf) == int(jnoise.key_salt(jf))


@pytest.mark.parametrize("frame,bounce,salt", [
    (0, 0, 0), (5, 3, 0xDEADBEEF), (2**31, 7, 123456789), (2**32 - 1, 0, 2**32 - 1),
])
def test_uniforms_bit_equal(frame, bounce, salt):
    rng = np.random.default_rng(frame % 1000 + bounce)
    pid = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    pid[:4] = (0, 1, 2**31, 2**32 - 1)  # wrap-around corners of uint32
    ref = jrng.uniforms(jnp.asarray(pid), frame, bounce, jnp.uint32(salt), 7)
    got = trng.uniforms(torch.as_tensor(pid.astype(np.int64)), frame, bounce, salt, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("h,w,tile", [(24, 32, 128), (135, 240, 1536), (97, 127, 1536)])
def test_order_noise_and_camera_rays(h, w, tile):
    cfg = RenderConfig()
    jo = jorder.make_order(h, w, 0, tile)
    to = torder.make_order(h, w, 0, tile, device="cpu")
    assert to.block == jo.block
    np.testing.assert_array_equal(to.rows.numpy(), np.asarray(jo.rows))
    np.testing.assert_array_equal(to.cols.numpy(), np.asarray(jo.cols))
    jp = jnoise.pids_from_order(jo, w)
    tp = tnoise.pids_from_order(to, w)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    jkey = jstate.fused_wavefront_key(jax.random.fold_in(jax.random.PRNGKey(3), 5))
    tkey = tstate.fused_wavefront_key(trng.fold_in(trng.prng_key(3), 5))
    jcam_key = jax.random.fold_in(jkey, 0xC0FFEE)
    tcam_key = trng.fold_in(tkey, 0xC0FFEE)
    jj = jnoise.camera_jitter(cfg, jcam_key, 5, jp, h, w)
    tj = tnoise.camera_jitter(TConfig(), tcam_key, 5, tp, h, w)
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    for bounce in (0, 1, 6):
        ju = jnoise.bounce_uniforms(cfg, jkey, 5, bounce, jp, h, w)
        tu = tnoise.bounce_uniforms(TConfig(), tkey, 5, bounce, tp, h, w)
        assert tu.keys() == ju.keys()
        for k in ju:
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]), err_msg=k)

    jo_, jd = jcam.generate_rays_flat(jcam.Camera.reference_default(), jo.rows,
                                      jo.cols, jj[0:2], h, w, lens_u=jj[2:4])
    to_, td = tcam.generate_rays_flat(tcam.Camera(), to.rows, to.cols, tj[0:2], h, w)
    np.testing.assert_array_equal(to_.numpy(), np.asarray(jo_))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("frame,bounce,salt,count", [
    (0, 0, 0, 4), (5, 3, 0xDEADBEEF, 6), (2**31, 7, 123456789, 10),
    (2**32 - 1, 1, 2**32 - 1, 7),
])
def test_uniforms_r2_bit_equal(frame, bounce, salt, count):
    """The r2 lattice sampler (cfg.sampler="r2") draws the reference's bits,
    odd counts and uint32 wrap-around corners included."""
    rng = np.random.default_rng(frame % 997 + bounce)
    pid = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    pid[:4] = (0, 1, 2**31, 2**32 - 1)
    assert trng._rd_alphas_u32(2) == jrng._rd_alphas_u32(2)
    ref = jrng.uniforms_r2(jnp.asarray(pid), frame, bounce, jnp.uint32(salt), count)
    got = trng.uniforms_r2(torch.as_tensor(pid.astype(np.int64)), frame, bounce, salt,
                           count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed,data,shape", [
    (0, 0, (64 * 64, 4)), (3, 0xFFFF, (64 * 64, 4)), (2**31 + 5, 7, (16 * 16, 4)),
    (12345, 2**32 - 1, (5, 3)),
])
def test_threefry_uniform_bit_equal(seed, data, shape):
    """The host threefry uniform of the TILED noise tiles is
    ``jax.random.uniform(key, shape, float32)`` bit for bit, and its bits
    ``jax.random.bits``: jax's default threefry_partitionable counter layout
    (element i hashes the counter pair (0, i)), not the old split-iota one."""
    assert jax.config.jax_threefry_partitionable
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    tk = trng.fold_in(trng.prng_key(seed), data)
    np.testing.assert_array_equal(trng.random_bits(tk, shape),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    got = trng.uniform(tk, shape)
    want = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("frame", [0, 4, 17])
def test_tiled_noise_bit_equal(frame):
    """TILED noise: the tile of each bounce (and the camera's, bounce -1),
    _tile_lookup with the reference's bottom-up rows and frame//3, frame//5
    offsets, the camera jitter and bounce uniforms with their swizzles and
    the counter-hash env draws, on the pixel ids of a row tile of a larger
    image (full height 40, rows 8..23)."""
    from tpu_pathtracer.config import NoiseMode as JNoise

    from tpu_pathtracer_torch.config import NoiseMode as TNoise

    h, w, full_h, row0 = 16, 24, 40, 8
    jcfg = RenderConfig(noise_mode=JNoise.TILED, noise_dimensions=16)
    tcfg = TConfig(noise_mode=TNoise.TILED, noise_dimensions=16)
    jo, to = jorder.make_order(h, w, row0), torder.make_order(h, w, row0, device="cpu")
    jp, tp = jnoise.pids_from_order(jo, w), tnoise.pids_from_order(to, w)
    jkey = jax.random.fold_in(jax.random.PRNGKey(11), frame)
    tkey = trng.fold_in(trng.prng_key(11), frame)
    for bounce in (-1, 0, 3):
        jt = jnoise._tile(jcfg, jkey, bounce)
        tt = tnoise._tile(tcfg, tkey, bounce, "cpu")
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        if bounce >= 0:
            ref = jnoise._tile_lookup(jcfg, jt, frame, bounce, jo.rows, jo.cols, full_h)
            got = tnoise._tile_lookup(tcfg, tt, frame, bounce, to.rows, to.cols, full_h)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tnoise.camera_jitter(tcfg, tkey, frame, tp, full_h, w).numpy(),
        np.asarray(jnoise.camera_jitter(jcfg, jkey, frame, jp, full_h, w)))
    for bounce in (0, 2):
        ju = jnoise.bounce_uniforms(jcfg, jkey, frame, bounce, jp, full_h, w,
                                    with_env=True)
        tu = tnoise.bounce_uniforms(tcfg, tkey, frame, bounce, tp, full_h, w,
                                    with_env=True)
        assert tu.keys() == ju.keys()
        for k in ju:
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]), err_msg=k)


@pytest.mark.parametrize("with_env", [False, True])
def test_r2_camera_and_bounce_uniforms_bit_equal(with_env):
    """cfg.sampler="r2": the camera jitter and the bounce uniforms (the
    reference's dimension order, env rows included) are the reference's."""
    h, w = 24, 32
    jcfg, tcfg = RenderConfig(sampler="r2"), TConfig(sampler="r2")
    jo, to = jorder.make_order(h, w, 0, 128), torder.make_order(h, w, 0, 128, device="cpu")
    jp, tp = jnoise.pids_from_order(jo, w), tnoise.pids_from_order(to, w)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    tkey = trng.fold_in(trng.prng_key(5), 9)
    np.testing.assert_array_equal(
        tnoise.camera_jitter(tcfg, tkey, 9, tp, h, w).numpy(),
        np.asarray(jnoise.camera_jitter(jcfg, jkey, 9, jp, h, w)))
    for bounce in (0, 5):
        ju = jnoise.bounce_uniforms(jcfg, jkey, 9, bounce, jp, h, w, with_env=with_env)
        tu = tnoise.bounce_uniforms(tcfg, tkey, 9, bounce, tp, h, w, with_env=with_env)
        assert tu.keys() == ju.keys()
        for k in ju:
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]), err_msg=k)
