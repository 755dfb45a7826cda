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
from tpu_pathtracer_torch.models import camera as tcam
from tpu_pathtracer_torch.ops import rng as trng
from tpu_pathtracer_torch.render import noise as tnoise
from tpu_pathtracer_torch.render import order as torder
from tpu_pathtracer_torch.render import state as tstate


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 + 5, 2**40 + 3])
def test_threefry_key_schedule_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    tk = trng.prng_key(seed)
    np.testing.assert_array_equal(trng.key_data(tk), np.asarray(jax.random.key_data(jk)))
    for frame in (0, 1, 2, 17, 1000, 2**31 + 9):
        jf = jstate.fused_wavefront_key(jstate.frame_rng_key(RenderConfig(), jk, frame))
        tf = tstate.fused_wavefront_key(tstate.frame_rng_key(tk, frame))
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
    tj = tnoise.camera_jitter(tcam_key, 5, tp)
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    for bounce in (0, 1, 6):
        ju = jnoise.bounce_uniforms(cfg, jkey, 5, bounce, jp, h, w)
        tu = tnoise.bounce_uniforms(tkey, 5, bounce, tp)
        assert tu.keys() == ju.keys()
        for k in ju:
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]), err_msg=k)

    jo_, jd = jcam.generate_rays_flat(jcam.Camera.reference_default(), jo.rows,
                                      jo.cols, jj[0:2], h, w, lens_u=jj[2:4])
    to_, td = tcam.generate_rays_flat(tcam.Camera(), to.rows, to.cols, tj[0:2], h, w)
    np.testing.assert_array_equal(to_.numpy(), np.asarray(jo_))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
