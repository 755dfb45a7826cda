"""tpu_pathtracer_torch's BSDFs against the reference's, for the four
parity materials on random inputs.  Tolerance atol 1e-6: the same float32
operation order, but sqrt/cos/sin may round differently in XLA and torch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.config import RenderConfig
from tpu_pathtracer.models import bsdf as jb
from tpu_pathtracer_torch.models import bsdf as tb
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 4096


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def unit(n):
        v = rng.normal(size=(3, n)).astype(np.float32)
        return v / np.linalg.norm(v, axis=0, keepdims=True)

    n = unit(N)
    w_i = unit(N)
    # half the incoming directions hit the front face, as on real surfaces
    flip = (np.sum(w_i * n, axis=0) > 0) & (np.arange(N) % 2 == 0)
    w_i[:, flip] *= -1
    return {
        "mtype": rng.integers(0, 4, N).astype(np.int32),
        "ior": rng.uniform(1.0, 2.0, N).astype(np.float32),
        "w_i": w_i, "n": n, "w_o": unit(N),
        "lobe_u": rng.uniform(size=N).astype(np.float32),
        "dir_u": rng.uniform(size=(2, N)).astype(np.float32),
        "cur_ior": np.where(rng.uniform(size=N) < 0.5, 1.00029,
                            rng.uniform(1.0, 2.0, N)).astype(np.float32),
    }


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_material_matches(seed):
    x = _inputs(seed)
    aeps = RenderConfig().angle_epsilon
    j = {k: _pair(v)[0] for k, v in x.items()}
    t = {k: _pair(v)[1] for k, v in x.items()}
    # mirror directions exercise the delta lobes' angle test
    mirror = x["w_i"] - 2 * np.sum(x["n"] * x["w_i"], 0) * x["n"]
    for w_o in (x["w_o"], mirror.astype(np.float32)):
        jw, tw = _pair(w_o)
        rb, rp = jb.eval_material(j["mtype"], j["ior"], j["w_i"], jw, j["n"],
                                  j["lobe_u"], aeps)
        gb, gp = tb.eval_material(t["mtype"].long(), t["ior"], t["w_i"], tw,
                                  t["n"], t["lobe_u"], aeps)
        np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=0, atol=1e-6)
        np.testing.assert_allclose(gp.numpy(), np.asarray(rp), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,quirks", [(0, True), (1, True), (2, False)])
def test_sample_bounce_matches(seed, quirks):
    x = _inputs(seed)
    j = {k: _pair(v)[0] for k, v in x.items()}
    t = {k: _pair(v)[1] for k, v in x.items()}
    ref = jb.sample_bounce(j["mtype"], j["ior"], j["w_i"], j["n"], j["lobe_u"],
                           j["dir_u"], j["cur_ior"], quirks=quirks)
    got = tb.sample_bounce(t["mtype"].long(), t["ior"], t["w_i"], t["n"],
                           t["lobe_u"], t["dir_u"], t["cur_ior"], quirks=quirks)
    for name, r, g in zip(("w_o", "bsdf", "pdf", "ior", "finite"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_fresnel_matches():
    """Front-facing incidence from air (the NEE arm's eta_out = 1.0 and the
    camera ray's IoR), where no total internal reflection can occur."""
    x = _inputs(3)
    i = x["w_i"] * np.sign(np.sum(x["w_i"] * x["n"], 0))  # cos(theta_i) >= 0
    for eta_out in (1.0, 1.00029):
        r = jb.fresnel(jnp.asarray(x["n"]), jnp.asarray(i), eta_out,
                       jnp.asarray(x["ior"]))
        g = tb.fresnel(torch.from_numpy(x["n"]), torch.from_numpy(i), eta_out,
                       torch.from_numpy(x["ior"]))
        # rtol 1e-5: at grazing incidence r_s and r_p divide differences of
        # nearly equal products, so sqrt's last-ulp differences show there
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
