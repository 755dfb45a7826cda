"""The PCG4D uniforms of tpu_pathtracer_torch/ops/rng.py and the host side of
their kernels (csrc/rng.cu), on the CPU.

- ``uniforms_plain`` and ``uniforms_r2_plain`` against the reference's
  ``uniforms`` and ``uniforms_r2`` (tpu_pathtracer/ops/rng.py), bit-equal:
  the arithmetic is integer and the top 24 bits convert to float32 exactly.
- The key blocks the wrappers hand the kernels (``uniform_keys``,
  ``uniform_r2_keys``) against the plain versions' own per-group keys, and
  the kernels' uint32 arithmetic, written out here in numpy, fed those
  blocks: bit-equal to the plain versions.
- The wrappers on CPU tensors: the plain versions, no launch, no library;
  the count guard.

256 lanes and 24x32 frames.  The kernels themselves run only on the card
(tests/test_torch_cuda.py and chip_smoke.py's RNG and epilogue phase).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.ops import rng as jrng
from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.ops import hopper_traverse as ht
from tpu_pathtracer_torch.ops import rng as trng
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LANES = 256
M32 = 0xFFFFFFFF
# (frame, bounce, salt): zero, plain, frame and salt past 2^31, all ones
CASES = [(0, 0, 0), (5, 3, 0xDEADBEEF), (2**31 + 7, 7, 2**31 + 12345),
         (2**32 - 1, 1, 2**32 - 1)]
# the same with negative bounces, which the host wraps to uint32
KEY_CASES = CASES + [(9, -1, 2**31), (123, -7, 2**32 - 2)]


def _pids(seed: int) -> np.ndarray:
    """LANES uint32 pixel ids with the wrap-around corners first."""
    pid = np.random.default_rng(seed).integers(0, 2**32, LANES, dtype=np.uint64)
    pid[:4] = (0, 1, 2**31, 2**32 - 1)
    return pid.astype(np.uint32)


def _u32(x) -> np.ndarray:
    return np.asarray(int(x) & M32, np.uint32)


def _pcg4d(v):
    """csrc/rng.cu:pcg4d on four numpy uint32 arrays (numpy wraps)."""
    v0, v1, v2, v3 = (np.asarray(x, np.uint32).copy() for x in v)
    mul, inc = np.uint32(1664525), np.uint32(1013904223)
    v0, v1, v2, v3 = v0 * mul + inc, v1 * mul + inc, v2 * mul + inc, v3 * mul + inc
    for shift in (False, True):
        if shift:
            v0, v1, v2, v3 = (x ^ (x >> np.uint32(16)) for x in (v0, v1, v2, v3))
        v0 = v0 + v1 * v3
        v1 = v1 + v2 * v0
        v2 = v2 + v0 * v1
        v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def _unit(bits) -> np.ndarray:
    return (bits >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / 16777216.0)


def kernel_model(pid: np.ndarray, keys: list[int], count: int, r2: bool) -> np.ndarray:
    """What each thread of ``tpupt_uniforms`` (``r2``: ``tpupt_uniforms_r2``)
    computes from its key block, in numpy uint32 -> (count, N) float32."""
    p = np.broadcast_to(pid.astype(np.uint32), pid.shape)
    k = [np.uint32(x) for x in keys]
    groups = trng.MAX_COUNT // 4
    rows = []
    for g in range((count + 3) // 4):
        if not r2:
            rows += _pcg4d((p, np.full_like(p, k[3 * g]), np.full_like(p, k[3 * g + 1]),
                            np.full_like(p, k[3 * g + 2])))
            continue
        mixed, frame, alphas = k[4 * groups], k[4 * groups + 1], k[4 * groups + 2:]
        rot = _pcg4d((p, np.full_like(p, k[4 * g]), np.full_like(p, mixed),
                      np.full_like(p, k[4 * g + 1])))
        scr = _pcg4d((p, np.full_like(p, k[4 * g + 2]), np.full_like(p, mixed),
                      np.full_like(p, k[4 * g + 3])))
        rows += [rot[j] + (frame ^ scr[j >> 1]) * alphas[j & 1] for j in range(4)]
    return np.stack([_unit(r) for r in rows[:count]])


@pytest.mark.parametrize("form", ["uniforms", "uniforms_r2"])
@pytest.mark.parametrize("count", range(1, 11))
def test_plain_bit_equal_to_reference(form, count):
    """uniforms_plain / uniforms_r2_plain == the reference's uniforms /
    uniforms_r2, every count the frame draws (1 .. 10), bit for bit."""
    pid = _pids(count)
    for frame, bounce, salt in CASES:
        ref = getattr(jrng, form)(jnp.asarray(pid), frame, bounce, jnp.uint32(salt), count)
        got = getattr(trng, f"{form}_plain")(torch.as_tensor(pid.astype(np.int64)),
                                             frame, bounce, salt, count)
        assert got.shape == (count, LANES)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("frame,bounce,salt", KEY_CASES)
def test_key_helper_equals_plain_group_keys(frame, bounce, salt):
    """uniform_keys / uniform_r2_keys == the keys the plain versions form
    for each PCG4D group, computed again in numpy's wrapping uint32 (the
    reference's arithmetic), including negative bounces and salts at or
    above 2^31; and the plain version's own pcg4d fed those keys gives its
    rows back."""
    pid = torch.as_tensor(_pids(7).astype(np.int64))
    with np.errstate(over="ignore"):
        mixed = _u32(bounce) ^ (_u32(salt) << np.uint32(1))
        for count in (1, 4, 6, 10, trng.MAX_COUNT):
            keys = trng.uniform_keys(frame, bounce, salt, count)
            assert len(keys) == 3 * trng.MAX_COUNT // 4
            rows = []
            for g in range((count + 3) // 4):
                want = [_u32(frame) + np.uint32(0x9E3779B9) * np.uint32(g), mixed,
                        _u32(salt) + np.uint32(g) * np.uint32(0x85EBCA6B)]
                assert keys[3 * g:3 * g + 3] == [int(x) for x in want]
                full = [torch.full_like(pid, k) for k in keys[3 * g:3 * g + 3]]
                rows += [trng._to_unit_float(x) for x in trng.pcg4d(pid & M32, *full)]
            assert torch.equal(torch.stack(rows[:count]),
                               trng.uniforms_plain(pid, frame, bounce, salt, count))

            r2 = trng.uniform_r2_keys(frame, bounce, salt, count)
            assert len(r2) == trng.MAX_COUNT + 4
            for p in range((count + 3) // 4):
                step = np.uint32(0x9E3779B9) * np.uint32(p)
                want = [np.uint32(0x52D00000) + step,
                        _u32(salt) + np.uint32(p) * np.uint32(0x85EBCA6B),
                        np.uint32(0x5C4AB1E5) + step,
                        _u32(salt) + np.uint32(p) * np.uint32(0xC2B2AE35)]
                assert r2[4 * p:4 * p + 4] == [int(x) for x in want]
            assert r2[-4:] == [int(mixed), int(_u32(frame)), *trng._rd_alphas_u32(2)]


@pytest.mark.parametrize("form", ["uniforms", "uniforms_r2"])
@pytest.mark.parametrize("count", [1, 3, 4, 6, 10, 16])
def test_key_blocks_drive_the_kernel_arithmetic(form, count):
    """The kernels' uint32 arithmetic (numpy, :func:`kernel_model`) fed the
    wrapper's key block == the plain version, bit for bit."""
    pid = _pids(100 + count)
    r2 = form == "uniforms_r2"
    helper = trng.uniform_r2_keys if r2 else trng.uniform_keys
    for frame, bounce, salt in KEY_CASES:
        got = kernel_model(pid, helper(frame, bounce, salt, count), count, r2)
        want = getattr(trng, f"{form}_plain")(torch.as_tensor(pid.astype(np.int64)),
                                              frame, bounce, salt, count)
        np.testing.assert_array_equal(got, want.numpy())


def test_wrappers_take_the_plain_path_on_cpu(monkeypatch):
    """On CPU tensors the wrappers are the plain versions: the same bits,
    no launch counted and the kernels' library never loaded -- for single
    draws and for a whole 24x32 frame, whose nearest-hit queries also go
    through the window walk's epilogue wrapper without a launch."""
    def no_library():
        raise AssertionError("the kernels' library was loaded on the CPU")

    monkeypatch.setattr(trng, "load_library", no_library)
    monkeypatch.setattr(ht, "load_library", no_library)
    pid = torch.as_tensor(_pids(5).astype(np.int64))
    before = (trng.uniforms.launches, trng.uniforms_r2.launches)
    for count in (1, 4, 6, 10):
        for form in ("uniforms", "uniforms_r2"):
            assert torch.equal(getattr(trng, form)(pid, 3, 2, 0xABCDEF01, count),
                               getattr(trng, f"{form}_plain")(pid, 3, 2, 0xABCDEF01, count))
    n0 = ht.window_walk_resolve.launches
    for sampler in ("prng", "r2"):
        r = Renderer("cornellbox", 32, 24, RenderConfig(max_path_length=3, sampler=sampler),
                     device="cpu")
        r.run(1)
        assert np.isfinite(r.image()).all()
    assert (trng.uniforms.launches, trng.uniforms_r2.launches) == before
    assert ht.window_walk_resolve.launches == n0


@pytest.mark.parametrize("form", ["uniforms", "uniforms_r2"])
def test_count_and_input_guards(form):
    """A count past MAX_COUNT (or below 1) raises, on any device; so does a
    pixel-id tensor the kernel does not take."""
    fn = getattr(trng, form)
    pid = torch.as_tensor(_pids(9).astype(np.int64))
    for count in (0, trng.MAX_COUNT + 1, 40):
        with pytest.raises(ValueError, match="count"):
            fn(pid, 0, 0, 0, count)
    assert fn(pid, 0, 0, 0, trng.MAX_COUNT).shape == (trng.MAX_COUNT, LANES)
    with pytest.raises(ValueError, match="pixel_id"):
        fn(pid.to(torch.int32), 0, 0, 0, 4)
    with pytest.raises(ValueError, match="pixel_id"):
        fn(pid[::2], 0, 0, 0, 4)
    assert fn(pid[:0], 0, 0, 0, 4).shape == (4, 0)
