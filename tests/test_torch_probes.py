"""tpu_pathtracer_torch's two measuring tools (scripts/perf_launch.py and
scripts/perf_ophit_probe.py) against the reference's Pallas kernels of
scripts/perf_launch.py and scripts/perf_ophit_probe.py in interpret mode, on
seeded numpy inputs fed to both sides, and the tools' ``main()`` on the CPU.

Tolerances, each with its reason:
  * the no-op: exact (a copy and zeros);
  * the row-test probe, 128 lanes x 256 rows of standard-normal planes:
    best_t to rtol 1e-5 or atol 1e-6 where both accepted something, best_i
    equal on >= 99% of the lanes.  XLA contracts the tests' multiply-adds
    into FMAs on the CPU, torch does not; with random planes ``num = n.o +
    d0`` cancels, so a small t carries the last-ulp difference of its terms
    as an absolute error (observed: 6.8e-9 on a t of 3.1e-4, 2.2e-5 relative,
    hence the absolute floor, as torch_parity.assert_hits_agree has), and
    an accept on the edge u + v <= 1 or a near tie can flip.  Observed:
    best_i equal on every lane for all six variants, ``nodiv`` included.
On CPU tensors no kernel launches.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_pathtracer_torch.scripts import dense_march, perf_launch, perf_ophit_probe
from torch_parity import load_reference_script, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LANES, TILE, ROWS, MTBLOCK = 128, 128, 256, 16


@pytest.fixture(scope="module")
def ref_launch():
    return load_reference_script("perf_launch")


@pytest.fixture(scope="module")
def ref_probe():
    return load_reference_script("perf_ophit_probe")


@pytest.mark.parametrize("ntables", [0, 3])
@pytest.mark.parametrize("tile", [128, 256])
def test_noop_matches_reference(ref_launch, tile, ntables):
    """noop_plain == a pallas_call of noop_kernel, and run_noop_plain ==
    the reference's run_noop, exactly; tables and tile change nothing; the
    wrapper on a CPU tensor launches nothing."""
    rng = np.random.default_rng(41)
    rays = rng.normal(size=(8, 512)).astype(np.float32)
    tables = [rng.normal(size=(16, 8)).astype(np.float32) for _ in range(ntables)]
    spec = pl.BlockSpec((8, tile), lambda g: (0, g), memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        ref = pl.pallas_call(
            ref_launch.noop_kernel, grid=(512 // tile,),
            in_specs=[spec] + [pl.BlockSpec(memory_space=pltpu.VMEM)] * ntables,
            out_specs=spec, out_shape=jax.ShapeDtypeStruct((8, 512), jnp.float32),
        )(jnp.asarray(rays), *(jnp.asarray(t) for t in tables))
        ref_sum = ref_launch.run_noop(jnp.asarray(rays), [jnp.asarray(t) for t in tables],
                                      tile)
    trays, ttables = torch.from_numpy(rays), [torch.from_numpy(t) for t in tables]
    before = perf_launch.noop.launches
    got = perf_launch.noop(trays, ttables, tile)
    assert perf_launch.noop.launches == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(got, perf_launch.noop_plain(trays, ttables, tile))
    assert float(perf_launch.run_noop_plain(trays, ttables, tile)) == float(ref_sum)
    assert float(perf_launch.run_noop(trays, ttables, tile)) == float(ref_sum)
    assert (got[1:] == 0).all() and torch.equal(got[0], trays[0])


@pytest.mark.parametrize("variant", perf_ophit_probe.VARIANTS)
def test_rowtest_probe_matches_reference(ref_probe, variant):
    """rowtest_probe_plain == a pallas_call of the reference's _kernel,
    built as its run_variant builds it."""
    rng = np.random.default_rng(43)
    rays = rng.normal(size=(8, LANES)).astype(np.float32)
    tris = rng.normal(size=(ROWS, 16)).astype(np.float32)
    kern = functools.partial(ref_probe._kernel, nblocks=ROWS // MTBLOCK, mtblock=MTBLOCK,
                             variant=variant)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pl.pallas_call(
            kern, grid=(LANES // TILE,),
            in_specs=[pl.BlockSpec((8, TILE), lambda g: (0, g), memory_space=pltpu.VMEM),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((2, TILE), lambda g: (0, g), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((2, LANES), jnp.float32),
        )(jnp.asarray(rays), jnp.asarray(tris)))
    before = perf_ophit_probe.rowtest_probe.launches
    t, i = perf_ophit_probe.rowtest_probe(variant, torch.from_numpy(rays),
                                          torch.from_numpy(tris), TILE, MTBLOCK)
    assert perf_ophit_probe.rowtest_probe.launches == before
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    t, i = t.numpy(), i.numpy()
    fin = np.isfinite(ref[0])
    np.testing.assert_array_equal(np.isfinite(t), fin)
    assert fin.mean() > 0.5
    np.testing.assert_allclose(t[fin], ref[0][fin], rtol=1e-5, atol=1e-6)
    same = i == ref[1].astype(np.int32)
    print(f"{variant}: best_i equal on {same.mean():.2%} of {LANES} lanes, "
          f"{fin.sum()} accepted")
    assert same.mean() >= 0.99
    if variant == "nopick":
        assert (i == -1).all()
    else:
        assert (i[fin] >= 0).all() and (i[~fin] == -1).all()


def test_rows_latch_equals_block_latch():
    """The block latch and the row-by-row latch pick the same winner (the
    first of equal-t rows), whatever the block size; a partial last block is
    not marched."""
    rays, tris = perf_ophit_probe.probe_inputs(64, 40, "cpu", seed=3)
    t16, i16 = perf_ophit_probe.rowtest_probe_plain("full-bw", rays, tris, 16)
    t8, i8 = perf_ophit_probe.rowtest_probe_plain("rows-latch", rays, tris[:32], 8)
    assert torch.equal(t16, t8) and torch.equal(i16, i8) and int(i16.max()) < 32
    with pytest.raises(ValueError, match="variant"):
        perf_ophit_probe.rowtest_probe("nope", rays, tris)


def test_perf_launch_main_on_cpu(capsys):
    rc = perf_launch.main(["--platform", "cpu", "--lanes", "2048", "--reps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[0] == "device: cpu"
    assert lines[1].startswith("v1 tables: [") and lines[2].startswith("v2 tables: [")
    assert [ln.split()[0] for ln in lines[3:7]] == ["tile="] * 4
    assert "blocks=    3" in lines[3] and "+v1 tables=" in lines[3] and "+v2 tables=" in lines[3]
    assert lines[7].startswith("tables (pointer arguments")
    assert lines[8].startswith("v1 all-dead (capped_walk, 2048 lanes):")
    assert lines[9].startswith("v2 all-dead (window_walk, 2048 lanes):")


def test_perf_ophit_probe_main_on_cpu(capsys):
    rc = perf_ophit_probe.main(["--platform", "cpu", "--lanes", "64", "--rows", "40",
                                "--reps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and lines[0] == "device: cpu"
    assert lines[1] == "lanes=64 rows/lane=40 row-tests=2.05e+03"
    rows = [ln.split() for ln in lines[2:]]
    assert [r[0] for r in rows] == ["ROW"] * 6
    assert tuple(r[1] for r in rows) == perf_ophit_probe.VARIANTS
    assert all(r[3] == "ms" and r[5] == "ps/rowtest" for r in rows)
    assert "%" not in lines[2] and all("%" in ln for ln in lines[3:])


@pytest.mark.parametrize("tool", [perf_launch, perf_ophit_probe],
                         ids=["perf_launch", "perf_ophit_probe"])
@pytest.mark.parametrize("platform", ["auto", "gpu"])
def test_tools_need_a_card_unless_asked_for_the_cpu(tool, platform, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--platform", platform])


@pytest.mark.parametrize("tile", [96, 768, 6144])
@pytest.mark.parametrize("n", [1, 31, 33, 4096, 65537])
def test_probe_launch_shape_covers_every_lane_once(n, tile):
    """The probe's launch shape (scripts/dense_march.py, which the kernel's
    lane mapping mirrors) covers every lane exactly once at the kernel's k:
    no lane twice, none left out, no slot past n; whole warps, at most
    MAX_THREADS threads; the tool's table (7,104 marched rows) tiled in
    whole 16-row blocks and the card tests' (196 or 200 rows) staged whole,
    within the card's shared memory."""
    k = perf_ophit_probe.K_LANES
    for rows in (7104, 7112 // 7 * 7, 196, 200):
        shape = dense_march.march_shape(n, tile, k, rows, perf_ophit_probe.STAGED_ROW_BYTES)
        lanes = dense_march.march_lanes(shape, n, tile, k)
        assert torch.equal(lanes[lanes >= 0].sort().values, torch.arange(n))
        assert shape.threads % 32 == 0 and shape.threads <= dense_march.MAX_THREADS
        assert shape.threads * k * shape.passes >= tile > shape.threads * k * (
            shape.passes - 1)
        assert shape.smem <= dense_march.SHARED_LIMIT
        if rows * perf_ophit_probe.STAGED_ROW_BYTES > dense_march.ONE_TILE_BYTES:
            assert shape.tile_rows % 16 == 0 and shape.tile_rows < rows
        else:
            assert shape.tile_rows == rows


def test_launch_shape_rejects_what_the_kernels_cannot_take():
    """A tile that is not a multiple of 32 (100) and a table whose staging
    would pass the card's shared memory raise before any launch."""
    with pytest.raises(ValueError, match="tile=100"):
        dense_march.march_shape(4096, 100, 4, 200, 48)
    with pytest.raises(ValueError, match="shared memory"):
        dense_march.march_shape(4096, 768, 4, 200, 48, head_bytes=dense_march.SHARED_LIMIT)


def test_probe_bound_full_bw():
    """chip_smoke's bound of the tool's full-bw march, 2,073,600 lanes x
    7,104 rows at 38 operations a row test, 2 flops each, over 67 TFLOP/s:
    16.71 ms, bound by operations (the bytes: 40 a lane and the 455 KB
    table, 0.025 ms)."""
    import chip_smoke

    b = chip_smoke.probe_bound(perf_ophit_probe.N, 7104, perf_ophit_probe.T8,
                               perf_ophit_probe.ROWTEST_OPS["full-bw"])
    assert b["bound_ops"] == 2073600 * 7104 * 38
    assert b["bound_bytes"] == 2073600 * 40 + 7112 * 64
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"], 2) == 16.71
