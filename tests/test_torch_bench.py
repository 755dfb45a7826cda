"""tpu_pathtracer_torch.bench on the CPU: one JSON line with the root
bench.py's fields, its exact ray count, and its flags (--mesh on a virtual
CPU mesh).  Counts exact (integers)."""

import contextlib
import io
import json

import pytest

from tpu_pathtracer_torch import RenderConfig, bench
from tpu_pathtracer_torch.render.stats import count_traced_rays_exact
from tpu_pathtracer_torch.scene import load_scene, scene_path
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the fields of the root bench.py's line (bench.py:233-253), less
# vs_baseline (the TPU north star)
REFERENCE_FIELDS = {
    "metric", "value", "unit", "hud_mrays_per_s", "rays_traced_per_frame",
    "ms_per_frame", "mean_ms_per_frame", "best_ms_per_frame", "best_mrays_per_s",
    "frame_times_ms", "spp_per_sec", "scene", "resolution", "path_depth", "device",
    "mesh", "finite", "image_mean", "traced_count_s",
}
TINY = ["--platform", "cpu", "--width", "32", "--height", "24", "--depth", "3",
        "--frames", "1", "--warmup", "0"]


def run_bench(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.main(argv) == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("flags,cfg", [
    ([], {}),
    (["--kernel", "sweep", "--no-utilization"], {"traversal_kernel": "sweep"}),
    (["--fuse-shadow", "--no-utilization"], {"fuse_shadow_walk": True}),
    (["--intersector", "brute"], {"intersector": "brute"}),
], ids=["default", "sweep", "fused", "brute"])
def test_bench_prints_one_line(flags, cfg):
    """The line carries the reference's fields plus package; its ray count
    is the exact count of the measured frame; the default run carries the
    utilization block (the brute backend has no walk to price)."""
    out = run_bench(TINY + flags)
    assert REFERENCE_FIELDS <= set(out) and "vs_baseline" not in out
    assert out["package"] == "tpu_pathtracer_torch" and out["device"] == "cpu"
    assert out["finite"] and out["ms_per_frame"] > 0 and out["resolution"] == "32x24"
    # value: traced Mrays/s over the median frame, rounded to 3 decimals (a
    # slow CPU frame can round it to 0)
    mrays = out["rays_traced_per_frame"] / out["ms_per_frame"] / 1e3
    assert abs(out["value"] - mrays) <= 1e-3
    scene = load_scene(scene_path("CornellBox-Water-plastic"), device="cpu")
    want = count_traced_rays_exact(scene, RenderConfig(max_path_length=3, **cfg),
                                   24, 32, frame_indices=(0,))
    assert out["rays_traced_per_frame"] == int(want) > 24 * 32
    if flags:
        assert "utilization" not in out
    else:
        u = out["utilization"]
        assert u["lane_unit"] == "warp32"
        assert u["spent_lane_ops_per_ray"] >= u["useful_lane_ops_per_ray"] > 0


@pytest.mark.parametrize("flags", [["--mesh", "2x1"]], ids=" ".join)
def test_bench_unported_flags_raise(flags):
    """--mesh, which raised until the multi-device split was ported, now
    runs the bench over a virtual CPU mesh: the root bench.py's aggregate
    metric, the mesh in the line, no utilization block, and the exact ray
    count of the whole image."""
    out = run_bench(TINY + flags)
    assert out["metric"] == "traced_mrays_per_sec_aggregate_2x1mesh_1spp"
    assert out["mesh"] == "2x1" and "utilization" not in out and out["finite"]
    scene = load_scene(scene_path("CornellBox-Water-plastic"), device="cpu")
    want = count_traced_rays_exact(scene, RenderConfig(max_path_length=3), 24, 32,
                                   frame_indices=(0,))
    assert out["rays_traced_per_frame"] == int(want)


@pytest.mark.parametrize("flags,cfg", [
    (["--spp", "2", "--fuse", "2"], {"samples_per_frame": 2, "fuse_samples": 2}),
    (["--spp", "3", "--fuse", "1"], {"samples_per_frame": 3, "fuse_samples": 1}),
    (["--row-tiles", "2"], {"row_tiles": 2}),
    (["--prefix-sort"], {"prefix_sort": True}),
    (["--sort-skip", "1"], {"sort_bounce_skip": "1"}),
    (["--cull-zero-nee"], {"cull_zero_nee": True}),
    (["--bake-materials"], {"bake_materials": True}),
], ids=lambda x: " ".join(x) if isinstance(x, list) else None)
def test_bench_frame_mode_flags(flags, cfg):
    """The frame-mode flags and --bake-materials map to their RenderConfig
    fields as the root bench.py's do: the line's ray count is the exact
    count of that config, its metric names the spp, and --spp > 1 adds the
    utilization block's density caveat."""
    out = run_bench(TINY + flags)
    spp = cfg.get("samples_per_frame", 1)
    assert out["finite"] and out["metric"].endswith(f"_{spp}spp")
    scene = load_scene(scene_path("CornellBox-Water-plastic"), device="cpu")
    want = count_traced_rays_exact(scene, RenderConfig(max_path_length=3, **cfg),
                                   24, 32, frame_indices=(0,))
    assert out["rays_traced_per_frame"] == int(want) > 24 * 32 * spp
    assert ("density_caveat" in out["utilization"]) == (spp > 1)


def test_bench_needs_a_device_without_platform_cpu(monkeypatch):
    """No silent CPU fallback: auto and gpu raise without a CUDA device."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(TINY[2:])


@pytest.mark.parametrize("name,kind", [
    ("void cub::DeviceRadixSortUpsweepKernel<Policy900, false, long, int>(long const*)",
     "torch ops"),
    ("void cub::DeviceRadixSortDownsweepKernel<Policy900, false, long, int>(long const*)",
     "torch ops"),
    ("void (anonymous namespace)::sweep_kernel<true>(float const*, float const*)", "sweep"),
    ("void (anonymous namespace)::window_walk_kernel<false, true>(float const*)",
     "window_walk"),
    ("(anonymous namespace)::minwalk_kernel(float const*, float const*)", "minwalk"),
], ids=["upsweep", "downsweep", "sweep", "window", "minwalk"])
def test_profiler_kernel_kind(name, kind):
    """chip_smoke's profiler breakdown attributes a device kernel to a port
    kernel by its symbol: CUB's radix-sort Upsweep/Downsweep kernels are
    torch ops, not the sweep (a substring match counted them as the sweep)."""
    import chip_smoke

    assert chip_smoke.kernel_kind(name) == kind
