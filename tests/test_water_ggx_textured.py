"""The water-ggx-textured configuration on the CPU: its scene files are the
generator's output (scripts/water_ggx_textured.py), the scene loads with
the five materials the configuration states, the shading kernel and the
bounce graphs admit its frames, the program's plain path is ``correct``
against the benchmark's reference (ptbench/reference.py) at a test size,
and the launch record counts the lanes that hit a GGX type and a textured
material as the hits say.  The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import os

import numpy as np
import pytest
import torch

from ptbench import harness
from ptbench.harness import run_cell
from ptbench.manifest import Bench
from tpu_pathtracer_torch import Renderer, RenderConfig
from tpu_pathtracer_torch.models import bsdf
from tpu_pathtracer_torch.ops import shade
from tpu_pathtracer_torch.render.wavefront import chains_cover
from tpu_pathtracer_torch.scene import attach_env, load_scene, scene_path
from torch_parity import SpanLog, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "water-ggx-textured"
CELL = f"{NAME}.rgb"
# material -> (type, roughness, textured)
MATERIALS = {"rightSphere": (bsdf.MATERIAL_ROUGH_CONDUCTOR, 0.3, False),
             "leftSphere": (bsdf.MATERIAL_ROUGH_PLASTIC, 0.5, False),
             "water": (bsdf.MATERIAL_ROUGH_DIELECTRIC, 0.2, False),
             "floor": (bsdf.MATERIAL_ROUGH_PLASTIC, 0.4, True),
             "backWall": (bsdf.MATERIAL_DIFFUSE, 0.0, True)}


@pytest.fixture(scope="module")
def scene():
    return load_scene(scene_path(NAME), rough_materials=True, device="cpu")


def _names():
    from tpu_pathtracer_torch.scene.objmtl import load_obj

    return [m.name for m in load_obj(scene_path(NAME)).materials]


def test_committed_scene_is_the_generator_output(tmp_path):
    """The committed OBJ, MTL and both PNGs are, byte for byte, what
    scripts/water_ggx_textured.py writes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "water_ggx_textured", os.path.join(ROOT, "scripts", "water_ggx_textured.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    paths = gen.write(str(tmp_path / NAME))
    assert [os.path.basename(p) for p in paths] == [
        f"{NAME}.obj", f"{NAME}.mtl", f"{NAME}-wall.png", f"{NAME}-floor.png"]
    for path in paths:
        with open(path, "rb") as a, open(os.path.join(ROOT, "assets", "scenes",
                                                      os.path.basename(path)), "rb") as b:
            assert a.read() == b.read(), path


def test_scene_has_the_stated_materials(scene):
    """With the GGX material model: the rough conductor, two rough plastics
    and the rough dielectric at the stated roughness, the back wall diffuse,
    the other materials as the source's; a (2, 2048, 2048, 3) stack of the
    two maps, the wall's and the floor's; texcoords on those two surfaces
    alone, spanning 0..2; copper's F0 as the conductor's Kd."""
    names = _names()
    mtype, rough = scene.mat_type.tolist(), scene.mat_roughness.tolist()
    tex = scene.mat_tex.tolist()
    for name, (want_type, want_rough, textured) in MATERIALS.items():
        k = names.index(name)
        assert mtype[k] == want_type, name
        assert rough[k] == pytest.approx(want_rough), name
        assert (tex[k] >= 0) == textured, name
    others = [k for k, n in enumerate(names) if n not in MATERIALS]
    assert [mtype[k] for k in others] == [bsdf.MATERIAL_DIFFUSE] * len(others) == [0] * 4
    assert sorted(t for t in tex if t >= 0) == [0, 1]
    assert tuple(scene.textures.shape) == (2, 2048, 2048, 3)
    assert scene.textures.dtype == torch.float32
    assert torch.allclose(scene.mat_diffuse[:, names.index("rightSphere")],
                          torch.tensor([0.955, 0.638, 0.538]))
    textured = (scene.tri_uv != 0).any(0)
    on = scene.material_id[textured].unique().tolist()
    assert sorted(names[k] for k in on) == ["backWall", "floor"]
    assert int(textured.sum()) == 4 and scene.num_triangles == 7088
    assert float(scene.tri_uv.min()) == 0.0 and float(scene.tri_uv.max()) == 2.0


@pytest.mark.parametrize("traffic", ["rgb", "spectral-env", "spp2-fuse2"])
def test_kernel_and_graphs_admit_the_frames(scene, traffic):
    """Under each traffic mix's settings the frames of this scene shade in
    the kernel's kMaterials instances and replay as bounce graphs."""
    bench = Bench(ROOT)
    cfg = RenderConfig(max_path_length=8, **bench.traffic(traffic).get("render", {}))
    sc = scene
    if bench.traffic(traffic).get("env"):
        sc = attach_env(scene, np.full((4, 8, 3), 0.5, np.float32))
    assert shade.shade_kernel_covers(cfg, sc) and shade.has_materials(sc)
    assert chains_cover(cfg, sc)


@pytest.mark.parametrize("seed", [2 ** 31 + 27, 4_000_000_007, 11])
def test_plain_path_is_correct_against_the_reference(seed, monkeypatch):
    """The cell through the harness at 24x32, depth 4, two warm-up frames
    and a short window, on the CPU (the plain shading): ``correct`` against
    ptbench/reference.py's GGX types and map_Kd, under the cell's own
    limits."""
    bench = Bench(ROOT)
    config = bench.config

    def shallow(name):
        return dict(config(name), max_path_length=4)

    monkeypatch.setattr(bench, "config", shallow)
    monkeypatch.setattr(harness, "WARMUP_FRAMES", 2)
    res = run_cell(bench, CELL, seed, 0.1, False, device="cpu", size=(24, 32),
                   log=lambda msg: None)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["rel_l1"]["value"] < 1e-5


def test_records_count_the_ggx_and_textured_lanes(scene):
    """Each shading launch's ggx_lanes and tex_lanes in a frame's record
    equal the lanes counted by hand from the nearest hits of its bounce:
    live lanes whose hit is at least eps away and whose material is a GGX
    type, or has a texture."""
    cfg = RenderConfig(max_path_length=4, secondary_tile=16)
    r = Renderer(scene, 32, 24, cfg, seed=3, device="cpu")
    hits = []
    inner = r._intersect

    def recorder(o, d, active, t_max=None, coherent=False, **kw):
        hit = inner(o, d, active, t_max=t_max, coherent=coherent, **kw)
        if t_max is None:
            hits.append((active.clone(), hit))
        return hit

    for attr in ("occlusion", "fused", "hbm"):
        if hasattr(inner, attr):
            setattr(recorder, attr, getattr(inner, attr))
    r._intersect = recorder
    r.step(timer=SpanLog())
    rec, = r.frame_records
    launches = rec["launches"]
    assert len(launches) == len(hits) == 4
    mtype, mtex = scene.mat_type, scene.mat_tex
    for x, (active, hit) in zip(launches, hits):
        valid = active & torch.isfinite(hit.t) & (hit.t >= cfg.distance_epsilon)
        ggx = valid & (mtype[hit.mat] >= bsdf.MATERIAL_ROUGH_CONDUCTOR)
        tex = valid & (mtex[hit.mat] >= 0)
        assert x["rough"] and x["textured"]
        assert (x["ggx_lanes"], x["tex_lanes"]) == (int(ggx.sum()), int(tex.sum()))
    assert launches[0]["ggx_lanes"] > 0 and launches[0]["tex_lanes"] > 0
