"""A configuration with the GGX material model and a ``map_Kd`` texture runs
through the harness and the check with nothing but its configuration JSON:
Water-plastic's box with one material of each GGX type and a checker on
the back wall, written into a temporary directory.  On the CPU at a test
size: the program is ``correct``, the bfloat16 control and each fault are
not; the reference's GGX pieces against closed forms; what the reference
does not model is refused; and the reference alone loads nothing of JAX or
of either package."""

import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from ptbench import check, harness, reference, scenes
from ptbench.control import readings
from ptbench.harness import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OBJ_PATH = scenes.obj_path
TRAFFIC = ("rgb", "spectral-env", "spp2-fuse2")
CELL = "rough-textured.rgb"
SIZE = (24, 32)
# the back wall's two faces, and their replacement at the end of the OBJ:
# texcoords 0..2 across the wall, so the map wraps once
BACK_WALL = ("f 1101/1259/1095 1102/1259/1095 1103/1259/1095 \n"
             "f 1103/1259/1095 1104/1259/1095 1101/1259/1095 \n")
TEXTURED_WALL = ("vt 2 2\nvt 0 2\nvt 0 0\nvt 2 0\ng backWall\nusemtl backWall\n"
                 "f 1101/-4/1095 1102/-3/1095 1103/-2/1095\n"
                 "f 1103/-2/1095 1104/-1/1095 1101/-4/1095\n")
# Ks = (roughness, metalness, +-ior): a rough conductor, a rough plastic, a
# rough dielectric
MATERIALS = {"rightSphere": ("Kd 0.95 0.64 0.54", "Ks 0.3 1.0 0.0"),
             "leftSphere": ("Kd 1.0 1.0 1.0", "Ks 0.5 0.0 -1.5"),
             "water": ("Kd 1.0 1.0 1.0", "Ks 0.2 0.0 1.33333")}


def png(path, img, depth=8, interlace=0):
    """(H, W, 3) uint8 -> an RGB PNG, every row filter 0 (``depth`` and
    ``interlace`` only label the header)."""
    h, w = img.shape[:2]
    raw = b"".join(b"\0" + img[r].tobytes() for r in range(h))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, interlace))
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def checker(size, tiles):
    """A (size, size, 3) uint8 checker of tiles x tiles squares, light grey
    and blue."""
    i = np.arange(size) * tiles // size
    odd = ((i[:, None] + i[None, :]) % 2).astype(bool)
    return np.where(odd[..., None], np.uint8([40, 90, 160]), np.uint8([230, 230, 230]))


def write_scene(folder, name="rough-textured", size=16, tiles=4, wall=TEXTURED_WALL,
                maps=("checker.png",), depth=8, interlace=0) -> str:
    """Water-plastic's box with the GGX materials and a checker ``map_Kd``
    on the back wall (and on the floor, where ``maps`` names two) -> the
    OBJ's path."""
    src = os.path.join(ROOT, "assets", "scenes", "CornellBox-Water-plastic")
    with open(src + ".obj") as fh:
        obj = fh.read()
    assert BACK_WALL in obj
    obj = obj.replace(BACK_WALL, "").replace("mtllib CornellBox-Water-plastic.mtl",
                                             f"mtllib {name}.mtl") + wall
    with open(src + ".mtl") as fh:
        mtl = fh.read().replace("\t", "    ")
    for mat, lines in MATERIALS.items():
        head = f"newmtl {mat}\n"
        at = mtl.index(head) + len(head)
        end = mtl.find("\nnewmtl", at) + 1 or len(mtl)
        mtl = mtl[:at] + "".join(f"    {x}\n" for x in lines) + mtl[end:]
    for mat, m in zip(("backWall", "floor"), maps):
        head = f"newmtl {mat}\n"
        mtl = mtl.replace(head, f"{head}    map_Kd {m}\n")
        png(os.path.join(folder, m), checker(size if mat == "backWall" else 2 * size, tiles),
            depth=depth, interlace=interlace)
    with open(os.path.join(folder, f"{name}.obj"), "w") as fh:
        fh.write(obj)
    with open(os.path.join(folder, f"{name}.mtl"), "w") as fh:
        fh.write(mtl)
    return os.path.join(folder, f"{name}.obj")


@pytest.fixture
def cell(bench, monkeypatch, tmp_path):
    """The scene in tmp_path, found by ``scenes.obj_path``; a configuration
    JSON with ``rough_materials``; a cell on each traffic mix (a 16x32 sky
    map), at depth 4, two warm-up frames, the rgb cell's limits."""
    obj = write_scene(str(tmp_path))
    monkeypatch.setattr(scenes, "obj_path",
                        lambda name: obj if name == "rough-textured" else OBJ_PATH(name))
    cfg = {"name": "rough-textured", "scene": {"obj": "rough-textured", "rough_materials": True},
           "width": SIZE[1], "height": SIZE[0], "max_path_length": 4, "reduced": []}
    path = tmp_path / "rough-textured.json"
    path.write_text(json.dumps(cfg))
    doc = dict(bench.doc)
    doc["configs"] = [*doc["configs"], {"name": "rough-textured", "file": str(path)}]
    doc["workloads"] = [*doc["workloads"], *(
        {"name": f"rough-textured.{t}", "config": "rough-textured", "traffic": t, "chips": 1}
        for t in TRAFFIC)]
    monkeypatch.setattr(bench, "doc", doc)
    traffic = bench.traffic

    def small(name):
        t = dict(traffic(name))
        t.update(env=t["env"] and {"height": 16, "width": 32})
        return t

    monkeypatch.setattr(bench, "traffic", small)
    limits = bench.limits("water-plastic.rgb")
    monkeypatch.setattr(bench, "limits", lambda workload: limits)
    monkeypatch.setattr(harness, "WARMUP_FRAMES", 2)
    return bench


def _run(bench, workload=CELL, seed=2 ** 31 + 77):
    return run_cell(bench, workload, seed, 0.1, False, device="cpu", size=SIZE,
                    log=lambda msg: None)


@pytest.mark.parametrize("traffic", TRAFFIC[1:])
def test_sound_run_is_correct_on_every_mix(cell, traffic):
    """Hero bins, dispersion and the env light (spectral-env), and fused
    samples (spp2-fuse2), over the GGX types and the texture."""
    res = _run(cell, f"rough-textured.{traffic}")
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["rel_l1"]["value"] < 1e-5, res["checks"]


def test_sound_run_is_correct_with_every_lane_type(cell):
    res = _run(cell)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["rel_l1"]["value"] < 1e-5, res["checks"]
    mesh = reference.parse_obj(scenes.obj_path("rough-textured"))
    sc = reference.Scene(mesh, 3, "cpu", rough_materials=True)
    assert sc.rough and sc.textures is not None
    # every GGX type, the textured wall and a diffuse wall among the first
    # hits of the check's pixels
    pix = check.sample_pixels(2 ** 31 + 77, SIZE[0] * SIZE[1], harness.CHECK_PIXELS)
    r, c = torch.as_tensor(pix // SIZE[1]), torch.as_tensor(pix % SIZE[1])
    d = reference.normalize(torch.stack([(2.0 * c / (SIZE[1] - 1) - 1.0),
                                         (2.0 * (SIZE[0] - 1 - r) / (SIZE[0] - 1) - 1.0)
                                         * SIZE[0] / SIZE[1], -torch.ones(len(pix))]).float())
    o = torch.tensor([[0.0], [1.0], [2.35]]).expand(3, len(pix))
    _, tri, _, _ = sc.bvh.nearest(o, d, torch.ones(len(pix), dtype=torch.bool),
                                  torch.full((len(pix),), float("inf")))
    mat = sc.mat[tri[tri >= 0]]
    kinds = set(sc.m_type[mat].tolist())
    assert {reference.DIFFUSE, reference.ROUGH_CONDUCTOR, reference.ROUGH_PLASTIC,
            reference.ROUGH_DIELECTRIC} <= kinds, kinds
    assert (sc.textures["of_mat"][mat] >= 0).any()


def test_control_fails(cell):
    r = readings(cell, CELL, 2 ** 31 + 78, 0.1, device="cpu", size=SIZE)
    limits = cell.limits(CELL)["limits"]
    assert check.verdict(r["program"], limits)[0], r
    assert not check.verdict(r["control"], limits)[0], r


def _scene_fault(monkeypatch, fault):
    """The program's scene loaded with ``fault`` applied underneath the
    harness."""
    import tpu_pathtracer_torch.scene as program_scene

    load = program_scene.load_scene

    def faulty(path, samples=3, rough_materials=False, device="cuda"):
        if fault == "flat":
            rough_materials = False
        sc = load(path, samples=samples, rough_materials=rough_materials, device=device)
        if fault == "untextured":
            sc = sc._replace(textures=None, mat_tex=None, tri_uv=None)
        if fault == "v_flipped":
            uv = sc.tri_uv.clone()
            uv[1::2] = 1.0 - uv[1::2]
            sc = sc._replace(tri_uv=uv)
        return sc

    monkeypatch.setattr(program_scene, "load_scene", faulty)


@pytest.mark.parametrize("fault", ["flat", "untextured", "v_flipped"])
def test_fault_is_not_correct(cell, monkeypatch, fault):
    _scene_fault(monkeypatch, fault)
    res = _run(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("alpha", [0.04, 0.25, 0.64])
def test_projected_d_integrates_to_one(alpha):
    """The integral over the hemisphere of D(m) cos(theta_m): midpoints in
    cos theta, refined toward the peak at the normal."""
    x = torch.linspace(0.0, 1.0, 400001, dtype=torch.float64)
    cos_m = 1.0 - x ** 3                 # dense near cos = 1
    mid_c = 0.5 * (cos_m[1:] + cos_m[:-1])
    dc = cos_m[:-1] - cos_m[1:]
    total = (reference.ggx_d(mid_c, torch.tensor(alpha, dtype=torch.float64)) * mid_c
             * dc).sum() * 2.0 * np.pi
    assert float(total) == pytest.approx(1.0, abs=2e-4)


def test_vndf_sample_pdf_is_the_eval_pdf():
    g = torch.Generator().manual_seed(5)
    n_lanes = 20000
    n = torch.nn.functional.normalize(torch.randn(3, n_lanes, generator=g, dtype=torch.float64),
                                      dim=0)
    w_i = torch.nn.functional.normalize(torch.randn(3, n_lanes, generator=g,
                                                    dtype=torch.float64), dim=0)
    w_i = torch.where((reference.dot(w_i, n) > 0)[None], -w_i, w_i)   # toward the surface
    alpha = torch.rand(n_lanes, generator=g, dtype=torch.float64) * 0.9 + 0.05
    u = torch.rand(2, n_lanes, generator=g, dtype=torch.float64)
    w_o, weight, pdf = reference.ggx_sample(w_i, n, alpha, u)
    fcos, epdf = reference.ggx_eval(w_i, w_o, n, alpha)
    ok = pdf > 0
    assert ok.float().mean() > 0.8
    torch.testing.assert_close(epdf[ok], pdf[ok], rtol=1e-6, atol=1e-9)
    # the weight is f cos / pdf = G2 / G1
    torch.testing.assert_close(fcos[ok] / epdf[ok], weight[ok], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind,match", [
    ("sizes", "maps of one size"), ("depth", "8-bit non-interlaced"),
    ("interlace", "8-bit non-interlaced"), ("bare", "have no texcoords")])
def test_refuses_what_it_does_not_model(tmp_path, kind, match):
    kw = {"sizes": dict(maps=("checker.png", "floor.png")), "depth": dict(depth=16),
          "interlace": dict(interlace=1),
          "bare": dict(wall="g backWall\nusemtl backWall\nf 1101//1095 1102//1095 1103//1095\n")
          }[kind]
    obj = write_scene(str(tmp_path), **kw)
    with pytest.raises(ValueError, match=match) as err:
        reference.Scene(reference.parse_obj(obj), 3, "cpu", rough_materials=True)
    named = str(tmp_path / ("rough-textured.obj" if kind == "bare" else "checker.png"))
    assert named in str(err.value)


@pytest.mark.parametrize("ctype,ch", [(0, 1), (2, 3), (6, 4)])
def test_png_decoder_reads_every_filter(tmp_path, ctype, ch):
    """Rows of each of the five filter types, encoded by hand, in gray, RGB
    and RGBA, decode to the image in linear RGB (the sRGB EOTF)."""
    g = np.random.default_rng(3)
    img = g.integers(0, 256, (5, 7, ch)).astype(np.int64)
    rows, prev = [], np.zeros(7 * ch, np.int64)
    for r, kind in enumerate(range(5)):
        cur = img[r].reshape(-1)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) >> 1, paeth][kind]
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    blob = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))
    path = tmp_path / "filters.png"
    path.write_bytes(blob)
    got = reference.read_png(str(path))
    rgb = img.repeat(3, axis=2) if ch == 1 else img[..., :3]
    srgb = rgb.astype(np.float32) / np.float32(255.0)
    want = np.where(srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def test_reference_alone_loads_neither_package():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import ptbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tpu_pathtracer', 'tpu_pathtracer_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout
