"""tpu_pathtracer_torch's LBVH builder against tpu_pathtracer's: every array
of the build and every table of the layout built on it exact, on the 5
bundled scenes and a GRID 64 procedural terrain (7,940 triangles, many
equal Morton codes).

Exact throughout: the integers are integers, bmin/bmax are minima and
maxima of the same float32 vertices, and the centroid ``(p0+p1+p2)/3`` and
its unit-cube map round the same in torch and under XLA on the CPU (no
difference observed on any of these scenes or on GRID 256)."""

import numpy as np
import pytest
import torch

from test_scale import _terrain_mesh
from tpu_pathtracer.accel import build_layout as jbuild_layout
from tpu_pathtracer.accel import lbvh as jlbvh
from tpu_pathtracer.scene import SCENE_NAMES, load_scene as jload_scene, scene_path
from tpu_pathtracer.scene.scene import build_scene as jbuild_scene
from tpu_pathtracer_torch.accel import build_layout, lbvh, native
from tpu_pathtracer_torch.scene import build_scene, load_scene
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TERRAIN = "terrain-grid64"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the LBVH build is ~1,000 small ops
    on 130K-lane tensors, and intra-op threads of several test workers on
    one host's cores turn each op's barrier into a wait (measured: 67 s
    instead of 0.9 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module", params=list(SCENE_NAMES) + [TERRAIN])
def scenes(request):
    """(reference scene, port scene on the CPU)."""
    if request.param == TERRAIN:
        mesh = _terrain_mesh(64)
        return jbuild_scene(mesh), build_scene(mesh, device="cpu")
    path = scene_path(request.param)
    return jload_scene(path), load_scene(path, device="cpu")


@pytest.mark.parametrize("leaf", [56, 8])
def test_lbvh_build_exact(scenes, leaf):
    js, ts = scenes
    ref = jlbvh.build(js.p0, js.p1, js.p2, leaf_size=leaf)
    got = lbvh.build(ts.p0, ts.p1, ts.p2, leaf_size=leaf)
    assert got.root == ref.root
    for name in ref._fields[:-1]:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_lbvh_layout_tables_exact(scenes):
    """build_layout(builder="lbvh"): every table of the port's layout ==
    the reference's, the LBVH chosen on both sides."""
    js, ts = scenes
    ref = jbuild_layout(js, leaf_size=56, builder="lbvh")
    got = build_layout(ts, leaf_size=56, builder="lbvh")
    for name in ("nodes", "nodes_meta", "tris", "sorted_to_orig", "prepass", "nodes8",
                 "meta4", "tris8", "tris8bw", "prepassbw", "leafbox", "leafmeta"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert got.anchor == ref.anchor
    assert (got.num_nodes, got.num_tris, got.max_leaf, got.num_leaves) == (
        ref.num_nodes, ref.num_tris, ref.max_leaf, ref.num_leaves)


def test_morton_and_clz():
    """The int64 emulation of uint32 Morton spreading and clz: the
    reference's values on seeded centroids, and clz at the edges."""
    rng = np.random.default_rng(3)
    c = rng.random((3, 4096)).astype(np.float32)
    c[:, :3] = [[0.0, 1.0, 0.999], [0.0, 1.0, 0.5], [0.0, 1.0, 1e-7]]
    ref = np.asarray(jlbvh.morton_codes(*c)).astype(np.int64)
    got = lbvh.morton_codes(*(torch.from_numpy(x) for x in c)).numpy()
    np.testing.assert_array_equal(got, ref)
    x = torch.tensor([0, 1, 2, 3, 2 ** 16, 2 ** 30 - 1, 2 ** 31, 2 ** 32 - 1])
    want = [32 - int(v).bit_length() for v in x.tolist()]
    assert lbvh.clz32(x).tolist() == want


def test_auto_builder_falls_back_to_lbvh(monkeypatch):
    """builder="auto" takes the LBVH when the native library is not
    available, as the reference does; "sah" names the native build."""
    ts = load_scene(scene_path("cornellbox"), device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    auto = build_layout(ts, leaf_size=4)
    want = build_layout(ts, leaf_size=4, builder="lbvh")
    for name in ("nodes", "nodes_meta", "tris"):
        assert torch.equal(getattr(auto, name), getattr(want, name))
    with pytest.raises(ValueError):
        build_layout(ts, builder="nope")
