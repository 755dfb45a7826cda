"""tpu_pathtracer_torch's scene tensors and BVH layout tables against the
reference's: exact, for every bundled scene."""

import numpy as np
import pytest

from tpu_pathtracer.accel import build_layout as jbuild_layout
from tpu_pathtracer.scene import SCENE_NAMES, load_scene as jload_scene, scene_path
from tpu_pathtracer_torch import interop
from tpu_pathtracer_torch.accel import build_layout
from tpu_pathtracer_torch.scene import load_scene
from torch_parity import arrays, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the tables the kernels read (accel/layout.py); tris8 = the MT window rows,
# leafbox / leafmeta = the candidate-sweep kernels' per-leaf tables
_TABLES = ("nodes", "nodes_meta", "tris", "sorted_to_orig", "prepass",
           "nodes8", "meta4", "tris8", "tris8bw", "prepassbw", "leafbox", "leafmeta")


@pytest.fixture(scope="module", params=SCENE_NAMES)
def scenes(request):
    path = scene_path(request.param)
    return jload_scene(path), load_scene(path, device="cpu")


def _tensor_fields(scene):
    """Every field but the optional environment light (None until
    attach_env; tests/test_torch_envlight.py holds it)."""
    assert scene.env is None
    return [name for name in scene._fields if name != "env"]


def test_scene_fields_exact(scenes):
    js, ts = scenes
    assert js.env is None
    for name in _tensor_fields(ts):
        ref = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert (ts.num_triangles, ts.num_lights) == (js.num_triangles, js.num_lights)
    # the light table's exclusive-prefix CDF ends in the sentinel total
    cdf = ts.light_cdf.numpy()
    assert cdf[0] == 0.0 and (np.diff(cdf) >= 0).all()
    assert ts.light_pdf[-1] == 1.0 and ts.light_area[-1] == 0.0


@pytest.mark.parametrize("leaf", [56, 8, 4])
def test_layout_tables_exact(scenes, leaf):
    js, ts = scenes
    ref = jbuild_layout(js, leaf_size=leaf)
    got = build_layout(ts, leaf_size=leaf)
    for name in _TABLES:
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert got.anchor == ref.anchor
    assert (got.num_nodes, got.num_tris, got.max_leaf, got.num_leaves) == (
        ref.num_nodes, ref.num_tris, ref.max_leaf, ref.num_leaves)
    # the pad rows of leafbox keep the far point-box that no ray can enter
    pad = got.leafbox.numpy()[got.num_leaves:, :6]
    assert (pad == np.float32([1e30, -1e30, 1e30] * 2)).all()
    # the interop bridge carries the reference's layout over unchanged
    carried = interop.layout_from_arrays(arrays(ref))
    for name in _TABLES:
        np.testing.assert_array_equal(getattr(carried, name).numpy(),
                                      getattr(got, name).numpy(), err_msg=name)
    assert carried.num_leaves == got.num_leaves


def test_scene_from_arrays_exact(scenes):
    js, ts = scenes
    carried = interop.scene_from_arrays(arrays(js))
    assert carried.env is None
    for name in _tensor_fields(ts):
        np.testing.assert_array_equal(getattr(carried, name).numpy(),
                                      getattr(ts, name).numpy(), err_msg=name)
