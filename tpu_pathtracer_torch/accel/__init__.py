"""Acceleration structure: SAH or LBVH build + DFS-threaded layout.

``build_layout`` is the one-call equivalent of the reference's
``MPSTriangleAccelerationStructure`` setup+rebuild (reference:
renderer/Renderer.mm:456-462).
"""

from __future__ import annotations

from ..scene.scene import Scene
from . import lbvh, native
from .layout import BVHLayout, layout_arrays, layout_to  # noqa: F401


def build_layout(scene: Scene, leaf_size: int = 16, builder: str = "auto") -> BVHLayout:
    """Build the traversal-ready BVH for a scene, on the scene's device.

    ``builder``: "sah" (the native C++ binned-SAH build, best trees),
    "lbvh" (the Morton/Karras build of accel/lbvh.py, run on the scene's
    device), or "auto" (SAH when the native library is available, the LBVH
    otherwise), as the reference's."""
    if builder not in ("auto", "sah", "lbvh"):
        raise ValueError(f"builder={builder!r}: expected 'auto', 'sah' or 'lbvh'")
    cpu = lambda t: t.cpu().numpy()  # noqa: E731
    if builder == "sah" or (builder == "auto" and native.available()):
        bvh = native.build_sah(cpu(scene.p0), cpu(scene.p1), cpu(scene.p2), leaf_size)
    else:
        bvh = lbvh.build(scene.p0, scene.p1, scene.p2, leaf_size=leaf_size)
        bvh = bvh._replace(**{k: cpu(v) for k, v in bvh._asdict().items()
                              if k != "root"})
    arrays = layout_arrays(
        bvh,
        normals=(cpu(scene.n0), cpu(scene.n1), cpu(scene.n2)),
        material_id=cpu(scene.material_id),
        light_index=cpu(scene.light_index),
    )
    return layout_to(arrays, scene.p0.device)
