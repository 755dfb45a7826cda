"""Acceleration structure: native SAH build + DFS-threaded layout.

``build_layout`` is the one-call equivalent of the reference's
``MPSTriangleAccelerationStructure`` setup+rebuild (reference:
renderer/Renderer.mm:456-462).
"""

from __future__ import annotations

from ..scene.scene import Scene
from . import native
from .layout import BVHLayout, layout_arrays, layout_to  # noqa: F401


def build_layout(scene: Scene, leaf_size: int = 16, builder: str = "auto",
                 bake_materials: bool = False) -> BVHLayout:
    """Build the traversal-ready BVH for a scene, on the scene's device.

    ``builder``: "sah" or "auto" (both the native C++ binned-SAH builder).
    The JAX LBVH builder and material-baked rows are not ported yet."""
    if builder == "lbvh":
        raise NotImplementedError(
            "the LBVH builder is not ported to tpu_pathtracer_torch yet "
            "(ROADMAP.md queue 1 item 14)")
    if builder not in ("auto", "sah"):
        raise ValueError(f"builder={builder!r}: expected 'auto', 'sah' or 'lbvh'")
    if bake_materials:
        raise NotImplementedError(
            "bake_materials is not ported to tpu_pathtracer_torch yet "
            "(ROADMAP.md queue 1 item 10)")
    cpu = lambda t: t.cpu().numpy()  # noqa: E731
    bvh = native.build_sah(cpu(scene.p0), cpu(scene.p1), cpu(scene.p2), leaf_size)
    arrays = layout_arrays(
        bvh,
        normals=(cpu(scene.n0), cpu(scene.n1), cpu(scene.n2)),
        material_id=cpu(scene.material_id),
        light_index=cpu(scene.light_index),
    )
    return layout_to(arrays, scene.p0.device)
