"""tests/test_scale.py's procedural terrain without JAX, for
tpu_pathtracer_torch: the tests, chip_smoke.py and the README's
large-scene recipe build it from here.  Imports numpy and the port only.

    import sys; sys.path.insert(0, "tests")   # from the repository root
    from torch_terrain import terrain_scene
    scene = terrain_scene(256)                 # 130,052 triangles on the card
"""

from __future__ import annotations

import numpy as np


def terrain_mesh(n: int):
    """tests/test_scale.py's ``_terrain_mesh(n)`` as the port's ObjMesh: a
    displaced (n x n)-vertex heightfield over [-1, 1]^2 with analytic
    normals, (n-1)^2 * 2 triangles, plus a 2-triangle emissive quad above
    it facing down."""
    from tpu_pathtracer_torch.scene.objmtl import MtlRecord, ObjMesh

    xs = np.linspace(-1.0, 1.0, n, dtype=np.float64)
    x, z = np.meshgrid(xs, xs, indexing="ij")
    y = 0.35 * np.sin(3.0 * x) * np.cos(2.0 * z) + 0.15 * np.sin(
        7.0 * x + 1.0) * np.cos(5.0 * z)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    dfdx = 0.35 * 3.0 * np.cos(3.0 * x) * np.cos(2.0 * z) + 0.15 * 7.0 * np.cos(
        7.0 * x + 1.0) * np.cos(5.0 * z)
    dfdz = -0.35 * 2.0 * np.sin(3.0 * x) * np.sin(2.0 * z) - 0.15 * 5.0 * np.sin(
        7.0 * x + 1.0) * np.sin(5.0 * z)
    nrm = np.stack([-dfdx, np.ones_like(x), -dfdz], axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, c], axis=1),
                           np.stack([a, c, d], axis=1)]).astype(np.uint32)
    v0 = len(pos)
    lamp_pos = np.array([[-0.4, 2.0, -0.4], [0.4, 2.0, -0.4], [0.4, 2.0, 0.4],
                         [-0.4, 2.0, 0.4]])
    lamp_tris = np.array([[v0, v0 + 1, v0 + 2], [v0, v0 + 2, v0 + 3]], np.uint32)
    return ObjMesh(
        positions=np.concatenate([pos, lamp_pos]).astype(np.float32),
        normals=np.concatenate([nrm, np.tile([[0.0, -1.0, 0.0]], (4, 1))]).astype(
            np.float32),
        triangles=np.concatenate([tris, lamp_tris]),
        material_ids=np.concatenate([np.zeros(len(tris), np.int32),
                                     np.ones(2, np.int32)]),
        materials=[MtlRecord(name="ground", kd=(0.7, 0.7, 0.7)),
                   MtlRecord(name="lamp", kd=(0.0, 0.0, 0.0), ka=(12.0, 12.0, 12.0))],
    )


def terrain_scene(grid: int, device="cuda"):
    """``terrain_mesh(grid)`` through ``build_scene`` on ``device``."""
    from tpu_pathtracer_torch.scene import build_scene

    return build_scene(terrain_mesh(grid), device=device)
