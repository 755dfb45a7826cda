"""Wavefront OBJ/MTL parsing (numpy only; a copy of
``tpu_pathtracer/scene/objmtl.py``).

Matching SceneKit-visible behavior of the reference's scene import
(reference: renderer/Renderer.mm:265-270, 331-432):

  * faces are triangulated as fans;
  * (position, normal) index pairs are deduplicated into unified vertices;
  * each ``usemtl`` face run becomes one geometry element carrying its
    material (reference: renderer/Renderer.mm:372-377);
  * MTL channels: ``Kd`` diffuse, ``Ka`` emission, and the reference's
    channel hack ``Ks = (roughness, metalness, +-ior)``
    (reference: renderer/Renderer.mm:286-295); unknown keys are ignored.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class MtlRecord:
    name: str
    kd: tuple = (1.0, 1.0, 1.0)
    ka: tuple = (0.0, 0.0, 0.0)  # emission (reference Ka hack)
    ks: tuple = (1.0, 0.0, 0.0)  # (roughness, metalness, +-ior) hack
    map_kd: str | None = None    # diffuse texture path (extension)


@dataclasses.dataclass
class ObjMesh:
    positions: np.ndarray       # (V, 3) float32, unified vertices
    normals: np.ndarray         # (V, 3) float32
    triangles: np.ndarray       # (T, 3) uint32 indices into unified vertices
    material_ids: np.ndarray    # (T,) int32 per-triangle material index
    materials: list             # list[MtlRecord], in first-use order
    texcoords: np.ndarray | None = None  # (V, 2) float32 per unified vertex


def parse_mtl(path: str) -> dict:
    """Parse an MTL file into {name: MtlRecord}."""
    records: dict[str, MtlRecord] = {}
    current: MtlRecord | None = None
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                current = MtlRecord(name=parts[1] if len(parts) > 1 else "")
                records[current.name] = current
            elif current is not None and key in ("Kd", "Ka", "Ks"):
                vals = tuple(float(v) for v in parts[1:4])
                if len(vals) == 3:
                    setattr(current, key.lower(), vals)
            elif current is not None and key.lower() == "map_kd":
                # last token is the filename (options like -o are ignored)
                current.map_kd = os.path.join(base_dir, parts[-1])
    return records


def load_obj(path: str) -> ObjMesh:
    positions_raw: list[tuple] = []
    normals_raw: list[tuple] = []
    texcoords_raw: list[tuple] = []
    mtl_records: dict[str, MtlRecord] = {}

    materials: list[MtlRecord] = []
    material_index: dict[str, int] = {}
    current_material = -1

    vertex_map: dict[tuple, int] = {}
    unified_pos: list[tuple] = []
    unified_nrm: list[int] = []  # normal raw index per unified vertex (-1 if none)
    unified_uv: list[int] = []   # texcoord raw index per unified vertex (-1 if none)
    tri_indices: list[tuple] = []
    tri_materials: list[int] = []

    base_dir = os.path.dirname(os.path.abspath(path))

    def get_material(name: str) -> int:
        if name not in material_index:
            rec = mtl_records.get(name, MtlRecord(name=name))
            material_index[name] = len(materials)
            materials.append(rec)
        return material_index[name]

    def unify(v_idx: int, n_idx: int, t_idx: int) -> int:
        key = (v_idx, n_idx, t_idx)
        out = vertex_map.get(key)
        if out is None:
            out = len(unified_pos)
            vertex_map[key] = out
            unified_pos.append(positions_raw[v_idx])
            unified_nrm.append(n_idx)
            unified_uv.append(t_idx)
        return out

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions_raw.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            elif key == "vn":
                normals_raw.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vt":
                texcoords_raw.append(
                    (float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0)
                )
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(parts[1:]))
                if os.path.exists(mtl_path):
                    mtl_records.update(parse_mtl(mtl_path))
            elif key == "usemtl":
                current_material = get_material(parts[1] if len(parts) > 1 else "")
            elif key == "f":
                corners = []
                for token in parts[1:]:
                    fields = token.split("/")
                    v_idx = int(fields[0])
                    v_idx = v_idx - 1 if v_idx > 0 else len(positions_raw) + v_idx
                    n_idx = -1
                    if len(fields) >= 3 and fields[2]:
                        n_idx = int(fields[2])
                        n_idx = n_idx - 1 if n_idx > 0 else len(normals_raw) + n_idx
                    t_idx = -1
                    if len(fields) >= 2 and fields[1]:
                        t_idx = int(fields[1])
                        t_idx = (
                            t_idx - 1 if t_idx > 0 else len(texcoords_raw) + t_idx
                        )
                    corners.append(unify(v_idx, n_idx, t_idx))
                if current_material < 0:
                    current_material = get_material("")
                for i in range(1, len(corners) - 1):  # fan triangulation
                    tri_indices.append((corners[0], corners[i], corners[i + 1]))
                    tri_materials.append(current_material)

    positions = np.asarray(unified_pos, np.float32).reshape(-1, 3)
    triangles = np.asarray(tri_indices, np.uint32).reshape(-1, 3)
    material_ids = np.asarray(tri_materials, np.int32)

    normals = np.zeros_like(positions)
    missing = np.asarray([n < 0 for n in unified_nrm], bool)
    have = ~missing
    if normals_raw:
        nrm_arr = np.asarray(normals_raw, np.float32)
        idx = np.asarray([max(n, 0) for n in unified_nrm], np.int64)
        normals[have] = nrm_arr[idx[have]]
    if missing.any():
        # Face-averaged fallback normals (SceneKit generates normals when the
        # OBJ omits them; all bundled scenes provide vn, so this is a safety net).
        face_n = np.cross(
            positions[triangles[:, 1]] - positions[triangles[:, 0]],
            positions[triangles[:, 2]] - positions[triangles[:, 0]],
        )
        for c in range(3):
            np.add.at(normals, triangles[:, c], face_n)
        lens = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = np.where(lens > 0, normals / np.maximum(lens, 1e-20), normals)
        # restore exact vn values where present
        if normals_raw:
            normals[have] = nrm_arr[idx[have]]

    texcoords = None
    if texcoords_raw and any(t >= 0 for t in unified_uv):
        uv_arr = np.asarray(texcoords_raw, np.float32)
        idx = np.asarray([max(t, 0) for t in unified_uv], np.int64)
        texcoords = uv_arr[idx]
        texcoords[np.asarray([t < 0 for t in unified_uv])] = 0.0

    return ObjMesh(
        positions=positions,
        normals=normals,
        triangles=triangles,
        material_ids=material_ids,
        materials=materials,
        texcoords=texcoords,
    )
