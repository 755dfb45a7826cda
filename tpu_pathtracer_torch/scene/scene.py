"""Flat SoA scene tensors on one device.

The port of ``tpu_pathtracer/scene/scene.py``: the reference's five GPU
buffers (vertex/index/reference/material/lightTriangle, reference:
renderer/Renderer.mm:450-454) as one immutable NamedTuple of torch tensors.
Triangles are stored fully gathered, component-major ``(3, T)``.

The light table mirrors the reference exactly: per-emissive-triangle
area = 0.5*|cross|, pdf = area/totalArea, exclusive-prefix cdf, plus a
sentinel entry {cdf=sum, pdf=1, area=0} used by the CDF walk
(reference: renderer/Renderer.mm:393-448).

Index-valued fields are int64 (torch has no general uint32 arithmetic);
their values equal the reference's int32/uint32 fields.  The reference's
extension fields are all here: the environment light (:func:`attach_env`),
map_Kd textures, the per-bin IoR of dispersion (:func:`attach_dispersion`)
and the roughness of the GGX types; each is None when the scene does not
use it.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..core import spectrum as spec
from ..io.png import read_png
from ..models.bsdf import (MATERIAL_ROUGH_CONDUCTOR, MATERIAL_SMOOTH_DIELECTRIC,
                           MATERIAL_SMOOTH_PLASTIC)
from ..models.envlight import EnvLight
from ..models.texture import resample_nearest
from .materials import classify
from .objmtl import ObjMesh, load_obj


class Scene(NamedTuple):
    # --- triangle geometry, gathered component-major SoA: (3, T) each ---
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    # --- per-triangle references (reference: Raytracing.h:106-111) ---
    material_id: torch.Tensor     # (T,) int64
    light_index: torch.Tensor     # (T,) int64, -1 when not emissive
    # --- material table (reference: Raytracing.h:98-104) ---
    mat_diffuse: torch.Tensor     # (S, M)
    mat_emissive: torch.Tensor    # (S, M)
    mat_ior: torch.Tensor         # (M,)
    mat_type: torch.Tensor        # (M,) int64
    # --- light table incl. sentinel row (reference: Raytracing.h:113-123) ---
    light_emissive: torch.Tensor  # (S, L+1)
    light_p: torch.Tensor         # (3 vertices, 3 components, L+1)
    light_n: torch.Tensor         # (3 vertices, 3 components, L+1)
    light_area: torch.Tensor      # (L+1,)
    light_pdf: torch.Tensor       # (L+1,)
    light_cdf: torch.Tensor       # (L+1,) exclusive prefix; sentinel = total
    light_tri: torch.Tensor       # (L+1,) int64 triangle index of each light
    # --- extensions (no reference equivalent); None when unused ---
    # HDR environment light (attach_env)
    env: EnvLight | None = None
    # per-triangle texcoords (6, T): uv0.xy, uv1.xy, uv2.xy (the reference
    # parses texcoords and drops them, renderer/Renderer.mm:365-369)
    tri_uv: torch.Tensor | None = None
    # (M,) int64 per-material index into ``textures`` (-1 = untextured)
    mat_tex: torch.Tensor | None = None
    # (K, TH, TW, 3) RGB texture stack, every texture at one size
    textures: torch.Tensor | None = None
    # (S, M) per-bin material IoR of dispersive Fresnel (attach_dispersion;
    # the reference's materials carry one IoR, renderer/Raytracing.h:101)
    mat_ior_bins: torch.Tensor | None = None
    # (M,) roughness, present only when a GGX type was classified
    # (load_scene(..., rough_materials=True))
    mat_roughness: torch.Tensor | None = None

    @property
    def num_triangles(self) -> int:
        return self.p0.shape[1]

    @property
    def num_lights(self) -> int:
        return self.light_area.shape[0] - 1


def scene_arrays(mesh: ObjMesh, samples: int = 3, rough_materials: bool = False) -> dict:
    """OBJ mesh -> numpy arrays of every :class:`Scene` field (None for an
    extension the scene does not use)."""
    mats = classify(mesh.materials, rough_materials=rough_materials)

    tris = mesh.triangles.astype(np.int64)
    pos, nrm = mesh.positions, mesh.normals
    p = [pos[tris[:, k]] for k in range(3)]
    n = [nrm[tris[:, k]] for k in range(3)]

    # --- light table (reference: renderer/Renderer.mm:393-448) ---
    mat_ids = mesh.material_ids
    is_emitter = (mats.emissive[mat_ids] > 0.0).any(axis=1)
    light_tri = np.nonzero(is_emitter)[0]
    num_lights = len(light_tri)

    light_index = np.full(len(tris), -1, np.int64)
    light_index[light_tri] = np.arange(num_lights)

    lp = np.stack([p[0][light_tri], p[1][light_tri], p[2][light_tri]], axis=1)
    ln = np.stack([n[0][light_tri], n[1][light_tri], n[2][light_tri]], axis=1)
    cross = np.cross(lp[:, 1] - lp[:, 0], lp[:, 2] - lp[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total_area = area.sum() if num_lights else 1.0
    pdf = area / total_area
    cdf = np.concatenate([[0.0], np.cumsum(pdf)[:-1]]) if num_lights else np.zeros(0)
    l_emissive = mats.emissive[mat_ids[light_tri]]

    # sentinel row {cdf = sum(pdf), pdf = 1, area = 0}
    def with_sentinel(arr, sentinel):
        return np.concatenate([arr, np.asarray([sentinel], arr.dtype)], axis=0)

    light_emissive = np.concatenate([l_emissive, np.zeros((1, 3), np.float32)])
    light_p = np.concatenate([lp, np.zeros((1, 3, 3), np.float32)])
    light_n = np.concatenate([ln, np.zeros((1, 3, 3), np.float32)])

    # (rows, 3) RGB table -> (S, rows) component-major spectrum table
    def up(rgb):
        return spec.from_rgb(rgb, samples).T

    return dict(
        **_texture_arrays(mesh, tris),
        # present only when a GGX type was classified, so parity scenes run
        # the parity math
        mat_roughness=(mats.roughness if rough_materials
                       and (mats.mtype >= MATERIAL_ROUGH_CONDUCTOR).any() else None),
        p0=p[0].T, p1=p[1].T, p2=p[2].T, n0=n[0].T, n1=n[1].T, n2=n[2].T,
        material_id=mat_ids.astype(np.int64),
        light_index=light_index,
        mat_diffuse=up(mats.diffuse),
        mat_emissive=up(mats.emissive),
        mat_ior=mats.ior,
        mat_type=mats.mtype.astype(np.int64),
        light_emissive=up(light_emissive),
        # (L+1, vertex, comp) -> (vertex, comp, L+1)
        light_p=np.transpose(light_p, (1, 2, 0)),
        light_n=np.transpose(light_n, (1, 2, 0)),
        light_area=with_sentinel(area.astype(np.float32), 0.0),
        light_pdf=with_sentinel(pdf.astype(np.float32), 1.0),
        light_cdf=with_sentinel(
            cdf.astype(np.float32),
            np.float32(pdf.sum()) if num_lights else 1.0),
        light_tri=with_sentinel(light_tri.astype(np.int64), 0),
    )


def _texture_arrays(mesh: ObjMesh, tris: np.ndarray) -> dict:
    """``tri_uv``, ``mat_tex`` and ``textures`` of a mesh: every map_Kd
    read once (io/png.py:read_png) and stacked at the largest height and
    width, nearest-resampled.  A missing or undecodable map_Kd warns and
    leaves its material untextured, as the reference does; no usable
    texture leaves all three None."""
    none = dict(tri_uv=None, mat_tex=None, textures=None)
    tex_paths = [m.map_kd for m in mesh.materials]
    if mesh.texcoords is None or not any(tex_paths):
        return none
    images, tex_of_mat = [], {}
    for path in tex_paths:
        if path and path not in tex_of_mat:
            try:
                img = read_png(path)
            except (OSError, ValueError) as e:
                logging.warning("map_Kd %s unusable (%s); material renders "
                                "untextured", path, e)
                tex_of_mat[path] = -1
                continue
            tex_of_mat[path] = len(images)
            images.append(img)
    if not images:
        return none
    th = max(im.shape[0] for im in images)
    tw = max(im.shape[1] for im in images)
    stack = np.stack([im if im.shape[:2] == (th, tw) else resample_nearest(im, th, tw)
                      for im in images])
    uv = mesh.texcoords  # (V, 2)
    return dict(
        tri_uv=np.concatenate([uv[tris[:, k]] for k in range(3)], axis=1).T,
        mat_tex=np.asarray([tex_of_mat.get(p, -1) if p else -1 for p in tex_paths],
                           np.int64),
        textures=stack.astype(np.float32),
    )


def scene_to(arrays: dict, device) -> Scene:
    """numpy field arrays -> a :class:`Scene` on ``device`` (an absent or
    None extension stays None)."""
    def put(name):
        if arrays.get(name) is None:
            return None
        a = np.ascontiguousarray(arrays[name])
        dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
        return torch.tensor(a, dtype=dtype, device=device)

    return Scene(**{name: put(name) for name in Scene._fields if name != "env"})


def build_scene(mesh: ObjMesh, samples: int = 3, rough_materials: bool = False,
                device="cuda") -> Scene:
    """An :class:`ObjMesh` (loaded, or made procedurally) -> :class:`Scene`
    on ``device``: the reference's ``build_scene``.  ``rough_materials``
    classifies MTL roughness in (0, 1) to the GGX types (the reference
    leaves them diffuse)."""
    return scene_to(scene_arrays(mesh, samples, rough_materials), device)


def load_scene(path: str, samples: int = 3, rough_materials: bool = False,
               device="cuda") -> Scene:
    """OBJ path -> :class:`Scene` on ``device``."""
    return build_scene(load_obj(path), samples, rough_materials, device)


def area_light_power(scene: Scene) -> float:
    """Total emitted power of the area lights (for the env's select_p):
    sum over lights of luminance(emissive) * area * pi, in the reference's
    float32 numpy order."""
    rgb = spec.to_rgb(scene.light_emissive.cpu().numpy().T).T  # (3, L+1)
    lum = 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
    return float((lum[:-1] * scene.light_area.cpu().numpy()[:-1]).sum() * np.pi)


def attach_env(scene: Scene, image, strength: float = 1.0, rotation: float = 0.0,
               select_p: float | None = None) -> Scene:
    """Attach an HDR lat-long environment light ((Eh, Ew, 3) array or an EXR
    path) to a scene.  NEE then samples env vs area lights by emitted power
    unless ``select_p`` overrides."""
    from ..models.envlight import build_env

    if isinstance(image, str):
        from ..io.exr import read_exr

        image, _ = read_exr(image)
    env = build_env(np.asarray(image, np.float32), strength=strength,
                    rotation=rotation, select_p=select_p,
                    area_light_power=area_light_power(scene),
                    samples=scene.mat_diffuse.shape[0], device=scene.p0.device)
    return scene._replace(env=env)


def attach_dispersion(scene: Scene, b_um2: float, materials=None) -> Scene:
    """``scene`` with a per-bin IoR table: dispersive Fresnel (an extension;
    the reference's materials carry one scalar IoR,
    renderer/Raytracing.h:101).  ``b_um2``: the Cauchy B coefficient (um^2)
    of every smooth plastic and smooth dielectric material, or of
    ``materials`` (indices) when given.  The scalar ``mat_ior`` stays the
    d-line value, so lobe choices and the tracked ray IoR do not change;
    only the per-bin throughput weights do (models/bsdf.py:
    dispersion_weights)."""
    samples = scene.mat_diffuse.shape[0]
    mtype = scene.mat_type.cpu().numpy()
    ior = scene.mat_ior.cpu().numpy()
    m = ior.shape[0]
    if materials is None:
        sel = (mtype == MATERIAL_SMOOTH_PLASTIC) | (mtype == MATERIAL_SMOOTH_DIELECTRIC)
    else:
        sel = np.zeros(m, bool)
        sel[np.asarray(materials)] = True
    bins = np.repeat(ior[None, :], samples, axis=0).astype(np.float32)  # (S, M)
    for j in range(m):
        if sel[j]:
            bins[:, j] = spec.cauchy_ior_bins(float(ior[j]), b_um2, samples)
    return scene._replace(mat_ior_bins=torch.tensor(bins, device=scene.p0.device))
