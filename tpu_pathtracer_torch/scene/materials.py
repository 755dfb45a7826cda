"""Material classification from MTL channels.

Reproduces the reference's decision tree over the smuggled MTL channels
(reference: renderer/Renderer.mm:278-329): ``Kd`` = diffuse, ``Ka`` = emission,
``Ks`` = (roughness, metalness, +-ior):

  * metalness > 0 and roughness == 0          -> MIRROR
    (metalness > 0, roughness in (0,1)        -> rough conductor TODO in the
     reference; it leaves materialType unset — the parity default classifies
     DIFFUSE and warns, ``rough_materials=True`` opts into GGX
     MATERIAL_ROUGH_CONDUCTOR)
  * roughness == 1                            -> DIFFUSE
  * ior <= 0   (ior := abs(ior))              -> SMOOTH_PLASTIC (roughness==0)
                                                 else DIFFUSE, or GGX
                                                 ROUGH_PLASTIC when opted in
  * ior > 0                                   -> SMOOTH_DIELECTRIC (roughness==0)
                                                 else DIFFUSE, or GGX
                                                 ROUGH_DIELECTRIC when opted in
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ..models.bsdf import (
    MATERIAL_DIFFUSE,
    MATERIAL_MIRROR,
    MATERIAL_NAMES,
    MATERIAL_ROUGH_CONDUCTOR,
    MATERIAL_ROUGH_DIELECTRIC,
    MATERIAL_ROUGH_PLASTIC,
    MATERIAL_SMOOTH_DIELECTRIC,
    MATERIAL_SMOOTH_PLASTIC,
)
from .objmtl import MtlRecord

log = logging.getLogger(__name__)


@dataclasses.dataclass
class MaterialTable:
    diffuse: np.ndarray    # (M, 3) float32
    emissive: np.ndarray   # (M, 3) float32
    ior: np.ndarray        # (M,) float32
    mtype: np.ndarray      # (M,) int32
    roughness: np.ndarray  # (M,) float32 (0 where the type ignores it)


def classify(records: list[MtlRecord],
             rough_materials: bool = False) -> MaterialTable:
    """MTL records -> material table.

    ``rough_materials=True`` opts into the GGX extension types for the
    combinations the reference stubs as TODO (roughness strictly between 0
    and 1); the default reproduces the reference's diffuse fallback."""
    count = len(records)
    diffuse = np.zeros((count, 3), np.float32)
    emissive = np.zeros((count, 3), np.float32)
    ior = np.zeros(count, np.float32)
    mtype = np.zeros(count, np.int32)
    rough = np.zeros(count, np.float32)

    for i, rec in enumerate(records):
        diffuse[i] = rec.kd
        emissive[i] = rec.ka
        roughness, metalness, raw_ior = rec.ks
        ior[i] = raw_ior
        is_rough = 0.0 < roughness < 1.0
        if metalness > 0.0:
            if roughness == 0.0:
                mtype[i] = MATERIAL_MIRROR
            elif rough_materials and is_rough:
                mtype[i] = MATERIAL_ROUGH_CONDUCTOR
                rough[i] = roughness
            else:
                # rough conductor: unimplemented in the reference too
                # (renderer/Renderer.mm:305 leaves the type unset -> 0 = diffuse)
                mtype[i] = MATERIAL_DIFFUSE
                if rough_materials:
                    # flag is on but roughness is out of GGX's (0, 1) range
                    log.warning(
                        "material %r: metal roughness %.3g outside (0, 1) "
                        "-> diffuse", rec.name, roughness)
                else:
                    log.warning(
                        "material %r: rough conductor unsupported -> "
                        "diffuse (pass rough_materials=True for GGX)",
                        rec.name)
        elif roughness == 1.0:
            mtype[i] = MATERIAL_DIFFUSE
        elif raw_ior <= 0.0:
            ior[i] = abs(raw_ior)
            if roughness == 0.0:
                mtype[i] = MATERIAL_SMOOTH_PLASTIC
            elif rough_materials and is_rough:
                mtype[i] = MATERIAL_ROUGH_PLASTIC
                rough[i] = roughness
            else:
                mtype[i] = MATERIAL_DIFFUSE
        else:
            if roughness == 0.0:
                mtype[i] = MATERIAL_SMOOTH_DIELECTRIC
            elif rough_materials and is_rough:
                mtype[i] = MATERIAL_ROUGH_DIELECTRIC
                rough[i] = roughness
            else:
                mtype[i] = MATERIAL_DIFFUSE
        log.info("material %r -> %s", rec.name, MATERIAL_NAMES[mtype[i]])

    return MaterialTable(diffuse=diffuse, emissive=emissive, ior=ior,
                         mtype=mtype, roughness=rough)
