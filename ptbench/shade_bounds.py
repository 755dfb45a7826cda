"""The least time of one shading launch (``csrc/shade.cu``), priced from the
program's record of the launch (``Renderer.frame_records``: its lanes, C
carried planes, form, env picks and misses) and the scene's tables.

A copy of ``chip_smoke.py:shade_bound`` (commit e67867d), which prices a
launch from its tensors: each plane of a lane read and written once (175 +
20 C bytes, the inline form 12 more, hero bins 8 C), the scene's tables
once; with the environment light its four uniform rows (16 bytes a lane),
the alias slot and the sampled texel's row (16 + 4 C) on each lane whose
NEE picks the env and the texel's row (4 + 4 C) on each live lane that
missed.  Operations: 360 + 10 C a lane, 60 C more with dispersion, 60 a
lane for the env's eval and 80 a pick; each takes an FMA's slot (2 flops).
The peaks are ``ptbench/bounds.py``'s.
"""

from __future__ import annotations

from ptbench.bounds import least_seconds

OPS_SHADE_LANE, OPS_SHADE_PLANE = 360, 10
OPS_ENV_EVAL, OPS_ENV_SAMPLE, OPS_DISPERSION_PLANE = 60, 80, 60
FLOPS_PER_OP = 2
TABLES = ("mat_diffuse", "mat_emissive", "mat_ior", "mat_type", "light_cdf", "light_p",
          "light_n", "light_pdf", "light_area", "light_tri", "light_emissive",
          "mat_ior_bins")


def table_bytes(scene) -> int:
    """The bytes of the scene tables one launch reads (``mat_ior_bins``
    where the scene is dispersive)."""
    return sum(t.numel() * t.element_size()
               for t in (getattr(scene, k) for k in TABLES) if t is not None)


def shade_work(launch: dict, tables: int) -> tuple[int, int]:
    """(bytes, operations) of one launch."""
    n, c = launch["lanes"], launch["planes"]
    lane = 175 + 20 * c + (12 if launch["inline"] else 0) + (8 * c if launch["hero"] else 0)
    nbytes = n * lane + tables
    ops = n * (OPS_SHADE_LANE + OPS_SHADE_PLANE * c)
    if launch["dispersion"]:
        ops += n * OPS_DISPERSION_PLANE * c
    if launch["env"]:
        picks, misses = launch["env_picks"], launch["env_misses"]
        nbytes += n * 16 + picks * (16 + 4 * c) + misses * (4 + 4 * c)
        ops += n * OPS_ENV_EVAL + picks * OPS_ENV_SAMPLE
    return nbytes, ops


def least_shade_seconds(launch: dict, tables: int) -> float:
    nbytes, ops = shade_work(launch, tables)
    return least_seconds(nbytes, ops * FLOPS_PER_OP)
