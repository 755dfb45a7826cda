"""The least time of one shading launch on a scene with materials (the GGX
types and map_Kd textures, ``csrc/shade.cu``'s ``kMaterials`` instances),
priced from the program's record of the launch: its lanes, C carried
planes, form, env picks and misses, and its ``ggx_lanes`` (live lanes that
hit a GGX type) and ``tex_lanes`` (live lanes that hit a textured
material).

``shade_work`` is a copy of ``ptbench/shade_bounds.py:shade_work``, so that
a later change there cannot move this yardstick; ``material_work`` adds, a
launch:

* on each GGX lane the plain version's GGX evaluation toward the NEE sample
  and its VNDF sample (``tpu_pathtracer_torch/models/ggx.py``: eval_lobe,
  sample_lobe, each lambda, D, G1 and G2 counted once a lane, as the kernel
  shares them), ``OPS_GGX_EVAL`` + ``OPS_GGX_SAMPLE`` float32 operations;
* on each textured lane the texcoord interpolation, the wrap and the
  bilinear filter of three channels (``models/texture.py``:
  sample_bilinear), ``OPS_TEXEL``;
* and the bytes each textured lane must move: its triangle's texcoord row
  (24), the hit's u and v (8) and the material's texture index (8).

Each operation takes an FMA's slot (2 flops).  No texel tap is priced at
HBM bandwidth: neighbouring lanes share taps through L2, so a bound priced
by the tap could be beaten by a correct kernel.  The peaks are
``ptbench/bounds.py``'s.
"""

from __future__ import annotations

from ptbench.bounds import least_seconds

OPS_SHADE_LANE, OPS_SHADE_PLANE = 360, 10
OPS_ENV_EVAL, OPS_ENV_SAMPLE, OPS_DISPERSION_PLANE = 60, 80, 60
FLOPS_PER_OP = 2
TABLES = ("mat_diffuse", "mat_emissive", "mat_ior", "mat_type", "light_cdf", "light_p",
          "light_n", "light_pdf", "light_area", "light_tri", "light_emissive",
          "mat_ior_bins")

# models/ggx.py, each add, multiply, division, square root, comparison,
# select, clamp bound, sine and cosine one operation: eval_lobe (two dots
# of v and l with n, h, its length and m, two more dots, D, the three
# tests, 1 / (4 cos_v), the two lambdas, G1, G2 and the two products) and
# sample_lobe (the ONB, v in it, the stretch, the frame around vh, the
# warped disk sample, the unstretch, m in world space, the reflection, the
# tests, the two lambdas, G1, G2, D and the pdf)
OPS_GGX_EVAL = 82
OPS_GGX_SAMPLE = 193
# models/texture.py: the texcoords at (u, v) (12), the wrap to [0, 1) and
# the texel grid (12), the four taps' indices, and the bilinear filter of
# three channels (2 + 3 x 9)
OPS_TEXEL = 56
TEXEL_LANE_BYTES = 24 + 8 + 8


def table_bytes(scene) -> int:
    """The bytes of the scene tables one launch reads (``mat_ior_bins``
    where the scene is dispersive)."""
    return sum(t.numel() * t.element_size()
               for t in (getattr(scene, k) for k in TABLES) if t is not None)


def shade_work(launch: dict, tables: int) -> tuple[int, int]:
    """(bytes, operations) of one launch without its materials' work."""
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


def has_materials(launch: dict) -> bool:
    """Whether the launch's record says its scene has a roughness table or
    textures, with its counts read (False on a record that has neither
    key: a program without the materials' counters)."""
    return bool(launch.get("rough") or launch.get("textured")) and \
        launch.get("ggx_lanes") is not None and launch.get("tex_lanes") is not None


def material_work(launch: dict, tables: int) -> tuple[int, int]:
    """(bytes, operations) of one launch with its materials' work."""
    nbytes, ops = shade_work(launch, tables)
    if has_materials(launch):
        ggx, tex = launch["ggx_lanes"], launch["tex_lanes"]
        nbytes += tex * TEXEL_LANE_BYTES
        ops += ggx * (OPS_GGX_EVAL + OPS_GGX_SAMPLE) + tex * OPS_TEXEL
    return nbytes, ops


def least_material_seconds(launch: dict, tables: int) -> float:
    nbytes, ops = material_work(launch, tables)
    return least_seconds(nbytes, ops * FLOPS_PER_OP)
