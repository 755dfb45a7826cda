"""Runtime render configuration (PyTorch port).

A copy of ``tpu_pathtracer/config.py`` so that configs round-trip between
the two packages: same field names, same defaults, same validation.  The
reference renderer configures everything at compile time via a macro block
(reference: renderer/Raytracing.h:11-33); here every knob is a runtime field
of a frozen dataclass.

Fields that only steer the TPU kernels (tile widths, XLA lowering
switches) are kept as inert fields and say so in their comment.
Configurations this port does not cover yet raise ``NotImplementedError``
in :func:`check_supported`, naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import enum


class ComparisonMode(enum.IntEnum):
    """Golden-image comparison modes (reference: renderer/Raytracing.h:27-33)."""

    DISABLED = 0
    ABSOLUTE_VALUE = 1   # abs(color - ref)
    REF_TO_COLOR = 2     # max(0, ref - color): visible if output darker than reference
    COLOR_TO_REF = 3     # max(0, color - ref): visible if reference darker than output
    LUMINANCE = 4        # red = output brighter, green = reference brighter


class NoiseMode(enum.IntEnum):
    """Random-number supply for the integrator.

    PRNG: counter-based hashing keyed on (pixel, frame, bounce, purpose,
    seed) -- independent samples, bit-reproducible across devices.
    TILED: parity mode reproducing the reference's 64x64 float4 noise buffer
    (reference: renderer/Renderer.mm:102-129, renderer/Shaders.metal:91,
    135-138).
    """

    PRNG = 0
    TILED = 1


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- feature flags (defaults = reference macro block, Raytracing.h:11-33) ---
    enable_tone_mapping: bool = False      # ENABLE_TONE_MAPPING
    manual_srgb: bool = False              # MANUAL_SRGB (display path only)
    accumulate_image: bool = True          # ACCUMULATE_IMAGE
    distance_epsilon: float = 1e-4         # DISTANCE_EPSILON
    angle_epsilon: float = 0.00003807693583  # ANGLE_EPSILON
    noise_dimensions: int = 64             # NOISE_DIMENSIONS (TILED noise only)
    animate_noise: bool = True             # ANIMATE_NOISE (TILED noise only)
    max_frames: int = 0                    # MAX_FRAMES (0 = unlimited)
    max_path_length: int = 8               # MAX_PATH_LENGTH
    # CONTENT_SCALE: display -> render ratio (Raytracing.h:25); render sizes
    # are explicit here.
    content_scale: float = 1.0
    comparison_mode: ComparisonMode = ComparisonMode.DISABLED
    comparison_scale: float = 10.0         # COMPARISON_SCALE
    spectrum_samples: int = 3              # SPECTRUM_SAMPLES (Spectrum.h:3)
    # Hero-wavelength spectral sampling (spectrum_samples > 3 only); 0
    # disables.  Not ported yet.
    hero_wavelengths: int = 0

    # --- framework extensions (no reference equivalent) ---
    noise_mode: NoiseMode = NoiseMode.PRNG
    # "prng" = i.i.d. counter hash; "r2" = rank-1 lattice sampler.
    sampler: str = "prng"
    # Replicate the reference's estimator quirks (models/bsdf.py).
    reference_quirks: bool = True
    # Snell-bent smooth-dielectric transmission (extension; not ported yet).
    refract_dielectric: bool = False
    # Samples per pixel per frame (the reference always renders 1 spp/frame).
    samples_per_frame: int = 1
    # Max samples fused into one wavefront when samples_per_frame > 1.
    fuse_samples: int = 2
    # Sequential row tiles per frame.
    row_tiles: int = 1
    # Intersection backend: "bvh" (BVH traversal) or "brute" (every ray
    # against every triangle, no BVH).
    intersector: str = "bvh"
    # Use the traversal kernels; False selects the portable torch walker
    # (ops/traverse.py:intersect_bvh), the reference's pure-JAX backend.
    use_pallas: bool = True
    # Ray-tile width of the TPU camera-ray kernel.  Inert for the kernels
    # here (one thread per ray); it still sets the pixel block order
    # (render/order.py), which does not change the image.
    traversal_tile: int = 1536
    # Nearest-hit kernel: "window" (csrc/window_walk.cu), "minwalk" (MT rows
    # with the payload resolved in-kernel, csrc/minwalk.cu) or "sweep" (the
    # dense march for incoherent bounces, csrc/sweep.cu; camera rays keep
    # the window walk).
    traversal_kernel: str = "window"
    # TPU-only (inert): window chain depth of the TPU window kernel.
    traversal_chain: int = 4
    # TPU-only (inert): triangle rows per leaf-march step, camera rays.
    traversal_mtblock: int = 56
    # TPU-only (inert): secondary-bounce tile, window, row block and chain
    # of the TPU window kernel.  secondary_tile still bounds the live-prefix
    # ladder's smallest rung (render/wavefront.py), as in the reference.
    secondary_tile: int = 768
    secondary_window: int = 8
    secondary_mtblock: int = 16
    secondary_chain: int = 6
    # TPU-only (inert): dense-sweep kernel tile and row block (the sweep
    # here is one thread per ray over every row).
    sweep_tile: int = 6144
    sweep_mtblock: int = 56
    # TPU-only (inert): ray-tile width of the TPU occlusion kernel.
    occlusion_tile: int = 6144
    # Any-hit occlusion kernel (csrc/anyhit_walk.cu): "auto" = on iff the
    # scene carries an environment light; "on" = always; "off" = the
    # nearest-hit-must-be-target shadow test through the capped walk.
    occlusion_anyhit: str = "auto"
    # Leaf triangle test of the window walk and the sweep: "bw"
    # (Baldwin-Weber planes, tris8bw) or "mt" (Moller-Trumbore rows, tris8).
    tritest: str = "bw"
    # One fused path+shadow walk per bounce: the bounce's nearest hit and
    # the previous bounce's shadow query share one 2N-lane launch.
    fuse_shadow_walk: bool = False
    # BVH leaf sizes: nearest-hit layout and the shadow-query layout (None =
    # share the nearest-hit layout).  Both were tuned for TPU tiles; a
    # per-thread walk may want other sizes (ROADMAP.md, perf queue).  Must
    # stay <= 63 (the leaf count packs in 6 bits).
    leaf_size: int = 56
    occlusion_leaf_size: int | None = 8
    # Big-triangle pre-pass size: test the K largest triangles before the
    # walk to prime best_t (K=0 disables; must be a multiple of 8).
    traversal_prepass: int = 32
    # Material-baked resolve rows (not ported yet).
    bake_materials: bool = False
    # TPU-only (inert): XLA lowering of the payload-resolve row gather.
    resolve_gather: str = "rows"
    # Skip NEE shadow rays whose contribution is exactly zero.
    cull_zero_nee: bool = False
    # Sort the wavefront before each secondary bounce by (alive, origin
    # cell, direction bin); kernel path only, as in the reference.
    sort_rays: bool = True
    # Live-prefix ladder: after each bounce sort (dead lanes last), run the
    # bounce on the shortest power-of-two prefix that still holds every live
    # lane.  Value = number of halvings; 0 disables.  Bit-identical output.
    live_ladder: int = 3
    # Prefix-width bounce sorts: each sort at the ladder rung's width.
    prefix_sort: bool = False
    # Bounce indices whose wavefront sort is skipped.
    sort_bounce_skip: str = ""
    # TPU-only (inert): XLA sort lowering ("variadic" / "gather"); the port
    # always sorts one int64 key and gathers the planes.
    sort_lowering: str = "variadic"
    # Table budget of the route choice (render/wavefront.py:hbm_route): the
    # TPU's per-kernel VMEM budget, kept so that a scene takes the
    # reference's route; past it "auto" takes the HBM route.
    vmem_table_budget_mb: float = 12.0
    # The HBM route: "on" always, "auto" past the table budget, "off" never.
    # The route sends every query through the window walk on the leaf-56
    # layout (capped shadow queries too) and drops the any-hit walk, as the
    # reference's HBM-streaming window kernel; on the card every table lives
    # in device memory either way.
    hbm_tables: str = "auto"
    # Guard against 0/0 -> NaN when a sampled pdf underflows to exactly zero.
    pdf_floor: float = 1e-20
    # Progressive frames queued before the host blocks: the analog of the
    # reference's triple buffering (reference: renderer/Renderer.mm:16).
    frames_in_flight: int = 3

    def __post_init__(self):
        # Enum-like string knobs fail loudly on typos.
        checks = {
            "occlusion_anyhit": ("on", "off", "auto"),
            "tritest": ("bw", "mt"),
            "traversal_kernel": ("window", "minwalk", "sweep"),
            "sampler": ("prng", "r2"),
            "intersector": ("bvh", "brute"),
            "resolve_gather": ("rows", "cols", "percol"),
            "sort_lowering": ("variadic", "gather"),
            "hbm_tables": ("auto", "on", "off"),
        }
        for field, allowed in checks.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"{field}={v!r}: expected one of {allowed}")
        if self.sort_bounce_skip:
            try:
                skip = [int(x) for x in self.sort_bounce_skip.split(",")]
            except ValueError:
                raise ValueError(
                    f"sort_bounce_skip={self.sort_bounce_skip!r}: expected "
                    "comma-separated bounce indices, e.g. '1,6,7'") from None
            bad = [b for b in skip if not 1 <= b < self.max_path_length]
            if bad:
                raise ValueError(
                    f"sort_bounce_skip entries {bad} outside the bounce loop "
                    f"range [1, {self.max_path_length})")
            if self.prefix_sort:
                raise ValueError(
                    "sort_bounce_skip is incompatible with prefix_sort (the "
                    "prefix loop's rung IS its sort width)")
            if not self.sort_rays:
                raise ValueError(
                    "sort_bounce_skip requires sort_rays=True (there is no "
                    "per-bounce sort to skip otherwise)")
        if self.fuse_shadow_walk and (
            self.intersector != "bvh" or not self.use_pallas
            or not self.sort_rays
        ):
            raise ValueError(
                "fuse_shadow_walk requires the BVH kernel intersector with "
                "sorted wavefronts (intersector='bvh', use_pallas=True, "
                "sort_rays=True)")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Each configuration the port does not cover yet, as (predicate, what,
# ROADMAP.md item that ports it).
_UNSUPPORTED = (
    (lambda c: c.spectrum_samples != 3, "spectrum_samples != 3 (dispersion)",
     "queue 1 item 10"),
    (lambda c: c.hero_wavelengths > 0, "hero wavelengths", "queue 1 item 10"),
    (lambda c: c.refract_dielectric, "refract_dielectric", "queue 1 item 10"),
    (lambda c: c.bake_materials, "bake_materials", "queue 1 item 10"),
)


def check_supported(cfg: RenderConfig) -> None:
    """Raise ``NotImplementedError`` for any configuration the port does not
    compute yet, naming the ROADMAP.md item that ports it.  Never computes a
    different configuration silently."""
    for pred, what, item in _UNSUPPORTED:
        if pred(cfg):
            raise NotImplementedError(
                f"{what} is not ported to tpu_pathtracer_torch yet "
                f"(ROADMAP.md {item})")


PI = 3.1415926  # reference: renderer/Raytracing.h:18 (note: float, not math.pi)
IOR_AIR = 1.00029  # initial ray IoR (reference: renderer/Shaders.metal:99)
