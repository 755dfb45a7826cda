"""Command-line progressive renderer on PyTorch + CUDA.

The port of ``tpu_pathtracer/cli.py``: the same flags with the same names
and defaults.  Flags whose feature is not ported yet raise
``NotImplementedError`` naming their ROADMAP.md item; the TPU-only
``--compile-cache`` and ``--sort-lowering`` are accepted and change nothing.
``--spectrum N`` without ``--hero`` runs on every platform: the reference's
exit for it guards the TPU sort's compile time, which the card does not
have.

Examples:
    python -m tpu_pathtracer_torch.cli --scene cornellbox --frames 64 -o out.exr
    python -m tpu_pathtracer_torch.cli --scene CornellBox-Water-plastic \
        --width 1920 --height 1080 --frames 16 --env sky.exr --png out.png

``--platform`` picks the device: ``auto`` and ``gpu`` need a CUDA card and
raise without one; only ``--platform cpu`` runs the kernels' plain torch
versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from .config import ComparisonMode, NoiseMode, RenderConfig
from .device import device_for
from .scene.assets import DEFAULT_SCENE, SCENE_NAMES, golden_path


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", default=DEFAULT_SCENE, choices=SCENE_NAMES)
    p.add_argument("--width", type=int, default=960,
                   help="display (drawable) width")
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--content-scale", type=float, default=1.0,
                   help="render at width*s x height*s like the reference's "
                        "CONTENT_SCALE drawable scaling (Raytracing.h:25)")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--spp-per-frame", type=int, default=1)
    p.add_argument("--spectrum", type=int, default=3,
                   help="spectrum bins S (3 = the reference's RGB stand-in)")
    p.add_argument("--hero", type=int, default=0,
                   help="hero-wavelength bins per path (0 = trace all S)")
    p.add_argument("--fuse-samples", type=int, default=None,
                   help="max samples fused into one wavefront (default: "
                        "cfg.fuse_samples)")
    p.add_argument("--depth", type=int, default=8, help="MAX_PATH_LENGTH")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--intersector", choices=("bvh", "brute"), default="bvh")
    p.add_argument("--no-pallas", action="store_true",
                   help="the portable torch walker instead of the CUDA kernels")
    p.add_argument("--leaf-size", type=int, default=None,
                   help="override cfg.leaf_size (nearest-hit BVH leaf)")
    p.add_argument("--builder", choices=("auto", "sah", "lbvh"), default="auto",
                   help="BVH builder: native C++ SAH or the torch LBVH")
    p.add_argument("--no-accumulate", action="store_true")
    p.add_argument("--tone-map", action="store_true")
    p.add_argument("--noise", choices=("prng", "tiled", "r2"), default="prng",
                   help="prng = i.i.d. counter hash, tiled = the reference's "
                        "64x64 noise tiles, r2 = the rank-1 lattice sampler")
    p.add_argument("--no-quirks", action="store_true",
                   help="use conventional MIS instead of reference-exact estimator")
    p.add_argument("--env", help="HDR lat-long environment map (EXR) to light "
                                 "the scene with (NEE/MIS importance-sampled)")
    p.add_argument("--env-strength", type=float, default=1.0)
    p.add_argument("--aperture", type=float, default=0.0,
                   help="thin-lens radius in world units (0 = the "
                        "reference's pinhole); use with --focus")
    p.add_argument("--focus", type=float, default=3.35,
                   help="focal-plane distance along the view axis "
                        "(cornellbox back wall ~ 3.35)")
    p.add_argument("--refract", action="store_true",
                   help="Snell-bent smooth-dielectric transmission instead "
                        "of the reference's straight-through quirk")
    p.add_argument("--rough-materials", action="store_true",
                   help="classify MTL roughness in (0,1) to the GGX "
                        "extension materials (the reference's TODO stubs "
                        "fall back to diffuse)")
    p.add_argument("--dispersion", type=float, default=None, metavar="B_UM2",
                   help="Cauchy B (um^2) for dispersive fresnel on plastic/"
                        "dielectric materials (use with --spectrum > 3; "
                        "~0.0042 for BK7 glass)")
    p.add_argument("--env-rotation", type=float, default=0.0,
                   help="azimuth rotation of the env map in radians")
    p.add_argument("-o", "--exr", help="write accumulated radiance EXR")
    p.add_argument("--png", help="write tonemapped/sRGB PNG")
    p.add_argument("--checkpoint",
                   help="write render-state checkpoint (a .npz path; the "
                        "Orbax directory form is not ported yet)")
    p.add_argument("--resume", help="resume from a .npz checkpoint (written "
                                    "by either package)")
    p.add_argument("--compare-mode", type=int, default=0, choices=range(5),
                   help="0=off 1=abs 2=ref-color 3=color-ref 4=luminance")
    p.add_argument("--compare-scale", type=float, default=10.0)
    p.add_argument("--compare-out", help="write the comparison image (PNG)")
    p.add_argument("--hud-every", type=int, default=8)
    p.add_argument("--preview-every", type=int, default=0,
                   help="write a progressive PNG preview every N frames")
    p.add_argument("--preview-path", default="preview.png")
    p.add_argument("--profile-dir", help="capture a torch.profiler trace here")
    p.add_argument("--compile-cache",
                   default=os.path.join(tempfile.gettempdir(),
                                        "tpu_pathtracer_jax_cache"),
                   help="accepted for compatibility and inert: the XLA "
                        "compilation cache of the TPU package")
    p.add_argument("--serve", type=int, metavar="PORT",
                   help="serve a live progressive viewer on this port while "
                        "rendering (0 = any port)")
    p.add_argument("--serve-host", default="127.0.0.1",
                   help="viewer bind address (endpoints are unauthenticated; "
                        "use 0.0.0.0 to expose beyond loopback deliberately)")
    p.add_argument("--row-tiles", type=int, default=1,
                   help="render each frame in N sequential row tiles")
    p.add_argument("--prefix-sort", action="store_true",
                   help="run each bounce's wavefront sort at the live-prefix "
                        "ladder's rung width instead of full width")
    p.add_argument("--cull-zero-nee", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="skip occlusion walks for NEE shadow rays whose "
                        "contribution is exactly zero; the same image")
    p.add_argument("--sort-skip", default="", metavar="B1,B2",
                   help="bounce indices whose wavefront sort is skipped "
                        "(e.g. '1,6,7'); the same image")
    p.add_argument("--sort-lowering", choices=("variadic", "gather"),
                   default="variadic",
                   help="accepted for compatibility and inert: the TPU "
                        "package's XLA sort lowering")
    p.add_argument("--mesh", metavar="TILESxSPP",
                   help="multi-device render (not ported yet)")
    p.add_argument("--platform", choices=("auto", "gpu", "cpu"), default="auto",
                   help="'auto' and 'gpu' need a CUDA device and raise "
                        "without one; 'cpu' runs the kernels' plain torch "
                        "versions")
    return p


# Each flag whose feature is not ported yet: (set?, flag, ROADMAP.md item).
def _unported(args) -> list[tuple[bool, str, str]]:
    return [
        (args.mesh is not None, "--mesh", "queue 1: multi-device"),
        *((bool(path) and not path.endswith(".npz"),
           f"{flag} {path} (the Orbax directory form)",
           "queue 1: the directory checkpoint form")
          for flag, path in (("--checkpoint", args.checkpoint),
                             ("--resume", args.resume))),
    ]


def main(argv=None) -> int:
    p = build_arg_parser()
    args = p.parse_args(argv)
    for on, flag, item in _unported(args):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to tpu_pathtracer_torch yet "
                f"(ROADMAP.md {item})")
    device = device_for(args.platform)

    from .renderer import Renderer
    from .scene import attach_dispersion, attach_env, load_scene, scene_path

    # reference: dispatch size = drawable size * CONTENT_SCALE
    # (renderer/Renderer.mm:642-643)
    args.width = max(1, round(args.width * args.content_scale))
    args.height = max(1, round(args.height * args.content_scale))
    cfg = RenderConfig(
        content_scale=args.content_scale,
        max_path_length=args.depth,
        samples_per_frame=args.spp_per_frame,
        **({"fuse_samples": args.fuse_samples}
           if args.fuse_samples is not None else {}),
        accumulate_image=not args.no_accumulate,
        enable_tone_mapping=args.tone_map,
        noise_mode=NoiseMode.TILED if args.noise == "tiled" else NoiseMode.PRNG,
        sampler="r2" if args.noise == "r2" else "prng",
        reference_quirks=not args.no_quirks,
        refract_dielectric=args.refract,
        intersector=args.intersector,
        use_pallas=not args.no_pallas,
        comparison_mode=ComparisonMode(args.compare_mode),
        comparison_scale=args.compare_scale,
        row_tiles=args.row_tiles,
        prefix_sort=args.prefix_sort,
        cull_zero_nee=args.cull_zero_nee,
        sort_lowering=args.sort_lowering,
        sort_bounce_skip=args.sort_skip,
        spectrum_samples=args.spectrum,
        hero_wavelengths=args.hero,
    )
    scene = load_scene(scene_path(args.scene), samples=cfg.spectrum_samples,
                       rough_materials=args.rough_materials, device=device)
    if args.env:
        scene = attach_env(scene, args.env, strength=args.env_strength,
                           rotation=args.env_rotation)
    if args.dispersion is not None:
        scene = attach_dispersion(scene, args.dispersion)
    camera = None
    if args.aperture > 0.0:
        from .models.camera import Camera

        camera = Camera(t=0.0, aperture=args.aperture, focus=args.focus)
    r = Renderer(scene=scene, width=args.width, height=args.height, cfg=cfg,
                 seed=args.seed, leaf_size=args.leaf_size, builder=args.builder,
                 camera=camera, device=device)
    if args.resume:
        r.load_checkpoint(args.resume)
        got = tuple(r.state.accum.shape)
        want = (args.height, args.width, cfg.spectrum_samples)
        if got != want:
            print(f"error: checkpoint {args.resume} has accumulator shape "
                  f"{got}, but this run requests {want} "
                  "(--width/--height/spectrum mismatch)", file=sys.stderr)
            return 2
        print(f"resumed at frame {r.frame_index}")

    if args.profile_dir:
        r.profile(args.profile_dir, frames=min(args.frames, 3))
        print("profile trace in", args.profile_dir)

    if args.serve is not None:
        from .viewer import ViewerServer

        if args.preview_every:
            print("note: --preview-every is ignored with --serve "
                  "(poll /frame.png instead)", file=sys.stderr)
        # load the golden so /compare.png can serve the live diff, but never
        # let a missing golden block plain viewing
        golden = None
        try:
            from .io.exr import read_exr
            from .utils.compare import downsample

            gold, _ = read_exr(golden_path(args.scene, args.depth))
            golden = downsample(gold, r.state.height, r.state.width)
        except Exception as e:  # noqa: BLE001 -- the golden is optional here
            print(f"note: no golden for live compare ({e})", file=sys.stderr)
        server = ViewerServer(r, scene_name=args.scene, host=args.serve_host,
                              port=args.serve, golden=golden)
        print(f"live viewer on http://{args.serve_host}:{server.port}/", flush=True)
        server.serve_while_rendering(args.frames)
    else:
        for i in range(args.frames):
            r.step()
            if args.hud_every and (i + 1) % args.hud_every == 0:
                print(r.hud(), flush=True)
            if args.preview_every and (i + 1) % args.preview_every == 0:
                r.save_png(args.preview_path)
    r.sync()  # fold any partial in-flight window into the HUD EMA
    print(r.hud())

    if args.exr:
        r.save_exr(args.exr)
        print("wrote", args.exr)
    if args.png:
        r.save_png(args.png)
        print("wrote", args.png)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
        print("wrote", args.checkpoint)

    if args.compare_mode and args.compare_out:
        from .io.exr import read_exr
        from .io.png import write_png
        from .utils.compare import blit_display, downsample, metrics

        gold, _ = read_exr(golden_path(args.scene, args.depth))
        gold = downsample(gold, r.state.height, r.state.width)
        img = r.image(rgb=True)
        diff = blit_display(img, gold, ComparisonMode(args.compare_mode),
                            args.compare_scale, tonemap=r.cfg.enable_tone_mapping,
                            manual_srgb=r.cfg.manual_srgb)
        write_png(args.compare_out, diff)
        print("wrote", args.compare_out, metrics(img, gold))
    return 0


if __name__ == "__main__":
    sys.exit(main())
