"""The comparison that decides a run's ``correct``.

After the window the harness takes the accumulated image the timed frames
produced, at pixels drawn from the seed, and the plain reference
(ptbench/reference.py) traces those pixels through every frame the run
accumulated, on the same inputs.  Three numbers are compared, each with the
limit of its cell (``limits/<cell>.json``, with the readings it was set
from):

* ``rel_l1``: the summed absolute difference over the summed reference,
  over every sampled pixel and spectral bin;
* ``bad_px_share``: the share of sampled pixels whose largest difference
  exceeds ``TAU`` of their largest reference value (a floor of a hundredth
  of the mean keeps dark pixels from counting rounding);
* ``nonfinite_share``: the share of sampled pixels with a value that is not
  finite, limit 0.  The two numbers above read such a value as 0, so they
  stay numbers (the bfloat16 control makes NaNs: a Fresnel denominator
  cancels to zero).

Paths are replayed, not estimated, so the program and the reference agree
to rounding except where a ray's fate turns on rounding (an edge between
two triangles, a lobe threshold): those few paths differ whole.  The
control (the reference in bfloat16 in the program's place) makes every
path differ.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference, scenes

TAU = 0.01

# RenderConfig fields whose values change no path of the image: the
# reference models a cell only when its traffic sets nothing else
PATH_NEUTRAL = {
    "samples_per_frame", "fuse_samples", "spectrum_samples", "hero_wavelengths",
    "max_path_length", "sort_rays", "live_ladder", "prefix_sort", "sort_bounce_skip",
    "frames_in_flight", "occlusion_anyhit", "hbm_tables", "tritest", "traversal_kernel",
    "fuse_shadow_walk", "leaf_size", "occlusion_leaf_size", "traversal_prepass",
    "row_tiles", "vmem_table_budget_mb", "cull_zero_nee",
}


def spec_of(config: dict, traffic: dict, height: int, width: int) -> dict:
    render = traffic.get("render", {})
    unknown = set(render) - PATH_NEUTRAL
    if unknown:
        raise ValueError(f"the reference does not model {sorted(unknown)}")
    s = render.get("spectrum_samples", 3)
    return {"height": height, "width": width, "depth": config["max_path_length"],
            "spp": render.get("samples_per_frame", 1), "s": s,
            "hero": render.get("hero_wavelengths", 0) if s > 3 else 0}


def sample_pixels(seed: int, npix: int, count: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 0x50C4])
    return np.sort(rng.choice(npix, size=min(count, npix), replace=False))


def reference_image(config: dict, traffic: dict, spec: dict, env_image, pixels,
                    frames: int, seed: int, device, dtype=torch.float32) -> np.ndarray:
    """The reference's running means of ``pixels`` after ``frames`` frames
    -> (P, S) float64."""
    mesh = reference.parse_obj(scenes.obj_path(config["scene"]["obj"]))
    sc = reference.Scene(mesh, spec["s"], device, dtype=dtype,
                         dispersion=traffic.get("dispersion"), env_image=env_image)
    return reference.render_pixels(sc, spec, pixels, frames, seed)


def numbers(got: np.ndarray, want: np.ndarray) -> dict:
    """The compared numbers of (P, S) pixel values against the reference's."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    finite = np.isfinite(got)
    diff = np.abs(np.where(finite, got, 0.0) - want)
    level = np.abs(want).max(axis=1)
    floor = 0.01 * level.mean() if level.size else 0.0
    rel = diff.max(axis=1) / np.maximum(level, max(floor, 1e-30))
    total = np.abs(want).sum()
    return {"rel_l1": float(diff.sum() / total) if total > 0 else float("inf"),
            "bad_px_share": float(np.mean(~(rel <= TAU))),
            "nonfinite_share": float(np.mean(~finite.all(axis=1)))}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or under its limit (a NaN is not)."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in values}
    return all(v["value"] <= v["limit"] for v in checks.values()), checks
