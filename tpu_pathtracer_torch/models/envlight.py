"""HDR environment light: lat-long map with alias-table importance sampling.

The port of ``tpu_pathtracer/models/envlight.py`` (a framework extension:
the Metal reference has no environment light).  The alias table is built on
the host with the reference's numpy Vose construction, so the table is
bit-equal to the reference's; sampling is two row gathers.

Direction convention: y-up lat-long.  v in [0,1] -> theta in [0,pi] from +y
(v=0 = zenith), u -> phi = 2*pi*u - pi (+ rotation) around y:
dir = (sin(theta)cos(phi), cos(theta), sin(theta)sin(phi)).  The sampler
jitters inside the chosen texel and the evaluator reads the nearest texel,
so the pdf matches the sampled distribution exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import spectrum as spec

PI = np.pi


class EnvLight(NamedTuple):
    """Device-resident environment light."""

    radiance: torch.Tensor   # (S, Eh, Ew) spectral radiance (strength folded in)
    pdf_sa: torch.Tensor     # (Eh, Ew) solid-angle pdf of sampling each texel
    alias_p: torch.Tensor    # (K,) alias-table acceptance threshold
    alias_i: torch.Tensor    # (K,) int64 alias slot (int32 values)
    select_p: torch.Tensor   # () float32: probability NEE samples the env
    rotation: torch.Tensor   # () float32: radians added to phi
    # the largest radiance entry (a host float) when every entry is finite
    # with its sign bit clear, else None: derived from ``radiance`` once, by
    # env_to (the shading kernel then reads no texel on a lane whose ray did
    # not miss: ops/shade.py).  Replace ``radiance`` only through env_to.
    radiance_max: float | None = None


def _vose_alias(p: np.ndarray):
    """Vose alias table for a discrete pdf (K,), the reference's exact
    pairing schedule (a sequential Python loop, ~1M texels/s)."""
    k = p.size
    scaled = (p.astype(np.float64) * k).tolist()
    prob = np.ones(k, np.float32)
    alias = np.arange(k, dtype=np.int32)
    small = [i for i, v in enumerate(scaled) if v < 1.0]
    large = [i for i, v in enumerate(scaled) if v >= 1.0]
    ns, ng = len(small), len(large)
    while ns and ng:
        ns -= 1
        s = small[ns]
        g = large[ng - 1]
        prob[s] = scaled[s]
        alias[s] = g
        rem = (scaled[g] + scaled[s]) - 1.0
        scaled[g] = rem
        if rem < 1.0:
            ng -= 1
            small[ns] = g
            ns += 1
    # leftovers keep prob=1, alias=self (the init above)
    return prob, alias


def build_env(image: np.ndarray, strength: float = 1.0, rotation: float = 0.0,
              select_p: float | None = None, area_light_power: float = 0.0,
              samples: int = 3, device="cuda") -> EnvLight:
    """(Eh, Ew, 3) HDR image -> :class:`EnvLight` on ``device``.
    ``select_p`` defaults to the env's share of total emitted power (clamped
    to [0.1, 0.9] when area lights exist)."""
    img = np.asarray(image, np.float32) * strength
    eh, ew = img.shape[:2]
    lum = img @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    theta_edges = np.linspace(0.0, PI, eh + 1)
    # exact per-row texel solid angle
    domega_row = (2.0 * PI / ew) * (np.cos(theta_edges[:-1]) - np.cos(theta_edges[1:]))
    weight = np.maximum(lum, 0.0) * domega_row[:, None]
    total = weight.sum()
    env_power = float(total)  # true emitted power (0 for a black map)
    if total <= 0.0:
        # black map: uniform sampling keeps the pdf valid
        weight = np.ones_like(weight) * domega_row[:, None]
        total = weight.sum()
    pdf_texel = (weight / total).astype(np.float32)          # sums to 1
    pdf_sa = pdf_texel / np.maximum(domega_row[:, None], 1e-12)
    prob, alias = _vose_alias(pdf_texel.reshape(-1).astype(np.float64))
    if select_p is None:
        if area_light_power > 0.0:
            select_p = float(np.clip(env_power / (env_power + area_light_power),
                                     0.1, 0.9))
        else:
            select_p = 1.0
    rad = spec.from_rgb(img.reshape(-1, 3), samples).T.reshape(samples, eh, ew)
    return env_to(dict(radiance=rad, pdf_sa=pdf_sa.astype(np.float32), alias_p=prob,
                       alias_i=alias, select_p=np.float32(select_p),
                       rotation=np.float32(rotation)), device)


def env_to(arrays: dict, device) -> EnvLight:
    """numpy field arrays (:func:`build_env`'s, or the reference's
    ``EnvLight._asdict()``) -> an :class:`EnvLight` on ``device``, every
    field contiguous (the shading kernel reads the tables in place), and its
    ``radiance_max`` derived from the radiance (:func:`radiance_max`)."""
    def put(name):
        a = np.asarray(arrays[name])
        a = np.ascontiguousarray(a) if a.ndim else a
        dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
        return torch.tensor(a, dtype=dtype, device=device)

    tables = {name: put(name) for name in EnvLight._fields if name != "radiance_max"}
    return EnvLight(**tables, radiance_max=radiance_max(arrays["radiance"]))


def radiance_max(radiance) -> float | None:
    """The largest entry of a radiance table (numpy, as float32) when every
    entry is finite with its sign bit clear (no NaN, no infinity, no
    negative value, no -0), else None."""
    a = np.asarray(radiance, np.float32)
    if a.size == 0 or not np.isfinite(a).all() or np.signbit(a).any():
        return None
    return float(a.max())


def _texel_dir(env: EnvLight, i, j, ju, jv):
    """Jittered direction inside texel (i, j); ju/jv in [0,1)."""
    eh, ew = env.pdf_sa.shape
    v = (i.to(torch.float32) + jv) / eh
    u = (j.to(torch.float32) + ju) / ew
    theta = PI * v
    phi = 2.0 * PI * u - PI + env.rotation
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)])


def _read(env: EnvLight, idx, bins=None):
    """Texel gathers: flat idx (N,) -> radiance (S, N), or (C, N) under
    hero sampling (``bins``), and pdf_sa (N,)."""
    s = env.radiance.shape[0]
    rad = spec.apply_bins(env.radiance.reshape(s, -1)[:, idx], bins)
    pdf = env.pdf_sa.reshape(-1)[idx]
    return rad, pdf


def sample_env(env: EnvLight, u_alias, u_jit, bins=None):
    """Importance-sample the map: u_alias (N,), u_jit (2, N) uniforms ->
    (dir (3, N), pdf_sa (N,), radiance (S|C, N))."""
    eh, ew = env.pdf_sa.shape
    k = eh * ew
    x = u_alias * k
    slot = torch.clamp(x.to(torch.int32), 0, k - 1).to(torch.int64)
    frac = x - slot.to(torch.float32)
    take_alias = frac >= env.alias_p[slot]
    idx = torch.where(take_alias, env.alias_i[slot], slot)
    d = _texel_dir(env, idx // ew, idx % ew, u_jit[0], u_jit[1])
    rad, pdf = _read(env, idx, bins)
    return d, pdf, rad


def eval_env(env: EnvLight, d, bins=None):
    """Radiance (S|C, N) and sampling pdf (N,) toward directions d (3, N),
    from the nearest texel."""
    return _read(env, texel_index(env, d), bins)


def texel_index(env: EnvLight, d) -> torch.Tensor:
    """Flat nearest-texel index of directions d (3, N), as eval_env reads."""
    eh, ew = env.pdf_sa.shape
    phi = torch.atan2(d[2], d[0]) - env.rotation
    u = (phi + PI) / (2.0 * PI)
    u = u - torch.floor(u)
    v = torch.arccos(torch.clamp(d[1], -1.0, 1.0)) / PI
    j = torch.clamp((u * ew).to(torch.int32), 0, ew - 1).to(torch.int64)
    i = torch.clamp((v * eh).to(torch.int32), 0, eh - 1).to(torch.int64)
    return i * ew + j
