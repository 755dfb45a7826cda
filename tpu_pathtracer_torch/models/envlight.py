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
    # the same tables as the shading kernel reads them, derived once a map by
    # env_to (:func:`env_records`): one record a texel, (K, T) float32, and
    # one an alias slot, (K, ALIAS_WORDS) int32
    texel_rec: torch.Tensor | None = None
    alias_rec: torch.Tensor | None = None


# the reference's fields of EnvLight, which env_to takes; the rest it derives
TABLES = ("radiance", "pdf_sa", "alias_p", "alias_i", "select_p", "rotation")
# an alias slot's record: alias_p's bits, alias_i, the pdf of the slot's
# texel and of its alias
ALIAS_WORDS = 4


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
    ``EnvLight._asdict()``; keys past :data:`TABLES` are ignored) -> an
    :class:`EnvLight` on ``device``, every field contiguous, with its
    ``radiance_max`` (:func:`radiance_max`) and its records
    (:func:`env_records`) derived from the tables."""
    def put(a, dtype=None):
        a = np.asarray(a)
        a = np.ascontiguousarray(a) if a.ndim else a
        if dtype is None:
            dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
        return torch.tensor(a, dtype=dtype, device=device)

    texel, alias = env_records(*(arrays[name] for name in TABLES[:4]))
    return EnvLight(**{name: put(arrays[name]) for name in TABLES},
                    radiance_max=radiance_max(arrays["radiance"]), texel_rec=put(texel),
                    alias_rec=put(alias, torch.int32))


def texel_layout(s: int) -> tuple[int, int]:
    """A texel's record at S radiance bins -> (its stride in floats: S
    rounded up to a multiple of 4, so that a record starts on 16 bytes; the
    column of its solid-angle pdf, S where the record has room, else -1)."""
    t = 4 * -(-s // 4)
    return t, (s if t > s else -1)


def env_records(radiance, pdf_sa, alias_p, alias_i):
    """The records the shading kernel reads (csrc/shade.cu), from the
    reference's tables (numpy) -> (texel (K, T) float32, alias (K,
    :data:`ALIAS_WORDS`) int32), K = Eh * Ew.  A texel's record holds its S
    radiance bins side by side and its pdf where :func:`texel_layout` has
    room (16 bytes at S = 3; at S = 16 64 bytes, the pdf not in it).  An
    alias slot's record holds alias_p's bits, alias_i, and the pdf of the
    slot's texel and of its alias (the pdf the NEE pick needs, either way).
    Every value is the table's, bit for bit."""
    rad = np.asarray(radiance, np.float32)
    s = rad.shape[0]
    pdf = np.asarray(pdf_sa, np.float32).reshape(-1)
    prob = np.asarray(alias_p, np.float32).reshape(-1)
    alias = np.asarray(alias_i).reshape(-1)
    k = pdf.size
    if alias.size and (alias.min() < 0 or alias.max() >= k):
        raise ValueError(f"env_records: alias_i outside [0, {k})")
    t, pdf_col = texel_layout(s)
    texel = np.zeros((k, t), np.float32)
    texel[:, :s] = rad.reshape(s, k).T
    if pdf_col >= 0:
        texel[:, pdf_col] = pdf
    rec = np.stack([prob.view(np.int32), alias.astype(np.int32), pdf.view(np.int32),
                    pdf[alias].view(np.int32)], axis=1)
    return texel, rec


def record_layout(env: EnvLight, s: int) -> tuple[int, int]:
    """The layout of ``env``'s records as a frame of S spectral bins reads
    them -> :func:`texel_layout` (S); ValueError unless the map is S bins
    wide and its records are those :func:`env_records` derives at S (the
    kernel reads them unchecked)."""
    k = env.pdf_sa.numel()
    t, pdf_col = texel_layout(s)
    if env.texel_rec is None or env.alias_rec is None:
        raise ValueError("the env light has no records (make it with "
                         "models/envlight.py:env_to)")
    if (env.radiance.shape[0] != s or tuple(env.texel_rec.shape) != (k, t)
            or tuple(env.alias_rec.shape) != (k, ALIAS_WORDS)):
        raise ValueError(
            f"an env light of {env.radiance.shape[0]} bins with records "
            f"{tuple(env.texel_rec.shape)} and {tuple(env.alias_rec.shape)} in a frame of "
            f"{s} bins: expected {s} bins, ({k}, {t}) and ({k}, {ALIAS_WORDS})")
    return t, pdf_col


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
