"""The plain reference that decides a run's ``correct``.

A straightforward path tracer over the same inputs as the program, in plain
PyTorch and NumPy: it imports nothing of the program, of JAX or of the JAX
package, and reads nothing the program made.  It parses the OBJ/MTL itself,
classifies the materials by the reference app's channel rules, builds the
light table and its CDF, the environment map's alias table, and a BVH of
its own (Morton-ordered, balanced, leaves of 8, walked with a per-ray
stack), and traces the paths of chosen pixels over every frame of a run.

The renderer's random numbers are a counter hash of (pixel, frame, bounce,
seed) (PCG4D over a threefry key schedule), so one pixel's paths do not
depend on any other pixel's: this reference traces only the sampled pixels,
each through every frame the run accumulated, and returns their running
means.  Paths follow the renderer's estimator as the reference app defines
it (its BSDF quirks, NEE with the power heuristic, the x-pdf emitter weight,
the unified area/env NEE of the env extension, hero wavelengths and
dispersive Fresnel).  The shadow query is resolved inside its bounce, the
nearest hit within the cap must be the sampled light triangle (nothing may
be hit for an env sample); the wavefront sort, the ladder and the deferred
queries of the renderer change no path.

``dtype`` computes every float in another precision (the control of
ptbench/check.py runs it in bfloat16); random integers stay exact.
"""

from __future__ import annotations

import os

import numpy as np
import torch

M32 = 0xFFFFFFFF
PI_R = 3.1415926                 # the reference app's PI (Raytracing.h:18)
IOR_AIR = 1.00029                # initial ray IoR (Shaders.metal:99)
EPS = 1e-4                       # DISTANCE_EPSILON
AEPS = 0.00003807693583          # ANGLE_EPSILON
PDF_FLOOR = 1e-20
LEAF = 8
DIFFUSE, MIRROR, PLASTIC, DIELECTRIC = 0, 1, 2, 3
_CAMERA_SALT, _HERO_SALT = 0x5CA1AB1E, 0x4E20


# ---------------------------------------------------------------------------
# inputs: OBJ/MTL, materials, spectra, lights, environment
# ---------------------------------------------------------------------------

def parse_obj(path: str) -> dict:
    """OBJ + MTL -> {"p": (T, 3, 3) corner positions, "n": (T, 3, 3) corner
    normals, "mat": (T,) material index, "materials": [{"kd", "ka", "ks"}]}.
    Faces are fans; a face's material is the last ``usemtl``."""
    base = os.path.dirname(os.path.abspath(path))
    v, vn, p, n, mat, names, mtl = [], [], [], [], [], {}, {}
    cur = None
    with open(path, errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                v.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                vn.append([float(x) for x in parts[1:4]])
            elif key == "mtllib":
                mtl.update(parse_mtl(os.path.join(base, " ".join(parts[1:]))))
            elif key == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                cur = names.setdefault(name, len(names))
            elif key == "f":
                corners = []
                for tok in parts[1:]:
                    f = tok.split("/")
                    vi, ni = int(f[0]), int(f[2])
                    corners.append((vi - 1 if vi > 0 else len(v) + vi,
                                    ni - 1 if ni > 0 else len(vn) + ni))
                if cur is None:
                    cur = names.setdefault("", len(names))
                for i in range(1, len(corners) - 1):
                    tri = (corners[0], corners[i], corners[i + 1])
                    p.append([v[c[0]] for c in tri])
                    n.append([vn[c[1]] for c in tri])
                    mat.append(cur)
    materials = [mtl.get(name, {"kd": (1.0, 1.0, 1.0), "ka": (0.0, 0.0, 0.0),
                                "ks": (1.0, 0.0, 0.0)})
                 for name in sorted(names, key=names.get)]
    return {"p": np.asarray(p, np.float32), "n": np.asarray(n, np.float32),
            "mat": np.asarray(mat, np.int64), "materials": materials}


def parse_mtl(path: str) -> dict:
    out, cur = {}, None
    with open(path, errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = {"kd": (1.0, 1.0, 1.0), "ka": (0.0, 0.0, 0.0), "ks": (1.0, 0.0, 0.0)}
                out[parts[1] if len(parts) > 1 else ""] = cur
            elif cur is not None and parts[0] in ("Kd", "Ka", "Ks") and len(parts) >= 4:
                cur[parts[0].lower()] = tuple(float(x) for x in parts[1:4])
    return out


def classify(m: dict) -> tuple[int, float]:
    """The reference app's material rules (Renderer.mm:278-329) ->
    (type, ior): Ks = (roughness, metalness, +-ior)."""
    rough, metal, ior = m["ks"]
    if metal > 0.0:
        return (MIRROR if rough == 0.0 else DIFFUSE), ior
    if rough == 1.0:
        return DIFFUSE, ior
    if ior <= 0.0:
        return (PLASTIC if rough == 0.0 else DIFFUSE), abs(ior)
    return (DIELECTRIC if rough == 0.0 else DIFFUSE), ior


def wavelengths(s: int) -> np.ndarray:
    """(S,) float32 bin wavelengths in [400, 700] nm, as float32
    ``linspace`` rounds them (the band edges below depend on it)."""
    f = np.float32
    div = s - 1
    i = np.arange(div, dtype=f)
    c = f(1.0) / f(div)
    head = f(400.0) * (f(1.0) - i * c)
    out = (i.astype(np.float64) * np.float64(f(700.0) * c) + head.astype(np.float64)).astype(f)
    return np.concatenate([out, [f(700.0)]]).astype(f)


def from_rgb(rgb: np.ndarray, s: int) -> np.ndarray:
    """(..., 3) RGB -> (..., S): identity at S = 3, else each bin takes the
    channel of its band (blue < 490 nm <= green < 580 nm <= red)."""
    rgb = np.asarray(rgb, np.float32)
    if s == 3:
        return rgb
    lam = wavelengths(s)
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    return np.where(lam < 490.0, b, np.where(lam < 580.0, g, r)).astype(np.float32)


def to_rgb(spec: np.ndarray) -> np.ndarray:
    spec = np.asarray(spec, np.float32)
    s = spec.shape[-1]
    if s == 3:
        return spec
    lam = wavelengths(s)
    w = np.stack([(lam >= 580.0), (lam >= 490.0) & (lam < 580.0), lam < 490.0]
                 ).astype(np.float32)
    w = w / w.sum(axis=1, keepdims=True)
    return (spec @ w.T).astype(np.float32)


def cauchy_bins(ior_d: float, b_um2: float, s: int) -> np.ndarray:
    """Per-bin IoR n = A + B / lambda_um^2 with n(589.3 nm) = ior_d."""
    lam = (np.asarray([640.0, 535.0, 445.0], np.float32) if s == 3
           else wavelengths(s)) / np.float32(1000.0)
    a = np.float32(ior_d - b_um2 / (0.5893 ** 2))
    return (a + np.float32(b_um2) / (lam * lam)).astype(np.float32)


def alias_table(p: np.ndarray):
    """Vose's alias table (small list popped from its end, large list's
    last entry), leftovers keep (1, self)."""
    k = p.size
    scaled = (p.astype(np.float64) * k).tolist()
    prob = np.ones(k, np.float32)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i, x in enumerate(scaled) if x < 1.0]
    large = [i for i, x in enumerate(scaled) if x >= 1.0]
    ns, ng = len(small), len(large)
    while ns and ng:
        ns -= 1
        s, g = small[ns], large[ng - 1]
        prob[s] = scaled[s]
        alias[s] = g
        rem = (scaled[g] + scaled[s]) - 1.0
        scaled[g] = rem
        if rem < 1.0:
            ng -= 1
            small[ns] = g
            ns += 1
    return prob, alias


class Scene:
    """Tensors of one scene at S spectral bins, floats in ``dtype``."""

    def __init__(self, mesh: dict, s: int, device, dtype=torch.float32,
                 dispersion: float | None = None, env_image: np.ndarray | None = None):
        def f(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

        self.s, self.dtype, self.device = s, dtype, device
        p, n = mesh["p"].astype(np.float32), mesh["n"].astype(np.float32)
        self.p = [f(p[:, k].T) for k in range(3)]
        self.n = [f(n[:, k].T) for k in range(3)]
        mat = mesh["mat"].astype(np.int64)
        self.mat = torch.as_tensor(mat, device=device)
        kinds = [classify(m) for m in mesh["materials"]]
        kd = np.asarray([m["kd"] for m in mesh["materials"]], np.float32)
        ka = np.asarray([m["ka"] for m in mesh["materials"]], np.float32)
        mtype = np.asarray([k[0] for k in kinds], np.int64)
        ior = np.asarray([k[1] for k in kinds], np.float32)
        self.m_type = torch.as_tensor(mtype, device=device)
        self.m_ior = f(ior)
        self.m_diffuse = f(from_rgb(kd, s).T)
        self.m_emissive = f(from_rgb(ka, s).T)
        self.m_ior_bins = None
        if dispersion is not None:
            bins = np.repeat(ior[None], s, axis=0)
            for j, t in enumerate(mtype):
                if t in (PLASTIC, DIELECTRIC):
                    bins[:, j] = cauchy_bins(float(ior[j]), dispersion, s)
            self.m_ior_bins = f(bins)
        # lights: every triangle whose material emits, in triangle order;
        # pdf by area, an exclusive-prefix CDF
        emits = (ka[mat] > 0.0).any(axis=1)
        lt = np.nonzero(emits)[0]
        self.num_lights = len(lt)
        light_of = np.full(len(mat), -1, np.int64)
        light_of[lt] = np.arange(len(lt))
        self.light_of = torch.as_tensor(light_of, device=device)
        lp = p[lt]                                   # (L, 3 vertices, 3)
        area = (0.5 * np.linalg.norm(np.cross(lp[:, 1] - lp[:, 0], lp[:, 2] - lp[:, 0]),
                                     axis=1)).astype(np.float32)
        pdf = area / area.sum()
        cdf = np.concatenate([[0.0], np.cumsum(pdf)[:-1]]).astype(np.float32)
        self.light_search = f(np.concatenate([cdf[1:], [np.float32(pdf.sum())]]))
        self.light_tri = torch.as_tensor(lt, device=device)
        self.light_p = [f(lp[:, k].T) for k in range(3)]
        self.light_n = [f(n[lt][:, k].T) for k in range(3)]
        self.light_area, self.light_pdf = f(area), f(pdf)
        light_emit = from_rgb(ka[mat[lt]], s)        # (L, S)
        self.light_emissive = f(light_emit.T)
        self.env = None
        if env_image is not None:
            rgb = to_rgb(light_emit)
            lum = 0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]
            self.env = self._env(np.asarray(env_image, np.float32),
                                 float((lum * area).sum() * np.pi), f)
        self.bvh = BVH(self.p, LEAF)

    def _env(self, img, light_power, f):
        eh, ew = img.shape[:2]
        lum = img @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
        edges = np.linspace(0.0, np.pi, eh + 1)
        domega = (2.0 * np.pi / ew) * (np.cos(edges[:-1]) - np.cos(edges[1:]))
        weight = np.maximum(lum, 0.0) * domega[:, None]
        total = weight.sum()
        power = float(total)
        if total <= 0.0:
            weight = np.ones_like(weight) * domega[:, None]
            total = weight.sum()
        pdf_texel = (weight / total).astype(np.float32)
        pdf_sa = (pdf_texel / np.maximum(domega[:, None], 1e-12)).astype(np.float32)
        prob, alias = alias_table(pdf_texel.reshape(-1).astype(np.float64))
        select_p = (float(np.clip(power / (power + light_power), 0.1, 0.9))
                    if light_power > 0.0 else 1.0)
        rad = from_rgb(img.reshape(-1, 3), self.s).T          # (S, K)
        dev = self.device
        return {"eh": eh, "ew": ew, "radiance": f(rad), "pdf": f(pdf_sa.reshape(-1)),
                "alias_p": f(prob), "alias_i": torch.as_tensor(alias, device=dev),
                "select_p": float(np.float32(select_p)),
                "one_minus": float(np.float32(1.0) - np.float32(select_p))}


# ---------------------------------------------------------------------------
# the BVH: Morton-ordered triangles, leaves of LEAF, a complete binary heap
# ---------------------------------------------------------------------------

class BVH:
    def __init__(self, p, leaf: int):
        p0, p1, p2 = (x.float().cpu().numpy() for x in p)
        t = p0.shape[1]
        lo = np.minimum(np.minimum(p0, p1), p2).T
        hi = np.maximum(np.maximum(p0, p1), p2).T
        c = 0.5 * (lo + hi)
        cmin, cmax = c.min(0), c.max(0)
        q = np.clip(((c - cmin) / np.maximum(cmax - cmin, 1e-12) * 1023).astype(np.int64),
                    0, 1023)
        code = np.zeros(t, np.int64)
        for bit in range(10):
            for axis in range(3):
                code |= ((q[:, axis] >> bit) & 1) << (3 * bit + (2 - axis))
        order = np.argsort(code, kind="stable")
        leaves = 1
        while leaves * leaf < t:
            leaves *= 2
        slots = np.full(leaves * leaf, -1, np.int64)
        slots[:t] = order
        self.leaves = leaves
        tri = slots.reshape(leaves, leaf)
        valid = tri >= 0
        safe = np.where(valid, tri, 0)
        llo = np.where(valid[..., None], lo[safe], np.inf).min(1)
        lhi = np.where(valid[..., None], hi[safe], -np.inf).max(1)
        nlo = np.full((2 * leaves, 3), np.inf, np.float32)
        nhi = np.full((2 * leaves, 3), -np.inf, np.float32)
        nlo[leaves:], nhi[leaves:] = llo, lhi
        first = leaves
        while first > 1:
            half = first // 2
            kids = np.arange(half, first)
            nlo[half:first] = np.minimum(nlo[2 * kids], nlo[2 * kids + 1])
            nhi[half:first] = np.maximum(nhi[2 * kids], nhi[2 * kids + 1])
            first = half
        dev, dt = p[0].device, p[0].dtype
        self.lo = torch.as_tensor(nlo, device=dev).to(dt)
        self.hi = torch.as_tensor(nhi, device=dev).to(dt)
        self.tri = torch.as_tensor(tri, device=dev)
        # each slot's (p0, e1, e2), zero for the padding (det 0: never hit)
        rows = torch.zeros((leaves * leaf, 9), dtype=dt, device=dev)
        sv = torch.as_tensor(slots, device=dev)
        ok = sv >= 0
        idx = sv[ok]
        a, b, cc = (x[:, idx] for x in p)
        rows[ok] = torch.cat([a, b - a, cc - a]).T
        self.rows = rows.view(leaves, leaf, 9)
        self.depth = int(np.log2(leaves)) + 2

    def nearest(self, o, d, active, t_max):
        """Nearest hit with 0 < t < t_max of each active ray -> (t, tri, u,
        v): t = inf and tri = -1 where nothing is hit.  Each ray keeps a
        stack of (node, entry distance); a node whose entry is no longer
        nearer than the best hit is dropped when popped."""
        n = o.shape[1]
        dev, dt = o.device, o.dtype
        inf = torch.full((n,), float("inf"), dtype=dt, device=dev)
        best_t = torch.where(active, t_max, inf)
        best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        best_u = torch.zeros(n, dtype=dt, device=dev)
        best_v = torch.zeros(n, dtype=dt, device=dev)
        tiny = torch.tensor(1e-30, dtype=dt, device=dev)
        inv = torch.stack([1.0 / torch.where(torch.abs(x) < tiny,
                                             torch.where(x < 0, -tiny, tiny), x) for x in d])
        size = 2 * self.depth + 2
        stack = torch.zeros((n, size), dtype=torch.int64, device=dev)
        stack_t = torch.zeros((n, size), dtype=dt, device=dev)
        sp = torch.zeros(n, dtype=torch.int64, device=dev)
        root = torch.ones(n, dtype=torch.int64, device=dev)
        enter = self._dist(root, o, inv, best_t)
        lanes = torch.nonzero(active & torch.isfinite(enter)).flatten()
        stack[lanes, 0] = 1
        stack_t[lanes, 0] = enter[lanes]
        sp[lanes] = 1
        while lanes.numel():
            top = sp[lanes] - 1
            node = stack[lanes, top]
            live = stack_t[lanes, top] < best_t[lanes]
            sp[lanes] = top
            leaf = live & (node >= self.leaves)
            inner = live & (node < self.leaves)
            if bool(leaf.any()):
                ll, ln = lanes[leaf], node[leaf] - self.leaves
                t, u, v = _mt(o[:, ll], d[:, ll], self.rows[ln])
                tt, k = torch.min(t, dim=1)
                better = tt < best_t[ll]
                upd, kb = ll[better], k[better][:, None]
                best_t[upd] = tt[better]
                best_tri[upd] = self.tri[ln[better], kb[:, 0]]
                best_u[upd] = u[better].gather(1, kb)[:, 0]
                best_v[upd] = v[better].gather(1, kb)[:, 0]
            if bool(inner.any()):
                il, inode = lanes[inner], node[inner]
                oi, ii, bi = o[:, il], inv[:, il], best_t[il]
                e0 = self._dist(2 * inode, oi, ii, bi)
                e1 = self._dist(2 * inode + 1, oi, ii, bi)
                first = e0 <= e1
                # the farther child first, so the nearer one pops next
                for kid, ent in ((torch.where(first, 2 * inode + 1, 2 * inode),
                                  torch.where(first, e1, e0)),
                                 (torch.where(first, 2 * inode, 2 * inode + 1),
                                  torch.where(first, e0, e1))):
                    push = torch.isfinite(ent)
                    pl = il[push]
                    at = sp[pl]
                    stack[pl, at] = kid[push]
                    stack_t[pl, at] = ent[push]
                    sp[pl] = at + 1
            lanes = lanes[sp[lanes] > 0]
        return torch.where(best_tri >= 0, best_t, inf), best_tri, best_u, best_v

    def _dist(self, node, o, inv, best_t):
        """Entry distance of each ray into the node's box, inf on a miss or
        beyond best_t."""
        lo, hi = self.lo[node].T, self.hi[node].T
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        enter = torch.minimum(t0, t1).amax(0)
        leave = torch.maximum(t0, t1).amin(0)
        ok = (enter <= leave) & (leave > 0) & (enter < best_t)
        return torch.where(ok, enter, torch.full_like(enter, float("inf")))


def _mt(o, d, rows):
    """Moller-Trumbore of rays (3, R) against rows (R, K, 9) -> (t, u, v)
    (R, K), t = inf without a hit (double-sided, t > 0)."""
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    r = rows.unbind(-1)
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = r
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    nz = det != 0.0
    inv = torch.where(nz, 1.0 / det, torch.zeros_like(det))
    tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = nz & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(ok, t, torch.full_like(t, float("inf"))), u, v


# ---------------------------------------------------------------------------
# random numbers: threefry key schedule on the host, PCG4D per lane
# ---------------------------------------------------------------------------

def _threefry(key, x0: int, x1: int) -> tuple[int, int]:
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def fold_in(key, data: int) -> tuple[int, int]:
    return _threefry(key, 0, int(data) & M32)


def salt(key) -> int:
    return (int(key[0]) ^ (int(key[1]) * 0x9E3779B9)) & M32


def frame_salts(seed: int, frames: int) -> tuple[list[int], list[int], list[int]]:
    """Per frame f: the salt of the bounce draws, of the camera jitter and of
    the hero bins (the wavefront key is fold_in(fold_in(key(seed), f), 0))."""
    key = (0, int(seed) & M32)
    out = ([], [], [])
    for fr in range(frames):
        wkey = fold_in(fold_in(key, fr), 0)
        s = salt(wkey)
        out[0].append(s)
        out[1].append(salt(fold_in(wkey, 0xC0FFEE)) ^ _CAMERA_SALT)
        out[2].append(s ^ _HERO_SALT)
    return out


def _mul32(a, b):
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _pcg4d(a, b, c, d):
    mul, inc = 1664525, 1013904223
    v = [(_mul32(x, mul) + inc) & M32 for x in (a, b, c, d)]
    for shift in (False, True):
        if shift:
            v = [x ^ (x >> 16) for x in v]
        v[0] = (v[0] + _mul32(v[1], v[3])) & M32
        v[1] = (v[1] + _mul32(v[2], v[0])) & M32
        v[2] = (v[2] + _mul32(v[0], v[1])) & M32
        v[3] = (v[3] + _mul32(v[1], v[2])) & M32
    return v


def uniforms(pid, frame, bounce: int, salt_, count: int, dtype):
    """(count, N) uniforms in [0, 1) of lanes with int64 pixel ids, frames
    and salts (tensors)."""
    outs = []
    for g in range((count + 3) // 4):
        v = _pcg4d(pid, (frame + 0x9E3779B9 * g) & M32,
                   (bounce ^ ((salt_ << 1) & M32)) & M32, (salt_ + g * 0x85EBCA6B) & M32)
        outs += [((x >> 8).to(torch.float32) * (1.0 / 16777216.0)).to(dtype) for x in v]
    return torch.stack(outs[:count])


# ---------------------------------------------------------------------------
# shading helpers
# ---------------------------------------------------------------------------

def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def normalize(a):
    return a * torch.rsqrt(dot(a, a))[None]


def reflect(i, n):
    return i - (2.0 * dot(n, i))[None] * n


def power_heuristic(f, g):
    f2, g2 = f * f, g * g
    den = f2 + g2
    pos = den > 0.0
    return torch.where(pos, f2 / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(den))


def fresnel(n, i, eta_out, eta_in):
    eta = eta_out / eta_in
    ci = torch.clamp(dot(n, i), -1.0, 1.0)
    st2 = (eta * eta) * (1.0 - ci * ci)
    ct = torch.sqrt(torch.clamp(1.0 - st2, min=0.0))
    rs = (eta_in * ci - eta_out * ct) / (eta_in * ci + eta_out * ct)
    rp = (eta_in * ct - eta_out * ci) / (eta_in * ct + eta_out * ci)
    return torch.where(st2 < 1.0, 0.5 * (rs * rs + rp * rp), torch.ones_like(st2))


def _pick(mtype, diffuse, mirror, plastic, dielectric):
    return torch.where(mtype == DIFFUSE, diffuse, torch.where(
        mtype == MIRROR, mirror, torch.where(mtype == PLASTIC, plastic, dielectric)))


def cosine_dir(u, n):
    """Cosine-hemisphere direction around n: u[1] -> cos theta, u[0] -> phi,
    on the branchless Pixar basis."""
    cos_t = torch.sqrt(u[1])
    phi = u[0] * (PI_R * 2.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    nx, ny, nz = n[0], n[1], n[2]
    neg = nz < 0.0
    a = 1.0 / torch.where(neg, 1.0 - nz, 1.0 + nz)
    b = nx * ny * a
    bu = torch.stack([1.0 - nx * nx * a, -b, torch.where(neg, nx, -nx)])
    bv = torch.stack([torch.where(neg, b, -b),
                      torch.where(neg, ny * ny * a - 1.0, 1.0 - ny * ny * a), -ny])
    return (bu * torch.cos(phi)[None] + bv * torch.sin(phi)[None]) * sin_t[None] + n * cos_t[None]


def dispersion(mtype, ior, bins_ior, w_i, n, lobe_u, eta_out):
    """Per-bin weights of the Fresnel lobes around the d-line lobe choice."""
    f_h = fresnel(n, -w_i, eta_out, ior)
    f_b = fresnel(n, -w_i, eta_out, bins_ior)
    second = (f_h < lobe_u)[None]
    w = torch.where(second, (1.0 - f_b) / torch.clamp(1.0 - f_h, min=1e-6)[None],
                    f_b / torch.clamp(f_h, min=1e-6)[None])
    has = ((mtype == PLASTIC) | (mtype == DIELECTRIC))[None]
    return torch.where(has, w, torch.ones_like(w))


def env_texel_dir(env, idx, ju, jv):
    eh, ew = env["eh"], env["ew"]
    v = ((idx // ew).to(ju.dtype) + jv) / eh
    u = ((idx % ew).to(ju.dtype) + ju) / ew
    theta = np.pi * v
    phi = 2.0 * np.pi * u - np.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)])


def env_lookup(env, d):
    """Nearest texel of directions d -> flat index."""
    eh, ew = env["eh"], env["ew"]
    phi = torch.atan2(d[2], d[0])
    u = (phi + np.pi) / (2.0 * np.pi)
    u = u - torch.floor(u)
    v = torch.arccos(torch.clamp(d[1], -1.0, 1.0)) / np.pi
    j = torch.clamp((u * ew).to(torch.int32), 0, ew - 1).to(torch.int64)
    i = torch.clamp((v * eh).to(torch.int32), 0, eh - 1).to(torch.int64)
    return i * ew + j


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

def trace_lanes(sc: Scene, spec: dict, pid, frame, salts, cam_salts, hero_salts):
    """Radiance (S, N) of N paths: lane i is the sample of pixel id
    ``pid[i]`` (pixel + sample * H * W) in frame ``frame[i]``, with that
    frame's salts."""
    dt, dev = sc.dtype, sc.device
    h, w, s = spec["height"], spec["width"], sc.s
    hero = spec["hero"] if s > 3 and spec["hero"] > 0 else 0
    n = pid.shape[0]
    pix = pid % (h * w)
    rows, cols = pix // w, pix % w
    # camera (Shaders.metal:75-103): (0, 1, 2.35) looking down -z, 90 degrees
    jit = uniforms(pid, frame, 0, cam_salts, 4, dt)
    aspect = float(np.float32(h) / np.float32(w))
    wm1, hm1 = float(max(w - 1, 1)), float(max(h - 1, 1))
    x = cols.to(dt)
    y = float(h - 1) - rows.to(dt)
    dx = (jit[0] * 2.0 - 1.0) / wm1 + (2.0 * x / wm1 - 1.0)
    dy = (jit[1] * 2.0 - 1.0) / hm1 + (2.0 * y / hm1 - 1.0) * aspect
    direction = normalize(torch.stack([dx, dy, -torch.ones_like(dx)]))
    origin = torch.tensor([0.0, 1.0, 2.35], dtype=dt, device=dev)[:, None].expand(3, n).clone()
    bins = None
    planes = s
    if hero:
        hu = uniforms(pid, frame, 0, hero_salts, 1, torch.float32)[0]
        offs = (torch.arange(hero, dtype=torch.float32, device=dev) / hero)[:, None]
        bins = torch.remainder((torch.remainder(hu[None] + offs, 1.0) * s).to(torch.int64), s)
        planes = hero

    def spectral(table, idx):
        out = table[:, idx]
        return out if bins is None else torch.gather(out, 0, bins)

    one = torch.ones(n, dtype=dt, device=dev)
    zero = torch.zeros(n, dtype=dt, device=dev)
    inf = torch.full((n,), float("inf"), dtype=dt, device=dev)
    thr = torch.ones((planes, n), dtype=dt, device=dev)
    rad = torch.zeros((planes, n), dtype=dt, device=dev)
    pdf, prev_diffuse, cur_ior = one.clone(), zero.clone(), torch.full_like(one, IOR_AIR)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    env = sc.env
    depth = spec["depth"]
    for b in range(depth):
        t, tri, hu_, hv_ = sc.bvh.nearest(origin, direction, alive, inf)
        hit_any = torch.isfinite(t)
        valid = alive & hit_any & (t >= EPS)
        tri0 = torch.where(hit_any, tri, 0)
        uu, vv = torch.where(hit_any, hu_, zero), torch.where(hit_any, hv_, zero)
        wts = (1.0 - uu - vv, uu, vv)
        hp = sum(sc.p[k][:, tri0] * wts[k][None] for k in range(3))
        hn = normalize(sum(sc.n[k][:, tri0] * wts[k][None] for k in range(3)))
        mat = sc.mat[tri0]
        m_diffuse, m_emissive = spectral(sc.m_diffuse, mat), spectral(sc.m_emissive, mat)
        m_ior, m_type = sc.m_ior[mat], sc.m_type[mat]
        u = uniforms(pid, frame, b, salts, 10 if env is not None else 6, dt)
        lobe_u = u[3]
        # next-event estimation toward a light triangle (Shaders.metal:149-176)
        li = torch.searchsorted(sc.light_search, u[0].contiguous(), right=True)
        has_light = li < sc.num_lights
        lic = torch.clamp(li, max=sc.num_lights - 1)
        r1 = torch.sqrt(u[1])
        bary = (1.0 - r1, r1 * (1.0 - u[2]), r1 * u[2])
        lp = sum(sc.light_p[k][:, lic] * bary[k][None] for k in range(3))
        ln = normalize(sum(sc.light_n[k][:, lic] * bary[k][None] for k in range(3)))
        to_l = lp - hp
        dist = torch.sqrt(dot(to_l, to_l))
        to_l = to_l / torch.clamp(dist, min=1e-30)[None]
        l_cos = -dot(to_l, ln)
        dir_ok = has_light & (dist >= EPS) & (l_cos >= AEPS)
        l_pdf = torch.where(dir_ok, sc.light_pdf[lic] * (dist * dist)
                            / (sc.light_area[lic] * l_cos), zero)
        target = sc.light_tri[lic]
        nee_emit = torch.where(has_light[None], spectral(sc.light_emissive, lic),
                               torch.zeros_like(thr))
        if env is not None:
            sel = env["select_p"]
            use_env = u[6] < sel
            k = env["pdf"].shape[0]
            xa = u[7] * k
            slot = torch.clamp(xa.to(torch.int32), 0, k - 1).to(torch.int64)
            take = (xa - slot.to(dt)) >= env["alias_p"][slot]
            idx = torch.where(take, env["alias_i"][slot], slot)
            e_dir = env_texel_dir(env, idx, u[8], u[9])
            nee_dir = torch.where(use_env[None], e_dir, to_l)
            l_pdf = torch.where(use_env, env["pdf"][idx] * sel, l_pdf * env["one_minus"])
            nee_emit = torch.where(use_env[None], spectral(env["radiance"], idx), nee_emit)
            not_self = (use_env | (target != tri0)) & (~use_env | (dot(nee_dir, hn) > 0.0))
            cap = torch.where(use_env, torch.full_like(dist, 1e30), dist + 4.0 * EPS)
            target = torch.where(use_env, -1, target)
        else:
            nee_dir, not_self, cap = to_l, target != tri0, dist + 4.0 * EPS
        # the material's NEE response (KernelHelpers.h:56-114): eta_out = 1
        cos_o = dot(nee_dir, hn)
        mirror_b = torch.where(torch.abs(dot(reflect(direction, hn), nee_dir) - 1.0) < AEPS,
                               cos_o, zero)
        diff_v = (1.0 / PI_R) * cos_o
        second = fresnel(hn, -direction, 1.0, m_ior) < lobe_u
        nee_bsdf = _pick(m_type, diff_v, mirror_b, torch.where(second, diff_v, mirror_b),
                         torch.where(second, zero, mirror_b))
        nee_mpdf = _pick(m_type, diff_v, one, torch.where(second, diff_v, one),
                         torch.where(second, zero, one))
        light_ok = valid & (l_pdf > 0.0) & not_self & (b + 1 < depth)
        nee_scale = torch.where(light_ok, power_heuristic(l_pdf, nee_mpdf) * nee_bsdf
                                / torch.where(light_ok, l_pdf, one), zero)
        nee_c = nee_emit * m_diffuse * thr * nee_scale[None]
        if sc.m_ior_bins is not None:
            bins_ior = spectral(sc.m_ior_bins, mat)
            nee_c = nee_c * dispersion(m_type, m_ior, bins_ior, direction, hn, lobe_u, 1.0)
        # the BSDF arm's MIS on emitter hits (Shaders.metal:180-197), x-pdf
        lti = sc.light_of[tri0]
        is_light = valid & (lti >= 0)
        ltc = torch.clamp(lti, min=0)
        to_e = hp - origin
        e_dist = torch.sqrt(dot(to_e, to_e))
        to_e = to_e / torch.clamp(e_dist, min=1e-30)[None]
        e_cos = -dot(to_e, hn)
        e_ok = (e_dist >= EPS) & (e_cos >= AEPS) & is_light
        e_lpdf = torch.where(e_ok, sc.light_pdf[ltc] * (e_dist * e_dist)
                             / torch.clamp(sc.light_area[ltc] * e_cos, min=1e-30), zero)
        if env is not None:
            e_lpdf = e_lpdf * env["one_minus"]
        e_w = power_heuristic(pdf, prev_diffuse * e_lpdf)
        emit = m_emissive * thr * torch.where(is_light, e_w * pdf, zero)[None]
        if env is not None:
            miss = alive & ~hit_any
            eidx = env_lookup(env, direction)
            e_rad = spectral(env["radiance"], eidx)
            w_env = power_heuristic(pdf, prev_diffuse * env["select_p"] * env["pdf"][eidx])
            emit = emit + e_rad * thr * torch.where(miss, w_env, zero)[None]
        rad = rad + emit
        # the next bounce (KernelHelpers.h:116-179)
        mirror_d = reflect(direction, hn)
        diff_d = cosine_dir(u[4:6], hn)
        mirror_cos = dot(mirror_d, hn)
        diff_b = (1.0 / PI_R) * dot(diff_d, hn)
        second = fresnel(hn, -direction, cur_ior, m_ior) < lobe_u
        s3 = second[None]
        w_o = _pick(m_type[None], diff_d, mirror_d, torch.where(s3, diff_d, mirror_d),
                    torch.where(s3, direction, mirror_d))
        nb_bsdf = _pick(m_type, diff_b, mirror_cos, torch.where(second, diff_b, mirror_cos),
                        torch.where(second, one, mirror_cos))
        nb_pdf = _pick(m_type, diff_b, one, torch.where(second, diff_b, one), one)
        nb_ior = torch.where((m_type == DIELECTRIC) & second, m_ior, cur_ior)
        safe = torch.where(torch.abs(nb_pdf) > PDF_FLOOR, nb_pdf,
                           torch.full_like(nb_pdf, PDF_FLOOR))
        scale = m_diffuse * (nb_bsdf / safe)[None]
        if sc.m_ior_bins is not None:
            scale = scale * dispersion(m_type, m_ior, bins_ior, direction, hn, lobe_u, cur_ior)
        # the shadow query, inside its bounce
        s_org = hp + hn * EPS
        if bool(light_ok.any()):
            st, stri, _, _ = sc.bvh.nearest(s_org, nee_dir, light_ok, cap)
            got = torch.isfinite(st)
            clear = light_ok & torch.where(target >= 0, got & (st >= EPS) & (stri == target),
                                           ~got)
            rad = rad + torch.where(clear[None], nee_c, torch.zeros_like(nee_c))
        v3 = valid[None]
        origin = torch.where(v3, hp + hn * EPS, origin)
        direction = torch.where(v3, w_o, direction)
        thr = torch.where(v3, thr * scale, thr)
        pdf = torch.where(valid, nb_pdf, pdf)
        prev_diffuse = torch.where(valid, (m_type == DIFFUSE).to(dt), prev_diffuse)
        cur_ior = torch.where(valid, nb_ior, cur_ior)
        alive = valid
    if not hero:
        return rad
    out = torch.zeros((s, n), dtype=dt, device=dev)
    rad = rad * (s / hero)
    lane = torch.arange(n, device=dev)
    for c in range(hero):
        out[bins[c], lane] += rad[c]
    return out


def render_pixels(sc: Scene, spec: dict, pixels: np.ndarray, frames: int, seed: int,
                  chunk: int = 1 << 20) -> np.ndarray:
    """The running mean after ``frames`` frames of each pixel (flat index
    row * W + col) -> (P, S) float64: frame f's colour is the mean of its
    ``spp`` samples, sample k of pixel p keyed on pixel id p + k * H * W."""
    dev = sc.device
    h, w, spp = spec["height"], spec["width"], spec["spp"]
    salts = [torch.as_tensor(np.asarray(x, np.int64), device=dev)
             for x in frame_salts(seed, frames)]
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    p = pix.shape[0]
    lanes = p * frames * spp
    acc = torch.zeros((p, sc.s), dtype=torch.float64, device=dev)
    for start in range(0, lanes, chunk):
        i = torch.arange(start, min(start + chunk, lanes), device=dev)
        px, rest = i % p, i // p
        sample, frame = rest % spp, rest // spp
        pid = (pix[px] + sample * (h * w)) & M32
        rad = trace_lanes(sc, spec, pid, frame, salts[0][frame], salts[1][frame],
                          salts[2][frame])
        acc.index_add_(0, px, rad.T.to(torch.float64))
    return (acc / (frames * spp)).cpu().numpy()
