"""The wavefront path-tracing pipeline.

The port of ``tpu_pathtracer/render/wavefront.py``: the per-frame kernel
sequence of the reference (renderer/Renderer.mm:500-585),

    rayGenerator -> [ intersect -> intersectionHandler -> shadow-intersect
                      -> lightSamplingHandler ] x MAX_PATH_LENGTH -> accumulate

as torch ops on component-major SoA tensors (on one card each bounce's
launches replay as a CUDA graph, render/graphs.py).  On the kernel path
each secondary bounce's wavefront is sorted (dead lanes last, then origin
cell and direction bin) with the previous bounce's NEE shadow pack riding
along; the pack resolves right after the sort (its origin is the same hit
point), and the bounce then runs on the shortest live prefix of the
live-prefix ladder.  The portable backends, and ``sort_rays=False``, run
the unsorted pipeline with the shadow query traced inside its bounce.

Estimator notes (reference-exact when ``cfg.reference_quirks``):
  * NEE: contribution = emissive * mat.diffuse * throughput * W * bsdf /
    lightPdf with W = powerHeuristic(lightPdf, materialPdf)
    (renderer/Shaders.metal:166-169).
  * BSDF-arm MIS on emitter hits: radiance += emissive * throughput * W * mPdf
    (renderer/Shaders.metal:189-193); with quirks off the mPdf is dropped.
  * A nearest hit closer than DISTANCE_EPSILON kills the path
    (renderer/Shaders.metal:122-126).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import IOR_AIR, NoiseMode, RenderConfig, check_supported
from ..core.geometry import interpolate
from ..core.math3d import dot, length, where3
from ..core.sampling import balance_heuristic, barycentric, select_light_index
from ..core.spectrum import apply_bins
from ..models import bsdf as bsdf_lib
from ..models import ggx
from ..models.camera import Camera, CameraTerms, camera_rays, camera_terms
from ..models.envlight import eval_env, sample_env
from ..models.texture import diffuse_modulation
from ..ops import shade as shade_ops
from ..ops import wavefront_sort as sort_ops
from ..ops.hopper_traverse import make_cuda_intersector
from ..ops.intersect import HitShade, intersect_brute, shade_from_scene
from ..ops.rng import fold_in
from ..ops.traverse import make_bvh_intersector
from ..scene.scene import Scene
from .graphs import ChainGraphs
from .noise import bounce_uniforms, camera_jitter, hero_bins, pids_from_order, uniform_count
from .order import make_order
from .timing import FrameTrace, frame_trace, span

IntersectFn = Callable[..., HitShade]
# (origins (3, N), directions (3, N), active (N,) bool, t_max=None,
#  coherent=False) -> HitShade


class PathState(NamedTuple):
    """SoA ray state (the reference's Ray struct, renderer/Raytracing.h:54-69,
    plus the owning pixel id so the wavefront can be re-sorted)."""

    origin: torch.Tensor        # (3, N)
    direction: torch.Tensor     # (3, N)
    throughput: torch.Tensor    # (S, N)
    radiance: torch.Tensor      # (S, N)
    pdf: torch.Tensor           # (N,) previous bounce's material pdf
    prev_diffuse: torch.Tensor  # (N,) 1.0 if the previous lobe had a finite pdf
    ior: torch.Tensor           # (N,) current medium IoR
    alive: torch.Tensor         # (N,) bool
    pixel: torch.Tensor         # (N,) int64 absolute pixel id of this lane
    # (C, N) int64 wavelength bins under hero sampling (cfg.hero_wavelengths
    # > 0); None when every spectrum bin is traced
    bins: torch.Tensor | None = None


class ShadowPack(NamedTuple):
    """A deferred NEE shadow query (the reference's LightSamplingRay,
    renderer/Raytracing.h:71-83); its origin is the next path origin."""

    to_light: torch.Tensor      # (3, N) unit direction to the light sample
    cap: torch.Tensor           # (N,) range cap just past the light sample
    target: torch.Tensor        # (N,) int64 light triangle that must be nearest
    contrib: torch.Tensor       # (S, N) radiance added if unoccluded
    ok: torch.Tensor            # (N,) bool: query live


def initial_path_state(origins, directions, samples: int, pixel, bins=None) -> PathState:
    """Fresh lanes: unit throughput, no radiance, air; ``samples`` is S, or
    C under hero sampling (``bins`` (C, N))."""
    num = origins.shape[1]
    dev = origins.device
    return PathState(
        origin=origins,
        direction=directions,
        throughput=torch.ones((samples, num), device=dev),
        radiance=torch.zeros((samples, num), device=dev),
        pdf=torch.ones(num, device=dev),
        prev_diffuse=torch.zeros(num, device=dev),
        ior=torch.full((num,), IOR_AIR, device=dev),
        alive=torch.ones(num, dtype=torch.bool, device=dev),
        pixel=pixel,
        bins=bins,
    )


def select_spectrum(table: torch.Tensor, idx: torch.Tensor, bins) -> torch.Tensor:
    """Spectral table lookup: (S, M) x (N,) -> (S, N), or (C, N) under hero
    sampling."""
    return apply_bins(table[:, idx], bins)


def scene_sort_bounds(scene: Scene, trace: FrameTrace | None = None):
    """Scene-AABB (wmin, winv) of the sort key's spatial cell, as float32
    values held in Python floats: two host reads."""
    lo = torch.minimum(torch.minimum(scene.p0, scene.p1), scene.p2).amin(dim=1)
    hi = torch.maximum(torch.maximum(scene.p0, scene.p1), scene.p2).amax(dim=1)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-6)
    with span(trace, "host_read"):
        wmin = tuple(lo.tolist())
    with span(trace, "host_read"):
        winv = tuple(inv.tolist())
    return wmin, winv


def sort_wavefront(state: PathState, wmin, winv, pack: ShadowPack, out=None):
    """Re-order the wavefront and its shadow pack by the sort key
    (ops/wavefront_sort.py: dead bit, origin cell, direction bin), pixel id
    breaking ties: one int64 key ``(key << 32) | pixel`` sorted stably, then
    every plane gathered by the permutation -> (state, pack), fresh tensors
    or, with ``out``, the (state, pack) of the same shapes it writes.  Hero
    bins (C, N) ride as one more plane; the TPU's sort-operand limit, which
    made the reference pack them into uint32 planes, does not apply here.
    On CUDA tensors the key and the gather are one kernel launch each
    (csrc/wavefront_sort.cu), the gather reading pixel and alive from the
    sorted key; on the CPU their plain versions run."""
    cuda = state.alive.is_cuda
    key = (sort_ops.sort_key if cuda else sort_ops.sort_key_plain)(
        state.origin, state.direction, state.alive, state.pixel, wmin, winv)
    key, perm = torch.sort(key, stable=True)
    dst = None if out is None else [*out[0], *out[1]]
    if cuda:
        planes = sort_ops.gather_planes([*state, *pack], perm, key, pixel=_PIXEL,
                                        alive=_ALIVE, out=dst)
    else:
        planes = sort_ops.gather_planes_plain([*state, *pack], perm, out=dst)
    if dst is not None and any(p is not o for p, o in zip(planes, dst)):
        raise ValueError("sort_wavefront: the gather did not write the planes given as out")
    return PathState(*planes[:len(state)]), ShadowPack(*planes[len(state):])


_PIXEL, _ALIVE = PathState._fields.index("pixel"), PathState._fields.index("alive")


def _conductor_albedo(m_diffuse, m_type, w_i, out_dir):
    """Spectral throughput factor with rough-conductor Fresnel: Schlick at
    the half vector (F0 = Kd) replaces the albedo on rough-conductor lanes
    (the GGX lobe evaluates with F = 1); other materials keep the albedo."""
    is_rc = (m_type == bsdf_lib.MATERIAL_ROUGH_CONDUCTOR)[None]
    hv = out_dir - w_i  # v + l with v = -w_i
    hlen = torch.sqrt(torch.clamp(dot(hv, hv), min=1e-12))
    cos_vm = torch.clamp(-dot(w_i, hv) / hlen, 0.0, 1.0)
    return torch.where(is_rc, ggx.schlick(m_diffuse, cos_vm), m_diffuse)


def trace_bounce(scene: Scene, cfg: RenderConfig, intersect: IntersectFn,
                 bounce: int, state: PathState, uniforms: dict,
                 with_stats: bool = False, coherent: bool = False,
                 defer_shadow: bool = False, hit: HitShade | None = None,
                 trace: FrameTrace | None = None, live: int | None = None):
    """One wavefront stage group: intersect + shade + NEE sample + shadow
    (reference: renderer/Shaders.metal:105-231) -> the new state.

    With ``defer_shadow`` the NEE occlusion query is returned as a
    :class:`ShadowPack` for :func:`resolve_shadow` after the next sort ->
    (state, pack); without it the query is traced here from the shadow
    origin ``hp + hn * eps`` and resolved into the state.  ``with_stats``
    appends {"path": n, "shadow": n}, the rays the traversal processes.
    ``hit`` supplies a precomputed nearest hit (the fused path+shadow walk,
    cfg.fuse_shadow_walk) instead of tracing here.  ``trace``
    (render/timing.py) spans the shading as "shade" and counts its launch,
    ``live`` the live lanes entering it where the caller read them.

    The shading after the intersect is one launch of ``csrc/shade.cu`` on
    CUDA tensors when ``ops/shade.py:shade_kernel_covers`` holds for the
    config and scene (env-lit, hero, dispersive, GGX and textured frames
    included); otherwise (the CPU, and on the card more than 16 carried
    planes) :func:`_shade_plain`."""
    if hit is None:
        hit = intersect(state.origin, state.direction, state.alive,
                        coherent=coherent)
    kernel = state.alive.is_cuda and shade_ops.shade_kernel_covers(cfg, scene)
    inline = not defer_shadow
    with span(trace, "shade", bounce=bounce, lanes=state.alive.shape[0]):
        if kernel:
            new_state, pack, shadow_origin, counts = shade_ops.shade_bounce(
                scene, cfg, bounce, state, uniforms, hit, inline)
        else:
            new_state, pack, shadow_origin, counts = _shade_plain(
                scene, cfg, bounce, state, uniforms, hit, inline)
    if trace is not None:
        names = ((("env_picks", "env_misses") if scene.env is not None else ())
                 + (("ggx_lanes", "tex_lanes") if shade_ops.has_materials(scene) else ()))
        trace.shading(bounce, state, scene, live, inline, kernel, dict(zip(names, counts[2:])))
    n_path, n_shadow = counts[:2]
    # rays the traversal processes (the reference's MPS skips lanes with
    # maxDistance < 0)
    stats = ({"path": n_path, "shadow": n_shadow},) if with_stats else ()
    if defer_shadow:
        # the query's origin is new_state.origin (hp + eps * n): it rides
        # the next bounce's sort and resolves there.  The range cap just
        # past the light sample is a pure traversal cull.
        return (new_state, pack, *stats)
    clear = occlusion_clear(intersect, shadow_origin, pack.to_light, pack.ok, pack.cap,
                            pack.target, cfg.distance_epsilon)
    new_state = new_state._replace(
        radiance=new_state.radiance + torch.where(clear[None], pack.contrib, 0.0))
    return (new_state, *stats) if with_stats else new_state


def _shade_plain(scene: Scene, cfg: RenderConfig, bounce: int, state: PathState,
                 uniforms: dict, hit: HitShade, inline: bool):
    """The shading of one bounce after its intersect, as torch ops: BSDF
    sampling, NEE with MIS, the BSDF-arm MIS on emitter hits -> (new state,
    shadow pack, the shadow origin ``hp + hn * eps`` when ``inline`` else
    None, (live path lanes, live shadow lanes and, with an environment
    light, its picks and misses, and in a scene with a roughness table or
    textures the lanes that hit a GGX type and those that hit a textured
    material) as int64 tensors).  The plain version of
    ``ops/shade.py:shade_bounce`` (csrc/shade.cu), and the shading of every
    frame that kernel does not cover."""
    eps = cfg.distance_epsilon
    aeps = cfg.angle_epsilon
    # A hit nearer than DISTANCE_EPSILON (or a miss) kills the path
    # (reference: renderer/Shaders.metal:122-126).
    valid = state.alive & hit.valid & (hit.t >= eps)

    tri = torch.where(valid, hit.tri, 0)
    mat = hit.mat
    bins = state.bins
    m_diffuse = select_spectrum(scene.mat_diffuse, mat, bins)
    m_emissive = select_spectrum(scene.mat_emissive, mat, bins)
    m_ior = scene.mat_ior[mat]
    m_type = scene.mat_type[mat]
    # the GGX types; None keeps the parity math untouched
    m_rough = scene.mat_roughness[mat] if scene.mat_roughness is not None else None
    if scene.textures is not None:
        # map_Kd modulation at the interpolated texcoords (an extension; the
        # reference drops texcoords, renderer/Renderer.mm:365-369)
        m_diffuse = m_diffuse * diffuse_modulation(scene, tri, hit.u, hit.v, mat, bins,
                                                   scene.mat_diffuse.shape[0])
    hp, hn = hit.pos, hit.normal

    w_i = state.direction
    lobe_u = uniforms["lobe"]

    # ---- next-event estimation (reference: renderer/Shaders.metal:149-176) ----
    li = select_light_index(uniforms["light_select"], scene.light_cdf)
    lw = barycentric(uniforms["light_bary"])
    lp, ln_ = interpolate(
        scene.light_p[0][:, li], scene.light_p[1][:, li], scene.light_p[2][:, li],
        scene.light_n[0][:, li], scene.light_n[1][:, li], scene.light_n[2][:, li],
        lw,
    )
    to_light_full = lp - hp
    dist = length(to_light_full)
    to_light = to_light_full / torch.clamp(dist, min=1e-30)[None]
    l_dot_d = -dot(to_light, ln_)
    dir_ok = (dist >= eps) & (l_dot_d >= aeps)
    # solid-angle pdf (reference: renderer/KernelHelpers.h:181-190)
    light_pdf = torch.where(
        dir_ok,
        scene.light_pdf[li] * (dist * dist) / (scene.light_area[li] * l_dot_d),
        0.0,
    )
    target = scene.light_tri[li]
    env = scene.env
    if env is not None:
        # Unified NEE over {area lights, environment} (an extension of the
        # reference): each lane samples the env with probability select_p,
        # and each branch pdf carries its selection probability, so one MIS
        # weight covers both.
        sel_p = env.select_p
        use_env = uniforms["env_select"] < sel_p
        e_dir, e_pdf, e_rad = sample_env(env, uniforms["env_alias"], uniforms["env_jit"],
                                         bins)
        nee_dir = where3(use_env, e_dir, to_light)
        light_pdf = torch.where(use_env, e_pdf * sel_p, light_pdf * (1.0 - sel_p))
        nee_emit = torch.where(use_env[None], e_rad,
                               select_spectrum(scene.light_emissive, li, bins))
        # Below-horizon env samples could only add negative radiance through
        # the signed diffuse eval: gated out.  Area-light lanes keep the
        # reference's ungated behaviour.
        not_self = (use_env | (target != tri)) & (~use_env | (dot(nee_dir, hn) > 0.0))
        # env shadow rays are unbounded (any scene hit occludes), and target
        # -1 marks "clear iff nothing is hit"
        shadow_cap = torch.where(use_env, 1e30, dist + 4.0 * eps)
        target = torch.where(use_env, -1, target)
    else:
        nee_dir = to_light
        nee_emit = select_spectrum(scene.light_emissive, li, bins)
        not_self = target != tri
        shadow_cap = dist + 4.0 * eps
    nee_bsdf, nee_mpdf = bsdf_lib.eval_material(
        m_type, m_ior, w_i, nee_dir, hn, lobe_u, aeps, roughness=m_rough)
    nee_weight = balance_heuristic(light_pdf, nee_mpdf)
    light_ok = valid & (light_pdf > 0.0) & not_self
    if bounce + 1 >= cfg.max_path_length:
        light_ok = torch.zeros_like(light_ok)
    if not cfg.reference_quirks:
        light_ok = light_ok & (dot(nee_dir, hn) > 0.0)
    nee_scale = torch.where(
        light_ok, nee_weight * nee_bsdf / torch.where(light_ok, light_pdf, 1.0), 0.0
    )
    nee_albedo = (m_diffuse if m_rough is None
                  else _conductor_albedo(m_diffuse, m_type, w_i, nee_dir))
    nee_contrib = nee_emit * nee_albedo * state.throughput * nee_scale[None]
    if scene.mat_ior_bins is not None:
        # dispersive Fresnel (an extension, scene.attach_dispersion): per-bin
        # reweighting around the scalar-Fresnel lobe choice; the NEE arm
        # keeps the reference's eta_out = 1.0
        m_ior_bins = select_spectrum(scene.mat_ior_bins, mat, bins)
        nee_contrib = nee_contrib * bsdf_lib.dispersion_weights(
            m_type, m_ior, m_ior_bins, w_i, hn, lobe_u, 1.0)
    if cfg.cull_zero_nee:
        # a shadow ray whose contribution is exactly zero in every bin adds
        # zero clear or occluded: skip its walk (delta lobes always qualify;
        # the reference traces them, renderer/Shaders.metal:149-176)
        light_ok = light_ok & torch.any(nee_contrib != 0.0, dim=0)

    # ---- BSDF-arm MIS when the path hits an emitter ----
    # (reference: renderer/Shaders.metal:180-197)
    lti = hit.light
    is_light = valid & (lti >= 0)
    lts = torch.where(is_light, lti, scene.num_lights)  # sentinel row when unused
    to_emitter_full = hp - state.origin
    e_dist = length(to_emitter_full)
    to_emitter = to_emitter_full / torch.clamp(e_dist, min=1e-30)[None]
    e_cos = -dot(to_emitter, hn)
    e_ok = (e_dist >= eps) & (e_cos >= aeps)
    emit_lpdf = torch.where(
        e_ok & is_light,
        scene.light_pdf[lts] * (e_dist * e_dist)
        / torch.clamp(scene.light_area[lts] * e_cos, min=1e-30),
        0.0,
    )
    if env is not None:
        # NEE reaches an emitter point with density light_pdf * (1 - select_p)
        # under the unified strategy: the BSDF arm's competitor must match
        emit_lpdf = emit_lpdf * (1.0 - env.select_p)
    emit_lpdf = state.prev_diffuse * emit_lpdf
    emit_weight = balance_heuristic(state.pdf, emit_lpdf)
    # The reference's x-pdf emitter quirk is bounded only because its one
    # finite-pdf lobe is diffuse; a GGX lane's pdf is the unbounded VNDF
    # density, so scenes with rough materials weight conventionally.
    quirk = cfg.reference_quirks and m_rough is None
    emit_factor = emit_weight * state.pdf if quirk else emit_weight
    emit_contrib = (
        m_emissive * state.throughput * torch.where(is_light, emit_factor, 0.0)[None]
    )
    if env is not None:
        # BSDF-arm env radiance: a live lane whose ray escapes sees the env,
        # MIS-weighted against the NEE env arm (the conventional weight; the
        # reference's x-pdf quirk applies only to its area lights)
        miss_env = state.alive & ~hit.valid
        env_rad, env_pdf = eval_env(env, state.direction, bins)
        env_lpdf = state.prev_diffuse * env.select_p * env_pdf
        env_w = balance_heuristic(state.pdf, env_lpdf)
        emit_contrib = emit_contrib + (
            env_rad * state.throughput * torch.where(miss_env, env_w, 0.0)[None])

    # ---- sample the next bounce (reference: renderer/Shaders.metal:199-211) ----
    if cfg.refract_dielectric and scene.mat_ior_bins is not None:
        raise NotImplementedError(
            "refract_dielectric + attach_dispersion: the per-bin lobe "
            "reweighting is exact only for straight-through transmission")
    w_o, nb_bsdf, nb_pdf, nb_ior, nb_finite = bsdf_lib.sample_bounce(
        m_type, m_ior, w_i, hn, lobe_u, uniforms["bounce_dir"], state.ior,
        quirks=cfg.reference_quirks, roughness=m_rough, refract=cfg.refract_dielectric,
    )
    safe_pdf = torch.where(torch.abs(nb_pdf) > cfg.pdf_floor, nb_pdf, cfg.pdf_floor)
    bounce_albedo = (m_diffuse if m_rough is None
                     else _conductor_albedo(m_diffuse, m_type, w_i, w_o))
    throughput_scale = bounce_albedo * (nb_bsdf / safe_pdf)[None]
    if scene.mat_ior_bins is not None:
        # the bounce arm: eta_out is the ray's tracked IoR
        throughput_scale = throughput_scale * bsdf_lib.dispersion_weights(
            m_type, m_ior, m_ior_bins, w_i, hn, lobe_u, state.ior)

    origin_off = hn * eps
    if cfg.refract_dielectric:
        # Snell-transmitted lanes leave on the far side of the surface, or
        # they re-hit their own interface (t = eps/|cos| >= eps survives the
        # kill rule); parity mode keeps the reference's +n offset
        # (renderer/Shaders.metal:205)
        origin_off = torch.where(dot(w_o, hn) < 0.0, -eps, eps)[None] * hn
    new_state = PathState(
        origin=where3(valid, hp + origin_off, state.origin),
        direction=where3(valid, w_o, state.direction),
        throughput=where3(valid, state.throughput * throughput_scale, state.throughput),
        radiance=state.radiance + emit_contrib,
        pdf=torch.where(valid, nb_pdf, state.pdf),
        prev_diffuse=torch.where(valid, nb_finite, state.prev_diffuse),
        ior=torch.where(valid, nb_ior, state.ior),
        alive=valid,
        pixel=state.pixel,
        bins=bins,
    )
    pack = ShadowPack(to_light=nee_dir, cap=shadow_cap, target=target,
                      contrib=nee_contrib, ok=light_ok)
    shadow_origin = hp + hn * eps if inline else None
    counts = (state.alive.sum(), light_ok.sum())
    if env is not None:
        counts += (use_env.sum(), miss_env.sum())
    if shade_ops.has_materials(scene):
        none = torch.zeros_like(valid)
        ggx_type = m_type >= bsdf_lib.MATERIAL_ROUGH_CONDUCTOR if m_rough is not None else none
        textured = scene.mat_tex[mat] >= 0 if scene.textures is not None else none
        counts += ((valid & ggx_type).sum(), (valid & textured).sum())
    return new_state, pack, shadow_origin, counts


def occlusion_clear(intersect: IntersectFn, o, d, ok, cap, target,
                    eps: float) -> torch.Tensor:
    """Shadow visibility, reference semantics: the NEAREST hit within the
    range cap must BE the targeted light triangle (reference:
    renderer/Shaders.metal:214-231); env samples (target -1) are clear iff
    nothing is hit.  When the intersector carries the any-hit walk
    (``intersect.occlusion``, cfg.occlusion_anyhit) that answers instead:
    the same semantics, but a shadowed lane stops at its first occluder."""
    occl = getattr(intersect, "occlusion", None)
    if occl is not None:
        return ok & occl(o, d, ok, cap, target)
    hit = intersect(o, d, ok, t_max=cap)
    return ok & torch.where(target >= 0,
                            hit.valid & (hit.t >= eps) & (hit.tri == target),
                            ~hit.valid)


def resolve_shadow(intersect: IntersectFn, state: PathState, pack: ShadowPack,
                   eps: float) -> PathState:
    """Resolve a deferred NEE pack against the sorted wavefront (the shadow
    origin is the lane's current path origin)."""
    clear = occlusion_clear(intersect, state.origin, pack.to_light, pack.ok,
                            pack.cap, pack.target, eps)
    return state._replace(
        radiance=state.radiance + torch.where(clear[None], pack.contrib, 0.0))


def make_brute_intersector(scene: Scene, t_min: float = 0.0) -> IntersectFn:
    """The dense backend (cfg.intersector="brute"): every lane against every
    triangle (ops/intersect.py:intersect_brute), no BVH, range caps unused."""
    def fn(o, d, active, t_max=None, coherent=False):
        del active, t_max, coherent  # dense backend: all lanes
        return shade_from_scene(scene, intersect_brute(o, d, scene.p0, scene.p1,
                                                       scene.p2, t_min=t_min))

    return fn


def _nbytes(lay, *names) -> int:
    return sum(getattr(lay, n).numel() * getattr(lay, n).element_size() for n in names)


def layout_vmem_bytes(lay) -> int:
    """Worst-case bytes of BVH tables ONE TPU traversal kernel call placed
    whole in VMEM (the reference's byte arithmetic, kept so the route
    choice is the reference's): a node table, its meta, one triangle-row
    variant and a prepass block; the window kernel's MT variant (tris8, 24
    cols) is the largest combination."""
    return max(_nbytes(lay, "nodes", "nodes_meta", "tris", "prepass"),
               _nbytes(lay, "nodes8", "meta4", "tris8", "prepass"),
               _nbytes(lay, "nodes8", "meta4", "tris8bw", "prepassbw"))


def layout_hbm_vmem_bytes(lay) -> int:
    """VMEM-resident bytes of the TPU's HBM-streaming window kernel: node
    tables + prepass block only (the triangle table stays in HBM)."""
    return _nbytes(lay, "nodes8", "meta4", "prepassbw")


def pallas_tables_fit(cfg: RenderConfig, lay, lay_occl=None) -> bool:
    """True when every layout's tables fit the per-kernel table budget
    (cfg.vmem_table_budget_mb)."""
    budget = int(cfg.vmem_table_budget_mb * 2 ** 20)
    worst = max(layout_vmem_bytes(lay),
                layout_vmem_bytes(lay_occl) if lay_occl is not None else 0)
    return worst <= budget


def hbm_route(cfg: RenderConfig, lay, lay_occl=None) -> bool:
    """Whether the frame takes the HBM route, as the reference's
    make_intersector picks it on a TPU: cfg.hbm_tables "on" always; "auto"
    when the tables exceed cfg.vmem_table_budget_mb and the node tables fit
    it; "off" never.

    One stated divergence: past the budget with "off" (or with "auto" and
    node tables past it too) the reference warns and drops to its pure-JAX
    walker, because Mosaic cannot place the tables in VMEM.  The card has no
    such limit -- every table lives in device memory -- so the port keeps
    the whole-table kernels there; no walker stands in for them."""
    if cfg.hbm_tables == "on":
        return True
    return (cfg.hbm_tables == "auto" and not pallas_tables_fit(cfg, lay, lay_occl)
            and layout_hbm_vmem_bytes(lay) <= int(cfg.vmem_table_budget_mb * 2 ** 20))


def make_intersector(scene: Scene, cfg: RenderConfig, lay=None,
                     lay_occl=None) -> IntersectFn:
    """Pick the intersection backend, as the reference's make_intersector:
    brute (cfg.intersector="brute" or no layout), the portable torch walker
    (cfg.use_pallas False), or the CUDA kernels on the route
    :func:`hbm_route` picks.  ``lay_occl`` optionally gives capped (shadow)
    queries of the whole-table route their own small-leaf layout."""
    if cfg.intersector == "brute" or lay is None:
        return make_brute_intersector(scene)
    if not cfg.use_pallas:
        return make_bvh_intersector(lay, scene)
    return make_cuda_intersector(
        lay, lay_occl, prepass=cfg.traversal_prepass,
        anyhit=(cfg.occlusion_anyhit == "on"
                or (cfg.occlusion_anyhit == "auto" and scene.env is not None)),
        eps=cfg.distance_epsilon, kernel=cfg.traversal_kernel,
        hbm=hbm_route(cfg, lay, lay_occl), tritest=cfg.tritest)


def ladder_sizes(n_lanes: int, cfg: RenderConfig) -> list[int]:
    """Live-prefix ladder widths N, N/2, ... (RenderConfig.live_ladder);
    every width stays >= 4 secondary tiles and halves exactly, as in the
    reference."""
    sizes = [n_lanes]
    for _ in range(cfg.live_ladder):
        s = sizes[-1] // 2
        if sizes[-1] % 2 or s < 4 * cfg.secondary_tile:
            break
        sizes.append(s)
    return sizes


def _prefix(tensors: NamedTuple, s: int):
    return type(tensors)(*(None if x is None else x[..., :s].contiguous()
                           for x in tensors))


def _splice(full: NamedTuple, prefix: NamedTuple):
    """Write the prefix lanes back in place (the full tensors are owned
    here: the sort's fresh outputs, or a set of the chain graphs' buffers);
    a None field (no hero bins) stays None, and a field the bounce handed
    back as it was is not copied onto itself."""
    for f, p in zip(full, prefix):
        if p is not None and p is not f:
            f[..., :p.shape[-1]] = p
    return full


def _rung(live: int, sizes: list[int]) -> int:
    """Index of the shortest ladder width that still holds ``live`` lanes."""
    return sum(live <= w for w in sizes[1:])


class WavefrontPlan(NamedTuple):
    """A wavefront's inputs that depend on no frame (:func:`plan_wavefront`).
    Read only: a frame writes none of its tensors."""

    pids: torch.Tensor        # (N,) int64 lane ids: absolute pixel ids, and
    #                           with PRNG noise + the sample's offset
    camera: CameraTerms       # basis, origin, the lanes' pixel terms
    bounds: tuple | None      # the sort key's (wmin, winv); None unsorted


def _pipeline(cfg: RenderConfig) -> tuple[bool, bool]:
    """(kernel path, sorted): block order, sorts, deferred NEE and the
    ladder only on the kernel path (the reference's rule; the RNG keys on
    absolute pixel ids, so the order never changes the image)."""
    pallas_path = cfg.intersector == "bvh" and cfg.use_pallas
    return pallas_path, cfg.sort_rays and pallas_path


def plan_wavefront(scene: Scene, cfg: RenderConfig, camera: Camera, height: int,
                   width: int, row0: int, full_height: int, full_width: int,
                   samples: int, sample0: int, trace: FrameTrace | None = None
                   ) -> WavefrontPlan:
    """The :class:`WavefrontPlan` of :func:`render_sample`'s wavefront over
    rows ``row0 .. row0 + height`` and ``samples`` samples from ``sample0``
    (PRNG noise; one sample otherwise): the block order and its pixel ids,
    the camera's terms and the sort bounds.  Its host reads (the camera's
    three copies, the bounds' two reads) go through ``trace``."""
    pallas_path, do_sort = _pipeline(cfg)
    order = make_order(height, width, row0, cfg.traversal_tile if pallas_path else None,
                       device=scene.p0.device)
    pids = pids_from_order(order, full_width)
    rows, cols = order.rows, order.cols
    if cfg.noise_mode == NoiseMode.PRNG:
        npix_full = full_height * full_width
        pids = torch.cat([(pids + (sample0 + s) * npix_full) & 0xFFFFFFFF
                          for s in range(samples)])
        rows, cols = rows.repeat(samples), cols.repeat(samples)
    terms = camera_terms(camera, rows, cols, full_height, full_width, trace)
    return WavefrontPlan(pids, terms, scene_sort_bounds(scene, trace) if do_sort else None)


class ChainBuffers(NamedTuple):
    """The fixed buffers a wavefront's captured bounce chains run on
    (render/graphs.py), allocated once a plan, outside every graph."""

    sets: tuple        # two full-width (PathState, ShadowPack): each sort
    #                    writes the set the bounce did not read
    inputs: tuple      # the camera's origins and directions (3, N), the
    #                    hero bins (C, N) or None: bounce 0's input
    uniforms: torch.Tensor  # (uniform_count * N,) float32: a bounce's
    #                    rows, drawn eagerly before its replay
    live: torch.Tensor      # () int64: the live lanes the ladder reads


def chains_cover(cfg: RenderConfig, scene: Scene) -> bool:
    """Whether ``cfg``'s frames on ``scene`` can replay captured bounce
    chains: the sorted pipeline without prefix sorts (a prefix sort hands
    its bounce a fresh wavefront of the rung's width, which no fixed buffer
    holds), PRNG noise (TILED draws a host-made tile every bounce) and the
    shading kernel (ops/shade.py:shade_kernel_covers: GGX and textured
    scenes too, whose kernel reads the nearest hit's u and v, made inside
    the same chain)."""
    return (_pipeline(cfg)[1] and not cfg.prefix_sort
            and cfg.noise_mode == NoiseMode.PRNG and shade_ops.shade_kernel_covers(cfg, scene))


def _hero(cfg: RenderConfig) -> int:
    """The hero bins C a lane carries (hero sampling: S > 3 with
    cfg.hero_wavelengths > 0), else 0."""
    return cfg.hero_wavelengths if cfg.spectrum_samples > 3 and cfg.hero_wavelengths > 0 else 0


def chain_buffers(cfg: RenderConfig, scene: Scene, n_lanes: int) -> ChainBuffers:
    """Allocate the :class:`ChainBuffers` of an ``n_lanes`` wavefront."""
    dev = scene.p0.device
    hero = _hero(cfg)
    planes = hero or cfg.spectrum_samples

    def f32(*shape):
        return torch.empty(shape, device=dev)

    def full_set():
        state = PathState(
            origin=f32(3, n_lanes), direction=f32(3, n_lanes),
            throughput=f32(planes, n_lanes), radiance=f32(planes, n_lanes),
            pdf=f32(n_lanes), prev_diffuse=f32(n_lanes), ior=f32(n_lanes),
            alive=torch.empty(n_lanes, dtype=torch.bool, device=dev),
            pixel=torch.empty(n_lanes, dtype=torch.int64, device=dev),
            bins=torch.empty((hero, n_lanes), dtype=torch.int64, device=dev) if hero else None)
        pack = ShadowPack(to_light=f32(3, n_lanes), cap=f32(n_lanes),
                          target=torch.empty(n_lanes, dtype=torch.int64, device=dev),
                          contrib=f32(planes, n_lanes),
                          ok=torch.empty(n_lanes, dtype=torch.bool, device=dev))
        return state, pack

    bins = torch.empty((hero, n_lanes), dtype=torch.int64, device=dev) if hero else None
    return ChainBuffers(
        sets=(full_set(), full_set()), inputs=(f32(3, n_lanes), f32(3, n_lanes), bins),
        uniforms=f32(uniform_count(scene.env is not None) * n_lanes),
        live=torch.zeros((), dtype=torch.int64, device=dev))


class WavefrontPlans:
    """A renderer's wavefront plans, one a (row0, samples, sample0) slot of
    its frame.  :meth:`get` hands back the slot's plan while what it was
    built from holds (the sizes, the order's tile, the noise mode and
    pipeline, the camera's angle, the scene), and otherwise builds it anew
    in place of the old one, counted in the frame's ``plan_builds``.

    With ``capture`` (render/graphs.py: ``CudaCapture`` on the card) each
    plan :func:`chains_cover` allows also gets its slot's
    :class:`~tpu_pathtracer_torch.render.graphs.ChainGraphs` and their
    buffers (:meth:`chains`): a rebuilt plan drops its slot's graphs."""

    def __init__(self, capture=None):
        self.capture = capture
        self._held: dict[tuple, tuple] = {}
        self._graphs: dict[tuple, tuple] = {}   # slot -> (ChainGraphs, cfg)

    def get(self, scene: Scene, cfg: RenderConfig, camera: Camera, height: int,
            width: int, row0: int, full_height: int, full_width: int, samples: int,
            sample0: int, trace: FrameTrace | None = None) -> WavefrontPlan:
        pallas_path, do_sort = _pipeline(cfg)
        key = (height, width, full_height, full_width,
               cfg.traversal_tile if pallas_path else None, cfg.noise_mode, do_sort,
               np.float32(camera.t).tobytes())
        slot = (row0, samples, sample0)
        held = self._held.get(slot)
        if held is not None and held[0] == key and held[1] is scene:
            return held[2]
        plan = plan_wavefront(scene, cfg, camera, height, width, row0, full_height,
                              full_width, samples, sample0, trace)
        self._held[slot] = (key, scene, plan)
        self._graphs.pop(slot, None)
        if self.capture is not None and chains_cover(cfg, scene):
            self._graphs[slot] = (ChainGraphs(self.capture, chain_buffers(
                cfg, scene, plan.pids.shape[0])), cfg)
        if trace is not None:
            trace.plan_builds += 1
        return plan

    def chains(self, row0: int, samples: int, sample0: int, cfg: RenderConfig):
        """The ChainGraphs of the slot's plan (:meth:`get` it first) where
        its plan was built for ``cfg``, or None."""
        held = self._graphs.get((row0, samples, sample0))
        return None if held is None or held[1] != cfg else held[0]


def render_sample(scene: Scene, cfg: RenderConfig, camera: Camera, height: int,
                  width: int, key, frame_index: int, intersect: IntersectFn,
                  row0: int = 0, full_height: int | None = None,
                  full_width: int | None = None, with_ray_count: bool = False,
                  samples: int = 1, sample0: int = 0, timer=None,
                  plans: WavefrontPlans | None = None):
    """Trace ``samples`` samples per pixel of rows ``row0 .. row0 + height``
    of a ``full_height`` x ``full_width`` image in one wavefront -> their
    SUMMED (height, width, S) radiance.

    ``key``: the wavefront's raw uint32[2] key (render/state.py derives it).
    With PRNG noise sample s's lanes key on the virtual pixel id ``pixel +
    (sample0 + s) * full_height * full_width``, so every uniform is the same
    however samples are grouped into wavefronts or rows into tiles; TILED
    noise decodes the pixel from the id and takes one sample a wavefront.

    The pipeline is the reference's: on the kernel path (``intersector ==
    "bvh"`` and ``use_pallas``) pixels run in block order and, with
    cfg.sort_rays, each secondary bounce is sorted, carries the previous
    bounce's deferred NEE pack and runs on the live-prefix ladder
    (cfg.prefix_sort: the sort itself at the rung's width;
    cfg.sort_bounce_skip: no sort before the listed bounces).  Otherwise
    pixels run row-major, unsorted, with each bounce's shadow query traced
    in the bounce and no ladder.

    On the sorted pipeline a secondary bounce sorts the wavefront and reads
    the ladder, and every bounce draws its uniforms, then runs one chain --
    the cut to the rung's width, the shadow resolve and the shading, the
    splice back and the live count.  Where ``plans`` holds chain graphs for
    the wavefront (:meth:`WavefrontPlans.chains`: a Renderer's on the card,
    where :func:`chains_cover` allows) the chains run on the plan's fixed
    buffers, the sort writing one set from the other, and replay as CUDA
    graphs once captured (render/graphs.py), unless a StageTimer times the
    frame.  The frames are bit-equal either way.

    ``with_ray_count`` also returns the EXACT number of rays the traversal
    processed (live path rays per bounce + live NEE shadow rays) as an int64
    tensor -- the Mrays/s numerator.  ``timer``: a StageTimer or the
    frame's FrameTrace (render/timing.py); with it, or while a profiler
    records, the wavefront's stages run inside spans (prepare, each bounce
    and its sort, walks, uniforms, shading and host reads, restore) and the
    trace counts its shading launches and keeps its traced rays; a replayed
    chain adds what its capture recorded.  With cfg.fuse_shadow_walk each
    secondary bounce makes one ``intersect.fused`` call for its nearest hit
    and the previous bounce's shadow query.  ``plans``: the
    :class:`WavefrontPlans` that hold the wavefront's frame-invariant
    inputs (a Renderer's); without it :func:`plan_wavefront` builds them
    here."""
    check_supported(cfg)
    trace = frame_trace(timer)
    raw = intersect
    if trace is not None:
        intersect = trace.intersector(intersect)
    if cfg.fuse_shadow_walk and getattr(intersect, "fused", None) is None:
        # the reference warns and walks separately; the port computes no
        # other configuration than the one asked for
        raise ValueError("cfg.fuse_shadow_walk needs an intersector with a "
                         "fused walk (ops/hopper_traverse.py:make_cuda_intersector)")
    full_height = full_height or height
    full_width = full_width or width
    npix_full = full_height * full_width
    if cfg.noise_mode != NoiseMode.PRNG:
        if samples != 1:
            raise ValueError("sample fusion requires PRNG noise")
        sample0 = 0
    _, do_sort = _pipeline(cfg)
    eps = cfg.distance_epsilon
    dev = scene.p0.device
    spectrum = cfg.spectrum_samples
    hero = _hero(cfg)
    carried = hero or spectrum   # the planes a lane carries: C hero bins or S
    with_env = scene.env is not None
    with span(trace, "prepare"):
        plan = (plan_wavefront if plans is None else plans.get)(
            scene, cfg, camera, height, width, row0, full_height, full_width, samples,
            sample0, trace)
        graphs = None if plans is None else plans.chains(row0, samples, sample0, cfg)
        # the chains replay as graphs unless a StageTimer times the frame
        # (it synchronises inside its spans); it then runs them from here,
        # on the same buffers
        replay = graphs is not None and (trace is None or trace.timer is None)
        pids = plan.pids
        jitter = camera_jitter(cfg, fold_in(key, 0xC0FFEE), frame_index, pids,
                               full_height, full_width)
        origins, directions = camera_rays(camera, plan.camera, jitter[0:2], full_height,
                                          full_width, lens_u=jitter[2:4])
        bins = hero_bins(cfg, key, frame_index, pids) if hero else None  # (C, N)
        inputs = (origins, directions, bins)
        buf = None if graphs is None else graphs.buffers
        if buf is not None:
            # bounce 0's chain reads the camera's rays from the fixed buffers
            for dst, src in zip(buf.inputs, inputs):
                if src is not None:
                    dst.copy_(src)
            inputs = buf.inputs
        if not do_sort:
            state = initial_path_state(origins, directions, carried, pids, bins)

    def draw(b, pixel, out=None):
        with span(trace, "uniforms"):
            return bounce_uniforms(cfg, key, frame_index, b, pixel, full_height, full_width,
                                   with_env=with_env, out=out)

    def shade(b, st, uniforms, tr, isect, coherent=False, hit=None, live=None):
        return trace_bounce(scene, cfg, isect, b, st, uniforms, with_stats=True,
                            coherent=coherent, defer_shadow=do_sort, hit=hit, trace=tr,
                            live=live)

    def bounce(b, lanes):
        return span(trace, "bounce", bounce=b, lanes=lanes)

    n_lanes = pids.shape[0]
    if not do_sort:
        # bounce 0 is camera-coherent already; camera lanes all start live
        with bounce(0, n_lanes):
            state, stats = shade(0, state, draw(0, state.pixel), trace, intersect,
                                 coherent=True, live=n_lanes)
        nrays = stats["path"] + stats["shadow"]
        for b in range(1, cfg.max_path_length):
            with bounce(b, n_lanes):
                state, stats = shade(b, state, draw(b, state.pixel), trace, intersect)
            nrays = nrays + stats["path"] + stats["shadow"]
    else:
        wmin, winv = plan.bounds
        depth = cfg.max_path_length
        sizes = ladder_sizes(n_lanes, cfg)
        prefix_sort = cfg.prefix_sort and len(sizes) > 1
        skip = ({int(x) for x in cfg.sort_bounce_skip.split(",")}
                if cfg.sort_bounce_skip else set())

        def reads(b):
            """Whether the ladder reads the live lanes before bounce b: after
            each sort (every bounce with prefix sorts)."""
            return 0 < b < depth and len(sizes) > 1 and (prefix_sort or b not in skip)

        def sorts(b):
            """Whether bounce b starts with a sort of the whole wavefront
            (with prefix sorts each bounce sorts its own cut)."""
            return 0 < b < depth and not prefix_sort and b not in skip

        def stage(b, st, pk, uniforms, live, tr, isect):
            """Resolve the previous bounce's shadow pack and shade bounce
            b; with the fused walk both queries share one launch (the
            reference's two per-bounce intersection encodes,
            renderer/Renderer.mm:519-523,545-553, collapsed)."""
            fused = getattr(isect, "fused", None) if cfg.fuse_shadow_walk else None
            if fused is None:
                return shade(b, resolve_shadow(isect, st, pk, eps), uniforms, tr, isect,
                             live=live)
            hit, clear = fused(st.origin, st.direction, st.alive, pk.to_light,
                               pk.ok, pk.cap, pk.target)
            st = st._replace(
                radiance=st.radiance + torch.where(clear[None], pk.contrib, 0.0))
            return shade(b, st, uniforms, tr, isect, hit=hit, live=live)

        def chain(b, s, src, into, uniforms, live, tr, isect):
            """Bounce b on ``s`` lanes -> (the (state, pack) it leaves at
            full width, its traced rays, the live lanes counted where the
            ladder reads them next, else None): the bounce's launches after
            its sort, its ladder read and its uniforms, one graph on the
            chain graphs' path.

            Bounce 0 starts from the camera's ``inputs``, a later one from
            ``src`` cut to its ``s`` lanes.  The result is spliced back into
            the full-width (state, pack) ``into`` -- on the chain graphs'
            path always the set ``src`` is, so that the state stays in their
            buffers -- or, where None, is the full-width state itself."""
            if b == 0:
                st = initial_path_state(inputs[0], inputs[1], carried, pids, inputs[2])
                st, pk, stats = shade(0, st, uniforms, tr, isect, coherent=True,
                                      live=n_lanes)
            else:
                st, pk = (src if src[0].alive.shape[-1] == s
                          else (_prefix(src[0], s), _prefix(src[1], s)))
                st, pk, stats = stage(b, st, pk, uniforms, live, tr, isect)
            if into is not None:
                # dead suffix lanes are untouched by a bounce (every update
                # is alive-masked), so splicing the prefix back is exact
                st, pk = _splice(into[0], st), _splice(into[1], pk)
            count = None
            if reads(b + 1):
                count = torch.sum(st.alive, 0, out=None if buf is None else buf.live)
            return (st, pk), stats["path"] + stats["shadow"], count

        def step(b, rung, count):
            """The ladder before bounce b -> (the bounce's width, the rung
            after the read, the live lanes it read: every lane at bounce 0,
            None where it does not read)."""
            if b == 0:
                return n_lanes, 0, n_lanes
            live = None
            if reads(b):
                with span(trace, "host_read"):
                    live = int(count)
            s = sizes[rung]
            if live is not None:
                rung = _rung(live, sizes)
            # a skipped sort keeps the last sorted rung (a bounce only kills
            # lanes, so every live lane is still inside it); with prefix
            # sorts the bounce runs on the rung read a bounce earlier (it
            # trails the eager ladder by at most one bounce)
            return (s if prefix_sort else sizes[rung]), rung, live

        rung, count, cur, side, counters = 0, None, None, 0, []
        rows = uniform_count(with_env)
        for b in range(depth):
            with bounce(b, sizes[rung]):
                if sorts(b):
                    # one sort carries the path wavefront and the previous
                    # bounce's NEE pack (same hit point); the pack resolves
                    # after it.  It runs from here on every path, into the
                    # other set of the chain graphs' buffers
                    with span(trace, "sort"):
                        cur = sort_wavefront(cur[0], wmin, winv, cur[1],
                                             out=None if buf is None else buf.sets[1 - side])
                    side = 1 - side
                s, rung, live = step(b, rung, count)
                src = cur
                if prefix_sort and b > 0:
                    # the sort runs at the rung's width: bounce b's live
                    # lanes sit in the prefix the previous sort compacted
                    # them into, and dead lanes never revive
                    part = cur if s == n_lanes else (_prefix(cur[0], s), _prefix(cur[1], s))
                    with span(trace, "sort"):
                        src = sort_wavefront(part[0], wmin, winv, part[1])
                if buf is not None:
                    into = buf.sets[side]
                else:
                    into = None if s == n_lanes else cur
                uniforms = draw(b, pids if b == 0 else src[0].pixel[:s],
                                None if buf is None else buf.uniforms[:rows * s].view(rows, s))

                def run(tr, isect, b=b, s=s, src=src, into=into, uniforms=uniforms,
                        live=live):
                    return chain(b, s, src, into, uniforms, live, tr, isect)

                if replay:
                    # the slot's graphs were built for this cfg and scene (chains)
                    counters.append(graphs.run(
                        (b, s, raw), lambda tr, isect, run=run: run(tr, isect)[1], trace,
                        intersect, raw, live, (("shade", {"bounce": b, "lanes": s}),)))
                    cur, count = into, buf.live
                else:
                    cur, rays, count = run(trace, intersect)
                    counters.append((rays,))
        state = cur[0]
        if replay:
            # the chains' counters out of the graphs' memory, traced or not:
            # tracing adds no launch
            snap = iter(torch.stack([t for c in counters for t in c]).unbind())
            rays, counts = [], []
            for c in counters:
                rays.append(next(snap))
                counts += [next(snap) for _ in c[1:]]
            if trace is not None:
                trace.settle(rays, counts)
            nrays = sum(rays[1:], rays[0]) if with_ray_count else None
        else:
            nrays = sum((c[0] for c in counters[1:]), counters[0][0])
        # the final bounce's pack is empty by construction: NEE is gated
        # by bounce + 1 < max_path_length (renderer/Shaders.metal:158)
    if trace is not None and not replay:
        trace.rays(nrays)

    with span(trace, "restore"):
        # raster restore: lane -> (sample, pixel of this tile) is unique in
        # every pipeline and lane order, so one scatter is exact; the samples
        # then sum in order
        npix = height * width
        slot = ((state.pixel // npix_full - sample0) * npix
                + state.pixel % npix_full - row0 * full_width)
        flat = torch.zeros((spectrum, samples * npix), device=dev)
        if hero:
            # each path covered C of the S bins: add its radiance into the
            # (bin, sample, pixel) slots with the S/C inverse-coverage
            # weight.  A lane may draw one bin twice (C > S), so each hero
            # plane adds on its own, in plane order: every plane's slots are
            # distinct, and the sum is the same on any device.
            rad = state.radiance * (spectrum / hero)
            for c in range(hero):
                at = state.bins[c] * (samples * npix) + slot
                flat.view(-1)[at] += rad[c]
        else:
            flat[:, slot] = state.radiance
        planes = flat.reshape(spectrum, samples, npix).unbind(1)
        total = planes[0]
        for p in planes[1:]:
            total = total + p
        img = total.reshape(spectrum, height, width).permute(1, 2, 0)
    if with_ray_count:
        return img, nrays
    return img
