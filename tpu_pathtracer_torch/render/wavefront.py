"""The wavefront path-tracing pipeline.

The port of ``tpu_pathtracer/render/wavefront.py``: the per-frame kernel
sequence of the reference (renderer/Renderer.mm:500-585),

    rayGenerator -> [ intersect -> intersectionHandler -> shadow-intersect
                      -> lightSamplingHandler ] x MAX_PATH_LENGTH -> accumulate

as eager torch ops on component-major SoA tensors.  On the kernel path
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
from .noise import bounce_uniforms, camera_jitter, hero_bins, pids_from_order
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


def sort_wavefront(state: PathState, wmin, winv, pack: ShadowPack):
    """Re-order the wavefront and its shadow pack by the sort key
    (ops/wavefront_sort.py: dead bit, origin cell, direction bin), pixel id
    breaking ties: one int64 key ``(key << 32) | pixel`` sorted stably, then
    every plane gathered by the permutation -> (state, pack).  Hero bins
    (C, N) ride as one more plane; the TPU's sort-operand limit, which made
    the reference pack them into uint32 planes, does not apply here.  On
    CUDA tensors the key and the gather are one kernel launch each
    (csrc/wavefront_sort.cu), the gather reading pixel and alive from the
    sorted key; on the CPU their plain versions run."""
    cuda = state.alive.is_cuda
    key = (sort_ops.sort_key if cuda else sort_ops.sort_key_plain)(
        state.origin, state.direction, state.alive, state.pixel, wmin, winv)
    key, perm = torch.sort(key, stable=True)
    if cuda:
        planes = sort_ops.gather_planes([*state, *pack], perm, key, pixel=_PIXEL,
                                        alive=_ALIVE)
    else:
        planes = sort_ops.gather_planes_plain([*state, *pack], perm)
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
    config and scene (env-lit, hero and dispersive frames included);
    otherwise (the CPU, and on the card the textured and GGX frames)
    :func:`_shade_plain`."""
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
        trace.shading(bounce, state, scene, live, inline, kernel, counts[2:] or None)
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
    light, its picks and misses) as int64 tensors).  The plain version of
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
    """Write the prefix lanes back in place (the full tensors are the sort's
    fresh outputs, owned here); a None field (no hero bins) stays None."""
    for f, p in zip(full, prefix):
        if p is not None:
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


class WavefrontPlans:
    """A renderer's wavefront plans, one a (row0, samples, sample0) slot of
    its frame.  :meth:`get` hands back the slot's plan while what it was
    built from holds (the sizes, the order's tile, the noise mode and
    pipeline, the camera's angle, the scene), and otherwise builds it anew
    in place of the old one, counted in the frame's ``plan_builds``."""

    def __init__(self):
        self._held: dict[tuple, tuple] = {}

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
        if trace is not None:
            trace.plan_builds += 1
        return plan


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

    ``with_ray_count`` also returns the EXACT number of rays the traversal
    processed (live path rays per bounce + live NEE shadow rays) as an int64
    tensor -- the Mrays/s numerator.  ``timer``: a StageTimer or the
    frame's FrameTrace (render/timing.py); with it, or while a profiler
    records, the wavefront's stages run inside spans (prepare, each bounce
    and its sort, walks, uniforms, shading and host reads, restore) and the
    trace counts its shading launches and keeps its traced rays.  With
    cfg.fuse_shadow_walk each secondary bounce makes one ``intersect.fused``
    call for its nearest hit and the previous bounce's shadow query.
    ``plans``: the :class:`WavefrontPlans` that hold the wavefront's
    frame-invariant inputs (a Renderer's); without it :func:`plan_wavefront`
    builds them here."""
    check_supported(cfg)
    trace = frame_trace(timer)
    if trace is not None:
        intersect = trace.intersector(intersect)
    fused = getattr(intersect, "fused", None) if cfg.fuse_shadow_walk else None
    if cfg.fuse_shadow_walk and fused is None:
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
    with span(trace, "prepare"):
        plan = (plan_wavefront if plans is None else plans.get)(
            scene, cfg, camera, height, width, row0, full_height, full_width, samples,
            sample0, trace)
        pids = plan.pids
        jitter = camera_jitter(cfg, fold_in(key, 0xC0FFEE), frame_index, pids,
                               full_height, full_width)
        origins, directions = camera_rays(camera, plan.camera, jitter[0:2], full_height,
                                          full_width, lens_u=jitter[2:4])
        hero = (cfg.hero_wavelengths
                if spectrum > 3 and cfg.hero_wavelengths > 0 else 0)
        if hero:
            bins = hero_bins(cfg, key, frame_index, pids)  # (C, N)
            state = initial_path_state(origins, directions, hero, pids, bins)
        else:
            state = initial_path_state(origins, directions, spectrum, pids)

    def shade(b, st, coherent=False, hit=None, live=None):
        with span(trace, "uniforms"):
            uniforms = bounce_uniforms(cfg, key, frame_index, b, st.pixel, full_height,
                                       full_width, with_env=scene.env is not None)
        return trace_bounce(scene, cfg, intersect, b, st, uniforms, with_stats=True,
                            coherent=coherent, defer_shadow=do_sort, hit=hit, trace=trace,
                            live=live)

    def bounce(b, lanes):
        return span(trace, "bounce", bounce=b, lanes=lanes)

    n_lanes = state.alive.shape[0]
    if not do_sort:
        # bounce 0 is camera-coherent already; camera lanes all start live
        with bounce(0, n_lanes):
            state, stats = shade(0, state, coherent=True, live=n_lanes)
        nrays = stats["path"] + stats["shadow"]
        for b in range(1, cfg.max_path_length):
            with bounce(b, n_lanes):
                state, stats = shade(b, state)
            nrays = nrays + stats["path"] + stats["shadow"]
    else:
        wmin, winv = plan.bounds

        def stage(b, st, pk, live):
            """Resolve the previous bounce's shadow pack and shade bounce
            b; with the fused walk both queries share one launch (the
            reference's two per-bounce intersection encodes,
            renderer/Renderer.mm:519-523,545-553, collapsed)."""
            if fused is None:
                return shade(b, resolve_shadow(intersect, st, pk, eps), live=live)
            hit, clear = fused(st.origin, st.direction, st.alive, pk.to_light,
                               pk.ok, pk.cap, pk.target)
            st = st._replace(
                radiance=st.radiance + torch.where(clear[None], pk.contrib, 0.0))
            return shade(b, st, hit=hit, live=live)

        def cut(st, pk, s):
            return (st, pk) if s == sizes[0] else (_prefix(st, s), _prefix(pk, s))

        # one sort carries the next path wavefront and the previous
        # bounce's NEE pack (same hit point); the pack resolves after it
        with bounce(0, n_lanes):
            state, pack, stats = shade(0, state, coherent=True, live=n_lanes)
        nrays = stats["path"] + stats["shadow"]
        sizes = ladder_sizes(n_lanes, cfg)
        prefix_sort = cfg.prefix_sort and len(sizes) > 1
        skip = ({int(x) for x in cfg.sort_bounce_skip.split(",")}
                if cfg.sort_bounce_skip else set())
        rung = 0
        for b in range(1, cfg.max_path_length):
            live = None
            with bounce(b, sizes[rung]):
                if prefix_sort:
                    # the sort runs at the rung's width: bounce b's live
                    # lanes sit in the prefix the previous sort compacted
                    # them into, and dead lanes never revive, so the next
                    # rung is known before this sort (it trails the eager
                    # ladder by at most one bounce)
                    with span(trace, "host_read"):
                        live = int(state.alive.sum())
                    s = sizes[rung]
                    st, pk = cut(state, pack, s)
                    with span(trace, "sort"):
                        st, pk = sort_wavefront(st, wmin, winv, pk)
                    rung = _rung(live, sizes)
                else:
                    if b not in skip:
                        with span(trace, "sort"):
                            state, pack = sort_wavefront(state, wmin, winv, pack)
                        if len(sizes) > 1:
                            # every live lane sits in the sorted prefix
                            with span(trace, "host_read"):
                                live = int(state.alive.sum())
                            rung = _rung(live, sizes)
                    # a skipped sort keeps the last sorted rung: a bounce
                    # only kills lanes, so every live lane is still inside it
                    s = sizes[rung]
                    st, pk = cut(state, pack, s)
                st, pk, stats = stage(b, st, pk, live)
                nrays = nrays + stats["path"] + stats["shadow"]
                if s == sizes[0]:
                    state, pack = st, pk
                else:
                    # dead suffix lanes are untouched by a bounce (every
                    # update is alive-masked), so splicing the prefix back
                    # is exact
                    state, pack = _splice(state, st), _splice(pack, pk)
        # the final bounce's pack is empty by construction: NEE is gated
        # by bounce + 1 < max_path_length (renderer/Shaders.metal:158)
    if trace is not None:
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
