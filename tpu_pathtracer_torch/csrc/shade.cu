// The shading of one bounce in one launch: NEE (the light pick, the solid-
// angle pdf, the material eval and the power heuristic), the BSDF-arm MIS on
// emitter hits, the next bounce's BSDF sample and the throughput update, for
// the four parity materials, one thread a lane; with the environment light's
// arms of both (the alias-table sample and the lat-long eval), hero
// wavelength bins and the dispersive per-bin Fresnel weights.
//
// Replaces a stage that XLA fused on the TPU: tpu_pathtracer/render/
// wavefront.py's trace_bounce after its intersect (:455-760), with
// models/bsdf.py's eval_material, sample_bounce and dispersion_weights
// (:126-188, :274), models/envlight.py's sample_env and eval_env (:155-185)
// and the warps of core/sampling.py.  The port's plain version
// (render/wavefront.py:_shade_plain) issues some 300 elementwise torch
// launches a bounce.
//
// Coverage: what ops/shade.py:shade_kernel_covers admits, every frame but
// those with a roughness table (the GGX types) or textures, at 1 to
// kMaxSpectrum carried planes (C under hero sampling, S otherwise); the
// environment light, hero bins and dispersion each on or off;
// reference_quirks, refract_dielectric and cull_zero_nee on or off, the last
// bounce's NEE gate.  refract_dielectric with dispersion is refused by the
// wrapper, as the plain version refuses it.
//
// Contract: bit-equal to the plain version on the card.  Every value keeps
// the plain version's operation order (dot = (x*x + y*y) + z*z; left-to-right
// products and quotients), --fmad=false keeps each multiply and add apart as
// torch's one-operation kernels do, division and sqrtf are IEEE, normalize is
// v * rsqrtf(dot(v, v)) as torch.rsqrt, cosf, sinf, atan2f and acosf are the
// CUDA math library's as torch.cos, torch.sin, torch.atan2 and torch.acos,
// the clamps propagate NaN as torch.clamp does, the light pick is
// torch.searchsorted's upper-bound loop, a float-to-int32 cast is
// __float2int_rz as ATen's (truncating; NaN to 0), and every constant that
// torch folds from a Python double arrives as the float32 it rounds to
// (ops/shade.py:folded_constants); a float32 tensor divided by a Python
// scalar is, on CUDA, ATen's multiply by the float32 reciprocal, so those
// arrive as reciprocals.  The selects are the plain version's torch.where
// chains, so a NaN in an arm that is not taken stays out; the env sample is
// drawn only where NEE picks the env.  The env eval of the BSDF arm adds
// radiance * throughput * weight on every lane, the weight +0 on a lane whose
// ray did not miss, and that product still reaches the radiance (the sign of
// a zero, a NaN).  Where the map is clean (every entry finite with its sign
// bit clear, at most env_radiance_max; +inf for any other map) and
// env_radiance_max * throughput is finite, radiance * throughput is finite
// with the throughput's sign, so
// the product is throughput * +0 bit for bit: such a lane reads no texel and
// computes no texel index (tests/test_torch_shade_kernel.py holds the
// identity case by case).  Any other lane reads its texel as before.
//
// What bounds it on an H100: bytes.  A lane reads 113 + 8 C bytes (the
// state, the hit record, six uniform rows) and writes 62 + 12 C (the new
// state and the shadow pack; the inline form 12 more for the shadow origin):
// 235 bytes at C = S = 3, 487 MB on 2,073,600 lanes, 0.145 ms at 3.35 TB/s.
// Hero bins add 8 C a lane; the environment light its four uniform rows (16),
// on each live lane that missed the texel its eval reads (4 + 4 C), and on
// the lanes whose NEE picks the env the alias slot (12) and the sampled texel
// (4 + 4 C).  Its ~300
// float32 operations a lane (about 100 more with the env's transcendentals)
// are below that.  The design: one thread a lane, one kernel instance a
// feature set (env, hero, dispersion: a parity frame runs none of the
// others' code or registers), every plane read and written once by
// consecutive lanes (coalesced), the scene tables (a few hundred bytes) read
// through the cache, no shared memory; the bounce's two counts are block sums
// (__syncthreads_count) added into int64 counts with one atomic a block; so
// are, in the env-lit instances, the lanes whose NEE picked the env and the
// live lanes whose ray missed (what the bound prices, chip_smoke.shade_bound).
// The env's tables (megabytes, past L2 at S = 16) are gathered where a
// lane's texel falls, so what the env costs is scattered 32-byte sectors: a
// lane reads them as the records models/envlight.py:env_records derives once
// a map, not as the reference's planes (alias_p, alias_i, pdf_sa and one
// radiance row a plane: 3 + C sectors a pick, 1 + C a miss).  A pick reads
// its slot's record (16 bytes: the threshold, the alias and the pdf of
// either texel, so no pdf read waits on the texel) and then the chosen
// texel's record, its S bins side by side: 2 sectors at S = 3 (one 16-byte
// load with the pdf), 3 at S = 16 (a 64-byte record); a miss its texel's
// record (1 sector at S = 3; at S = 16 2, and the pdf plane).  The same
// floats from other addresses: the result stays bit-equal.
// chip_smoke.env_sectors counts the sectors; the measured share of the
// bound: PERF.md section 6, the table of the XLA-fused stages.
#include <cuda_runtime.h>

// Everything one launch reads and writes (ops/shade.py:_ShadeParams mirrors
// it field for field).  Planes are contiguous: a (k, n) plane's row r starts
// at r * n.  Outside the anonymous namespace: the extern "C" launcher takes
// it, and a type of internal linkage would hide the launcher's symbol.
struct ShadeParams {
  // the path state
  const float* origin;         // (3, n)
  const float* direction;      // (3, n)
  const float* throughput;     // (s, n): s planes, C under hero sampling, else S
  const float* radiance;       // (s, n)
  const float* pdf;            // (n,)
  const float* prev_diffuse;   // (n,)
  const float* ior;            // (n,)
  const unsigned char* alive;  // (n,) bool
  // the hit record
  const float* t;
  const long long* tri;
  const long long* mat;
  const long long* light;
  const float* pos;     // (3, n)
  const float* normal;  // (3, n)
  // the bounce's uniform rows
  const float* light_select;
  const float* light_bary0;
  const float* light_bary1;
  const float* lobe;
  const float* bounce_dir0;
  const float* bounce_dir1;
  // the scene tables
  const float* mat_diffuse;      // (S, m)
  const float* mat_emissive;     // (S, m)
  const float* mat_ior;          // (m,)
  const long long* mat_type;     // (m,)
  const float* light_cdf;        // (num_lights + 1,)
  const float* light_p;          // (3 vertices, 3, num_lights + 1)
  const float* light_n;          // (3 vertices, 3, num_lights + 1)
  const float* light_pdf;        // (num_lights + 1,)
  const float* light_area;       // (num_lights + 1,)
  const long long* light_tri;    // (num_lights + 1,)
  const float* light_emissive;   // (S, num_lights + 1)
  // the environment light (null without one), as models/envlight.py:
  // env_records derives it once a map: one record a texel, (env_h * env_w,
  // env_texel_stride) floats, its S radiance bins side by side and its
  // solid-angle pdf at column env_pdf_col (-1: none there); one record an
  // alias slot, (env_h * env_w, 4) 32-bit words: alias_p's bits, alias_i,
  // the pdf of the slot's texel and of its alias; the pdf (env_h * env_w,),
  // read where a texel's record holds none; select_p and the rotation (0-d
  // tensors, read on the card: no host sync)
  const float* env_texel_rec;
  const int* env_alias_rec;
  const float* env_pdf;
  const float* env_select_p;
  const float* env_rotation;
  // the env's uniform rows (null without an env)
  const float* env_select;
  const float* env_alias;
  const float* env_jit0;
  const float* env_jit1;
  // hero sampling: each lane's table rows, (s, n); null reads row c for plane c
  const long long* bins;
  // dispersion: the per-bin material IoR (S, m); null without
  const float* mat_ior_bins;
  // the new state
  float* out_origin;
  float* out_direction;
  float* out_throughput;
  float* out_radiance;
  float* out_pdf;
  float* out_prev_diffuse;
  float* out_ior;
  unsigned char* out_alive;
  // the shadow pack
  float* to_light;        // (3, n)
  float* cap;
  long long* target;
  float* contrib;         // (s, n)
  unsigned char* ok;
  float* shadow_origin;   // (3, n) in the inline form, else null
  // [live path lanes, live shadow lanes, env picks, env misses]; the env
  // counts only in the kEnv instances (0 in the others)
  unsigned long long* stats;
  int n, s, m, num_lights, env_h, env_w, env_texel_stride, env_pdf_col;
  float eps, aeps, four_eps, inv_pi, two_pi, pdf_floor;
  // the env's constants (models/envlight.py's PI is numpy's pi, not
  // config.py's 3.1415926) and the dispersion weights' floor, as torch
  // rounds them (ops/shade.py:folded_constants)
  float env_pi, env_two_pi, env_inv_two_pi, env_pi_recip, env_cap, disp_floor, inv_env_h,
      inv_env_w, env_hf, env_wf, env_kf;
  int last_bounce, quirks, refract, cull_zero_nee;
  int env, hero, dispersion;
  // the env radiance table's largest entry when every entry is finite with
  // its sign bit clear (models/envlight.py:radiance_max), else +inf (every
  // lane then reads its texel)
  float env_radiance_max;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSpectrum = 16;  // ops/shade.py:MAX_SPECTRUM

// Material type enum (models/bsdf.py).
constexpr long long kDiffuse = 0;
constexpr long long kMirror = 1;
constexpr long long kPlastic = 2;
constexpr long long kDielectric = 3;
constexpr long long kRoughPlastic = 5;
constexpr long long kRoughDielectric = 6;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, size_t n, size_t i) {
  return {p[i], p[n + i], p[2 * n + i]};
}

__device__ __forceinline__ void store3(float* p, size_t n, size_t i, V3 v) {
  p[i] = v.x;
  p[n + i] = v.y;
  p[2 * n + i] = v.z;
}

// core/math3d.py:dot, (a0*b0 + a1*b1) + a2*b2.
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// core/math3d.py:reflect, i - (2 * dot(n, i)) * n.
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  const float k = 2.0f * dot(n, i);
  return {i.x - k * n.x, i.y - k * n.y, i.z - k * n.z};
}

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// models/bsdf.py:_select4 on the type.
template <typename T>
__device__ __forceinline__ T select4(long long mtype, T diffuse, T mirror, T plastic,
                                     T dielectric) {
  return mtype == kDiffuse ? diffuse
         : mtype == kMirror ? mirror
         : mtype == kPlastic ? plastic
                             : dielectric;
}

// core/sampling.py:balance_heuristic (the power heuristic; 0/0 gives 0).
__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float f2 = f * f;
  const float g2 = g * g;
  const float d = f2 + g2;
  return d > 0.0f ? f2 / d : 0.0f;
}

// models/bsdf.py:fresnel; ``i`` points away from the surface.
__device__ __forceinline__ float fresnel(V3 n, V3 i, float eta_out, float eta_in) {
  const float eta_scale = eta_out / eta_in;
  const float cos_i = clamp_nan(dot(n, i), -1.0f, 1.0f);
  const float sin_t_sq = (eta_scale * eta_scale) * (1.0f - cos_i * cos_i);
  const float cos_t = sqrtf(clamp_min(1.0f - sin_t_sq, 0.0f));
  const float r_s = (eta_in * cos_i - eta_out * cos_t) / (eta_in * cos_i + eta_out * cos_t);
  const float r_p = (eta_in * cos_t - eta_out * cos_i) / (eta_in * cos_t + eta_out * cos_i);
  return sin_t_sq < 1.0f ? 0.5f * (r_s * r_s + r_p * r_p) : 1.0f;
}

// core/sampling.py:generate_diffuse_bounce (the cosine-hemisphere warp with
// the branchless ONB of build_orthonormal_basis).
__device__ __forceinline__ V3 diffuse_bounce(float u0, float u1, V3 n, float two_pi) {
  const float cos_theta = sqrtf(u1);
  const float phi = u0 * two_pi;
  const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
  const bool negz = n.z < 0.0f;
  const float a = 1.0f / (negz ? 1.0f - n.z : 1.0f + n.z);
  const float b = n.x * n.y * a;
  const V3 u = {1.0f - n.x * n.x * a, -b, negz ? n.x : -n.x};
  const V3 v = {negz ? b : -b, negz ? n.y * n.y * a - 1.0f : 1.0f - n.y * n.y * a, -n.y};
  const float c = cosf(phi);
  const float s = sinf(phi);
  return {(u.x * c + v.x * s) * sin_theta + n.x * cos_theta,
          (u.y * c + v.y * s) * sin_theta + n.y * cos_theta,
          (u.z * c + v.z * s) * sin_theta + n.z * cos_theta};
}

// torch.searchsorted(cdf, xi, right=True) over cdf[0 .. len): ATen's
// upper-bound loop, NaN included.
__device__ __forceinline__ long long upper_bound(const float* cdf, long long len, float xi) {
  long long lo = 0, hi = len;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (!(cdf[mid] > xi)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// models/bsdf.py:dispersion_weights for one bin: ``f_h`` is the scalar
// Fresnel at the same eta_out, ``second`` the lobe it chose (f_h < lobe_u).
__device__ __forceinline__ float dispersion_weight(long long mtype, V3 n, V3 i, float eta_out,
                                                   float ior_bin, float f_h, bool second,
                                                   float floor) {
  const float f_b = fresnel(n, i, eta_out, ior_bin);
  const float w_spec = f_b / clamp_min(f_h, floor);
  const float w_sec = (1.0f - f_b) / clamp_min(1.0f - f_h, floor);
  const bool has_fresnel_lobe = mtype == kPlastic || mtype == kDielectric ||
                                mtype == kRoughPlastic || mtype == kRoughDielectric;
  return has_fresnel_lobe ? (second ? w_sec : w_spec) : 1.0f;
}

// models/envlight.py:_texel_dir: the jittered direction inside texel ``idx``.
__device__ __forceinline__ V3 env_texel_dir(const ShadeParams& p, int idx, float ju,
                                            float jv, float rotation) {
  const int ti = idx / p.env_w, tj = idx % p.env_w;
  const float v = (static_cast<float>(ti) + jv) * p.inv_env_h;
  const float u = (static_cast<float>(tj) + ju) * p.inv_env_w;
  const float theta = v * p.env_pi;
  const float phi = u * p.env_two_pi - p.env_pi + rotation;
  const float sin_t = sinf(theta);
  return {sin_t * cosf(phi), cosf(theta), sin_t * sinf(phi)};
}

// models/envlight.py:texel_index: the flat nearest texel toward ``d``.
__device__ __forceinline__ int env_texel_index(const ShadeParams& p, V3 d, float rotation) {
  const float phi = atan2f(d.z, d.x) - rotation;
  float u = (phi + p.env_pi) * p.env_inv_two_pi;
  u = u - floorf(u);
  const float v = acosf(clamp_nan(d.y, -1.0f, 1.0f)) * p.env_pi_recip;
  const int j = min(max(__float2int_rz(u * p.env_wf), 0), p.env_w - 1);
  const int i = min(max(__float2int_rz(v * p.env_hf), 0), p.env_h - 1);
  return i * p.env_w + j;
}

// Texel ``idx``'s record as one 16-byte load where it is four floats (S <= 3
// with its pdf) and ``kVec``, else zeros: env_word then reads the record word
// by word.  The hero instances (S > 3: C of S bins a lane) take no vector.
template <bool kVec>
__device__ __forceinline__ float4 env_record4(const ShadeParams& p, long long idx) {
  return kVec && p.env_texel_stride == 4
             ? __ldg(reinterpret_cast<const float4*>(p.env_texel_rec) + idx)
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Word ``col`` of texel ``idx``'s record (``rec``: env_record4 of it).
template <bool kVec>
__device__ __forceinline__ float env_word(const ShadeParams& p, long long idx, size_t col,
                                          float4 rec) {
  if (kVec && p.env_texel_stride == 4) {
    return col == 0 ? rec.x : col == 1 ? rec.y : col == 2 ? rec.z : rec.w;
  }
  return __ldg(p.env_texel_rec + idx * p.env_texel_stride + col);
}

// Texel ``idx``'s solid-angle pdf: from its record, or the pdf plane.
template <bool kVec>
__device__ __forceinline__ float env_texel_pdf(const ShadeParams& p, long long idx, float4 rec) {
  return p.env_pdf_col < 0 ? __ldg(p.env_pdf + idx)
                           : env_word<kVec>(p, idx, p.env_pdf_col, rec);
}

// One instance per feature set (the env light, hero bins, dispersion): a
// frame's kernel carries only the arithmetic and registers its features need.
// Blocks an SM (ptxas -v, PERF.md section 6): four (64 registers) for every
// instance but the env light's without hero bins, which runs three (80
// registers).  At four the parity and hero forms ran 11% and 15% faster than
// at the 72-96 registers ptxas chooses.  With the records the env instances
// without hero bins spilled 232-344 bytes at 64 registers and spill none or
// 40 at 80, where the env-lit form runs 2.3% faster; the hero instances with
// the env spill 60-184 bytes at 64 registers and spilled none at 72-80, yet
// ran 3% slower there.  Texel and slot indices are 32-bit (the hero form with the env 2%
// faster than at 64-bit); the record's address is 64-bit.
constexpr int blocks_per_sm(bool env, bool hero) { return env && !hero ? 3 : 4; }

template <bool kEnv, bool kHero, bool kDispersion>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kEnv, kHero))
    shade_bounce_kernel(ShadeParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  bool counted_path = false, counted_shadow = false, counted_pick = false,
       counted_miss = false;
  if (lane < p.n) {
    const size_t n = p.n, i = lane;
    const float eps = p.eps, aeps = p.aeps;
    const bool alive = p.alive[i] != 0;
    const float t = p.t[i];
    // a hit nearer than eps, or a miss, kills the path
    const bool valid = alive && isfinite(t) && t >= eps;
    const long long tri = valid ? p.tri[i] : 0;
    const long long mat = p.mat[i];
    const float m_ior = p.mat_ior[mat];
    const long long m_type = p.mat_type[mat];
    const V3 hp = load3(p.pos, n, i);
    const V3 hn = load3(p.normal, n, i);
    const V3 o = load3(p.origin, n, i);
    const V3 w_i = load3(p.direction, n, i);
    const float lobe_u = p.lobe[i];
    const float pdf_in = p.pdf[i];
    const float ior_in = p.ior[i];
    const size_t lrow = static_cast<size_t>(p.num_lights) + 1;

    // ---- next-event estimation ----
    const long long li = upper_bound(p.light_cdf + 1, p.num_lights, p.light_select[i]);
    const float r1 = sqrtf(p.light_bary0[i]);
    const float r2 = p.light_bary1[i];
    const float w0 = 1.0f - r1, w1 = r1 * (1.0f - r2), w2 = r1 * r2;
    V3 lp, lnv;
    {
      const float* P = p.light_p + li;
      const float* N = p.light_n + li;
      lp.x = P[0 * lrow] * w0 + P[3 * lrow] * w1 + P[6 * lrow] * w2;
      lp.y = P[1 * lrow] * w0 + P[4 * lrow] * w1 + P[7 * lrow] * w2;
      lp.z = P[2 * lrow] * w0 + P[5 * lrow] * w1 + P[8 * lrow] * w2;
      lnv.x = N[0 * lrow] * w0 + N[3 * lrow] * w1 + N[6 * lrow] * w2;
      lnv.y = N[1 * lrow] * w0 + N[4 * lrow] * w1 + N[7 * lrow] * w2;
      lnv.z = N[2 * lrow] * w0 + N[5 * lrow] * w1 + N[8 * lrow] * w2;
    }
    const float rn = rsqrtf(dot(lnv, lnv));
    const V3 ln = {lnv.x * rn, lnv.y * rn, lnv.z * rn};
    const V3 tlf = {lp.x - hp.x, lp.y - hp.y, lp.z - hp.z};
    const float dist = sqrtf(dot(tlf, tlf));
    const float dcl = clamp_min(dist, 1e-30f);
    const V3 to_light = {tlf.x / dcl, tlf.y / dcl, tlf.z / dcl};
    const float l_dot_d = -dot(to_light, ln);
    const bool dir_ok = dist >= eps && l_dot_d >= aeps;
    const float light_pdf =
        dir_ok ? p.light_pdf[li] * (dist * dist) / (p.light_area[li] * l_dot_d) : 0.0f;
    long long target = p.light_tri[li];
    float shadow_cap = dist + p.four_eps;
    V3 nee_dir = to_light;
    float nee_pdf = light_pdf;
    bool not_self = target != tri;

    // ---- the env arm of the unified NEE over {area lights, env}: the lane
    // samples the env with probability select_p (models/envlight.py:
    // sample_env), each arm's pdf carries its selection probability, env
    // samples below the horizon are gated out, and an env shadow ray is
    // unbounded with target -1 ----
    const float sel_p = kEnv ? *p.env_select_p : 0.0f;
    const float rotation = kEnv ? *p.env_rotation : 0.0f;
    const bool use_env = kEnv && p.env_select[i] < sel_p;
    int e_idx = 0;
    float4 e_rec = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (use_env) {
      const int k = p.env_h * p.env_w;
      const float x = p.env_alias[i] * p.env_kf;
      const int slot = min(max(__float2int_rz(x), 0), k - 1);
      const float frac = x - static_cast<float>(slot);
      // the alias slot's record in one load, then the chosen texel's
      const int4 a = __ldg(reinterpret_cast<const int4*>(p.env_alias_rec) + slot);
      const bool take = frac >= __int_as_float(a.x);
      e_idx = take ? a.y : slot;
      e_rec = env_record4<!kHero>(p, e_idx);
      nee_dir = env_texel_dir(p, e_idx, p.env_jit0[i], p.env_jit1[i], rotation);
      nee_pdf = __int_as_float(take ? a.w : a.z) * sel_p;
      not_self = dot(nee_dir, hn) > 0.0f;
      shadow_cap = p.env_cap;
      target = -1;
    } else if (kEnv) {
      nee_pdf = light_pdf * (1.0f - sel_p);
    }

    // models/bsdf.py:eval_material toward the NEE sample
    const V3 mirror_dir = reflect(w_i, hn);
    const V3 wneg = neg(w_i);
    float nee_bsdf, nee_mpdf;
    const float cos_l = dot(nee_dir, hn);
    // the scalar Fresnel at eta_out = 1 and its lobe choice (the dispersion
    // weights of the NEE arm reuse both)
    const float f_nee = fresnel(hn, wneg, 1.0f, m_ior);
    const bool second_nee = f_nee < lobe_u;
    {
      const bool is_mirror_dir = fabsf(dot(mirror_dir, nee_dir) - 1.0f) < aeps;
      const float mirror_bsdf = is_mirror_dir ? cos_l : 0.0f;
      const float diffuse_val = p.inv_pi * cos_l;
      nee_bsdf = select4(m_type, diffuse_val, mirror_bsdf,
                         second_nee ? diffuse_val : mirror_bsdf, second_nee ? 0.0f : mirror_bsdf);
      nee_mpdf = select4(m_type, diffuse_val, 1.0f, second_nee ? diffuse_val : 1.0f,
                         second_nee ? 0.0f : 1.0f);
    }
    const float nee_weight = power_heuristic(nee_pdf, nee_mpdf);
    bool light_ok = valid && nee_pdf > 0.0f && not_self;
    if (p.last_bounce) light_ok = false;
    if (!p.quirks) light_ok = light_ok && cos_l > 0.0f;
    const float nee_scale = light_ok ? nee_weight * nee_bsdf / nee_pdf : 0.0f;

    // ---- BSDF-arm MIS on emitter hits ----
    const long long lti = p.light[i];
    const bool is_light = valid && lti >= 0;
    const long long lts = is_light ? lti : p.num_lights;
    const V3 tef = {hp.x - o.x, hp.y - o.y, hp.z - o.z};
    const float e_dist = sqrtf(dot(tef, tef));
    const float ecl = clamp_min(e_dist, 1e-30f);
    const V3 to_emitter = {tef.x / ecl, tef.y / ecl, tef.z / ecl};
    const float e_cos = -dot(to_emitter, hn);
    const bool e_ok = e_dist >= eps && e_cos >= aeps;
    float emit_lpdf = e_ok && is_light
                          ? p.light_pdf[lts] * (e_dist * e_dist) /
                                clamp_min(p.light_area[lts] * e_cos, 1e-30f)
                          : 0.0f;
    // NEE reaches an emitter point with density light_pdf * (1 - select_p)
    if (kEnv) emit_lpdf = emit_lpdf * (1.0f - sel_p);
    const float prev_diffuse = p.prev_diffuse[i];
    emit_lpdf = prev_diffuse * emit_lpdf;
    const float emit_weight = power_heuristic(pdf_in, emit_lpdf);
    const float emit_factor = p.quirks ? emit_weight * pdf_in : emit_weight;
    const float emit_scale = is_light ? emit_factor : 0.0f;
    // the env seen by a live lane whose ray escaped (models/envlight.py:
    // eval_env), MIS-weighted against the env arm of NEE; on any other lane
    // the weight is +0 and the texel (index -1: not yet computed) is read
    // only where that product is not throughput * +0 (the header comment)
    const bool miss = kEnv && alive && !isfinite(t);
    int m_idx = -1;
    float4 m_rec = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float env_weight = 0.0f;
    if (miss) {
      m_idx = env_texel_index(p, w_i, rotation);
      m_rec = env_record4<!kHero>(p, m_idx);
      env_weight = power_heuristic(
          pdf_in, prev_diffuse * sel_p * env_texel_pdf<!kHero>(p, m_idx, m_rec));
    }

    // ---- models/bsdf.py:sample_bounce ----
    const V3 diffuse_dir = diffuse_bounce(p.bounce_dir0[i], p.bounce_dir1[i], hn, p.two_pi);
    const float mirror_cos = p.quirks ? dot(mirror_dir, hn) : 1.0f;
    const float diffuse_val = p.inv_pi * dot(diffuse_dir, hn);
    const float f_bounce = fresnel(hn, wneg, ior_in, m_ior);
    const bool second = f_bounce < lobe_u;
    V3 diel_dir;
    float diel_bsdf, diel_ior;
    if (!p.refract) {
      // straight-through transmission
      diel_dir = sel(second, w_i, mirror_dir);
      diel_bsdf = second ? 1.0f : mirror_cos;
      diel_ior = second ? m_ior : ior_in;
    } else {
      // Snell-bent transmission, two-sided normals, air outside
      const bool entering = dot(w_i, hn) < 0.0f;
      const V3 n_f = sel(entering, hn, neg(hn));
      const float eta_t = entering ? m_ior : 1.0f;
      const float f_r = fresnel(n_f, wneg, ior_in, eta_t);
      const float eta = ior_in / clamp_min(eta_t, 1e-6f);
      const float cos_i = -dot(w_i, n_f);
      const float sin_t_sq = eta * eta * clamp_min(1.0f - cos_i * cos_i, 0.0f);
      const float cos_t = sqrtf(clamp_min(1.0f - sin_t_sq, 0.0f));
      const float k = eta * cos_i - cos_t;
      const V3 refr = {eta * w_i.x + k * n_f.x, eta * w_i.y + k * n_f.y,
                       eta * w_i.z + k * n_f.z};
      const bool dsl = f_r < lobe_u;
      const V3 refl = reflect(w_i, n_f);
      const float refl_w = p.quirks ? dot(refl, n_f) : 1.0f;
      diel_dir = sel(dsl, refr, refl);
      diel_bsdf = dsl ? eta * eta : refl_w;
      diel_ior = dsl ? eta_t : ior_in;
    }
    const V3 w_o = select4(m_type, diffuse_dir, mirror_dir,
                           sel(second, diffuse_dir, mirror_dir), diel_dir);
    const float nb_bsdf = select4(m_type, diffuse_val, mirror_cos,
                                  second ? diffuse_val : mirror_cos, diel_bsdf);
    const float nb_pdf = select4(m_type, diffuse_val, 1.0f, second ? diffuse_val : 1.0f, 1.0f);
    const float nb_ior = select4(m_type, ior_in, ior_in, ior_in, diel_ior);
    const float nb_finite = m_type == kDiffuse ? 1.0f : 0.0f;
    const float safe_pdf = fabsf(nb_pdf) > p.pdf_floor ? nb_pdf : p.pdf_floor;
    const float bounce_scale = nb_bsdf / safe_pdf;

    // ---- the spectral planes: NEE contribution, radiance, throughput; under
    // hero sampling plane c reads the tables at the lane's bin (not unrolled:
    // unrolled by 4 the hero form with the env ran 12% slower, and at nvcc's
    // choice the parity instance spilled 36 bytes and ran 2.5% slower) ----
    bool any_contrib = false;
#pragma unroll 1
    for (int c = 0; c < p.s; ++c) {
      const size_t at = c * n + i;
      const size_t row = kHero ? static_cast<size_t>(p.bins[at]) : c;
      const float m_diffuse = p.mat_diffuse[row * p.m + mat];
      const float m_emissive = p.mat_emissive[row * p.m + mat];
      const float thr = p.throughput[at];
      const float nee_emit =
          use_env ? env_word<!kHero>(p, e_idx, row, e_rec) : p.light_emissive[row * lrow + li];
      float contrib = nee_emit * m_diffuse * thr * nee_scale;
      float scale = m_diffuse * bounce_scale;
      if (kDispersion) {
        // the NEE arm at the reference's eta_out = 1, the bounce arm at the
        // ray's tracked IoR
        const float ior_bin = p.mat_ior_bins[row * p.m + mat];
        contrib = contrib * dispersion_weight(m_type, hn, wneg, 1.0f, ior_bin, f_nee,
                                              second_nee, p.disp_floor);
        scale = scale * dispersion_weight(m_type, hn, wneg, ior_in, ior_bin, f_bounce, second,
                                          p.disp_floor);
      }
      p.contrib[at] = contrib;
      any_contrib = any_contrib || contrib != 0.0f;
      float emit = m_emissive * thr * emit_scale;
      if (kEnv) {
        if (miss || !isfinite(p.env_radiance_max * thr)) {
          if (m_idx < 0) {
            m_idx = env_texel_index(p, w_i, rotation);
            m_rec = env_record4<!kHero>(p, m_idx);
          }
          emit = emit + env_word<!kHero>(p, m_idx, row, m_rec) * thr * env_weight;
        } else {
          emit = emit + thr * 0.0f;
        }
      }
      p.out_radiance[at] = p.radiance[at] + emit;
      p.out_throughput[at] = valid ? thr * scale : thr;
    }
    // a shadow ray whose contribution is exactly zero in every plane is
    // culled (cfg.cull_zero_nee)
    if (p.cull_zero_nee) light_ok = light_ok && any_contrib;

    // ---- the new state and the shadow pack ----
    float off = eps;
    if (p.refract) off = dot(w_o, hn) < 0.0f ? -eps : eps;
    store3(p.out_origin, n, i,
           valid ? V3{hp.x + off * hn.x, hp.y + off * hn.y, hp.z + off * hn.z} : o);
    store3(p.out_direction, n, i, valid ? w_o : w_i);
    p.out_pdf[i] = valid ? nb_pdf : pdf_in;
    p.out_prev_diffuse[i] = valid ? nb_finite : prev_diffuse;
    p.out_ior[i] = valid ? nb_ior : ior_in;
    p.out_alive[i] = valid;
    store3(p.to_light, n, i, nee_dir);
    p.cap[i] = shadow_cap;
    p.target[i] = target;
    p.ok[i] = light_ok;
    if (p.shadow_origin != nullptr) {
      store3(p.shadow_origin, n, i,
             {hp.x + hn.x * eps, hp.y + hn.y * eps, hp.z + hn.z * eps});
    }
    counted_path = alive;
    counted_shadow = light_ok;
    counted_pick = use_env;
    counted_miss = miss;
  }
  const int paths = __syncthreads_count(counted_path);
  const int shadows = __syncthreads_count(counted_shadow);
  const int picks = kEnv ? __syncthreads_count(counted_pick) : 0;
  const int misses = kEnv ? __syncthreads_count(counted_miss) : 0;
  if (threadIdx.x == 0) {
    if (paths) atomicAdd(p.stats, static_cast<unsigned long long>(paths));
    if (shadows) atomicAdd(p.stats + 1, static_cast<unsigned long long>(shadows));
    if (picks) atomicAdd(p.stats + 2, static_cast<unsigned long long>(picks));
    if (misses) atomicAdd(p.stats + 3, static_cast<unsigned long long>(misses));
  }
}

using ShadeKernel = void (*)(ShadeParams);

// the instances, indexed by env * 4 + hero * 2 + dispersion
const ShadeKernel kShadeKernels[8] = {
    shade_bounce_kernel<false, false, false>, shade_bounce_kernel<false, false, true>,
    shade_bounce_kernel<false, true, false>,  shade_bounce_kernel<false, true, true>,
    shade_bounce_kernel<true, false, false>,  shade_bounce_kernel<true, false, true>,
    shade_bounce_kernel<true, true, false>,   shade_bounce_kernel<true, true, true>};

}  // namespace

// params: a host ShadeParams (ops/shade.py:_ShadeParams); zeroes the four
// counts, then launches over params->n lanes.
extern "C" int tpupt_shade_bounce(const ShadeParams* params, void* stream) {
  const ShadeParams p = *params;
  if (p.s < 1 || p.s > kMaxSpectrum || p.n < 0 || (p.hero && p.bins == nullptr) ||
      (p.dispersion && p.mat_ior_bins == nullptr) ||
      (p.env && (p.env_texel_rec == nullptr || p.env_alias_rec == nullptr || p.env_h < 1 ||
                 p.env_w < 1 || p.env_texel_stride < 1 || p.env_texel_stride % 4 != 0 ||
                 p.env_pdf_col >= p.env_texel_stride ||
                 (p.env_pdf_col < 0 && p.env_pdf == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(p.stats, 0, 4 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.n > 0) {
    const ShadeKernel kernel =
        kShadeKernels[(p.env ? 4 : 0) + (p.hero ? 2 : 0) + (p.dispersion ? 1 : 0)];
    kernel<<<(p.n + kThreads - 1) / kThreads, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
