// Reference-mode megakernel (kernel C) for NVIDIA Hopper (sm_90a): one
// whole path-traced sample per ray in one launch.
//
// Replaces: strolle_tpu/ops/pallas/ref_kernel.py trace_sample_megakernel
// (_ref_megakernel_body). Per bounce: closest hit over Baldwin-Weber rows
// [T, 24] (n d0 T1 d1 T2 d2 n0 n1 n2 mat pad), material resolve, emissive,
// next-event estimation with one uniformly picked light and a
// sphere-sampled any-hit shadow ray, then the layered-BRDF continuation.
// The PCG state (uint32_t wrap-around) is stepped in exactly the order of
// the JAX package's kernel and of the plain version in
// ops/kernels/ref_kernel.py, so a pixel matches sample for sample.
//
// What bounds it on this card: operations, and of those the
// ray-triangle tests (2 x (depth + 1) x T per ray, against ~190
// operations of shading per bounce). A ray reads 28 bytes and writes 12;
// everything else stays in registers. The TPU kernel broadcast one row
// per step over (128, 128) ray planes and selected materials and lights
// with masked loops because its vector unit cannot gather. Here it is
// one thread per ray, and the design cuts what a test issues:
// - The test fuses its multiply-adds as XLA does (below), which also
//   takes about a sixth of its instructions away (PERF.md).
// - It is split in two (bw_plane, bw_inside): the shadow loop computes
//   p, u and v only where the plane lies ahead before the light (a
//   branch that a warp skips when none of its lanes needs it), and a
//   warp leaves it once all its lanes have an occluder. The operations
//   and their order are those of one whole test, so the results are
//   bit-identical. (An explicit warp vote before p, u and v, in either
//   loop, measured no faster: most warps hold a lane that needs them.)
// - The block stages only the 12 floats of each row that the test
//   reads, as three float4: a row is three 16-byte shared-memory
//   broadcasts, and 1024 rows take 48 KB, not 96 KB (twice the resident
//   blocks at the megakernel's limit). The winner's normals and material
//   are read from device memory once a bounce. Staging is a few loads per
//   thread against thousands of tests, so the grid stays one thread per
//   ray in blocks of 128; registers (64-72) allow 7-8 blocks an SM.
// Material and light rows are staged too and indexed directly.
//
// Specialisation: FLAT (all vertex normals equal and unit: no barycentric
// interpolation) and NO_METAL (no metallic material in use: the GGX lobe
// drops out; its random draws are still made) are template parameters,
// four instantiations. Dead rays keep running as in the JAX kernel, so a
// non-finite throughput propagates the same way.
//
// Floating point: built with --fmad=false and no fast math (see
// ops/kernels/cuda_lib.py), with explicit fmaf exactly where XLA:CPU
// fuses the JAX kernel's _bw_isect (and where the plain version
// emulates it); every other operation rounds as in the plain PyTorch
// version. The remaining differences against it come from library
// sinf/cosf/rsqrtf where PyTorch's CPU math differs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1.1920929e-07f;
constexpr float kNudge = 0.01f;
constexpr float kMinRoughness = static_cast<float>(0.089 * 0.089);
constexpr float kRangeUnlimited = 1e30f;
constexpr float kLightPoint = 1.0f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kInvPi = static_cast<float>(1.0 / 3.14159265358979323846);
constexpr float kF90Scale = static_cast<float>(50.0 * 0.33);
constexpr float kInvU32 = 1.0f / 4294967296.0f;  // 4294967295.0f == 2^32 in float32
constexpr int kTriWidth = 24;
constexpr int kRowQuads = 3;  // the float4 of a row that the test reads
constexpr int kMatWidth = 12;
constexpr int kLightWidth = 13;
constexpr int kThreads = 128;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 normalize3(V3 a) {
  const float inv = rsqrtf(fmaxf(a.x * a.x + a.y * a.y + a.z * a.z, 1e-20f));
  return {a.x * inv, a.y * inv, a.z * inv};
}

__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// PCG white noise: state' = state * 747796405 + 2891336453, hashed word.
__device__ __forceinline__ uint32_t next_u32(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28u) + 4u)) ^ state) * 277803737u;
  return (word >> 22u) ^ word;
}

// One round-to-nearest u32 -> f32 conversion, divided by 2^32.
__device__ __forceinline__ float next_f32(uint32_t& state) {
  return __uint2float_rn(next_u32(state)) * kInvU32;
}

// The plane part of one Baldwin-Weber test against the row's first four
// floats (n, d0): nd = n . d (Möller-Trumbore's det is -nd) and the
// distance t to the plane; plane is false where the ray runs
// parallel to it (|nd| < eps), and then no hit is possible.
__device__ __forceinline__ float bw_plane(float4 r0, V3 o, V3 d, float& nd, bool& plane) {
  nd = fmaf(r0.z, d.z, fmaf(r0.x, d.x, r0.y * d.y));
  const float no = fmaf(r0.z, o.z, fmaf(r0.x, o.x, r0.y * o.y));
  plane = !(fabsf(nd) < kEps);
  return (r0.w - no) / (plane ? nd : 1.0f);
}

// The rest of the test: the hit point p = o + t d in the row's
// barycentric planes (T1 d1, T2 d2) gives u and v; true where the
// point lies inside the triangle. A hit is plane && t > 0 && inside.
__device__ __forceinline__ bool bw_inside(float4 r1, float4 r2, V3 o, V3 d, float t,
                                          float& u, float& v) {
  const float px = fmaf(t, d.x, o.x);
  const float py = fmaf(t, d.y, o.y);
  const float pz = fmaf(t, d.z, o.z);
  u = fmaf(r1.z, pz, fmaf(r1.x, px, r1.y * py)) + r1.w;
  v = fmaf(r2.z, pz, fmaf(r2.x, px, r2.y * py)) + r2.w;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

__device__ __forceinline__ float ggx_distribution(float n_dot_h, float a) {
  const float a2 = a * a;
  const float dd = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0f;
  return a2 / (kPi * dd * dd);
}

__device__ __forceinline__ V3 specular_eval(V3 bc, float metallic, float roughness,
                                            float reflectance, V3 n, V3 l, V3 v) {
  const float a = clip(roughness, kMinRoughness, 1.0f);
  const V3 h = normalize3({l.x + v.x, l.y + v.y, l.z + v.z});
  const float n_dot_l = saturate(dot3(n, l));
  const float n_dot_h = saturate(dot3(n, h));
  const float l_dot_h = saturate(dot3(l, h));
  const float n_dot_v = saturate(dot3(n, v));
  const float d = ggx_distribution(n_dot_h, a);
  const float k = a * a / 2.0f;
  const float g = (n_dot_v / (n_dot_v * (1.0f - k) + k)) * (n_dot_l / (n_dot_l * (1.0f - k) + k));
  const float f0_base = 0.16f * reflectance * reflectance * (1.0f - metallic);
  const float f0r = f0_base + bc.x * metallic;
  const float f0g = f0_base + bc.y * metallic;
  const float f0b = f0_base + bc.z * metallic;
  const float f90 = saturate((f0r + f0g + f0b) * kF90Scale);
  const float x = fmaxf(1.0f - l_dot_h, 0.001f);
  const float x2 = x * x;
  const float p = x2 * x2 * x;
  const float scale = d * g / fmaxf(4.0f * n_dot_l * n_dot_v, 1e-8f);
  const bool ok = metallic > 0.0f && n_dot_l > 0.0f && n_dot_v > 0.0f;
  if (!ok) return {0.0f, 0.0f, 0.0f};
  return {scale * (f0r + (f90 - f0r) * p), scale * (f0g + (f90 - f0g) * p),
          scale * (f0b + (f90 - f0b) * p)};
}

template <bool FLAT, bool NO_METAL>
__global__ void __launch_bounds__(kThreads)
    ref_megakernel(const float* __restrict__ tris, int n_tris,
                   const float* __restrict__ mats, int n_mats,
                   const float* __restrict__ lights, int n_lights, int lcount,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const int64_t* __restrict__ state0, int n_rays, int depth,
                   float* __restrict__ out) {
  // three float4 per row: (n, d0), (T1, d1), (T2, d2)
  extern __shared__ float4 s_rows[];
  float* s_mat = reinterpret_cast<float*>(s_rows + kRowQuads * n_tris);
  float* s_light = s_mat + kMatWidth * n_mats;
  for (int j = threadIdx.x; j < kRowQuads * n_tris; j += blockDim.x) {
    const float* r = tris + kTriWidth * (j / kRowQuads) + 4 * (j % kRowQuads);
    s_rows[j] = make_float4(r[0], r[1], r[2], r[3]);
  }
  for (int j = threadIdx.x; j < kMatWidth * n_mats; j += blockDim.x) s_mat[j] = mats[j];
  for (int j = threadIdx.x; j < kLightWidth * n_lights; j += blockDim.x) s_light[j] = lights[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // the lanes of this warp that hold a ray: they take the warp votes
  const unsigned live = __ballot_sync(0xffffffffu, i < n_rays);
  if (i >= n_rays) return;

  V3 ro = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  V3 rd = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  uint32_t state = static_cast<uint32_t>(state0[i]);

  float col_r = 0.0f, col_g = 0.0f, col_b = 0.0f;
  float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
  bool alive = true;
  const int lc = lcount > 1 ? lcount : 1;
  const float lcount_f = static_cast<float>(lc);
  const float has_lights = lcount > 0 ? 1.0f : 0.0f;

  for (int bounce = 0; bounce <= depth; ++bounce) {
    // --- closest hit: keep the winner's index, resolve it afterwards ---
    // (strict < in ascending row order: the lowest index wins ties)
    float bt = INFINITY, bu = 0.0f, bv = 0.0f, bnd = 0.0f;
    int bi = -1;
    for (int k = 0; k < n_tris; ++k) {
      float nd, u, v;
      bool plane;
      const float t = bw_plane(s_rows[kRowQuads * k], ro, rd, nd, plane);
      const bool closer = plane && t > 0.0f && t < bt;
      const bool inside = bw_inside(s_rows[kRowQuads * k + 1], s_rows[kRowQuads * k + 2], ro,
                                    rd, t, u, v);
      if (closer && inside) {
        bt = t;
        bu = u;
        bv = v;
        bnd = nd;
        bi = k;
      }
    }
    V3 n = {0.0f, 0.0f, 0.0f};
    float mat = 0.0f;
    if (bi >= 0) {
      const float* r = tris + kTriWidth * bi;  // normals and material, once a bounce
      const float dsign = bnd <= 0.0f ? 1.0f : -1.0f;  // copysign(1, det), det = -nd
      mat = r[21];
      if (FLAT) {
        n = {r[12] * dsign, r[13] * dsign, r[14] * dsign};
      } else {
        const float w = 1.0f - bu - bv;
        n = normalize3({w * r[12] + bu * r[15] + bv * r[18],
                        w * r[13] + bu * r[16] + bv * r[19],
                        w * r[14] + bu * r[17] + bv * r[20]});
        n = {n.x * dsign, n.y * dsign, n.z * dsign};
      }
    }
    const bool is_some = bt < INFINITY;
    alive = alive && is_some;
    const float bts = is_some ? bt : 0.0f;
    const V3 p = {ro.x + rd.x * bts + n.x * kNudge, ro.y + rd.y * bts + n.y * kNudge,
                  ro.z + rd.z * bts + n.z * kNudge};

    // --- material (a miss reads material 0, as the JAX kernel does) ---
    V3 bc = {0.0f, 0.0f, 0.0f};
    float em_r = 0.0f, em_g = 0.0f, em_b = 0.0f;
    float metallic = 0.0f, roughness = NO_METAL ? 1.0f : 0.0f, reflectance = 0.0f;
    const int mi = static_cast<int>(mat);
    if (mi >= 0 && mi < n_mats && static_cast<float>(mi) == mat) {
      const float* m = s_mat + kMatWidth * mi;
      bc = {m[0], m[1], m[2]};
      em_r = m[4];
      em_g = m[5];
      em_b = m[6];
      if (!NO_METAL) {
        metallic = m[7];
        roughness = m[8];
        reflectance = m[9];
      }
    }
    if (bounce > 0 && !NO_METAL) roughness = fmaxf(roughness, 0.75f * 0.75f);

    const float alive_f = alive ? 1.0f : 0.0f;
    col_r = col_r + alive_f * thr_r * em_r;
    col_g = col_g + alive_f * thr_g * em_g;
    col_b = col_b + alive_f * thr_b * em_b;

    // --- NEE: one uniformly picked light ---
    const uint32_t lid = next_u32(state) % static_cast<uint32_t>(lc);
    float lr[kLightWidth];
#pragma unroll
    for (int c = 0; c < kLightWidth; ++c) {
      lr[c] = lid < static_cast<uint32_t>(n_lights) ? s_light[kLightWidth * lid + c] : 0.0f;
    }
    const V3 lpos = {lr[0], lr[1], lr[2]};
    const float lrad = lr[3];
    const float lcr = lr[4], lcg = lr[5], lcb = lr[6];
    const float lrange = lr[7], lkind = lr[8];
    const V3 sdir = {lr[9], lr[10], lr[11]};
    const float sangle = lr[12];

    // shadow ray from a point sampled on the light sphere toward the hit
    const float u0 = next_f32(state);
    const float u1 = next_f32(state);
    const float u2 = next_f32(state);
    const float phi = u0 * kTwoPi;
    const float cos_t = clip(u1 * 2.0f - 1.0f, -1.0f, 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
    const float rr = sqrtf(u2);
    const V3 so = {lpos.x + lrad * (rr * sin_t * cosf(phi)),
                   lpos.y + lrad * (rr * sin_t * sinf(phi)), lpos.z + lrad * (rr * cos_t)};
    const V3 th = {p.x - so.x, p.y - so.y, p.z - so.z};
    const float slen = sqrtf(fmaxf(th.x * th.x + th.y * th.y + th.z * th.z, 1e-20f));
    const V3 sd = {th.x / slen, th.y / slen, th.z / slen};
    // any hit at t < slen decides; the warp stops once all its lanes have one
    bool blocked = false;
    for (int k = 0; k < n_tris; ++k) {
      float nd, u, v;
      bool plane;
      const float t = bw_plane(s_rows[kRowQuads * k], so, sd, nd, plane);
      const bool nearer = !blocked && plane && t > 0.0f && t < slen;
      blocked = blocked || (nearer && bw_inside(s_rows[kRowQuads * k + 1],
                                                 s_rows[kRowQuads * k + 2], so, sd, t, u, v));
      if (__all_sync(live, blocked)) break;
    }
    const float occ = blocked ? 1.0f : 0.0f;

    // --- light radiance ---
    const V3 lv = {lpos.x - p.x, lpos.y - p.y, lpos.z - p.z};
    const V3 tp = normalize3({-lv.x, -lv.y, -lv.z});
    const V3 sdn = normalize3(sdir);
    const float cosang = clip(dot3(sdn, tp), -1.0f, 1.0f);
    // acos polynomial of the JAX kernel (max abs error ~1e-4), reflected
    const float ax = fabsf(cosang);
    const float poly = 1.5707288f + ax * (-0.2121144f + ax * (0.074261f - 0.0187293f * ax));
    const float acos_pos = sqrtf(fmaxf(1.0f - ax, 0.0f)) * poly;
    const float angle = cosang >= 0.0f ? acos_pos : kPi - acos_pos;
    const float q = angle / fmaxf(sangle, 1e-6f);
    const float spot_f = saturate(1.0f - q * q * q);
    const float f_angle = lkind == kLightPoint ? 1.0f : spot_f;

    const float l2 = lv.x * lv.x + lv.y * lv.y + lv.z * lv.z;
    const float inv_r2 = 1.0f / fmaxf(lrange * lrange, 1e-12f);
    const float factor = l2 * inv_r2;
    const float smooth = saturate(1.0f - factor * factor);
    const float atten = smooth * smooth / fmaxf(l2, 1e-4f);
    const float f_dist = lrange >= kRangeUnlimited ? 1.0f : atten;
    const float f_cos = saturate(dot3(n, normalize3(lv)));

    const float diff_k = (1.0f - metallic) / kPi;
    const V3 db = {bc.x * diff_k, bc.y * diff_k, bc.z * diff_k};
    const V3 v = {-rd.x, -rd.y, -rd.z};
    V3 sb = {0.0f, 0.0f, 0.0f};
    if (!NO_METAL) {
      // representative-point sphere-light specular
      const float ndv2 = dot3({-v.x, -v.y, -v.z}, n);
      const V3 r = {-v.x - 2.0f * ndv2 * n.x, -v.y - 2.0f * ndv2 * n.y,
                    -v.z - 2.0f * ndv2 * n.z};
      const float lr_dot = dot3(lv, r);
      const V3 ct = {lr_dot * r.x - lv.x, lr_dot * r.y - lv.y, lr_dot * r.z - lv.z};
      const float ct_len2 = fmaxf(ct.x * ct.x + ct.y * ct.y + ct.z * ct.z, 1e-20f);
      const float tt = saturate(lrad * rsqrtf(ct_len2));
      const V3 cl = {lv.x + ct.x * tt, lv.y + ct.y * tt, lv.z + ct.z * tt};
      const float inv_len = rsqrtf(fmaxf(cl.x * cl.x + cl.y * cl.y + cl.z * cl.z, 1e-20f));
      const float cr = clip(roughness, kMinRoughness, 1.0f);
      const float i_rough = cr / saturate(cr + lrad * 0.5f * inv_len);
      const V3 sp = {cl.x * inv_len, cl.y * inv_len, cl.z * inv_len};
      sb = specular_eval(bc, metallic, roughness, reflectance, n, sp, v);
      const float ir2 = i_rough * i_rough;
      sb = {ir2 * sb.x, ir2 * sb.y, ir2 * sb.z};
    }
    const float rad_k = f_angle * f_dist * f_cos;
    const float take = alive_f * has_lights * (1.0f - occ) * lcount_f;  // 1 / light pdf
    col_r = col_r + take * thr_r * lcr * rad_k * (db.x + sb.x);
    col_g = col_g + take * thr_g * lcg * rad_k * (db.y + sb.y);
    col_b = col_b + take * thr_b * lcb * rad_k * (db.z + sb.z);

    // --- layered BRDF continuation ---
    if (bounce < depth) {
      const float pick = next_f32(state);
      const float ra = next_f32(state);
      const float rb = next_f32(state);
      // Pixar orthonormal basis (tangent t, bitangent b) around n
      const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
      const float a_onb = -1.0f / (sign + n.z);
      const float b_onb = n.x * n.y * a_onb;
      const V3 tb = {1.0f + sign * n.x * n.x * a_onb, sign * b_onb, -sign * n.x};
      const V3 bb = {b_onb, sign + n.y * n.y * a_onb, -n.y};

      // diffuse lobe: cos_theta = ra, phi = 2 pi rb, pdf 1/pi
      const float d_cos = ra;
      const float d_sin = sqrtf(fmaxf(1.0f - d_cos * d_cos, 0.0f));
      const float dphi = kTwoPi * rb;
      const float dcp = cosf(dphi), dsp = sinf(dphi);
      V3 nd = {(tb.x * dcp + bb.x * dsp) * d_sin + n.x * d_cos,
               (tb.y * dcp + bb.y * dsp) * d_sin + n.y * d_cos,
               (tb.z * dcp + bb.z * dsp) * d_sin + n.z * d_cos};
      float pdf = kInvPi;
      V3 rad = db;
      if (!NO_METAL) {
        const bool use_spec = pick < metallic;
        // specular lobe: GGX NDF sampling
        const float a = clip(roughness, kMinRoughness, 1.0f);
        const float a2 = a * a;
        const float cos_th = sqrtf(fmaxf((1.0f - ra) / ((a2 - 1.0f) * ra + 1.0f), 0.0f));
        const float sin_th = sqrtf(fmaxf(1.0f - cos_th * cos_th, 0.0f));
        const float sphi = rb * kPi * 2.0f;
        const float cp = cosf(sphi), sp = sinf(sphi);
        const V3 h = {tb.x * (sin_th * cp) + bb.x * (sin_th * sp) + n.x * cos_th,
                      tb.y * (sin_th * cp) + bb.y * (sin_th * sp) + n.y * cos_th,
                      tb.z * (sin_th * cp) + bb.z * (sin_th * sp) + n.z * cos_th};
        const float n_dot_h = saturate(dot3(n, h));
        const float h_dot_v = saturate(dot3(h, v));
        const V3 sd2 = normalize3({2.0f * h_dot_v * h.x - v.x, 2.0f * h_dot_v * h.y - v.y,
                                   2.0f * h_dot_v * h.z - v.z});
        const float s_pdf = ggx_distribution(n_dot_h, a) * n_dot_h / fmaxf(4.0f * h_dot_v, 1e-8f);
        const V3 sr = specular_eval(bc, metallic, roughness, reflectance, n, sd2, v);
        if (use_spec) {
          nd = sd2;
          pdf = s_pdf / fmaxf(metallic, 1e-8f);
          rad = sr;
        } else {
          pdf = kInvPi / fmaxf(1.0f - metallic, 1e-8f);
        }
      }
      alive = alive && pdf > 0.0f;
      const float cosw = dot3(nd, n);
      const float scale = cosw / fmaxf(pdf, 1e-20f);
      thr_r = thr_r * scale * rad.x;
      thr_g = thr_g * scale * rad.y;
      thr_b = thr_b * scale * rad.z;
      ro = p;
      if (alive) rd = nd;
    }
  }
  out[3 * i] = col_r;
  out[3 * i + 1] = col_g;
  out[3 * i + 2] = col_b;
}

template <bool FLAT, bool NO_METAL>
cudaError_t launch(const float* tris, int n_tris, const float* mats, int n_mats,
                   const float* lights, int n_lights, int lcount, const float* o,
                   const float* d, const int64_t* state0, int n_rays, int depth, float* out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float4) * kRowQuads * static_cast<size_t>(n_tris) +
                      sizeof(float) * (static_cast<size_t>(kMatWidth) * n_mats +
                                       static_cast<size_t>(kLightWidth) * n_lights);
  auto kernel = ref_megakernel<FLAT, NO_METAL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(tris, n_tris, mats, n_mats, lights, n_lights,
                                             lcount, o, d, state0, n_rays, depth, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int strolle_trace_sample_megakernel(const float* tris, int n_tris,
                                               const float* mats, int n_mats,
                                               const float* lights, int n_lights, int lcount,
                                               const float* o, const float* d,
                                               const int64_t* state0, int n_rays, int depth,
                                               int flat, int no_metal, float* out,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flat && no_metal)
    return launch<true, true>(tris, n_tris, mats, n_mats, lights, n_lights, lcount, o, d,
                              state0, n_rays, depth, out, s);
  if (flat)
    return launch<true, false>(tris, n_tris, mats, n_mats, lights, n_lights, lcount, o, d,
                               state0, n_rays, depth, out, s);
  if (no_metal)
    return launch<false, true>(tris, n_tris, mats, n_mats, lights, n_lights, lcount, o, d,
                               state0, n_rays, depth, out, s);
  return launch<false, false>(tris, n_tris, mats, n_mats, lights, n_lights, lcount, o, d,
                              state0, n_rays, depth, out, s);
}
