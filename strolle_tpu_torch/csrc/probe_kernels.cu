// The ReSTIR DI/GI spatial neighbour probe (kernel 7), for NVIDIA Hopper
// (sm_90a).
//
// Replaces: strolle_tpu/ops/pallas/probe_kernels.py
//   probe_spatial_pallas (_probe_kernel), in its "di" and "gi" modes.
//
// What it computes, one thread per pixel: up to kTries tries at shared
// per-try offsets. Try t draws one word of the pixel's PCG stream
// (seeded seed ^ 48619x ^ 95461y), picks entry sel = level * n_var +
// word % n_var of the try's table and taps every plane of the [P, H, W]
// stack at the mirrored (y + dy[t*V + sel], x + dx[t*V + sel]). A tap on
// the pixel itself is skipped; a tap that fails the gates (no surface,
// |depth - centre| > depth_tol * centre, normal dot < normal_min) moves
// the pixel one radius level down (at most to n_lvls - 1); one that
// passes them with m > 0 (and, in GI mode, a reconnection Jacobian in
// [j_lo, j_hi]) is accepted and ends the search. Writes oy, ox (0 where
// none was accepted), found and, in GI mode, the Jacobian clamped to
// [c_lo, c_hi] (0 where none).
//
// The TPU kernel DMAs a halo'd window of a mirror-padded stack into VMEM
// per 32x128 block, and per try slices all V candidate taps out of it and
// selects each pixel's with a mask: its vector unit cannot gather. Here a
// thread reads its one selected tap per plane straight from the unpadded
// stack through the mirror (no padded copy, no 8/128 alignment pad); the
// tables (2 x tries x V ints, 768 bytes at the default tuning) sit in
// shared memory.
//
// What bounds it on this card: bytes. It must read the stack once (24 B
// per pixel in DI mode, 72 B in GI) and write 9 B (13 B in GI) per pixel;
// a try costs ~50 integer and fp32 operations (~120 in GI mode). The taps
// are scattered reads at up to 128 px from the pixel, served by L1 and L2
// (the stack, 11.7 MB or 35 MB at 800x608, fits the 50 MB L2); the
// centre's planes are coalesced.
//
// Floating point: --fmad=false and no fast math. The normal dot is
// (a*b + c*d) + e*f; the Jacobian's direction is v * (1 / max(|v|, 1e-20))
// with a correctly rounded sqrtf and division, as in the TPU kernel and
// the plain version (ops/kernels/probe_kernels.py), so every output is
// bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pcg_next(uint32_t* state) {
  *state = *state * 747796405u + 2891336453u;
  const uint32_t word = ((*state >> ((*state >> 28u) + 4u)) ^ *state) * 277803737u;
  return (word >> 22u) ^ word;
}

// camera.contain_xy on one axis, then clamped on screen (a no-op for taps
// within the margin).
__device__ __forceinline__ int mirror(int v, int n) {
  v = v < 0 ? -v : v;
  v = v >= n ? 2 * n - v - 1 : v;
  return min(max(v, 0), n - 1);
}

// torch.clamp: a NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// (distance, saturated cosine) of point p seen from the v2 vertex.
__device__ __forceinline__ void jacobian_part(float px, float py, float pz, const float* v2,
                                              const float* n2, float* dist, float* cosine) {
  const float vx = px - v2[0];
  const float vy = py - v2[1];
  const float vz = pz - v2[2];
  const float d = sqrtf((vx * vx + vy * vy) + vz * vz);
  const float inv = 1.0f / (isnan(d) ? d : fmaxf(d, 1e-20f));
  const float c = (n2[0] * (vx * inv) + n2[1] * (vy * inv)) + n2[2] * (vz * inv);
  *dist = d;
  *cosine = clamp_nan(c, 0.0f, 1.0f);
}

template <bool kGi, int kTries>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ stack, int h, int w, const int* __restrict__ dy_tab,
             const int* __restrict__ dx_tab, uint32_t seed, int n_var, int n_lvls,
             float depth_tol, float normal_min, float j_lo, float j_hi, float c_lo, float c_hi,
             int* __restrict__ oy_out, int* __restrict__ ox_out, bool* __restrict__ found_out,
             float* __restrict__ jac_out) {
  extern __shared__ int tabs[];  // dy [n_tab], then dx [n_tab]
  const int v = n_lvls * n_var;
  const int n_tab = kTries * v;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) {
    tabs[k] = dy_tab[k];
    tabs[n_tab + k] = dx_tab[k];
  }
  __syncthreads();
  const int n = h * w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = i % w;
  const int y = i / w;
  const size_t plane = static_cast<size_t>(n);
  const float* centre = stack + i;
  const float c_depth = __ldg(centre);
  const float c_nx = __ldg(centre + plane);
  const float c_ny = __ldg(centre + 2 * plane);
  const float c_nz = __ldg(centre + 3 * plane);
  float c_p[3] = {0.0f, 0.0f, 0.0f};
  if (kGi) {
#pragma unroll
    for (int q = 0; q < 3; ++q) c_p[q] = __ldg(centre + (15 + q) * plane);
  }

  uint32_t state = seed ^ (48619u * static_cast<uint32_t>(x)) ^ (95461u * static_cast<uint32_t>(y));
  int level = 0;
  bool done = false;
  int oy_r = 0;
  int ox_r = 0;
  float jac_r = 0.0f;
#pragma unroll
  for (int t = 0; t < kTries; ++t) {
    const uint32_t word = pcg_next(&state);
    if (done) continue;  // nothing changes once a tap is accepted
    const int entry = t * v + level * n_var + static_cast<int>(word % static_cast<uint32_t>(n_var));
    const int oy_t = tabs[entry];
    const int ox_t = tabs[n_tab + entry];
    const int y2 = mirror(y + oy_t, h);
    const int x2 = mirror(x + ox_t, w);
    if (x2 == x && y2 == y) continue;
    const float* tap = stack + static_cast<size_t>(y2) * w + x2;
    const float t_depth = __ldg(tap);
    const bool depth_bad = fabsf(t_depth - c_depth) > depth_tol * c_depth;
    const float ndot =
        (__ldg(tap + plane) * c_nx + __ldg(tap + 2 * plane) * c_ny) + __ldg(tap + 3 * plane) * c_nz;
    const bool gate_fail = !(__ldg(tap + 4 * plane) > 0.5f) || depth_bad || ndot < normal_min;
    if (gate_fail) {
      level = min(level + 1, n_lvls - 1);
      continue;
    }
    if (!(__ldg(tap + 5 * plane) > 0.0f)) continue;
    if (kGi) {
      float v1[3], v2[3], n2[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        v1[q] = __ldg(tap + (6 + q) * plane);
        v2[q] = __ldg(tap + (9 + q) * plane);
        n2[q] = __ldg(tap + (12 + q) * plane);
      }
      float nd, nc, od, oc;
      jacobian_part(c_p[0], c_p[1], c_p[2], v2, n2, &nd, &nc);
      jacobian_part(v1[0], v1[1], v1[2], v2, n2, &od, &oc);
      const float xj = (nc * od) * od;
      const float yj = (oc * nd) * nd;
      float j = yj == 0.0f ? 0.0f : xj / yj;
      const bool exists = v2[0] != 0.0f || v2[1] != 0.0f || v2[2] != 0.0f;
      j = exists ? j : 1.0f;
      if (!(j >= j_lo && j <= j_hi)) continue;
      jac_r = clamp_nan(j, c_lo, c_hi);
    }
    oy_r = oy_t;
    ox_r = ox_t;
    done = true;
  }
  oy_out[i] = oy_r;
  ox_out[i] = ox_r;
  found_out[i] = done;
  if (kGi) jac_out[i] = jac_r;
}

template <bool kGi, int kTries>
cudaError_t launch(const float* stack, int h, int w, const int* dy, const int* dx, uint32_t seed,
                   int n_var, int n_lvls, float depth_tol, float normal_min, float j_lo,
                   float j_hi, float c_lo, float c_hi, int* oy, int* ox, bool* found, float* jac,
                   cudaStream_t s) {
  const int n = h * w;
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = 2 * sizeof(int) * kTries * n_lvls * n_var;
  probe_kernel<kGi, kTries><<<blocks, kThreads, smem, s>>>(
      stack, h, w, dy, dx, seed, n_var, n_lvls, depth_tol, normal_min, j_lo, j_hi, c_lo, c_hi,
      oy, ox, found, jac);
  return cudaGetLastError();
}

template <bool kGi>
cudaError_t launch_tries(int tries, const float* stack, int h, int w, const int* dy,
                         const int* dx, uint32_t seed, int n_var, int n_lvls, float depth_tol,
                         float normal_min, float j_lo, float j_hi, float c_lo, float c_hi,
                         int* oy, int* ox, bool* found, float* jac, cudaStream_t s) {
#define STROLLE_PROBE_CASE(T)                                                                 \
  case T:                                                                                     \
    return launch<kGi, T>(stack, h, w, dy, dx, seed, n_var, n_lvls, depth_tol, normal_min,   \
                          j_lo, j_hi, c_lo, c_hi, oy, ox, found, jac, s);
  switch (tries) {
    STROLLE_PROBE_CASE(1)
    STROLLE_PROBE_CASE(2)
    STROLLE_PROBE_CASE(3)
    STROLLE_PROBE_CASE(4)
    STROLLE_PROBE_CASE(5)
    STROLLE_PROBE_CASE(6)
    STROLLE_PROBE_CASE(7)
    STROLLE_PROBE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef STROLLE_PROBE_CASE
}

}  // namespace

// The tables hold tries * n_lvls * n_var entries each; 1 <= tries <= 8
// (the reference's most), else cudaErrorInvalidValue. jac is NULL in DI
// mode.
extern "C" int strolle_probe_spatial(const float* stack, int h, int w, const int* dy,
                                     const int* dx, uint32_t seed, int gi, int tries, int n_var,
                                     int n_lvls, float depth_tol, float normal_min, float j_lo,
                                     float j_hi, float c_lo, float c_hi, int* oy, int* ox,
                                     bool* found, float* jac, void* stream) {
  if (h * w == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gi) {
    return launch_tries<true>(tries, stack, h, w, dy, dx, seed, n_var, n_lvls, depth_tol,
                              normal_min, j_lo, j_hi, c_lo, c_hi, oy, ox, found, jac, s);
  }
  return launch_tries<false>(tries, stack, h, w, dy, dx, seed, n_var, n_lvls, depth_tol,
                             normal_min, j_lo, j_hi, c_lo, c_hi, oy, ox, found, nullptr, s);
}
