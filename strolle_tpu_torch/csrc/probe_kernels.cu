// The ReSTIR DI/GI spatial neighbour probe (kernel 7), for NVIDIA Hopper
// (sm_90a): the spatial pass's one launch.
//
// Replaces: strolle_tpu/ops/pallas/probe_kernels.py
//   probe_spatial_pallas (_probe_kernel), in its "di" and "gi" modes.
//
// What it computes, one thread per pixel: up to kTries tries at shared
// per-try offsets. Try t draws one word of the pixel's PCG stream
// (seeded seed ^ 48619x ^ 95461y), picks entry sel = level * n_var +
// word % n_var of the try's table and taps the fields at the mirrored
// (y + dy[t*V + sel], x + dx[t*V + sel]). A tap on the pixel itself is
// skipped; a tap that fails the gates (no surface, |depth - centre| >
// depth_tol * centre, normal dot < normal_min) moves the pixel one radius
// level down (at most to n_lvls - 1); one that passes them with m > 0
// (and, in GI mode, a reconnection Jacobian in [j_lo, j_hi]) is accepted
// and ends the search. In GI mode the Jacobian is clamped to [c_lo, c_hi]
// (0 where none was accepted).
//
// One __global__ serves two entries:
// - The route entry (strolle_probe_route), the spatial passes' own.
//   Each block draws the offset tables from the seed into shared memory,
//   as restir/di.py::_draw_probe_tables draws them with torch on the
//   card: try t's seed is seed ^ 0x9E3779B9 (t + 1), its entry k's stream
//   is that seed ^ 48619k ^ 95461 (k / n_var); a disk sample takes
//   sqrtf of the first word's unit float and the cosine and sine of the
//   second's times float(2 pi); the offset is trunc(disk * radius[k /
//   n_var]), clamped to +-margin. It reads each field where it lies (a pointer, a
//   pixel stride and a component stride: depth, normal, is_some as the
//   bool bytes it is, m, and in GI mode v1_point, v2_point, v2_normal and
//   the surface point), and writes what restir/di.py::probe_fused
//   returns: the accepted neighbour's mirrored coordinates (0 where none),
//   found, the pixel's stream after kTries words (the kernel steps it on
//   every try) and, in GI mode, the Jacobian. Block 0 also writes its
//   tables where it is given a pointer for them (NULL on the route).
// - The stack entry (strolle_probe_spatial), the JAX kernel's contract:
//   a float32 [P, H, W] stack (planes at pixel stride 1, is_some a 0/1
//   plane), the tables given, the accepted offsets written.
//
// The TPU kernel DMAs a halo'd window of a mirror-padded stack into VMEM
// per 32x128 block and takes its tables by scalar prefetch, because its
// vector unit cannot gather. Here a thread reads its one selected tap
// straight from the fields through the mirror: no stack, no padded copy,
// no tables built by other launches. The three components of a [H, W, 3]
// field share one 32-byte sector. One thread a pixel, 256 a block, one
// block a tile of pixels; a tap's gate loads and its m go out together, so
// a try costs one round trip to L2 (GI's Jacobian loads follow only where
// the gates pass). Measured slower and dropped (PERF.md): the gate's
// is_some and depth before its normal, m after the gate, the Jacobian's
// loads with the gate, 128 threads, a persistent grid of 4 blocks an SM.
//
// What bounds it on this card: bytes. The route must read the fields
// once (21 B a pixel in DI mode, 69 B in GI) and write 17 B (21 B in GI);
// a try costs ~50 integer and fp32 operations (~120 in GI mode). The taps
// are scattered reads at up to 128 px from the pixel, served by L1 and L2
// (the fields, 10 MB or 34 MB at 800x608, fit the 50 MB L2); the
// centre's reads are coalesced. The tables cost each block 96 entries of
// two PCG words, a sqrt, a cos and a sin at the default tuning.
//
// Floating point: --fmad=false and no fast math. The tables: a word's
// unit float is its round-to-nearest float times 2^-32, exactly torch's
// float(word) / 4294967295.0 (the divisor rounds to 2^32 in float32, and
// torch's CUDA division by a CPU scalar multiplies by its reciprocal,
// 2^-32 exactly; both forms only scale by a power of two); sqrtf is the
// correctly rounded sqrt and sincosf the accurate libdevice sine and
// cosine, as torch's CUDA sqrt, sin and cos compute them on float32
// (chip_smoke.py holds block 0's tables to torch's draw on the card);
// every product is rounded on its own, as torch's one-op kernels round it. The
// normal dot is (a*b + c*d) + e*f; the Jacobian's direction is v * (1 /
// max(|v|, 1e-20)) with a correctly rounded sqrtf and division, as in the
// TPU kernel and the plain versions (ops/kernels/probe_kernels.py), so
// every output is bit-equal to the plain versions'.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLvls = 16;

// A [H, W] or [H, W, 3] field: pixel (y, x) at p + (y * w + x) * px,
// component q at q * comp past it (in elements; every offset below 2^31,
// so that a tap's address is one 32-bit multiply-add and one wide add).
struct Field {
  const void* p;
  int px;
  int comp;
};

struct Args {
  Field depth, normal, some, m, v1, v2, v2n, point;
  int h, w;
  const int* dy;  // the stack entry's tables (the route draws its own)
  const int* dx;
  uint32_t seed;
  int n_var, n_lvls, margin;
  float radii[kMaxLvls];
  float depth_tol, normal_min, j_lo, j_hi, c_lo, c_hi;
  int* out_y;  // the route: rhs_y, rhs_x; the stack entry: oy, ox
  int* out_x;
  bool* found;
  float* jac;        // GI mode only
  long long* state;  // the route only
  int* tab_out;      // the route, optional: block 0's tables, dy then dx
};

__device__ __forceinline__ uint32_t pcg_next(uint32_t* state) {
  *state = *state * 747796405u + 2891336453u;
  const uint32_t word = ((*state >> ((*state >> 28u) + 4u)) ^ *state) * 277803737u;
  return (word >> 22u) ^ word;
}

// rng.next_f32: float(word) / 4294967295.0, which is float(word) * 2^-32.
__device__ __forceinline__ float unit_f32(uint32_t word) {
  return __uint2float_rn(word) * 2.3283064365386962890625e-10f;
}

__device__ __forceinline__ float ld(const Field& f, int i, int q = 0) {
  return __ldg(static_cast<const float*>(f.p) + (i * f.px + q * f.comp));
}

template <bool kRoute>
__device__ __forceinline__ bool some_at(const Field& f, int i) {
  if (kRoute) return __ldg(static_cast<const unsigned char*>(f.p) + i * f.px) != 0;
  return __ldg(static_cast<const float*>(f.p) + i * f.px) > 0.5f;
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

// Entry k of the tables (try k / v, entry k % v of its table):
// offsets.draw_offset_table's draw under di.try_seed.
__device__ void draw_entry(const Args& a, int k, int v, int* dy, int* dx) {
  const int t = k / v;
  const int e = k - t * v;
  const int lvl = e / a.n_var;
  uint32_t s = (a.seed ^ (0x9E3779B9u * static_cast<uint32_t>(t + 1))) ^
               (48619u * static_cast<uint32_t>(e)) ^ (95461u * static_cast<uint32_t>(lvl));
  const float radius = sqrtf(unit_f32(pcg_next(&s)));
  const float angle = unit_f32(pcg_next(&s)) * static_cast<float>(6.283185307179586);
  float r = a.radii[0];  // radii[lvl] with constant indices: no copy to local memory
#pragma unroll
  for (int l = 1; l < kMaxLvls; ++l) r = l == lvl ? a.radii[l] : r;
  float sn, cs;
  sincosf(angle, &sn, &cs);  // cosf's and sinf's values, one range reduction
  const int ox = static_cast<int>((cs * radius) * r);
  const int oy = static_cast<int>((sn * radius) * r);
  dy[k] = min(max(oy, -a.margin), a.margin);
  dx[k] = min(max(ox, -a.margin), a.margin);
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

template <bool kGi, int kTries, bool kRoute>
__device__ __forceinline__ void probe_pixel(const Args& a, const int* tabs, int n_tab, int v,
                                            int i) {
  const int w = a.w;
  const int x = i % w;
  const int y = i / w;
  const float c_depth = ld(a.depth, i);
  const float c_nx = ld(a.normal, i, 0);
  const float c_ny = ld(a.normal, i, 1);
  const float c_nz = ld(a.normal, i, 2);
  float c_p[3] = {0.0f, 0.0f, 0.0f};
  if (kGi) {
#pragma unroll
    for (int q = 0; q < 3; ++q) c_p[q] = ld(a.point, i, q);
  }

  uint32_t state =
      a.seed ^ (48619u * static_cast<uint32_t>(x)) ^ (95461u * static_cast<uint32_t>(y));
  int level = 0;
  bool done = false;
  int out_y = 0;
  int out_x = 0;
  float jac_r = 0.0f;
#pragma unroll
  for (int t = 0; t < kTries; ++t) {
    const uint32_t word = pcg_next(&state);
    if (done) continue;  // nothing changes once a tap is accepted
    // word % n_var, a mask for the spatial passes' two variants
    const uint32_t var = a.n_var == 2 ? word & 1u : word % static_cast<uint32_t>(a.n_var);
    const int entry = t * v + level * a.n_var + static_cast<int>(var);
    const int oy_t = tabs[entry];
    const int ox_t = tabs[n_tab + entry];
    const int y2 = mirror(y + oy_t, a.h);
    const int x2 = mirror(x + ox_t, w);
    if (x2 == x && y2 == y) continue;
    const int j = y2 * w + x2;
    // the gate's loads and m issued together: one round trip a try
    const bool some = some_at<kRoute>(a.some, j);
    const float t_depth = ld(a.depth, j);
    const float t_m = ld(a.m, j);
    const float ndot =
        (ld(a.normal, j, 0) * c_nx + ld(a.normal, j, 1) * c_ny) + ld(a.normal, j, 2) * c_nz;
    const bool gate_fail =
        !some || fabsf(t_depth - c_depth) > a.depth_tol * c_depth || ndot < a.normal_min;
    if (gate_fail) {
      level = min(level + 1, a.n_lvls - 1);
      continue;
    }
    if (!(t_m > 0.0f)) continue;
    if (kGi) {
      float v1[3], v2[3], n2[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        v1[q] = ld(a.v1, j, q);
        v2[q] = ld(a.v2, j, q);
        n2[q] = ld(a.v2n, j, q);
      }
      float nd, nc, od, oc;
      jacobian_part(c_p[0], c_p[1], c_p[2], v2, n2, &nd, &nc);
      jacobian_part(v1[0], v1[1], v1[2], v2, n2, &od, &oc);
      const float xj = (nc * od) * od;
      const float yj = (oc * nd) * nd;
      float jv = yj == 0.0f ? 0.0f : xj / yj;
      const bool exists = v2[0] != 0.0f || v2[1] != 0.0f || v2[2] != 0.0f;
      jv = exists ? jv : 1.0f;
      if (!(jv >= a.j_lo && jv <= a.j_hi)) continue;
      jac_r = clamp_nan(jv, a.c_lo, a.c_hi);
    }
    out_y = kRoute ? y2 : oy_t;
    out_x = kRoute ? x2 : ox_t;
    done = true;
  }
  a.out_y[i] = out_y;
  a.out_x[i] = out_x;
  a.found[i] = done;
  if (kGi) a.jac[i] = jac_r;
  if (kRoute) a.state[i] = static_cast<long long>(state);
}

template <bool kGi, int kTries, bool kRoute>
__global__ void __launch_bounds__(kThreads) probe_kernel(const Args a) {
  extern __shared__ int tabs[];  // dy [n_tab], then dx [n_tab]
  const int v = a.n_lvls * a.n_var;
  const int n_tab = kTries * v;
  for (int k = threadIdx.x; k < n_tab; k += blockDim.x) {
    if (kRoute) {
      draw_entry(a, k, v, tabs, tabs + n_tab);
    } else {
      tabs[k] = a.dy[k];
      tabs[n_tab + k] = a.dx[k];
    }
  }
  __syncthreads();
  if (kRoute && a.tab_out != nullptr && blockIdx.x == 0) {
    for (int k = threadIdx.x; k < 2 * n_tab; k += blockDim.x) a.tab_out[k] = tabs[k];
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.h * a.w) probe_pixel<kGi, kTries, kRoute>(a, tabs, n_tab, v, i);
}

template <bool kGi, int kTries, bool kRoute>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int blocks = (a.h * a.w + kThreads - 1) / kThreads;
  const size_t smem = 2 * sizeof(int) * kTries * a.n_lvls * a.n_var;
  probe_kernel<kGi, kTries, kRoute><<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool kRoute>
cudaError_t dispatch(bool gi, int tries, const Args& a, cudaStream_t s) {
  if (a.h * a.w == 0) return cudaSuccess;
  if (a.n_var < 1 || a.n_lvls < 1 || a.n_lvls > kMaxLvls) return cudaErrorInvalidValue;
#define STROLLE_PROBE_CASE(T)                                         \
  case T:                                                             \
    return gi ? launch<true, T, kRoute>(a, s) : launch<false, T, kRoute>(a, s);
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

Args gates(int h, int w, uint32_t seed, int n_var, int n_lvls, float depth_tol, float normal_min,
           float j_lo, float j_hi, float c_lo, float c_hi, int* out_y, int* out_x, bool* found,
           float* jac) {
  Args a = {};
  a.h = h;
  a.w = w;
  a.seed = seed;
  a.n_var = n_var;
  a.n_lvls = n_lvls;
  a.depth_tol = depth_tol;
  a.normal_min = normal_min;
  a.j_lo = j_lo;
  a.j_hi = j_hi;
  a.c_lo = c_lo;
  a.c_hi = c_hi;
  a.out_y = out_y;
  a.out_x = out_x;
  a.found = found;
  a.jac = jac;
  return a;
}

}  // namespace

// The stack entry: a float32 [P, H, W] stack (P = 6 in DI mode, 18 in
// GI; 3 H W below 2^31), tables of tries * n_lvls * n_var entries each; 1 <= tries <= 8
// (the reference's most) and n_lvls <= 16, else cudaErrorInvalidValue.
// jac is NULL in DI mode.
extern "C" int strolle_probe_spatial(const float* stack, int h, int w, const int* dy,
                                     const int* dx, uint32_t seed, int gi, int tries, int n_var,
                                     int n_lvls, float depth_tol, float normal_min, float j_lo,
                                     float j_hi, float c_lo, float c_hi, int* oy, int* ox,
                                     bool* found, float* jac, void* stream) {
  Args a = gates(h, w, seed, n_var, n_lvls, depth_tol, normal_min, j_lo, j_hi, c_lo, c_hi, oy,
                 ox, found, gi ? jac : nullptr);
  const long long n = static_cast<long long>(h) * w;
  if (3 * n >= (1ll << 31)) return cudaErrorInvalidValue;
  auto plane = [&](int k) { return Field{stack + k * n, 1, static_cast<int>(n)}; };
  a.depth = plane(0);
  a.normal = plane(1);
  a.some = plane(4);
  a.m = plane(5);
  if (gi) {
    a.v1 = plane(6);
    a.v2 = plane(9);
    a.v2n = plane(12);
    a.point = plane(15);
  }
  a.dy = dy;
  a.dx = dx;
  return dispatch<false>(gi != 0, tries, a, static_cast<cudaStream_t>(stream));
}

// The route entry. fields (host memory): 8 rows of (pointer, pixel
// stride, component stride) for depth, normal, is_some (bool bytes), m,
// v1_point, v2_point, v2_normal and point (the last four read in GI mode
// only), each field's offsets below 2^31 elements; radii (host memory):
// n_lvls floats. Writes rhs_x, rhs_y (int32), found, state (int64, the
// stream after `tries` words), jac (NULL in DI mode) and, where tab_out
// is not NULL, block 0's tables (int32 [2, tries * n_lvls * n_var]: dy,
// then dx).
extern "C" int strolle_probe_route(const long long* fields, int h, int w, uint32_t seed, int gi,
                                   int tries, int n_var, int n_lvls, const float* radii,
                                   int margin, float depth_tol, float normal_min, float j_lo,
                                   float j_hi, float c_lo, float c_hi, int* rhs_x, int* rhs_y,
                                   bool* found, long long* state, float* jac, int* tab_out,
                                   void* stream) {
  if (n_lvls < 1 || n_lvls > kMaxLvls) return cudaErrorInvalidValue;
  Args a = gates(h, w, seed, n_var, n_lvls, depth_tol, normal_min, j_lo, j_hi, c_lo, c_hi, rhs_y,
                 rhs_x, found, gi ? jac : nullptr);
  Field* f[8] = {&a.depth, &a.normal, &a.some, &a.m, &a.v1, &a.v2, &a.v2n, &a.point};
  for (int k = 0; k < 8; ++k) {
    *f[k] = Field{reinterpret_cast<const void*>(fields[3 * k]),
                  static_cast<int>(fields[3 * k + 1]), static_cast<int>(fields[3 * k + 2])};
  }
  for (int k = 0; k < n_lvls; ++k) a.radii[k] = radii[k];
  a.margin = margin;
  a.state = state;
  a.tab_out = tab_out;
  return dispatch<true>(gi != 0, tries, a, static_cast<cudaStream_t>(stream));
}
