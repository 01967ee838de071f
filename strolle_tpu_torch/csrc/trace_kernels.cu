// Brute-force closest-hit (kernel A), any-hit (kernel B) and closest hit
// with the surface attributes resolved (kernel 4) for NVIDIA Hopper
// (sm_90a).
//
// Replaces: strolle_tpu/ops/pallas/trace_kernels.py
//   trace_closest_brute_pallas (_brute_closest_kernel),
//   trace_anyhit_brute_pallas (_brute_anyhit_kernel) and
//   trace_surface_pallas (_surface_closest_kernel).
//
// What they compute: for every ray, Möller-Trumbore against all packed
// [T, 12] rows (v0, e1, e2, pad). A: the closest hit (t, tri, u, v),
// t = +inf and tri = -1 on a miss, the lowest index winning ties
// (strict < in ascending order). B: whether any row is hit at t < t_max.
//
// What bounds them on this card: operations. Each ray-triangle test is
// about 40 fp32 operations on 24 bytes of ray, reused against every row,
// so at Cornell size (40 rows) the work is ~50x the bytes at the card's
// fp32 balance. The TPU kernel tiled rays into (128, 128) planes to keep
// its vector unit dense and broadcast one row per step; here it is one
// thread per ray (the ragged tail masked), and the block copies rows into
// shared memory, so every row read in the loop is a broadcast from shared
// memory that all 32 lanes of a warp take in one go. A and B take any row
// count, as the JAX kernels do: they stage the rows in tiles of kTileRows
// (48 KB), every thread of the block running every tile's load and both
// barriers. Kernel 4 copies all its rows at once: it takes at most 1024,
// as the JAX package routes it.
//
// B, redesigned for this card: any hit is order-free, so a ray may stop
// at its first occluder and skip what cannot make a hit. Its test
// (mt_front, mt_back) computes the second half of Möller-Trumbore only
// where the determinant and u pass, its rows are read as float4, and a
// warp leaves the row loop once all its lanes are done, the block the
// tile loop once all its warps are. (The whole test per row with each
// lane leaving on its own measured 16% slower, PERF.md.)
//
// Floating point: built with --fmad=false and no fast math (see
// ops/kernels/cuda_lib.py), with explicit fmaf exactly where the plain
// version (ops/intersect.py) fuses (moller_trumbore.cuh, and B's own
// test in the same operations); each operation then rounds as there, so
// t is bit-identical to it and tri equal, coplanar ties included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moller_trumbore.cuh"
#include "resolve.cuh"
#include "smem.cuh"

namespace {

using strolle::allow_smem;
using strolle::moller_trumbore;
using strolle::MtHit;
using strolle::resolve_surface;

constexpr int kRowWidth = 12;
constexpr int kGeomWidth = 28;
constexpr int kThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;  // kThreads is a multiple of 32
// Rows of A's and B's shared-memory tile: 48 KB of [*, 12] rows.
constexpr int kTileRows = 1024;

__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    closest_brute_kernel(const float* __restrict__ rows, int n_rows,
                         const float* __restrict__ o, const float* __restrict__ d,
                         int n_rays, float* __restrict__ t_out,
                         int* __restrict__ tri_out, float* __restrict__ u_out,
                         float* __restrict__ v_out) {
  extern __shared__ float s_rows[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (valid) {
    ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  }
  float bt = INFINITY, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  for (int first = 0; first < n_rows; first += kTileRows) {
    const int count = min(kTileRows, n_rows - first);
    __syncthreads();  // the previous tile's tests are done
    load_rows(s_rows, rows + static_cast<size_t>(first) * kRowWidth, count * kRowWidth);
    if (!valid) continue;
    for (int k = 0; k < count; ++k) {
      const MtHit h = moller_trumbore(s_rows + k * kRowWidth, ox, oy, oz, dx, dy, dz);
      if (h.t < bt) {
        bt = h.t;
        btri = first + k;
        bu = h.u;
        bv = h.v;
      }
    }
  }
  if (!valid) return;
  t_out[i] = bt;
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
}

// Kernel B's test of one row against one ray, in moller_trumbore()'s
// operations and order (so each value is bit-identical to its), in two
// parts: mt_front computes the determinant and u, mt_back the rest, and
// a lane runs mt_back only where mt_front passes (a branch that a warp
// skips when none of its lanes passes). The row is three float4 of
// shared memory, (v0, e1.x), (e1.y, e1.z, e2.x, e2.y), (e2.z, pad).
struct MtFront {
  float px, py, pz, inv_det, u, tx, ty, tz;
  bool pass;  // |det| >= eps and 0 <= u <= 1
};

__device__ __forceinline__ MtFront mt_front(float4 a, float4 b, float4 c, float ox, float oy,
                                            float oz, float dx, float dy, float dz) {
  MtFront f;
  // pvec = d x e2
  f.px = fmaf(dy, c.x, -(dz * b.w));
  f.py = fmaf(dz, b.z, -(dx * c.x));
  f.pz = fmaf(dx, b.w, -(dy * b.z));
  const float det = fmaf(b.y, f.pz, fmaf(b.x, f.py, a.w * f.px));
  f.inv_det = fabsf(det) < strolle::kEps ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  f.tx = ox - a.x, f.ty = oy - a.y, f.tz = oz - a.z;
  f.u = fmaf(f.tz, f.pz, fmaf(f.ty, f.py, f.tx * f.px)) * f.inv_det;
  f.pass = fabsf(det) >= strolle::kEps && f.u >= 0.0f && f.u <= 1.0f;
  return f;
}

// True where the ray hits the row at t < tm, given mt_front's pass.
__device__ __forceinline__ bool mt_back(const MtFront& f, float4 a, float4 b, float4 c,
                                        float dx, float dy, float dz, float tm) {
  // qvec = tvec x e1
  const float qx = fmaf(f.ty, b.y, -(f.tz * b.x));
  const float qy = fmaf(f.tz, a.w, -(f.tx * b.y));
  const float qz = fmaf(f.tx, b.x, -(f.ty * a.w));
  const float v = fmaf(dz, qz, fmaf(dy, qy, dx * qx)) * f.inv_det;
  const float t = fmaf(c.x, qz, fmaf(b.w, qy, b.z * qx)) * f.inv_det;
  return v >= 0.0f && f.u + v <= 1.0f && t > 0.0f && t < tm;
}

// Any hit is order-free: a ray is occluded if any row is hit at
// t < t_max. A warp leaves a tile's row loop once every lane has an
// occluder (a lane without a ray counts as done), and the block leaves
// the tile loop once all its warps have.
__global__ void __launch_bounds__(kThreads)
    anyhit_brute_kernel(const float* __restrict__ rows, int n_rows,
                        const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ t_max, int n_rays,
                        bool* __restrict__ occluded) {
  extern __shared__ float4 s_quads[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f, tm = 0.0f;
  if (valid) {
    ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    tm = t_max[i];
  }
  bool done = !valid;
  for (int first = 0; first < n_rows; first += kTileRows) {
    // a barrier (the previous tile's tests are done) that also tells
    // whether any ray of the block still looks for an occluder
    if (!__syncthreads_or(!done)) break;
    const int count = min(kTileRows, n_rows - first);
    load_rows(reinterpret_cast<float*>(s_quads), rows + static_cast<size_t>(first) * kRowWidth,
              count * kRowWidth);
    if (__all_sync(kFullWarp, done)) continue;
    for (int k = 0; k < count; ++k) {
      const float4 a = s_quads[3 * k], b = s_quads[3 * k + 1], c = s_quads[3 * k + 2];
      const MtFront f = mt_front(a, b, c, ox, oy, oz, dx, dy, dz);
      done = done || (f.pass && mt_back(f, a, b, c, dx, dy, dz, tm));
      if (__all_sync(kFullWarp, done)) break;
    }
  }
  if (valid) occluded[i] = done;
}

__global__ void __launch_bounds__(kThreads)
    surface_closest_kernel(const float* __restrict__ rows, int n_rows,
                           const float* __restrict__ o, const float* __restrict__ d,
                           int n_rays, float* __restrict__ t_out,
                           int* __restrict__ tri_out, float* __restrict__ u_out,
                           float* __restrict__ v_out, float* __restrict__ normal_out,
                           float* __restrict__ uv_out, int* __restrict__ mat_out) {
  extern __shared__ float s_rows[];
  load_rows(s_rows, rows, n_rows * kGeomWidth);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float bt = INFINITY, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  for (int k = 0; k < n_rows; ++k) {
    const MtHit h = moller_trumbore(s_rows + k * kGeomWidth, ox, oy, oz, dx, dy, dz);
    if (h.t < bt) {
      bt = h.t;
      btri = k;
      bu = h.u;
      bv = h.v;
    }
  }
  // A miss resolves to zeros, as the TPU kernel's where-selects leave it.
  float n[3] = {0.0f, 0.0f, 0.0f}, uv[2] = {0.0f, 0.0f};
  int mat = 0;
  if (btri >= 0) resolve_surface(s_rows + btri * kGeomWidth, dx, dy, dz, bu, bv, n, uv, &mat);
  t_out[i] = bt;
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
  normal_out[3 * i] = n[0];
  normal_out[3 * i + 1] = n[1];
  normal_out[3 * i + 2] = n[2];
  uv_out[2 * i] = uv[0];
  uv_out[2 * i + 1] = uv[1];
  mat_out[i] = mat;
}

// Shared memory of A's and B's row tile.
size_t tile_bytes(int n_rows) {
  return sizeof(float) * kRowWidth * static_cast<size_t>(n_rows < kTileRows ? n_rows : kTileRows);
}

}  // namespace

extern "C" int strolle_trace_closest_brute(const float* rows, int n_rows, const float* o,
                                           const float* d, int n_rays, float* t, int* tri,
                                           float* u, float* v, void* stream) {
  const size_t smem = tile_bytes(n_rows);
  cudaError_t err = allow_smem(closest_brute_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  closest_brute_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, o, d, n_rays, t, tri, u, v);
  return cudaGetLastError();
}

extern "C" int strolle_trace_anyhit_brute(const float* rows, int n_rows, const float* o,
                                          const float* d, const float* t_max, int n_rays,
                                          bool* occluded, void* stream) {
  const size_t smem = tile_bytes(n_rows);
  cudaError_t err = allow_smem(anyhit_brute_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  anyhit_brute_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, o, d, t_max, n_rays, occluded);
  return cudaGetLastError();
}


extern "C" int strolle_trace_surface(const float* rows, int n_rows, const float* o,
                                     const float* d, int n_rays, float* t, int* tri,
                                     float* u, float* v, float* normal, float* uv,
                                     int* mat, void* stream) {
  const size_t smem = sizeof(float) * kGeomWidth * static_cast<size_t>(n_rows);
  cudaError_t err = allow_smem(surface_closest_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  surface_closest_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, o, d, n_rays, t, tri, u, v, normal, uv, mat);
  return cudaGetLastError();
}
