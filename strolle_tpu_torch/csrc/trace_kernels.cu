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
// barriers. B leaves its loop at the first occluder, which does not change
// its answer, and the block stops loading tiles once all its rays are
// done. Kernel 4 copies all its rows at once: it takes at most 1024, as
// the JAX package routes it.
//
// Floating point: built with --fmad=false and no fast math (see
// ops/kernels/cuda_lib.py), with explicit fmaf exactly where the plain
// version (ops/intersect.py) fuses (moller_trumbore.cuh); each operation
// then rounds as there, so t is bit-identical to it and tri equal,
// coplanar ties included.

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

__global__ void __launch_bounds__(kThreads)
    anyhit_brute_kernel(const float* __restrict__ rows, int n_rows,
                        const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ t_max, int n_rays,
                        bool* __restrict__ occluded) {
  extern __shared__ float s_rows[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f, tm = 0.0f;
  if (valid) {
    ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    tm = t_max[i];
  }
  bool occ = false;
  for (int first = 0; first < n_rows; first += kTileRows) {
    // a barrier (the previous tile's tests are done) that also tells
    // whether any ray of the block still looks for an occluder
    if (!__syncthreads_or(valid && !occ)) break;
    const int count = min(kTileRows, n_rows - first);
    load_rows(s_rows, rows + static_cast<size_t>(first) * kRowWidth, count * kRowWidth);
    if (!valid || occ) continue;
    for (int k = 0; k < count; ++k) {
      if (moller_trumbore(s_rows + k * kRowWidth, ox, oy, oz, dx, dy, dz).t < tm) {
        occ = true;
        break;
      }
    }
  }
  if (valid) occluded[i] = occ;
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
