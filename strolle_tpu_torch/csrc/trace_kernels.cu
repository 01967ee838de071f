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
// 4: A's closest hit over [T, 28] rows, then the winner's normal, uv and
// material id (resolve.cuh).
//
// What bounds them on this card: operations. Each ray-triangle test is
// about 40 fp32 operations on 24 bytes of ray, reused against every row,
// so at Cornell size (40 rows) the work is ~50x the bytes at the card's
// fp32 balance. The TPU kernel tiled rays into (128, 128) planes to keep
// its vector unit dense and broadcast one row per step; here a warp holds
// 32 rays and the block copies rows into shared memory, so every row
// read in the loop is a broadcast from shared memory that all 32 lanes
// take in one go. A and B take any row count, as the JAX kernels do: they
// stage the rows in tiles of kTileRows (48 KB). Kernel 4 copies all its
// rows at once: it takes at most 1024, as the JAX package routes it.
//
// The split test (split_test.cuh, which the cluster kernels 8 and 9
// share): few ray-row pairs pass the first half of Möller-Trumbore
// (|det| >= eps and 0 <= u <= 1: 13.7% of Cornell's primaries against its
// rows, 0.6% of random rays against the dungeon's), so the rest is
// computed only where it passes, in branches that a warp skips once none
// of its lanes passes (84% of Cornell's (warp, row) pairs, 85% of the
// dungeon's). B's test (mt_front, mt_back) stops at the
// first occluder. A's and 4's (closest_rows) also drop a row before the
// division where the exact test is certain to reject it, and compute v
// only where t beats the best hit: 21, 31, 49 or 62 instructions a row
// where a warp leaves at one of those steps, 74 where it runs them all,
// against the whole test's 70 before (PERF.md). Rows are read as float4.
//
// A and 4 share closest_rows, A over [T, 12] tiles, 4 over its [T, 28]
// rows at a 112-byte stride (both two LDS.128 and one LDS a row). A also
// fills the card where rays are few: each ray's rows are split over S
// warps of its block (S = 1, 2, 4 or 8, the fewest that give the card
// ~2^18 threads: Cornell's 486,400 primaries take S = 1, the BVH-less
// dungeon's 65,536 random rays S = 4 and its 200x152 samples' 30,400
// rays S = 8), each slice testing a contiguous share of each tile, the
// slices' winners reduced by (t, row) through shared memory. Occupancy
// at 8,400 rows: 48 KB of shared memory and 256 threads a block, 44
// registers a thread, so shared memory allows four blocks, 32 of 64
// warps, an SM; 65,536 rays x 4 slices make 1,024 blocks, two waves on
// 132 SMs. Copying tile k + 1 by cp.async while tile k is tested needs two
// 48 KB buffers, so two blocks of 512 threads for the same 32 warps: it
// measured slower (PERF.md), since with four blocks on an SM one block
// tests rows while another loads its tile.
//
// B, redesigned for this card: any hit is order-free, so a ray may stop
// at its first occluder and skip what cannot make a hit. A warp leaves
// the row loop once all its lanes are done, the block the tile loop once
// all its warps are. (The whole test per row with each lane leaving on
// its own measured 16% slower, PERF.md.)
//
// Floating point: built with --fmad=false and no fast math (see
// ops/kernels/cuda_lib.py), with explicit fmaf exactly where the plain
// version (ops/intersect.py) fuses (moller_trumbore.cuh, and mt_front,
// mt_back and closest_rows of split_test.cuh in the same operations);
// each operation then rounds as there, so t is bit-identical to it and
// tri equal, coplanar ties included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "resolve.cuh"
#include "smem.cuh"
#include "split_test.cuh"

namespace {

using strolle::allow_smem;
using strolle::Closest;
using strolle::closest_rows;
using strolle::load_ray;
using strolle::mt_back;
using strolle::mt_front;
using strolle::MtFront;
using strolle::Ray;
using strolle::resolve_surface;

constexpr int kRowWidth = 12;
constexpr int kGeomWidth = 28;
constexpr int kThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;  // kThreads is a multiple of 32
// Rows of A's and B's shared-memory tile: 48 KB of [*, 12] rows.
constexpr int kTileRows = 1024;
// Kernel A: the most slices a ray's rows are split over, and the threads
// that fill the card (132 SMs x 2,048, ~2^18).
constexpr int kMaxSlices = 8;
constexpr long long kFillThreads = 1 << 18;

__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// Copies ``n`` float4 from global into shared memory, then a barrier.
__device__ __forceinline__ void load_quads(float4* dst, const float4* __restrict__ src, int n) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) dst[q] = src[q];
  __syncthreads();
}

// Kernel A. A block holds blockDim.x / slices rays; warp w tests slice
// w / (its rays / 32) of each tile's rows for them.
__global__ void __launch_bounds__(kThreads)
    closest_brute_kernel(const float4* __restrict__ rows, int n_rows,
                         const float* __restrict__ o, const float* __restrict__ d, int n_rays,
                         int slices, float* __restrict__ t_out, int* __restrict__ tri_out,
                         float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ float4 s_quads[];
  const int per_block = blockDim.x / slices;
  const int lane_ray = threadIdx.x % per_block;
  const int slice = threadIdx.x / per_block;
  const int i = blockIdx.x * per_block + lane_ray;
  const bool valid = i < n_rays;
  const Ray r = valid ? load_ray(o, d, i) : Ray{};
  Closest best = {INFINITY, 0.0f, 0.0f, -1};
  for (int first = 0; first < n_rows; first += kTileRows) {
    const int count = min(kTileRows, n_rows - first);
    __syncthreads();  // the previous tile's tests are done
    load_quads(s_quads, rows + first * 3, count * 3);
    if (valid) {
      closest_rows<3>(s_quads, count * slice / slices, count * (slice + 1) / slices, first, r,
                      best);
    }
  }
  if (slices > 1) {
    // Each slice's winner is the lowest of its rows at its least t, so
    // the least (t, row) over the slices is what one ascending pass with
    // strict < picks; a miss (+inf, -1) loses to any hit. The winners
    // overwrite the tile once every slice has tested it.
    __syncthreads();
    if (slice > 0) {
      s_quads[(slice - 1) * per_block + lane_ray] =
          make_float4(best.t, best.u, best.v, __int_as_float(best.tri));
    }
    __syncthreads();
    if (slice > 0) return;
    for (int q = 1; q < slices; ++q) {
      const float4 w = s_quads[(q - 1) * per_block + lane_ray];
      const int tri = __float_as_int(w.w);
      if (w.x < best.t || (w.x == best.t && tri < best.tri)) best = {w.x, w.y, w.z, tri};
    }
  }
  if (!valid) return;
  t_out[i] = best.t;
  tri_out[i] = best.tri;
  u_out[i] = best.u;
  v_out[i] = best.v;
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
  extern __shared__ float4 s_quads[];
  const float* s_rows = reinterpret_cast<const float*>(s_quads);
  load_rows(reinterpret_cast<float*>(s_quads), rows, n_rows * kGeomWidth);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  Closest best = {INFINITY, 0.0f, 0.0f, -1};
  closest_rows<kGeomWidth / 4>(s_quads, 0, n_rows, 0, r, best);
  // A miss resolves to zeros, as the TPU kernel's where-selects leave it.
  float n[3] = {0.0f, 0.0f, 0.0f}, uv[2] = {0.0f, 0.0f};
  int mat = 0;
  if (best.tri >= 0) {
    resolve_surface(s_rows + best.tri * kGeomWidth, r.dx, r.dy, r.dz, best.u, best.v, n, uv,
                    &mat);
  }
  t_out[i] = best.t;
  tri_out[i] = best.tri;
  u_out[i] = best.u;
  v_out[i] = best.v;
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
  int slices = 1;
  while (slices < kMaxSlices && static_cast<long long>(n_rays) * slices < kFillThreads) {
    slices *= 2;
  }
  // the row tile, which then holds the slices' winners
  const size_t winners = sizeof(float4) * static_cast<size_t>(kThreads);
  const size_t smem = slices > 1 && winners > tile_bytes(n_rows) ? winners : tile_bytes(n_rows);
  cudaError_t err = allow_smem(closest_brute_kernel, smem);
  if (err != cudaSuccess) return err;
  const int per_block = kThreads / slices;
  const int blocks = (n_rays + per_block - 1) / per_block;
  closest_brute_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(rows), n_rows, o, d, n_rays, slices, t, tri, u, v);
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
