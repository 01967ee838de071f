// Big-scene closest hit (kernel 5) and any hit (kernel 6) over clusters
// of BVH-ordered triangles, for NVIDIA Hopper (sm_90a).
//
// Replaces: strolle_tpu/ops/pallas/stream_kernels.py
//   stream_trace_surface_pallas (_stream_surface_kernel) and
//   stream_trace_anyhit_pallas (_stream_anyhit_kernel).
//
// What they compute, one thread per ray: walk the K clusters in index
// order; slab-test each cluster box [K, 8] against the ray's current
// best t; for an entered cluster slab-test its 8 sub-block boxes
// [K*8, 8] the same way; run Möller-Trumbore over the 32 rows [T', 28]
// of each entered sub-block. Kernel 5 starts best t at the ray's
// scene-box exit (tcap, from the wrapper) and keeps a hit on strict <,
// so ties go to the lowest row; it writes t (tcap on a miss), tri (-1 on
// a miss), u, v. Kernel 6 tests against t_max already clipped to the
// scene-box exit and leaves at its first hit. A ray with nothing to test
// (cap <= 0: it misses the scene box; or a zero direction) leaves at once.
//
// What bounds them on this card: operations. A slab test is ~25 fp32
// operations and a ray-triangle test ~46, on 24 bytes of ray; the walk's
// box and row reads (0.95 MB of rows for the 8.4k-triangle dungeon) stay
// in the 50 MB L2. The TPU kernel kept its (8, 128) lanes dense with
// per-tile front-to-back cluster lists, double-buffered row DMA and
// (32, 128) ray tiles; none of that carries over. Here the box tables
// (33 + 264 rows for the dungeon, under 10 KB) go into shared memory once
// per block, and each thread reads the rows of its entered sub-blocks
// through the read-only path. A front-to-back walk and shared-memory
// staging of rows are later work.
//
// The kCount variant (not used by the timed launches) also writes each
// ray's count of box tests and triangle tests: the walk's work, held
// against the plain version's and set beside the kernel's bound.
//
// Floating point: --fmad=false, no fast math; the slab tests are the
// plain version's subtract, multiply, min and max, and Möller-Trumbore
// is moller_trumbore.cuh, so t, u, v, tri and occlusion are bit-equal to
// the plain version (ops/kernels/stream_kernels.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moller_trumbore.cuh"
#include "slab.cuh"
#include "smem.cuh"

namespace {

using strolle::allow_smem;
using strolle::inv_dir;
using strolle::MtHit;
using strolle::slab;
using strolle::test_row;

constexpr int kThreads = 256;
constexpr int kClusterTris = 256;
constexpr int kSub = 8;
constexpr int kSubTris = kClusterTris / kSub;
constexpr int kRowWidth = 28;
constexpr int kBoxWidth = 8;
// Box tables above this size are read from global memory instead.
constexpr size_t kMaxSmem = 200 * 1024;

__device__ __forceinline__ bool enters(const float* b, float ox, float oy, float oz, float ix,
                                       float iy, float iz, float best) {
  float tn;
  return slab(b, b + 3, ox, oy, oz, ix, iy, iz, best, &tn);
}

// Copies the cluster and sub-block boxes into shared memory when
// use_smem; returns where the block reads them from.
__device__ __forceinline__ void stage_boxes(const float* __restrict__ clus_g,
                                            const float* __restrict__ subs_g, int n_clusters,
                                            bool use_smem, float* smem, const float** clus,
                                            const float** subs) {
  *clus = clus_g;
  *subs = subs_g;
  if (!use_smem) return;
  const int nc = n_clusters * kBoxWidth;
  const int ns = n_clusters * kSub * kBoxWidth;
  for (int i = threadIdx.x; i < nc; i += blockDim.x) smem[i] = clus_g[i];
  for (int i = threadIdx.x; i < ns; i += blockDim.x) smem[nc + i] = subs_g[i];
  __syncthreads();
  *clus = smem;
  *subs = smem + nc;
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    stream_surface_kernel(const float* __restrict__ clus_g, const float* __restrict__ subs_g,
                          int n_clusters, bool use_smem, const float* __restrict__ rows,
                          int n_rows, const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ tcap, int n_rays, float* __restrict__ t_out,
                          int* __restrict__ tri_out, float* __restrict__ u_out,
                          float* __restrict__ v_out, int* __restrict__ work) {
  extern __shared__ float smem[];
  const float* clus;
  const float* subs;
  stage_boxes(clus_g, subs_g, n_clusters, use_smem, smem, &clus, &subs);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float bt = tcap[i], bu = 0.0f, bv = 0.0f;
  int btri = -1;
  int box_tests = 0, tri_tests = 0;
  if (bt > 0.0f && (dx != 0.0f || dy != 0.0f || dz != 0.0f)) {
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    for (int k = 0; k < n_clusters; ++k) {
      if (kCount) ++box_tests;
      if (!enters(clus + k * kBoxWidth, ox, oy, oz, ix, iy, iz, bt)) continue;
      for (int s = 0; s < kSub; ++s) {
        if (kCount) ++box_tests;
        if (!enters(subs + (k * kSub + s) * kBoxWidth, ox, oy, oz, ix, iy, iz, bt)) continue;
        const int first = k * kClusterTris + s * kSubTris;
        const int last = min(first + kSubTris, n_rows);
        if (kCount && last > first) tri_tests += last - first;
        for (int j = first; j < last; ++j) {
          const MtHit h = test_row(rows, j, kRowWidth, ox, oy, oz, dx, dy, dz);
          if (h.t < bt) {
            bt = h.t;
            btri = j;
            bu = h.u;
            bv = h.v;
          }
        }
      }
    }
  }
  t_out[i] = bt;
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
  if (kCount) {
    work[2 * i] += box_tests;
    work[2 * i + 1] += tri_tests;
  }
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    stream_anyhit_kernel(const float* __restrict__ clus_g, const float* __restrict__ subs_g,
                         int n_clusters, bool use_smem, const float* __restrict__ rows,
                         int n_rows, const float* __restrict__ o, const float* __restrict__ d,
                         const float* __restrict__ t_max, int n_rays,
                         bool* __restrict__ occluded, int* __restrict__ work) {
  extern __shared__ float smem[];
  const float* clus;
  const float* subs;
  stage_boxes(clus_g, subs_g, n_clusters, use_smem, smem, &clus, &subs);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = t_max[i];
  bool occ = false;
  int box_tests = 0, tri_tests = 0;
  if (tm > 0.0f && (dx != 0.0f || dy != 0.0f || dz != 0.0f)) {
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    for (int k = 0; k < n_clusters && !occ; ++k) {
      if (kCount) ++box_tests;
      if (!enters(clus + k * kBoxWidth, ox, oy, oz, ix, iy, iz, tm)) continue;
      for (int s = 0; s < kSub && !occ; ++s) {
        if (kCount) ++box_tests;
        if (!enters(subs + (k * kSub + s) * kBoxWidth, ox, oy, oz, ix, iy, iz, tm)) continue;
        const int first = k * kClusterTris + s * kSubTris;
        const int last = min(first + kSubTris, n_rows);
        for (int j = first; j < last; ++j) {
          if (kCount) ++tri_tests;
          if (test_row(rows, j, kRowWidth, ox, oy, oz, dx, dy, dz).t < tm) {
            occ = true;
            break;
          }
        }
      }
    }
  }
  occluded[i] = occ;
  if (kCount) {
    work[2 * i] += box_tests;
    work[2 * i + 1] += tri_tests;
  }
}

size_t box_bytes(int n_clusters) {
  return sizeof(float) * kBoxWidth * static_cast<size_t>(n_clusters) * (1 + kSub);
}

}  // namespace

extern "C" int strolle_stream_trace_surface(const float* clus, const float* subs,
                                            int n_clusters, const float* rows, int n_rows,
                                            const float* o, const float* d, const float* tcap,
                                            int n_rays, float* t, int* tri, float* u, float* v,
                                            int* work, void* stream) {
  const bool use_smem = box_bytes(n_clusters) <= kMaxSmem;
  const size_t smem = use_smem ? box_bytes(n_clusters) : 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (work != nullptr) {
    err = allow_smem(stream_surface_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    stream_surface_kernel<true><<<blocks, kThreads, smem, s>>>(
        clus, subs, n_clusters, use_smem, rows, n_rows, o, d, tcap, n_rays, t, tri, u, v, work);
  } else {
    err = allow_smem(stream_surface_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    stream_surface_kernel<false><<<blocks, kThreads, smem, s>>>(
        clus, subs, n_clusters, use_smem, rows, n_rows, o, d, tcap, n_rays, t, tri, u, v,
        nullptr);
  }
  return cudaGetLastError();
}

extern "C" int strolle_stream_trace_anyhit(const float* clus, const float* subs,
                                           int n_clusters, const float* rows, int n_rows,
                                           const float* o, const float* d, const float* t_max,
                                           int n_rays, bool* occluded, int* work,
                                           void* stream) {
  const bool use_smem = box_bytes(n_clusters) <= kMaxSmem;
  const size_t smem = use_smem ? box_bytes(n_clusters) : 0;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (work != nullptr) {
    err = allow_smem(stream_anyhit_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    stream_anyhit_kernel<true><<<blocks, kThreads, smem, s>>>(
        clus, subs, n_clusters, use_smem, rows, n_rows, o, d, t_max, n_rays, occluded, work);
  } else {
    err = allow_smem(stream_anyhit_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    stream_anyhit_kernel<false><<<blocks, kThreads, smem, s>>>(
        clus, subs, n_clusters, use_smem, rows, n_rows, o, d, t_max, n_rays, occluded,
        nullptr);
  }
  return cudaGetLastError();
}
