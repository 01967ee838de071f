// Cluster-culled closest hit with the surface attributes resolved
// (kernel 8) and cluster-culled any hit (kernel 9), for NVIDIA Hopper
// (sm_90a).
//
// Replaces: strolle_tpu/ops/pallas/cluster_kernels.py
//   cluster_trace_surface_pallas (_cluster_surface_kernel) and
//   cluster_trace_anyhit_pallas (_cluster_anyhit_kernel).
//
// What they compute, one thread per ray: walk the K cluster boxes [K, 8]
// (bmin, bmax, first, count) in index order; enter a cluster when the
// ray's own slab test passes against its current best t (kernel 8, from
// +inf) or t_max (kernel 9); run Möller-Trumbore over the cluster's rows
// [first, min(first + count, n_rows)) of the [n_rows, 28] rows (the
// clamp keeps a table that overstates a count inside the rows; the TPU
// kernel reads whole zero-padded clusters instead). Kernel 8 keeps a hit
// on strict <, so ties go to the lowest row, then resolves the winner's
// normal, uv and material id from its row (resolve.cuh); it writes t
// (+inf on a miss), tri (-1), normal, uv, mat_id (zeros on a miss). Kernel 9 stops at the
// first row hit at t < t_max; t_max <= 0 never occludes. No scene-box
// clip, unlike kernels 5 and 6.
//
// Why per-ray culling computes the TPU kernel's function: the TPU kernel
// enters a cluster when ANY ray of its 64x128 tile passes the slab test
// against that ray's own best t, and then tests every ray of the tile. A
// ray that does not pass its own test cannot hit a triangle of that
// cluster nearer than its best t (the box holds the triangles), so its
// best hit stays the same; skipping the cluster for that ray only saves
// work. The closest hit is the same, ties to the lowest row included
// (both loop over rows in ascending order with strict <).
//
// What bounds them on this card: operations. A slab test is ~25 fp32
// operations and a ray-triangle test ~46, on 24 bytes of ray; the cluster
// boxes (33 rows, 1 KB, for the 8.4k-triangle dungeon) go into shared
// memory once per block (the wrapper refuses a table over the card's
// 227 KB per block, 7,264 clusters), and each thread reads the rows of
// the clusters it enters (0.95 MB for the dungeon, in the 50 MB L2)
// through the read-only path. The TPU kernel's VMEM-resident rows, (64, 128) ray
// tiles and second where-select pass for the attributes do not carry
// over: here the attributes come from one read of the winner's row.
//
// The kCount variant (not used by the timed launches) also writes each
// ray's count of box tests and triangle tests: the walk's work, held
// against the plain version's and set beside the kernel's bound.
//
// Floating point: --fmad=false, no fast math; slab.cuh, moller_trumbore.cuh
// and resolve.cuh repeat the plain version's operations
// (ops/kernels/cluster_kernels.py), so every output is bit-equal to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moller_trumbore.cuh"
#include "resolve.cuh"
#include "slab.cuh"
#include "smem.cuh"

namespace {

using strolle::allow_smem;
using strolle::inv_dir;
using strolle::MtHit;
using strolle::resolve_surface;
using strolle::slab;
using strolle::test_row;

constexpr int kThreads = 256;
constexpr int kRowWidth = 28;
constexpr int kBoxWidth = 8;

// Copies the cluster boxes into shared memory; every thread of the block
// takes part, so call it before any thread returns.
__device__ __forceinline__ void stage_clusters(const float* __restrict__ clus_g,
                                               int n_clusters, float* smem) {
  for (int i = threadIdx.x; i < n_clusters * kBoxWidth; i += blockDim.x) smem[i] = clus_g[i];
  __syncthreads();
}

// The rows [*first, *last) of the cluster box ``box``, clamped to n_rows.
__device__ __forceinline__ void cluster_span(const float* box, int n_rows, int* first,
                                             int* last) {
  *first = static_cast<int>(box[6]);
  *last = min(*first + static_cast<int>(box[7]), n_rows);
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    cluster_surface_kernel(const float* __restrict__ clus_g, int n_clusters,
                           const float* __restrict__ rows, int n_rows,
                           const float* __restrict__ o, const float* __restrict__ d,
                           int n_rays, float* __restrict__ t_out, int* __restrict__ tri_out,
                           float* __restrict__ normal_out, float* __restrict__ uv_out,
                           int* __restrict__ mat_out, int* __restrict__ work) {
  extern __shared__ float clus[];
  stage_clusters(clus_g, n_clusters, clus);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float bt = INFINITY, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  int box_tests = 0, tri_tests = 0;
  for (int k = 0; k < n_clusters; ++k) {
    const float* box = clus + k * kBoxWidth;
    float tn;
    if (kCount) ++box_tests;
    if (!slab(box, box + 3, ox, oy, oz, ix, iy, iz, bt, &tn)) continue;
    int first, last;
    cluster_span(box, n_rows, &first, &last);
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
  float n[3] = {0.0f, 0.0f, 0.0f}, uv[2] = {0.0f, 0.0f};
  int mat = 0;
  if (btri >= 0) {
    resolve_surface(rows + static_cast<size_t>(btri) * kRowWidth, dx, dy, dz, bu, bv, n, uv,
                    &mat);
  }
  t_out[i] = bt;
  tri_out[i] = btri;
  normal_out[3 * i] = n[0];
  normal_out[3 * i + 1] = n[1];
  normal_out[3 * i + 2] = n[2];
  uv_out[2 * i] = uv[0];
  uv_out[2 * i + 1] = uv[1];
  mat_out[i] = mat;
  if (kCount) {
    work[2 * i] += box_tests;
    work[2 * i + 1] += tri_tests;
  }
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    cluster_anyhit_kernel(const float* __restrict__ clus_g, int n_clusters,
                          const float* __restrict__ rows, int n_rows,
                          const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ t_max, int n_rays,
                          bool* __restrict__ occluded, int* __restrict__ work) {
  extern __shared__ float clus[];
  stage_clusters(clus_g, n_clusters, clus);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = t_max[i];
  bool occ = false;
  int box_tests = 0, tri_tests = 0;
  if (tm > 0.0f) {
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    for (int k = 0; k < n_clusters && !occ; ++k) {
      const float* box = clus + k * kBoxWidth;
      float tn;
      if (kCount) ++box_tests;
      if (!slab(box, box + 3, ox, oy, oz, ix, iy, iz, tm, &tn)) continue;
      int first, last;
      cluster_span(box, n_rows, &first, &last);
      for (int j = first; j < last; ++j) {
        if (kCount) ++tri_tests;
        if (test_row(rows, j, kRowWidth, ox, oy, oz, dx, dy, dz).t < tm) {
          occ = true;
          break;
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

size_t cluster_bytes(int n_clusters) {
  return sizeof(float) * kBoxWidth * static_cast<size_t>(n_clusters);
}

}  // namespace

extern "C" int strolle_cluster_trace_surface(const float* clus, int n_clusters,
                                             const float* rows, int n_rows, const float* o,
                                             const float* d, int n_rays, float* t, int* tri,
                                             float* normal, float* uv, int* mat, int* work,
                                             void* stream) {
  const size_t smem = cluster_bytes(n_clusters);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (work != nullptr) {
    err = allow_smem(cluster_surface_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    cluster_surface_kernel<true><<<blocks, kThreads, smem, s>>>(
        clus, n_clusters, rows, n_rows, o, d, n_rays, t, tri, normal, uv, mat, work);
  } else {
    err = allow_smem(cluster_surface_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    cluster_surface_kernel<false><<<blocks, kThreads, smem, s>>>(
        clus, n_clusters, rows, n_rows, o, d, n_rays, t, tri, normal, uv, mat, nullptr);
  }
  return cudaGetLastError();
}

extern "C" int strolle_cluster_trace_anyhit(const float* clus, int n_clusters,
                                            const float* rows, int n_rows, const float* o,
                                            const float* d, const float* t_max, int n_rays,
                                            bool* occluded, int* work, void* stream) {
  const size_t smem = cluster_bytes(n_clusters);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (work != nullptr) {
    err = allow_smem(cluster_anyhit_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    cluster_anyhit_kernel<true><<<blocks, kThreads, smem, s>>>(
        clus, n_clusters, rows, n_rows, o, d, t_max, n_rays, occluded, work);
  } else {
    err = allow_smem(cluster_anyhit_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    cluster_anyhit_kernel<false><<<blocks, kThreads, smem, s>>>(
        clus, n_clusters, rows, n_rows, o, d, t_max, n_rays, occluded, nullptr);
  }
  return cudaGetLastError();
}
