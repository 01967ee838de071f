// Cluster-culled closest hit with the surface attributes resolved
// (kernel 8) and cluster-culled any hit (kernel 9), for NVIDIA Hopper
// (sm_90a).
//
// Replaces: strolle_tpu/ops/pallas/cluster_kernels.py
//   cluster_trace_surface_pallas (_cluster_surface_kernel) and
//   cluster_trace_anyhit_pallas (_cluster_anyhit_kernel).
//
// What they compute, per ray: the closest hit among the rows of the
// [K, 8] cluster boxes (bmin, bmax, first, count), each cluster's rows
// [first, min(first + count, n_rows)) of the [n_rows, 28] rows (the clamp
// keeps a table that overstates a count inside the rows; the TPU kernel
// reads whole zero-padded clusters instead). Kernel 8 starts from
// t = +inf, keeps the least (t, row), so the lowest row wins an exact tie,
// then resolves the winner's normal, uv and material id from its row
// (resolve.cuh); it writes t (+inf on a miss), tri (-1), normal, uv,
// mat_id (zeros on a miss). Kernel 9: whether some row is hit at
// t < t_max; t_max <= 0 never occludes. No scene-box clip, unlike kernels
// 5 and 6. A ray with a zero direction hits nothing and walks nothing.
//
// The walk is warp_walk.cuh's, kernel 5's without its sub-block level: a
// warp of 32 consecutive rays walks its front-to-back list of the
// clusters its rays enter before their starting bound (+inf for 8, t_max
// for 9), stops once a key is past the largest bound of its lanes still
// walking, re-tests each box per lane, and tests an entered cluster's
// rows in blocks of 32, staged in shared memory where many lanes entered
// (more than kAcross), else across the lanes. Kernel 8's box tests reach
// best t * (1 + 2^-18) (kTieReach), so a cluster whose box face holds a
// tie at best t is entered though the slab's t_near rounds an ulp or
// three past it, and the lowest row wins every exact tie, as in the JAX
// kernel's index-order walk. A warp whose list would pass the list cap (a
// launch argument) walks all K in index order (the overflow path).
//
// What bounds them on this card: operations. A slab test is ~25 fp32
// operations and a ray-triangle test 24 to u and 22 more where u passes,
// on 24 bytes of ray; the rows (0.95 MB for the 8.4k-triangle dungeon)
// stay in the 50 MB L2. The index-order walk this replaced, one thread a
// ray, entered every cluster along a primary, those behind its first hit
// included, and fetched each row once per lane through the read-only
// path; the front-to-back list and the stop leave those clusters out, and
// a staged row is one 16-byte copy per warp. The cluster boxes (33 rows
// for the dungeon) go into shared memory after the 8 warps' lists and
// buffers where they fit; a larger table (up to 7,264 clusters, the
// wrapper's limit) is read from global memory.
//
// Floating point: --fmad=false, no fast math; the plain version
// (ops/kernels/cluster_kernels.py) walks the same warps the same way, and
// resolve.cuh repeats its operations, so every output is bit-equal to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "resolve.cuh"
#include "smem.cuh"
#include "warp_walk.cuh"

namespace {

using strolle::allow_smem;
using strolle::block_boxes;
using strolle::kBoxWidth;
using strolle::kWarps;
using strolle::kWarpSize;
using strolle::Lane;
using strolle::resolve_surface;
using strolle::start_lane;
using strolle::walk_smem;
using strolle::warp_scratch;
using strolle::warp_walk;
using strolle::WarpScratch;

constexpr int kThreads = strolle::kWalkThreads;

// A block of rows that at most kAcross lanes of a warp entered is tested
// across the lanes; one that more entered is staged. Measured in turns on
// the dungeon's sets and on the launches of a reference sample and a GI
// cycle (PERF.md, kernels 8 and 9).
struct ClusterSurface {
  static constexpr bool kAny = false;
  static constexpr bool kSubBlocks = false;
  static constexpr bool kTieReach = true;
  static constexpr int kAcross = 8;
};

struct ClusterAnyhit {
  static constexpr bool kAny = true;
  static constexpr bool kSubBlocks = false;
  static constexpr bool kTieReach = false;
  static constexpr int kAcross = 24;
};

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    cluster_surface_kernel(const float* __restrict__ clus_g, int n_clusters, int cap,
                           bool use_smem, const float* __restrict__ rows, int n_rows,
                           const float* __restrict__ o, const float* __restrict__ d,
                           int n_rays, float* __restrict__ t_out, int* __restrict__ tri_out,
                           float* __restrict__ normal_out, float* __restrict__ uv_out,
                           int* __restrict__ mat_out, int* __restrict__ work) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  const WarpScratch w = warp_scratch(smem, warp, cap);
  const float* clus =
      block_boxes(clus_g, n_clusters * kBoxWidth, nullptr, 0, use_smem, cap, smem);
  // Past this point only warp-level synchronisation: a warp with no ray
  // leaves whole.
  const int base = (blockIdx.x * kWarps + warp) * kWarpSize;
  if (base >= n_rays) return;
  const int i = base + lane;
  const bool in_range = i < n_rays;
  Lane l = start_lane<ClusterSurface>(o, d, i, in_range, INFINITY);
  warp_walk<ClusterSurface, kCount>(clus, nullptr, n_clusters, cap, rows, n_rows, w, lane, l);

  if (!in_range) return;
  float nrm[3] = {0.0f, 0.0f, 0.0f}, uv[2] = {0.0f, 0.0f};
  int mat = 0;
  if (l.best.tri >= 0) {
    resolve_surface(rows + static_cast<size_t>(l.best.tri) * strolle::kRowWidth, l.r.dx, l.r.dy,
                    l.r.dz, l.best.u, l.best.v, nrm, uv, &mat);
  }
  t_out[i] = l.best.t;
  tri_out[i] = l.best.tri;
  normal_out[3 * i] = nrm[0];
  normal_out[3 * i + 1] = nrm[1];
  normal_out[3 * i + 2] = nrm[2];
  uv_out[2 * i] = uv[0];
  uv_out[2 * i + 1] = uv[1];
  mat_out[i] = mat;
  if (kCount) {
    work[2 * i] += l.box_tests;
    work[2 * i + 1] += l.tri_tests;
  }
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    cluster_anyhit_kernel(const float* __restrict__ clus_g, int n_clusters, int cap,
                          bool use_smem, const float* __restrict__ rows, int n_rows,
                          const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ t_max, int n_rays,
                          bool* __restrict__ occluded, int* __restrict__ work) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  const WarpScratch w = warp_scratch(smem, warp, cap);
  const float* clus =
      block_boxes(clus_g, n_clusters * kBoxWidth, nullptr, 0, use_smem, cap, smem);
  const int base = (blockIdx.x * kWarps + warp) * kWarpSize;
  if (base >= n_rays) return;
  const int i = base + lane;
  const bool in_range = i < n_rays;
  Lane l = start_lane<ClusterAnyhit>(o, d, i, in_range, in_range ? t_max[i] : 0.0f);
  warp_walk<ClusterAnyhit, kCount>(clus, nullptr, n_clusters, cap, rows, n_rows, w, lane, l);

  if (!in_range) return;
  occluded[i] = l.occ;
  if (kCount) {
    work[2 * i] += l.box_tests;
    work[2 * i + 1] += l.tri_tests;
  }
}

// A negative list cap is refused, and rows off a 16-byte boundary (they
// are staged with 16-byte loads).
bool bad_args(int cap, const float* rows) {
  return cap < 0 || (reinterpret_cast<uintptr_t>(rows) & 15) != 0;
}

template <bool kCount>
cudaError_t launch_surface(const float* clus, int n_clusters, int cap, const float* rows,
                           int n_rows, const float* o, const float* d, int n_rays, float* t,
                           int* tri, float* normal, float* uv, int* mat, int* work,
                           cudaStream_t s) {
  bool use_smem;
  const size_t smem = walk_smem(cap, kBoxWidth * static_cast<size_t>(n_clusters), &use_smem);
  const cudaError_t err = allow_smem(cluster_surface_kernel<kCount>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cluster_surface_kernel<kCount><<<blocks, kThreads, smem, s>>>(
      clus, n_clusters, cap, use_smem, rows, n_rows, o, d, n_rays, t, tri, normal, uv, mat, work);
  return cudaGetLastError();
}

template <bool kCount>
cudaError_t launch_anyhit(const float* clus, int n_clusters, int cap, const float* rows,
                          int n_rows, const float* o, const float* d, const float* t_max,
                          int n_rays, bool* occluded, int* work, cudaStream_t s) {
  bool use_smem;
  const size_t smem = walk_smem(cap, kBoxWidth * static_cast<size_t>(n_clusters), &use_smem);
  const cudaError_t err = allow_smem(cluster_anyhit_kernel<kCount>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cluster_anyhit_kernel<kCount><<<blocks, kThreads, smem, s>>>(
      clus, n_clusters, cap, use_smem, rows, n_rows, o, d, t_max, n_rays, occluded, work);
  return cudaGetLastError();
}

}  // namespace

extern "C" int strolle_cluster_trace_surface(const float* clus, int n_clusters, int list_cap,
                                             const float* rows, int n_rows, const float* o,
                                             const float* d, int n_rays, float* t, int* tri,
                                             float* normal, float* uv, int* mat, int* work,
                                             void* stream) {
  if (bad_args(list_cap, rows)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (work != nullptr) {
    return launch_surface<true>(clus, n_clusters, list_cap, rows, n_rows, o, d, n_rays, t, tri,
                                normal, uv, mat, work, s);
  }
  return launch_surface<false>(clus, n_clusters, list_cap, rows, n_rows, o, d, n_rays, t, tri,
                               normal, uv, mat, nullptr, s);
}

extern "C" int strolle_cluster_trace_anyhit(const float* clus, int n_clusters, int list_cap,
                                            const float* rows, int n_rows, const float* o,
                                            const float* d, const float* t_max, int n_rays,
                                            bool* occluded, int* work, void* stream) {
  if (bad_args(list_cap, rows)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (work != nullptr) {
    return launch_anyhit<true>(clus, n_clusters, list_cap, rows, n_rows, o, d, t_max, n_rays,
                               occluded, work, s);
  }
  return launch_anyhit<false>(clus, n_clusters, list_cap, rows, n_rows, o, d, t_max, n_rays,
                              occluded, nullptr, s);
}
