// Big-scene closest hit (kernel 5) and any hit (kernel 6) over clusters
// of BVH-ordered triangles, for NVIDIA Hopper (sm_90a).
//
// Replaces: strolle_tpu/ops/pallas/stream_kernels.py
//   stream_trace_surface_pallas (_stream_surface_kernel) and
//   stream_trace_anyhit_pallas (_stream_anyhit_kernel).
//
// What they compute, per ray: the closest hit among the [T', 28] rows
// (kernel 5: t, tri, u, v; t stays at tcap, the ray's scene-box exit, and
// tri at -1 on a miss) or whether any row is hit before t_max, already
// clipped to the scene-box exit (kernel 6). Rows are grouped in clusters
// of 256 with a box each [K, 8], cut into 8 sub-blocks of 32 rows with a
// box each [K*8, 8]. A ray with nothing to test (bound <= 0: it misses the
// scene box; or a zero direction) leaves at once.
//
// The walk (warp_walk.cuh, which kernels 8 and 9 share): a warp of 32
// consecutive rays builds its front-to-back list of the clusters its rays
// enter before their starting bound (tcap for 5, t_max for 6), stops once
// a key is past the largest best t of its lanes still walking, and per
// walked cluster re-tests the cluster box and its 8 sub-block boxes; a
// sub-block's 32 rows are staged in shared memory where more than kAcross
// lanes entered it, else tested across the lanes. A warp that enters more
// than list_cap clusters walks all K in index order (the overflow path).
//
// Kernel 5 keeps a hit when (t, row) < (best t, best row): among exact
// ties the lowest row wins in whatever order the clusters are walked, and
// a hit at exactly tcap with no earlier hit stays a miss. Kernel 6 leaves
// a lane at its first hit.
//
// What bounds them on this card: operations. A slab test is ~25 fp32
// operations and a ray-triangle test 24 to u and 22 more where u passes,
// on 24 bytes of ray; the rows (0.95 MB for the 8.4k-triangle dungeon)
// stay in the 50 MB L2. What the design does about it: the index-order
// walk it replaces entered every cluster along a primary ray, those
// behind its first hit included, since best t stays at tcap until the
// first hit; the front-to-back list and the stop leave those out. The TPU
// built its per-tile lists outside the kernel with a conservative
// interval test; here the warp builds its own from the same K box tests
// the index-order walk made. For kernel 6 the order can cost: parallel
// rays toward the sun meet first the clusters around their origins, which
// hold the surfaces they leave, and test more rows before an occluder
// than in index order. The box tables (33 + 264 rows for the dungeon,
// under 10 KB) go into shared memory once per block where they fit beside
// the 8 warps' lists and row buffers.
//
// The kCount variant (not used by the timed launches) also adds to each
// ray's count of box tests (the K list tests, each walked cluster's
// re-test, 8 per entered cluster) and triangle tests (each entered
// sub-block's rows; for 6 up to the first hit): the walk's work, held
// against the plain version's and set beside the kernel's bound.
//
// Floating point: --fmad=false, no fast math; the plain version
// (ops/kernels/stream_kernels.py) walks the same warps the same way, so t,
// u, v, tri and occlusion are bit-equal to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem.cuh"
#include "warp_walk.cuh"

namespace {

using strolle::allow_smem;
using strolle::block_boxes;
using strolle::kBoxWidth;
using strolle::kSubBlocks;
using strolle::kWarps;
using strolle::kWarpSize;
using strolle::Lane;
using strolle::start_lane;
using strolle::walk_smem;
using strolle::warp_scratch;
using strolle::warp_walk;
using strolle::WarpScratch;

constexpr int kThreads = strolle::kWalkThreads;

// A sub-block that at most kAcross lanes entered is tested across the
// lanes; one that more entered is staged. Testing every sub-block across
// the lanes costs a round of shuffles per entered ray: on the dungeon's
// primaries, where most lanes enter the same sub-blocks, kernel 5 then
// took 0.91-0.93 ms against 0.55 staged (H100 80GB HBM3 at 700 W,
// stream_turns.py).
template <bool kAnyHit>
struct StreamWalk {
  static constexpr bool kAny = kAnyHit;
  static constexpr bool kSubBlocks = true;
  static constexpr bool kTieReach = false;
  static constexpr int kAcross = 24;
};

template <bool kAny, bool kCount>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const float* __restrict__ clus_g, const float* __restrict__ subs_g,
                  int n_clusters, int cap, bool use_smem, const float* __restrict__ rows,
                  int n_rows, const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ bound, int n_rays, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out, bool* __restrict__ occ_out,
                  int* __restrict__ work) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  const WarpScratch w = warp_scratch(smem, warp, cap);
  const int nc = n_clusters * kBoxWidth;
  const float* clus = block_boxes(clus_g, nc, subs_g, nc * kSubBlocks, use_smem, cap, smem);
  const float* subs = use_smem ? clus + nc : subs_g;
  // Past this point only warp-level synchronisation: a warp with no ray
  // leaves whole.
  const int base = (blockIdx.x * kWarps + warp) * kWarpSize;
  if (base >= n_rays) return;
  const int i = base + lane;
  const bool in_range = i < n_rays;
  Lane l = start_lane<StreamWalk<kAny>>(o, d, i, in_range, in_range ? bound[i] : 0.0f);
  warp_walk<StreamWalk<kAny>, kCount>(clus, subs, n_clusters, cap, rows, n_rows, w, lane, l);

  if (!in_range) return;
  if constexpr (kAny) {
    occ_out[i] = l.occ;
  } else {
    t_out[i] = l.best.t;
    tri_out[i] = l.best.tri;
    u_out[i] = l.best.u;
    v_out[i] = l.best.v;
  }
  if (kCount) {
    work[2 * i] += l.box_tests;
    work[2 * i + 1] += l.tri_tests;
  }
}

template <bool kAny, bool kCount>
cudaError_t launch(const float* clus, const float* subs, int n_clusters, int cap,
                   const float* rows, int n_rows, const float* o, const float* d,
                   const float* bound, int n_rays, float* t, int* tri, float* u, float* v,
                   bool* occ, int* work, void* stream) {
  // a negative list cap is refused; the rows are read with 16-byte loads
  if (cap < 0 || (reinterpret_cast<uintptr_t>(rows) & 15) != 0) return cudaErrorInvalidValue;
  bool use_smem;
  const size_t smem =
      walk_smem(cap, kBoxWidth * static_cast<size_t>(n_clusters) * (1 + kSubBlocks), &use_smem);
  const cudaError_t err = allow_smem(stream_kernel<kAny, kCount>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  stream_kernel<kAny, kCount><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      clus, subs, n_clusters, cap, use_smem, rows, n_rows, o, d, bound, n_rays, t, tri, u, v,
      occ, work);
  return cudaGetLastError();
}

}  // namespace

extern "C" int strolle_stream_trace_surface(const float* clus, const float* subs,
                                            int n_clusters, int list_cap, const float* rows,
                                            int n_rows, const float* o, const float* d,
                                            const float* tcap, int n_rays, float* t, int* tri,
                                            float* u, float* v, int* work, void* stream) {
  if (work != nullptr) {
    return launch<false, true>(clus, subs, n_clusters, list_cap, rows, n_rows, o, d, tcap,
                               n_rays, t, tri, u, v, nullptr, work, stream);
  }
  return launch<false, false>(clus, subs, n_clusters, list_cap, rows, n_rows, o, d, tcap,
                              n_rays, t, tri, u, v, nullptr, nullptr, stream);
}

extern "C" int strolle_stream_trace_anyhit(const float* clus, const float* subs,
                                           int n_clusters, int list_cap, const float* rows,
                                           int n_rows, const float* o, const float* d,
                                           const float* t_max, int n_rays, bool* occluded,
                                           int* work, void* stream) {
  if (work != nullptr) {
    return launch<true, true>(clus, subs, n_clusters, list_cap, rows, n_rows, o, d, t_max,
                              n_rays, nullptr, nullptr, nullptr, nullptr, occluded, work, stream);
  }
  return launch<true, false>(clus, subs, n_clusters, list_cap, rows, n_rows, o, d, t_max,
                             n_rays, nullptr, nullptr, nullptr, nullptr, occluded, nullptr,
                             stream);
}
