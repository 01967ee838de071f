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
// The walk. A warp is the tile: it takes 32 consecutive rays of the flat
// order the wrapper passes and walks them together, front to back.
// 1. The list. Each live lane slab-tests all K cluster boxes against its
//    starting bound (tcap for 5, t_max for 6). A cluster's key is the least
//    entry distance of the lanes that enter it (a shuffle reduction). The
//    entered clusters go into the warp's list in shared memory, sorted by
//    (key, k) with a rank sort. A warp that enters more than list_cap
//    clusters walks all K in index order instead, with no early stop (the
//    TPU kernel's overflow tiles).
// 2. The stop. Before each list entry the warp takes the largest best t of
//    its lanes still walking (6: those not yet occluded) and stops once
//    the entry's key is past it: no lane can enter that cluster or any
//    later one.
// 3. An entry. Each walking lane re-tests the cluster box against its own
//    best t, then its 8 sub-block boxes in turn. For each sub-block that
//    some lane enters (a ballot) the warp tests its 32 rows one of two ways:
//    - many lanes entered (more than kAcross): the warp copies the v0, e1,
//      e2 of the rows into a warp buffer in shared memory with 16-byte
//      loads, and the lanes that entered test all 32 rows from there;
//    - few did: each lane loads one row into registers and the warp loops
//      over the rays that entered, each broadcast by shuffles: a warp
//      reduction takes the least (t, row) (kernel 5) and a ballot the
//      first hit (kernel 6), so the warp runs one test per entered ray
//      instead of 32 rounds with most lanes idle.
//
// Kernel 5 keeps a hit when (t, row) < (best t, best row): among exact
// ties the lowest row wins in whatever order the clusters are walked, and
// a hit at exactly tcap with no earlier hit stays a miss. Kernel 6 leaves
// a lane at its first hit.
//
// What bounds them on this card: operations. A slab test is ~25 fp32
// operations and a ray-triangle test ~46, on 24 bytes of ray; the rows
// (0.95 MB for the 8.4k-triangle dungeon) stay in the 50 MB L2. What the
// design does about it: the index-order walk it replaces entered every
// cluster along a primary ray, those behind its first hit included, since
// best t stays at tcap until the first hit; the front-to-back list and the
// stop leave those out. The TPU built its per-tile lists outside the
// kernel with a conservative interval test; here the warp builds its own
// from the same K box tests the index-order walk made. Rows staged per
// warp are read as shared-memory broadcasts (every lane reads the same
// row) instead of one L2 transaction per lane and row, and a sub-block
// that few lanes entered is tested across the lanes. For kernel 6 the
// order can cost: parallel rays toward the sun meet first the clusters
// around their origins, which hold the surfaces they leave, and test more
// rows before an occluder than in index order. The box tables
// (33 + 264 rows for the dungeon, under 10 KB) go into shared memory once
// per block where they fit beside the 8 warps' lists and row buffers.
//
// The kCount variant (not used by the timed launches) also adds to each
// ray's count of box tests (the K list tests, each walked cluster's
// re-test, 8 per entered cluster) and triangle tests (each entered
// sub-block's rows; for 6 up to the first hit, also where the warp tests
// across lanes and so tests the rows past it): the walk's work, held
// against the plain version's and set beside the kernel's bound.
//
// Floating point: --fmad=false, no fast math; the slab tests are the
// plain version's subtract, multiply, min and max, and Möller-Trumbore
// is moller_trumbore.cuh, so t, u, v, tri and occlusion are bit-equal to
// the plain version (ops/kernels/stream_kernels.py), which walks the same
// warps the same way.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moller_trumbore.cuh"
#include "slab.cuh"
#include "smem.cuh"

namespace {

using strolle::allow_smem;
using strolle::inv_dir;
using strolle::moller_trumbore;
using strolle::MtHit;
using strolle::slab;

constexpr int kWarpSize = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarpSize;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClusterTris = 256;
constexpr int kSub = 8;
constexpr int kSubTris = kClusterTris / kSub;  // 32
constexpr int kRowWidth = 28;
constexpr int kBoxWidth = 8;
// A staged row: v0, e1, e2 and three floats more, as three 16-byte loads.
constexpr int kStageWidth = 12;
constexpr int kStageFloats = kSubTris * kStageWidth;
// Dynamic shared memory a block may take (the H100's 227 KB).
constexpr size_t kSmemLimit = 227 * 1024;
// A sub-block that at most this many lanes entered is tested across the
// lanes; one that more entered is staged. Testing every sub-block across
// the lanes costs a round of shuffles per entered ray: on the dungeon's
// primaries, where most lanes enter the same sub-blocks, kernel 5 then
// takes 0.91-0.93 ms against 0.55 staged (H100 80GB HBM3 at 700 W,
// stream_turns.py).
constexpr int kAcross = 24;

__device__ __forceinline__ bool enters(const float* b, float ox, float oy, float oz, float ix,
                                       float iy, float iz, float best) {
  float tn;
  return slab(b, b + 3, ox, oy, oz, ix, iy, iz, best, &tn);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = kWarpSize / 2; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kWarpSize / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// The list's length rounded up to whole 16-byte words.
__host__ __device__ __forceinline__ int padded(int cap) { return (cap + 3) & ~3; }

// A warp's scratch: first its unsorted list (keys, ids), then two row
// buffers that take turns, so one __syncwarp() per staged sub-block does.
__host__ __device__ __forceinline__ int scratch_floats(int cap) {
  return 2 * padded(cap) > 2 * kStageFloats ? 2 * padded(cap) : 2 * kStageFloats;
}

// A warp's shared memory: its scratch and its sorted list (keys, ids).
__host__ __device__ __forceinline__ int warp_floats(int cap) {
  return scratch_floats(cap) + 2 * padded(cap);
}

// Copies v0, e1, e2 (and 3 floats more) of rows [first, first + count)
// into ``buf``, count <= 32 rows of kStageWidth, 16 bytes a lane at a time.
__device__ __forceinline__ void stage_rows(const float* __restrict__ rows, int first, int count,
                                           float* buf, int lane) {
  constexpr int kVecs = kStageWidth / 4;
  const float4* src =
      reinterpret_cast<const float4*>(rows + static_cast<size_t>(first) * kRowWidth);
  float4* dst = reinterpret_cast<float4*>(buf);
  for (int q = lane; q < count * kVecs; q += kWarpSize) {
    dst[q] = __ldg(src + (q / kVecs) * (kRowWidth / 4) + q % kVecs);
  }
}

// Tests rows [first, first + count) against the rays of the lanes in
// ``entered``, one row per lane and one ray at a time (broadcast by
// shuffles). Kernel 5 keeps the least (t, row) of each ray, kernel 6 its
// first hit. All 32 lanes call it.
template <bool kAny, bool kCount>
__device__ __forceinline__ void test_across(const float* __restrict__ rows, int first, int count,
                                            unsigned entered, int lane, float ox, float oy,
                                            float oz, float dx, float dy, float dz, float& bt,
                                            int& btri, float& bu, float& bv, bool& occ,
                                            int& tri_tests) {
  float r[kStageWidth];
  if (lane < count) {
    const float4* src =
        reinterpret_cast<const float4*>(rows + static_cast<size_t>(first + lane) * kRowWidth);
#pragma unroll
    for (int q = 0; q < kStageWidth / 4; ++q) {
      const float4 x = __ldg(src + q);
      r[4 * q] = x.x;
      r[4 * q + 1] = x.y;
      r[4 * q + 2] = x.z;
      r[4 * q + 3] = x.w;
    }
  }
  for (unsigned todo = entered; todo != 0; todo &= todo - 1) {
    const int a = __ffs(todo) - 1;
    const float aox = __shfl_sync(kFull, ox, a), aoy = __shfl_sync(kFull, oy, a),
                aoz = __shfl_sync(kFull, oz, a), adx = __shfl_sync(kFull, dx, a),
                ady = __shfl_sync(kFull, dy, a), adz = __shfl_sync(kFull, dz, a);
    MtHit h = {INFINITY, 0.0f, 0.0f};
    if (lane < count) h = moller_trumbore(r, aox, aoy, aoz, adx, ady, adz);
    if constexpr (kAny) {
      const unsigned hits = __ballot_sync(kFull, h.t < __shfl_sync(kFull, bt, a));
      if (lane == a) {
        if (kCount) tri_tests += hits != 0 ? __ffs(hits) : count;
        if (hits != 0) occ = true;
      }
    } else {
      // the least (t, lane): on equal t the lowest row, as the staged loop
      float tmin = h.t;
      int w = lane;
#pragma unroll
      for (int off = kWarpSize / 2; off > 0; off >>= 1) {
        const float t2 = __shfl_xor_sync(kFull, tmin, off);
        const int w2 = __shfl_xor_sync(kFull, w, off);
        if (t2 < tmin || (t2 == tmin && w2 < w)) {
          tmin = t2;
          w = w2;
        }
      }
      const float wu = __shfl_sync(kFull, h.u, w), wv = __shfl_sync(kFull, h.v, w);
      const int j = first + w;
      if (lane == a) {
        if (kCount) tri_tests += count;
        if (tmin < bt || (tmin == bt && btri >= 0 && j < btri)) {
          bt = tmin;
          btri = j;
          bu = wu;
          bv = wv;
        }
      }
    }
  }
}

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
  const int pcap = padded(cap);
  float* scratch = smem + warp * scratch_floats(cap);
  float* ukey = scratch;
  int* uid = reinterpret_cast<int*>(scratch + pcap);
  float* lkey = smem + kWarps * scratch_floats(cap) + warp * 2 * pcap;
  int* lid = reinterpret_cast<int*>(lkey + pcap);

  const float* clus = clus_g;
  const float* subs = subs_g;
  if (use_smem) {
    float* boxes = smem + kWarps * warp_floats(cap);
    const int nc = n_clusters * kBoxWidth;
    const int ns = n_clusters * kSub * kBoxWidth;
    for (int q = threadIdx.x; q < nc; q += blockDim.x) boxes[q] = clus_g[q];
    for (int q = threadIdx.x; q < ns; q += blockDim.x) boxes[nc + q] = subs_g[q];
    __syncthreads();
    clus = boxes;
    subs = boxes + nc;
  }
  // Past this point only warp-level synchronisation: a warp with no ray
  // leaves whole.
  const int base = (blockIdx.x * kWarps + warp) * kWarpSize;
  if (base >= n_rays) return;
  const int i = base + lane;
  const bool in_range = i < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f, bt = 0.0f;
  if (in_range) {
    ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    bt = bound[i];
  }
  const bool live = in_range && bt > 0.0f && (dx != 0.0f || dy != 0.0f || dz != 0.0f);
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float bu = 0.0f, bv = 0.0f;
  int btri = -1;
  bool occ = false;
  int box_tests = 0, tri_tests = 0;

  // 1. The list: every cluster box against the starting bound.
  int n = 0;
  for (int k = 0; k < n_clusters; ++k) {
    float tn = INFINITY;
    bool e = false;
    if (live) {
      if (kCount) ++box_tests;
      const float* b = clus + k * kBoxWidth;
      e = slab(b, b + 3, ox, oy, oz, ix, iy, iz, bt, &tn);
    }
    const float key = warp_min(e ? tn : INFINITY);
    if (__ballot_sync(kFull, e)) {
      if (lane == 0 && n < cap) {
        ukey[n] = key;
        uid[n] = k;
      }
      ++n;
    }
  }
  const bool overflow = n > cap;
  __syncwarp();
  if (!overflow) {
    // rank sort on (key, k): ids went in ascending, so the position breaks ties
    for (int a = lane; a < n; a += kWarpSize) {
      const float ka = ukey[a];
      int rank = 0;
      for (int b = 0; b < n; ++b) {
        const float kb = ukey[b];
        rank += (kb < ka || (kb == ka && b < a)) ? 1 : 0;
      }
      lkey[rank] = ka;
      lid[rank] = uid[a];
    }
  }
  __syncwarp();

  // 2-3. The walk.
  const int steps = overflow ? n_clusters : n;
  int slot = 0;
  for (int step = 0; step < steps; ++step) {
    const bool walking = live && !occ;
    int k;
    if (overflow) {
      if (!__any_sync(kFull, walking)) break;
      k = step;
    } else {
      if (lkey[step] > warp_max(walking ? bt : -INFINITY)) break;
      k = lid[step];
    }
    bool in_cluster = false;
    if (walking) {
      if (kCount) ++box_tests;
      in_cluster = enters(clus + k * kBoxWidth, ox, oy, oz, ix, iy, iz, bt);
    }
    for (int s = 0; s < kSub; ++s) {
      bool in_sub = false;
      if (in_cluster && !occ) {
        if (kCount) ++box_tests;
        in_sub = enters(subs + (k * kSub + s) * kBoxWidth, ox, oy, oz, ix, iy, iz, bt);
      }
      const unsigned entered = __ballot_sync(kFull, in_sub);
      if (entered == 0) continue;
      const int first = k * kClusterTris + s * kSubTris;
      const int count = min(kSubTris, n_rows - first);
      if (count <= 0) continue;
      if (__popc(entered) <= kAcross) {
        test_across<kAny, kCount>(rows, first, count, entered, lane, ox, oy, oz, dx, dy, dz, bt,
                                  btri, bu, bv, occ, tri_tests);
        continue;
      }
      float* buf = scratch + slot * kStageFloats;
      slot ^= 1;
      stage_rows(rows, first, count, buf, lane);
      __syncwarp();
      if (!in_sub) continue;
      if constexpr (kAny) {
        for (int r = 0; r < count; ++r) {
          if (kCount) ++tri_tests;
          if (moller_trumbore(buf + r * kStageWidth, ox, oy, oz, dx, dy, dz).t < bt) {
            occ = true;
            break;
          }
        }
      } else {
        if (kCount) tri_tests += count;
#pragma unroll 4
        for (int r = 0; r < count; ++r) {
          const MtHit h = moller_trumbore(buf + r * kStageWidth, ox, oy, oz, dx, dy, dz);
          const int j = first + r;
          if (h.t < bt || (h.t == bt && btri >= 0 && j < btri)) {
            bt = h.t;
            btri = j;
            bu = h.u;
            bv = h.v;
          }
        }
      }
    }
  }

  if (!in_range) return;
  if constexpr (kAny) {
    occ_out[i] = occ;
  } else {
    t_out[i] = bt;
    tri_out[i] = btri;
    u_out[i] = bu;
    v_out[i] = bv;
  }
  if (kCount) {
    work[2 * i] += box_tests;
    work[2 * i + 1] += tri_tests;
  }
}

template <bool kAny, bool kCount>
cudaError_t launch(const float* clus, const float* subs, int n_clusters, int cap,
                   const float* rows, int n_rows, const float* o, const float* d,
                   const float* bound, int n_rays, float* t, int* tri, float* u, float* v,
                   bool* occ, int* work, void* stream) {
  // a negative list cap is refused; the rows are read with 16-byte loads
  if (cap < 0 || (reinterpret_cast<uintptr_t>(rows) & 15) != 0) return cudaErrorInvalidValue;
  const size_t warps = sizeof(float) * kWarps * static_cast<size_t>(warp_floats(cap));
  const size_t boxes = sizeof(float) * kBoxWidth * static_cast<size_t>(n_clusters) * (1 + kSub);
  const bool use_smem = warps + boxes <= kSmemLimit;
  const size_t smem = warps + (use_smem ? boxes : 0);
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
