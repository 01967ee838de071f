// The warp walk over [K, 8] cluster boxes (bmin, bmax, first, count),
// one template for the big-scene stream kernels (5 and 6:
// stream_kernels.cu) and the cluster kernels (8 and 9:
// cluster_kernels.cu). A traits struct tells them apart: closest or any
// hit, whether a cluster's 32-row blocks have boxes of their own (the
// stream layout's 8 sub-blocks), whether the box tests reach past the
// best t (kTieReach), and how few lanes must enter a block for it to be
// tested across the lanes.
//
// A warp is the tile: it takes 32 consecutive rays of the flat order.
// 1. The list. Each live lane slab-tests all K cluster boxes against its
//    starting bound (5: the scene-box exit tcap; 6: t_max clipped to it;
//    8: +inf; 9: t_max). A cluster's key is the least entry distance of
//    the lanes that enter it (a shuffle reduction). The entered clusters
//    go into the warp's list in shared memory, sorted by (key, k) with a
//    rank sort. A warp that enters more than the list cap (a launch
//    argument) walks all K in index order instead, with no early stop
//    (the TPU kernel's overflow tiles); the answer is the same.
// 2. The stop. Before each list entry the warp takes the largest bound of
//    its lanes still walking (the best t; any hit: t_max, of the lanes not
//    yet occluded) and stops once the entry's key is past it: no lane can
//    enter that cluster or any later one.
// 3. An entry. Each walking lane re-tests the cluster box against its own
//    bound (and the 8 sub-block boxes in turn, where there are). The rows
//    of a block of 32 that some lane entered are tested one of two ways:
//    - many lanes entered (more than K::kAcross): the warp copies v0, e1,
//      e2 of the rows into a buffer of shared memory with 16-byte loads
//      (stage_rows), and the lanes that entered test all of them as
//      shared-memory broadcasts with the split test (split_test.cuh):
//      closest hit with the loop of kernels A and 4 (closest_rows, its
//      tie rule by (t, row), since clusters come in any order), any hit
//      with mt_front / mt_back, each lane leaving at its first occluder;
//    - few did: each lane loads one row into registers and the warp takes
//      the rays that entered one at a time, broadcast by shuffles: a warp
//      reduction of the least (t, row) for a closest hit, a ballot of the
//      first occluder for any hit. The warp then runs one test a row per
//      entered ray, not 32 rounds with most lanes idle.
//
// The winner does not depend on the order: a hit is kept where (t, row) <
// (best t, best row), so among exact ties the lowest row wins, and a hit
// at exactly a starting best t with no hit yet (kernel 5's tcap) stays a
// miss. The lowest row must also be tested: a cluster is entered where
// the slab's t_near <= the bound, and t_near of a box whose face holds the
// winning triangle can round past the triangle's t (up to 3 ulps on the
// dungeon's rows twice over). With kTieReach the re-tests and the stop
// take best t * (1 + 2^-18), so such a cluster is still entered (kernel
// 8; kernel 5 keeps best t).
//
// Why per-warp culling computes the TPU kernel's function: the TPU kernel
// enters a cluster when ANY ray of its tile passes the slab test against
// that ray's own best t, and then tests every ray of the tile. A ray that
// does not pass its own test cannot hit a triangle of that cluster nearer
// than its best t (the box holds the triangles), so its best hit stays
// the same; skipping the cluster for that ray only saves work.
//
// A warp's shared memory (warp_floats): first its scratch, which holds
// the unsorted list (keys, ids) while the list is built and then two row
// buffers that take turns, so one __syncwarp() per staged block does;
// then its sorted list (keys, ids). The box tables follow the 8 warps'
// memory where they fit in the block's 227 KB (walk_smem); a larger table
// is read from global memory.
//
// The kCount variant (not used by the timed launches) also adds to each
// ray's count of box tests (the K list tests, each walked cluster's
// re-test and sub-block re-tests) and triangle tests (the rows of each
// block it entered; any hit: up to its first occluder).
//
// Floating point: --fmad=false, no fast math; slab.cuh, moller_trumbore.cuh
// and split_test.cuh repeat the plain versions' operations
// (ops/kernels/cluster_kernels.py, stream_kernels.py), which walk the same
// warps the same way, so every output is bit-equal to theirs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "moller_trumbore.cuh"
#include "slab.cuh"
#include "split_test.cuh"

namespace strolle {

constexpr int kWarpSize = 32;
constexpr int kWarps = 8;
constexpr int kWalkThreads = kWarps * kWarpSize;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWidth = 28;
constexpr int kBoxWidth = 8;
// Rows a block holds; a staged row is v0, e1, e2 and three floats more,
// three 16-byte loads.
constexpr int kStageRows = 32;
constexpr int kStageWidth = 12;
constexpr int kStageFloats = kStageRows * kStageWidth;
// The stream layout: clusters of 256 rows, 8 sub-blocks of 32 with a box
// each.
constexpr int kClusterRows = 256;
constexpr int kSubBlocks = kClusterRows / kStageRows;
// Dynamic shared memory a block may take (the H100's 227 KB).
constexpr size_t kSmemLimit = 227 * 1024;
// The factor by which kTieReach walks reach past the best t (the plain
// version's TIE_REACH).
constexpr float kTieReach = 1.0f + 0x1p-18f;

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

__host__ __device__ __forceinline__ int scratch_floats(int cap) {
  return 2 * padded(cap) > 2 * kStageFloats ? 2 * padded(cap) : 2 * kStageFloats;
}

__host__ __device__ __forceinline__ int warp_floats(int cap) {
  return scratch_floats(cap) + 2 * padded(cap);
}

// Bytes of dynamic shared memory a block takes: the warps' memory, and
// ``box_floats`` of box tables after it where they fit (*boxes_in_smem).
inline size_t walk_smem(int cap, size_t box_floats, bool* boxes_in_smem) {
  const size_t warps = sizeof(float) * kWarps * static_cast<size_t>(warp_floats(cap));
  const size_t boxes = sizeof(float) * box_floats;
  *boxes_in_smem = warps + boxes <= kSmemLimit;
  return warps + (*boxes_in_smem ? boxes : 0);
}

// The box tables: copied after the warps' memory when they fit there
// (every thread of the block takes part, so call it before any returns),
// else read from global memory. The returned pointer holds ``n`` floats
// of ``a`` then ``m`` of ``b``, or is ``a`` where they do not fit.
__device__ __forceinline__ const float* block_boxes(const float* __restrict__ a, int n,
                                                    const float* __restrict__ b, int m,
                                                    bool use_smem, int cap, float* smem) {
  if (!use_smem) return a;
  float* boxes = smem + kWarps * warp_floats(cap);
  for (int q = threadIdx.x; q < n; q += blockDim.x) boxes[q] = a[q];
  for (int q = threadIdx.x; q < m; q += blockDim.x) boxes[n + q] = b[q];
  __syncthreads();
  return boxes;
}

// Copies v0, e1, e2 (and 3 floats more) of rows [first, first + count)
// into ``buf``, count <= kStageRows rows of kStageWidth, 16 bytes a lane
// at a time.
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

// A warp's shared memory: its unsorted list (keys, ids) and row buffers
// (scratch) and its sorted list.
struct WarpScratch {
  float* scratch;
  float* ukey;
  int* uid;
  float* lkey;
  int* lid;
};

__device__ __forceinline__ WarpScratch warp_scratch(float* smem, int warp, int cap) {
  const int pcap = padded(cap);
  WarpScratch w;
  w.scratch = smem + warp * scratch_floats(cap);
  w.ukey = w.scratch;
  w.uid = reinterpret_cast<int*>(w.scratch + pcap);
  w.lkey = smem + kWarps * scratch_floats(cap) + warp * 2 * pcap;
  w.lid = reinterpret_cast<int*>(w.lkey + pcap);
  return w;
}

// What a lane carries through the walk: its ray and inverse direction,
// whether it walks at all (a positive bound and a non-zero direction),
// its closest hit so far (best.t starts at the bound: tcap or +inf) or,
// for any hit, t_max and whether it is occluded; and its counts.
struct Lane {
  Ray r;
  float ix, iy, iz;
  bool live;
  Closest best;
  float tm;
  bool occ;
  int box_tests, tri_tests;
};

template <class K>
__device__ __forceinline__ Lane start_lane(const float* __restrict__ o,
                                           const float* __restrict__ d, int i, bool in_range,
                                           float bound) {
  Lane l;
  l.r = in_range ? load_ray(o, d, i) : Ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  l.ix = inv_dir(l.r.dx), l.iy = inv_dir(l.r.dy), l.iz = inv_dir(l.r.dz);
  l.live = in_range && bound > 0.0f && (l.r.dx != 0.0f || l.r.dy != 0.0f || l.r.dz != 0.0f);
  l.best = {K::kAny ? INFINITY : bound, 0.0f, 0.0f, -1};
  l.tm = bound;
  l.occ = false;
  l.box_tests = l.tri_tests = 0;
  return l;
}

// The bound a lane's box tests take: its best t (raised by kTieReach
// where K asks for it) or t_max.
template <class K>
__device__ __forceinline__ float reach(const Lane& l) {
  if constexpr (K::kAny) {
    return l.tm;
  } else if constexpr (K::kTieReach) {
    return l.best.t * kTieReach;
  } else {
    return l.best.t;
  }
}

// Loads row ``first + lane`` (v0, e1, e2 and three floats more) into
// registers where lane < count.
__device__ __forceinline__ void lane_row(const float* __restrict__ rows, int first, int count,
                                         int lane, float4& a, float4& b, float4& c) {
  a = b = c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (lane < count) {
    const float4* src =
        reinterpret_cast<const float4*>(rows + static_cast<size_t>(first + lane) * kRowWidth);
    a = __ldg(src);
    b = __ldg(src + 1);
    c = __ldg(src + 2);
  }
}

// The ray of lane ``s``, broadcast by shuffles.
__device__ __forceinline__ Ray lane_ray(const Ray& r, int s) {
  return {__shfl_sync(kFull, r.ox, s), __shfl_sync(kFull, r.oy, s), __shfl_sync(kFull, r.oz, s),
          __shfl_sync(kFull, r.dx, s), __shfl_sync(kFull, r.dy, s), __shfl_sync(kFull, r.dz, s)};
}

// Rows [first, first + count), one a lane, against the rays of the lanes
// in ``todo``, one ray at a time. Closest hit: a warp reduction takes the
// least (t, row), which the ray's lane keeps by the (t, row) rule. Any
// hit: a ballot gives the ray its first occluder (and its count of tests
// up to it). All 32 lanes call it.
template <bool kAny, bool kCount>
__device__ __forceinline__ void test_across(const float* __restrict__ rows, int first, int count,
                                            unsigned todo, int lane, Lane& l) {
  float4 a, b, c;
  lane_row(rows, first, count, lane, a, b, c);
  for (; todo != 0; todo &= todo - 1) {
    const int s = __ffs(todo) - 1;
    const Ray x = lane_ray(l.r, s);
    if constexpr (kAny) {
      const float tm = __shfl_sync(kFull, l.tm, s);
      bool hit = false;
      if (lane < count) {
        const MtFront f = mt_front(a, b, c, x.ox, x.oy, x.oz, x.dx, x.dy, x.dz);
        hit = f.pass && mt_back(f, a, b, c, x.dx, x.dy, x.dz, tm);
      }
      const unsigned hits = __ballot_sync(kFull, hit);
      if (lane == s) {
        if (kCount) l.tri_tests += hits != 0 ? __ffs(hits) : count;
        if (hits != 0) l.occ = true;
      }
    } else {
      const float q[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
      MtHit h = {INFINITY, 0.0f, 0.0f};
      if (lane < count) h = moller_trumbore(q, x.ox, x.oy, x.oz, x.dx, x.dy, x.dz);
      float tmin = h.t;
      int wl = lane;
#pragma unroll
      for (int off = kWarpSize / 2; off > 0; off >>= 1) {
        const float t2 = __shfl_xor_sync(kFull, tmin, off);
        const int w2 = __shfl_xor_sync(kFull, wl, off);
        if (t2 < tmin || (t2 == tmin && w2 < wl)) {
          tmin = t2;
          wl = w2;
        }
      }
      const float wu = __shfl_sync(kFull, h.u, wl), wv = __shfl_sync(kFull, h.v, wl);
      if (lane == s && beats<true>(tmin, first + wl, l.best)) {
        l.best = {tmin, wu, wv, first + wl};
      }
    }
  }
}

// One block of count (1..kStageRows) rows from ``first``, which the lanes
// in ``entered`` (those with ``in``) test: across the lanes where few
// entered, else staged in the warp's next buffer. All 32 lanes call it.
template <class K, bool kCount>
__device__ __forceinline__ void test_block(const float* __restrict__ rows, int first, int count,
                                           bool in, unsigned entered, float* scratch, int& slot,
                                           int lane, Lane& l) {
  if constexpr (!K::kAny) {
    if (kCount && in) l.tri_tests += count;
  }
  if (__popc(entered) <= K::kAcross) {
    test_across<K::kAny, kCount>(rows, first, count, entered, lane, l);
    return;
  }
  float* buf = scratch + slot * kStageFloats;
  slot ^= 1;
  stage_rows(rows, first, count, buf, lane);
  __syncwarp();
  if (!in) return;
  const float4* q = reinterpret_cast<const float4*>(buf);
  if constexpr (K::kAny) {
    for (int j = 0; j < count; ++j) {
      if (kCount) ++l.tri_tests;
      const float4 a = q[3 * j], b = q[3 * j + 1], c = q[3 * j + 2];
      const MtFront f = mt_front(a, b, c, l.r.ox, l.r.oy, l.r.oz, l.r.dx, l.r.dy, l.r.dz);
      if (f.pass && mt_back(f, a, b, c, l.r.dx, l.r.dy, l.r.dz, l.tm)) {
        l.occ = true;
        break;
      }
    }
  } else {
    closest_rows<3, true>(q, 0, count, first, l.r, l.best);
  }
}

// The walk of one warp (steps 1-3 above) over the cluster boxes ``clus``
// (and, where K::kSubBlocks, the [K*8, 8] sub-block boxes ``subs``) and
// the [n_rows, 28] rows. All 32 lanes call it.
template <class K, bool kCount>
__device__ __forceinline__ void warp_walk(const float* clus, const float* subs, int n_clusters,
                                          int cap, const float* __restrict__ rows, int n_rows,
                                          const WarpScratch& w, int lane, Lane& l) {
  if (!__any_sync(kFull, l.live)) return;  // no ray to walk
  // 1. The list: every cluster box against the starting bound.
  const float start = reach<K>(l);
  int n = 0;
  for (int k = 0; k < n_clusters; ++k) {
    float tn = INFINITY;
    bool e = false;
    if (l.live) {
      if (kCount) ++l.box_tests;
      const float* b = clus + k * kBoxWidth;
      e = slab(b, b + 3, l.r.ox, l.r.oy, l.r.oz, l.ix, l.iy, l.iz, start, &tn);
    }
    const float key = warp_min(e ? tn : INFINITY);
    if (__ballot_sync(kFull, e)) {
      if (lane == 0 && n < cap) {
        w.ukey[n] = key;
        w.uid[n] = k;
      }
      ++n;
    }
  }
  const bool overflow = n > cap;
  __syncwarp();
  if (!overflow) {
    // rank sort on (key, k): ids went in ascending, so the position breaks ties
    for (int a = lane; a < n; a += kWarpSize) {
      const float ka = w.ukey[a];
      int rank = 0;
      for (int b = 0; b < n; ++b) {
        const float kb = w.ukey[b];
        rank += (kb < ka || (kb == ka && b < a)) ? 1 : 0;
      }
      w.lkey[rank] = ka;
      w.lid[rank] = w.uid[a];
    }
  }
  __syncwarp();

  // 2-3. The walk.
  const int steps = overflow ? n_clusters : n;
  int slot = 0;
  for (int step = 0; step < steps; ++step) {
    const bool walking = l.live && !l.occ;
    int k;
    if (overflow) {
      if (!__any_sync(kFull, walking)) break;
      k = step;
    } else {
      if (w.lkey[step] > warp_max(walking ? reach<K>(l) : -INFINITY)) break;
      k = w.lid[step];
    }
    const float* box = clus + k * kBoxWidth;
    bool in_cluster = false;
    if (walking) {
      if (kCount) ++l.box_tests;
      in_cluster = enters(box, l.r.ox, l.r.oy, l.r.oz, l.ix, l.iy, l.iz, reach<K>(l));
    }
    if (!__any_sync(kFull, in_cluster)) continue;
    if constexpr (K::kSubBlocks) {
      for (int s = 0; s < kSubBlocks; ++s) {
        bool in_sub = false;
        if (in_cluster && !l.occ) {
          if (kCount) ++l.box_tests;
          in_sub = enters(subs + (k * kSubBlocks + s) * kBoxWidth, l.r.ox, l.r.oy, l.r.oz, l.ix,
                          l.iy, l.iz, reach<K>(l));
        }
        const unsigned entered = __ballot_sync(kFull, in_sub);
        const int first = k * kClusterRows + s * kStageRows;
        const int count = min(kStageRows, n_rows - first);
        if (entered == 0 || count <= 0) continue;
        test_block<K, kCount>(rows, first, count, in_sub, entered, w.scratch, slot, lane, l);
      }
    } else {
      // the cluster's rows [first, min(first + count, n_rows))
      const int first = static_cast<int>(box[6]);
      const int last = min(first + static_cast<int>(box[7]), n_rows);
      for (int c = first; c < last; c += kStageRows) {
        const bool in = in_cluster && !l.occ;
        const unsigned entered = __ballot_sync(kFull, in);
        if (entered == 0) break;
        test_block<K, kCount>(rows, c, min(kStageRows, last - c), in, entered, w.scratch, slot,
                              lane, l);
      }
    }
  }
}

}  // namespace strolle
