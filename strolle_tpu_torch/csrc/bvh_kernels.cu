// BVH closest hit with the surface attributes resolved (kernel 10) and
// BVH any hit (kernel 11), for NVIDIA Hopper (sm_90a).
//
// Replaces: strolle_tpu/ops/pallas/bvh_kernels.py
//   bvh_trace_surface_pallas (_bvh_surface_kernel) and
//   bvh_trace_anyhit_pallas (_bvh_anyhit_kernel).
//
// What they compute, one thread per ray, each with its own stack of
// kMaxStack node ids (the root pre-pushed): pop a node of the [N, 16] rows
// (lmin lmax rmin rmax child0 child1 count0 count1), slab-test both
// children against the ray's best t (kernel 10, from +inf) or t_max
// (kernel 11); intersect leaf children inline, child 0 then child 1, up to
// kMaxLeaf rows [T', 28] each (a hit kept on strict <); push the interior
// children far first, so that the near one (the smaller entry distance,
// ties to child 0) pops first; clamp the stack pointer at kMaxStack - 1 as
// the TPU kernel does. Kernel 10 then resolves the winner's normal, uv and
// material id from its row (resolve.cuh) and writes t (+inf on a miss),
// tri (-1), normal, uv, mat_id (zeros on a miss). Kernel 11 stops at its
// first occluder; t_max <= 0 never occludes.
//
// The TPU kernel walks a 32x128 ray tile with ONE shared stack, descends
// a node when any ray of the tile wants it, orders children by the tile's
// nearest entry and interpolates every accepted candidate's attributes.
// Here each ray walks alone, as the reference does (strolle-gpu/src/
// ray.rs:114-266) and as the JAX package's jnp traversal does, and reads
// the winner's row once at the end: the inputs of the interpolation are
// the same, so are its bits. On an exact tie in t between triangles of
// different leaves the two orders can keep different triangles. (A walk
// per warp, as the TPU kernel's, would test 1.22x the nodes per dungeon
// primary and 2.55x per light shadow ray.)
//
// What bounds them on this card: instruction issue, not bytes. A dungeon
// primary visits ~31 nodes and tests ~2.7 triangles; all the rays of a
// launch touch a few hundred nodes (8-15 KB), which stay in L1. Half of a
// node visit's instructions are its two slab tests, whose subtracts,
// multiplies and min/max do not pair into fused multiply-adds. So the
// node visit is kept lean:
// - the node is four 16-byte loads through the read-only path;
// - the near child of two pushed ones is the one with tn0 <= tn1, with
//   no selects for missed boxes (both boxes were entered);
// - kernel 11 tests a leaf's rows with the split Möller-Trumbore test of
//   split_test.cuh (mt_front / mt_back), each row three float4 at the
//   rows' 112-byte stride; kernel 10 with the whole test
//   (moller_trumbore.cuh): a leaf holds 1.23 rows on average and half of
//   its tests pass the first half, and closest_rows measured 3% slower
//   there.
// Measured on the H100 and dropped (PERF.md, section 6): persistent warps fed
// from a ray queue, their lanes refilled once 1, 8, 16 or all 32 were
// free (slower than one ray per thread on every ray set: the hardware's
// block scheduler already keeps the SMs full, and the queue's votes and
// the rays' lost coherence cost more than the idle lanes it fills); the
// stack as a [slot][thread] column of shared memory, with or without its
// top in a register (the stack in local memory, which L1 holds, was
// faster); a bound of 40 registers (spills); 64 or 256 threads a block
// (within 2%).
//
// The kCount variant (not used by the timed launches) also adds each
// ray's count of box tests and triangle tests to ``work``: the walk's
// work, held against the plain version's and set beside the kernel's
// bound.
//
// Floating point: --fmad=false, no fast math; slab.cuh, moller_trumbore.cuh,
// split_test.cuh and resolve.cuh repeat the plain version's operations
// (ops/kernels/bvh_kernels.py), so every output is bit-equal to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moller_trumbore.cuh"
#include "resolve.cuh"
#include "slab.cuh"
#include "split_test.cuh"

namespace {

using strolle::Closest;
using strolle::inv_dir;
using strolle::load_ray;
using strolle::mt_back;
using strolle::mt_front;
using strolle::MtFront;
using strolle::MtHit;
using strolle::Ray;
using strolle::resolve_surface;
using strolle::slab;
using strolle::test_row;

constexpr int kThreads = 128;
constexpr int kRowWidth = 28;
constexpr int kRowQuads = kRowWidth / 4;
constexpr int kNodeQuads = 4;
constexpr int kMaxStack = 48;
constexpr int kMaxLeaf = 8;

// A node: two child boxes, the children (a leaf < 0: rows from -(c + 1))
// and the leaves' row counts, as four float4.
struct Node {
  float4 q0, q1, q2, q3;
};

__device__ __forceinline__ Node load_node(const float* __restrict__ nodes, int id) {
  const float4* p = reinterpret_cast<const float4*>(nodes) + static_cast<size_t>(id) * kNodeQuads;
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

// A ray's walk: its ray, inverse direction, bound, stack pointer and
// counts, all in registers. Its stack of node ids, indexed at run time, is
// an array of its own in local memory: inside this struct it would take
// the struct's other fields to local memory with it (measured 40% slower,
// PERF.md).
struct Walk {
  Ray r;
  float ix, iy, iz;
  float bound;  // kernel 10: the best t so far; kernel 11: t_max
  int ptr;
  int box_tests, tri_tests;
};

__device__ __forceinline__ Walk start(const float* __restrict__ o, const float* __restrict__ d,
                                      int i, float bound, int* stack) {
  Walk w;
  w.r = load_ray(o, d, i);
  w.ix = inv_dir(w.r.dx), w.iy = inv_dir(w.r.dy), w.iz = inv_dir(w.r.dz);
  w.bound = bound;
  stack[0] = 0;
  w.ptr = 1;
  w.box_tests = w.tri_tests = 0;
  return w;
}

// Kernel 11's rows [first, first + cnt): true at the first occluder.
template <bool kCount>
__device__ __forceinline__ bool occluded_rows(const float* __restrict__ rows, int first, int cnt,
                                              Walk& w) {
#pragma unroll 1
  for (int j = first; j < first + cnt; ++j) {
    if (kCount) ++w.tri_tests;
    const float4* q = reinterpret_cast<const float4*>(rows) + static_cast<size_t>(j) * kRowQuads;
    const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    const MtFront f = mt_front(a, b, c, w.r.ox, w.r.oy, w.r.oz, w.r.dx, w.r.dy, w.r.dz);
    if (f.pass && mt_back(f, a, b, c, w.r.dx, w.r.dy, w.r.dz, w.bound)) return true;
  }
  return false;
}

// Kernel 10's rows [first, first + cnt), in ascending order, a hit kept
// on strict <.
__device__ __forceinline__ void closest_leaf(const float* __restrict__ rows, int first, int cnt,
                                             const Ray& r, Closest& best) {
#pragma unroll 1
  for (int j = first; j < first + cnt; ++j) {
    const MtHit h = test_row(rows, j, kRowWidth, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
    if (h.t < best.t) best = {h.t, h.u, h.v, j};
  }
}

// One node of the walk: pop, slab-test both children against the bound,
// test leaf children inline, push interior children far first. Kernel 10
// keeps its closest hit in ``best`` and its bound at best.t; kernel 11
// returns true at its first occluder, false otherwise.
template <bool kAnyhit, bool kCount>
__device__ __forceinline__ bool visit(Walk& w, int* stack, const float* __restrict__ nodes,
                                      const float* __restrict__ rows, Closest& best) {
  const Node n = load_node(nodes, stack[--w.ptr]);
  if (kCount) w.box_tests += 2;
  const float lo0[3] = {n.q0.x, n.q0.y, n.q0.z}, hi0[3] = {n.q0.w, n.q1.x, n.q1.y};
  const float lo1[3] = {n.q1.z, n.q1.w, n.q2.x}, hi1[3] = {n.q2.y, n.q2.z, n.q2.w};
  float tn0, tn1;
  const bool hit0 = slab(lo0, hi0, w.r.ox, w.r.oy, w.r.oz, w.ix, w.iy, w.iz, w.bound, &tn0);
  const bool hit1 = slab(lo1, hi1, w.r.ox, w.r.oy, w.r.oz, w.ix, w.iy, w.iz, w.bound, &tn1);
  const int c0 = static_cast<int>(n.q3.x), c1 = static_cast<int>(n.q3.y);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = k == 0 ? c0 : c1;
    if (!(k == 0 ? hit0 : hit1) || c >= 0) continue;
    const int first = -(c + 1);
    const int cnt = min(static_cast<int>(k == 0 ? n.q3.z : n.q3.w), kMaxLeaf);
    if constexpr (kAnyhit) {
      if (occluded_rows<kCount>(rows, first, cnt, w)) return true;
    } else {
      if (kCount && cnt > 0) w.tri_tests += cnt;
      closest_leaf(rows, first, cnt, w.r, best);
      w.bound = best.t;
    }
  }
  // Interior children: the far one first, so that the near one pops
  // next. Where both are pushed both boxes were entered, and the near
  // one is child 0 where tn0 <= tn1; where one is pushed the order is moot.
  const bool push0 = hit0 && c0 >= 0, push1 = hit1 && c1 >= 0;
  if (push0 && push1) {
    const bool near0 = tn0 <= tn1;
    stack[min(w.ptr, kMaxStack - 1)] = near0 ? c1 : c0;
    stack[min(w.ptr + 1, kMaxStack - 1)] = near0 ? c0 : c1;
    w.ptr += 2;
  } else if (push0 || push1) {
    stack[min(w.ptr, kMaxStack - 1)] = push0 ? c0 : c1;
    w.ptr += 1;
  }
  w.ptr = min(w.ptr, kMaxStack - 1);
  return false;
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    bvh_surface_kernel(const float* __restrict__ nodes, const float* __restrict__ rows,
                       const float* __restrict__ o, const float* __restrict__ d, int n_rays,
                       float* __restrict__ t_out, int* __restrict__ tri_out,
                       float* __restrict__ normal_out, float* __restrict__ uv_out,
                       int* __restrict__ mat_out, int* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  int stack[kMaxStack];
  Walk w = start(o, d, i, INFINITY, stack);
  Closest best = {INFINITY, 0.0f, 0.0f, -1};
  while (w.ptr > 0) visit<false, kCount>(w, stack, nodes, rows, best);
  float nrm[3] = {0.0f, 0.0f, 0.0f}, uv[2] = {0.0f, 0.0f};
  int mat = 0;
  if (best.tri >= 0) {
    resolve_surface(rows + static_cast<size_t>(best.tri) * kRowWidth, w.r.dx, w.r.dy, w.r.dz,
                    best.u, best.v, nrm, uv, &mat);
  }
  t_out[i] = best.t;
  tri_out[i] = best.tri;
  normal_out[3 * i] = nrm[0];
  normal_out[3 * i + 1] = nrm[1];
  normal_out[3 * i + 2] = nrm[2];
  uv_out[2 * i] = uv[0];
  uv_out[2 * i + 1] = uv[1];
  mat_out[i] = mat;
  if (kCount) {
    work[2 * i] += w.box_tests;
    work[2 * i + 1] += w.tri_tests;
  }
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    bvh_anyhit_kernel(const float* __restrict__ nodes, const float* __restrict__ rows,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_max, int n_rays, bool* __restrict__ occluded,
                      int* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float tm = t_max[i];
  bool occ = false;
  if (tm > 0.0f) {
    int stack[kMaxStack];
    Walk w = start(o, d, i, tm, stack);
    Closest unused;
    while (w.ptr > 0 && !occ) occ = visit<true, kCount>(w, stack, nodes, rows, unused);
    if (kCount) {
      work[2 * i] += w.box_tests;
      work[2 * i + 1] += w.tri_tests;
    }
  }
  occluded[i] = occ;
}

// Nodes and rows are read as float4: both must start on a 16-byte
// boundary (the wrappers hand over aligned tables).
bool misaligned(const float* nodes, const float* rows) {
  return ((reinterpret_cast<uintptr_t>(nodes) | reinterpret_cast<uintptr_t>(rows)) & 15) != 0;
}

}  // namespace

extern "C" int strolle_bvh_trace_surface(const float* nodes, const float* rows, const float* o,
                                         const float* d, int n_rays, float* t, int* tri,
                                         float* normal, float* uv, int* mat, int* work,
                                         void* stream) {
  if (misaligned(nodes, rows)) return cudaErrorInvalidValue;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (work != nullptr) {
    bvh_surface_kernel<true><<<blocks, kThreads, 0, s>>>(nodes, rows, o, d, n_rays, t, tri,
                                                         normal, uv, mat, work);
  } else {
    bvh_surface_kernel<false><<<blocks, kThreads, 0, s>>>(nodes, rows, o, d, n_rays, t, tri,
                                                          normal, uv, mat, nullptr);
  }
  return cudaGetLastError();
}

extern "C" int strolle_bvh_trace_anyhit(const float* nodes, const float* rows, const float* o,
                                        const float* d, const float* t_max, int n_rays,
                                        bool* occluded, int* work, void* stream) {
  if (misaligned(nodes, rows)) return cudaErrorInvalidValue;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (work != nullptr) {
    bvh_anyhit_kernel<true><<<blocks, kThreads, 0, s>>>(nodes, rows, o, d, t_max, n_rays,
                                                        occluded, work);
  } else {
    bvh_anyhit_kernel<false><<<blocks, kThreads, 0, s>>>(nodes, rows, o, d, t_max, n_rays,
                                                         occluded, nullptr);
  }
  return cudaGetLastError();
}
