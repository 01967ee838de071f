// BVH closest hit with the surface attributes resolved (kernel 10) and
// BVH any hit (kernel 11), for NVIDIA Hopper (sm_90a).
//
// Replaces: strolle_tpu/ops/pallas/bvh_kernels.py
//   bvh_trace_surface_pallas (_bvh_surface_kernel) and
//   bvh_trace_anyhit_pallas (_bvh_anyhit_kernel).
//
// What they compute, one thread per ray, each with its own stack of
// kMaxStack node ids in local memory (the root pre-pushed): pop a node of
// the [N, 16] rows (lmin lmax rmin rmax child0 child1 count0 count1),
// slab-test both children against the ray's best t (kernel 10, from +inf)
// or t_max (kernel 11); intersect leaf children inline, child 0 then
// child 1, up to kMaxLeaf rows [T', 28] each (a hit kept on strict <);
// push the interior children far first, so that the near one (the
// smaller entry distance, ties to child 0) pops first; clamp the stack
// pointer at kMaxStack - 1 as the TPU kernel does. Kernel 10 then
// resolves the winner's normal, uv and material id from its row
// (resolve.cuh) and writes t (+inf on a miss), tri (-1), normal, uv,
// mat_id (zeros on a miss). Kernel 11 stops at its first occluder;
// t_max <= 0 never occludes.
//
// The TPU kernel walks a 32x128 ray tile with ONE shared stack, descends
// a node when any ray of the tile wants it, orders children by the tile's
// nearest entry and interpolates every accepted candidate's attributes.
// Here each ray walks alone, as the reference does (strolle-gpu/src/
// ray.rs:114-266) and as the JAX package's jnp traversal does, and reads
// the winner's row once at the end: the inputs of the interpolation are
// the same, so are its bits. On an exact tie in t between triangles of
// different leaves the two orders can keep different triangles.
//
// What bounds them on this card: operations. A node costs two slab tests
// (~25 fp32 operations each) and a leaf row a ray-triangle test (~46).
// The node rows (6,843 x 64 B = 438 KB for the dungeon) do not fit the
// 227 KB of shared memory a block may have, so nodes and rows are read
// through the read-only path and stay in the 50 MB L2. Divergence between
// the rays of a warp (different walks) is the cost of this simple form.
//
// The kCount variant (not used by the timed launches) also writes each
// ray's count of box tests and triangle tests: the walk's work, held
// against the plain version's and set beside the kernel's bound.
//
// Floating point: --fmad=false, no fast math; slab.cuh, moller_trumbore.cuh
// and resolve.cuh repeat the plain version's operations
// (ops/kernels/bvh_kernels.py), so every output is bit-equal to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moller_trumbore.cuh"
#include "resolve.cuh"
#include "slab.cuh"

namespace {

using strolle::inv_dir;
using strolle::MtHit;
using strolle::resolve_surface;
using strolle::slab;
using strolle::test_row;

constexpr int kThreads = 128;
constexpr int kRowWidth = 28;
constexpr int kNodeWidth = 16;
constexpr int kMaxStack = 48;
constexpr int kMaxLeaf = 8;
// The entry distance of a child box the ray misses, for the near-first order.
constexpr float kBig = 1e30f;

struct Node {
  float r[kNodeWidth];
};

__device__ __forceinline__ Node load_node(const float* __restrict__ nodes, int id) {
  Node n;
  const float* p = nodes + static_cast<size_t>(id) * kNodeWidth;
#pragma unroll
  for (int q = 0; q < kNodeWidth; ++q) n.r[q] = __ldg(p + q);
  return n;
}

// Pushes the interior children of node n that the ray enters, far first.
__device__ __forceinline__ void push_children(const Node& n, bool hit0, float tn0, bool hit1,
                                              float tn1, int* stack, int* ptr) {
  const int c0 = static_cast<int>(n.r[12]), c1 = static_cast<int>(n.r[13]);
  const bool push0 = hit0 && c0 >= 0, push1 = hit1 && c1 >= 0;
  const bool near0 = (hit0 ? tn0 : kBig) <= (hit1 ? tn1 : kBig);
  const int far_child = near0 ? c1 : c0, near_child = near0 ? c0 : c1;
  const bool far_push = near0 ? push1 : push0, near_push = near0 ? push0 : push1;
  if (far_push) {
    stack[min(*ptr, kMaxStack - 1)] = far_child;
    ++*ptr;
  }
  if (near_push) {
    stack[min(*ptr, kMaxStack - 1)] = near_child;
    ++*ptr;
  }
  *ptr = min(*ptr, kMaxStack - 1);
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
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float bt = INFINITY, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  int box_tests = 0, tri_tests = 0;
  int stack[kMaxStack];
  stack[0] = 0;
  int ptr = 1;
  while (ptr > 0) {
    const Node n = load_node(nodes, stack[--ptr]);
    if (kCount) box_tests += 2;
    float tn0, tn1;
    const bool hit0 = slab(n.r, n.r + 3, ox, oy, oz, ix, iy, iz, bt, &tn0);
    const bool hit1 = slab(n.r + 6, n.r + 9, ox, oy, oz, ix, iy, iz, bt, &tn1);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = static_cast<int>(n.r[12 + k]);
      if (!(k == 0 ? hit0 : hit1) || c >= 0) continue;
      const int first = -(c + 1);
      const int cnt = min(static_cast<int>(n.r[14 + k]), kMaxLeaf);
      if (kCount && cnt > 0) tri_tests += cnt;
      for (int j = first; j < first + cnt; ++j) {
        const MtHit h = test_row(rows, j, kRowWidth, ox, oy, oz, dx, dy, dz);
        if (h.t < bt) {
          bt = h.t;
          btri = j;
          bu = h.u;
          bv = h.v;
        }
      }
    }
    push_children(n, hit0, tn0, hit1, tn1, stack, &ptr);
  }
  float nrm[3] = {0.0f, 0.0f, 0.0f}, uv[2] = {0.0f, 0.0f};
  int mat = 0;
  if (btri >= 0) {
    resolve_surface(rows + static_cast<size_t>(btri) * kRowWidth, dx, dy, dz, bu, bv, nrm, uv,
                    &mat);
  }
  t_out[i] = bt;
  tri_out[i] = btri;
  normal_out[3 * i] = nrm[0];
  normal_out[3 * i + 1] = nrm[1];
  normal_out[3 * i + 2] = nrm[2];
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
    bvh_anyhit_kernel(const float* __restrict__ nodes, const float* __restrict__ rows,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_max, int n_rays, bool* __restrict__ occluded,
                      int* __restrict__ work) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = t_max[i];
  bool occ = false;
  int box_tests = 0, tri_tests = 0;
  if (tm > 0.0f) {
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    int stack[kMaxStack];
    stack[0] = 0;
    int ptr = 1;
    while (ptr > 0 && !occ) {
      const Node n = load_node(nodes, stack[--ptr]);
      if (kCount) box_tests += 2;
      float tn0, tn1;
      const bool hit0 = slab(n.r, n.r + 3, ox, oy, oz, ix, iy, iz, tm, &tn0);
      const bool hit1 = slab(n.r + 6, n.r + 9, ox, oy, oz, ix, iy, iz, tm, &tn1);
      for (int k = 0; k < 2 && !occ; ++k) {
        const int c = static_cast<int>(n.r[12 + k]);
        if (!(k == 0 ? hit0 : hit1) || c >= 0) continue;
        const int first = -(c + 1);
        const int cnt = min(static_cast<int>(n.r[14 + k]), kMaxLeaf);
        for (int j = first; j < first + cnt; ++j) {
          if (kCount) ++tri_tests;
          if (test_row(rows, j, kRowWidth, ox, oy, oz, dx, dy, dz).t < tm) {
            occ = true;
            break;
          }
        }
      }
      if (!occ) push_children(n, hit0, tn0, hit1, tn1, stack, &ptr);
    }
  }
  occluded[i] = occ;
  if (kCount) {
    work[2 * i] += box_tests;
    work[2 * i + 1] += tri_tests;
  }
}

}  // namespace

extern "C" int strolle_bvh_trace_surface(const float* nodes, const float* rows, const float* o,
                                         const float* d, int n_rays, float* t, int* tri,
                                         float* normal, float* uv, int* mat, int* work,
                                         void* stream) {
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
