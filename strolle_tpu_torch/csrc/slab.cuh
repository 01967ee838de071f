// The slab test shared by the port's walking kernels (stream_kernels.cu,
// cluster_kernels.cu, bvh_kernels.cu), and the guarded inverse direction
// it takes. The same operations as ops/intersect.py::slab and
// ::safe_inv_dir, in the same order, so the kernels enter exactly the
// boxes their plain versions enter (the library is built with
// --fmad=false).

#pragma once

#include <math.h>

namespace strolle {

// 1 / x, with |x| < 1e-20 replaced by +-1e-20.
__device__ __forceinline__ float inv_dir(float x) {
  const float tiny = 1e-20f;
  return 1.0f / (fabsf(x) < tiny ? (x >= 0.0f ? tiny : -tiny) : x);
}

// Does the ray o + t d (inverse direction i) enter the box lo(3) hi(3)
// before t = best? Writes the entry distance to *tn.
__device__ __forceinline__ bool slab(const float* lo, const float* hi, float ox, float oy,
                                     float oz, float ix, float iy, float iz, float best,
                                     float* tn) {
  const float t0x = (lo[0] - ox) * ix, t1x = (hi[0] - ox) * ix;
  const float t0y = (lo[1] - oy) * iy, t1y = (hi[1] - oy) * iy;
  const float t0z = (lo[2] - oz) * iz, t1z = (hi[2] - oz) * iz;
  const float t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  *tn = t_near;
  return t_near <= t_far && t_far >= 0.0f && t_near <= best;
}

}  // namespace strolle
