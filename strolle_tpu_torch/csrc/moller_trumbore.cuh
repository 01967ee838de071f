// The ray-triangle test shared by the port's kernels (trace_kernels.cu,
// stream_kernels.cu, cluster_kernels.cu, bvh_kernels.cu): Möller-Trumbore
// on a row v0(3) e1(3) e2(3).
//
// Multiply-adds are fused exactly where XLA:CPU fuses them in the JAX
// package (and where ops/intersect.py's plain version does):
// cross = fma(a1, b2, -(a2 * b1)), dot = fma(a2, b2, fma(a1, b1, a0 * b0)).
// Everything else rounds separately (the library is built with
// --fmad=false), so t is bit-identical to the plain version's and the
// closest-hit ids match the JAX package's tensor route, coplanar ties
// included.

#pragma once

#include <math.h>

namespace strolle {

constexpr float kEps = 1.1920929e-07f;  // float32 machine epsilon

struct MtHit {
  float t, u, v;  // t = +inf on a miss
};

__device__ __forceinline__ MtHit moller_trumbore(const float* r, float ox, float oy,
                                                 float oz, float dx, float dy, float dz) {
  const float v0x = r[0], v0y = r[1], v0z = r[2];
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  // pvec = d x e2
  const float px = fmaf(dy, e2z, -(dz * e2y));
  const float py = fmaf(dz, e2x, -(dx * e2z));
  const float pz = fmaf(dx, e2y, -(dy * e2x));
  const float det = fmaf(e1z, pz, fmaf(e1y, py, e1x * px));
  const float inv_det = fabsf(det) < kEps ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  const float u = fmaf(tz, pz, fmaf(ty, py, tx * px)) * inv_det;
  // qvec = tvec x e1
  const float qx = fmaf(ty, e1z, -(tz * e1y));
  const float qy = fmaf(tz, e1x, -(tx * e1z));
  const float qz = fmaf(tx, e1y, -(ty * e1x));
  const float v = fmaf(dz, qz, fmaf(dy, qy, dx * qx)) * inv_det;
  const float t = fmaf(e2z, qz, fmaf(e2y, qy, e2x * qx)) * inv_det;
  const bool hit = fabsf(det) >= kEps && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                   u + v <= 1.0f && t > 0.0f;
  return {hit ? t : INFINITY, u, v};
}

// Möller-Trumbore on row ``row`` of rows ``width`` floats wide in global
// memory, read through the read-only path.
__device__ __forceinline__ MtHit test_row(const float* __restrict__ rows, int row, int width,
                                          float ox, float oy, float oz, float dx, float dy,
                                          float dz) {
  float r[9];
  const float* p = rows + static_cast<size_t>(row) * width;
#pragma unroll
  for (int q = 0; q < 9; ++q) r[q] = __ldg(p + q);
  return moller_trumbore(r, ox, oy, oz, dx, dy, dz);
}

}  // namespace strolle
