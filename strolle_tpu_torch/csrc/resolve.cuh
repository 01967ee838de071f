// The winner's attributes from its pack_geometry row, shared by the port's
// surface kernels (kernel 4 in trace_kernels.cu, 8 in cluster_kernels.cu,
// 10 in bvh_kernels.cu); the same operations, in the same order, as
// ops/kernels/trace_kernels.py::resolve_winner.
//
// Row: v0(3) e1(3) e2(3) n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) mat(1) pad(3).
// The normal is w n0 + u n1 + v n2 (w = 1 - u - v), flipped by the sign
// of the Möller-Trumbore determinant (with the fused multiply-adds of the
// closest-hit test, so the sign is the one that test saw) and normalised
// by 1 / sqrt(max(|n|^2, 1e-20)): a correctly rounded sqrt and divide, not
// the approximate rsqrtf, so the result is bit-equal to the plain version.

#pragma once

#include <math.h>

namespace strolle {

__device__ __forceinline__ void resolve_surface(const float* r, float dx, float dy, float dz,
                                                float bu, float bv, float* n, float* uv,
                                                int* mat) {
  const float px = fmaf(dy, r[8], -(dz * r[7]));
  const float py = fmaf(dz, r[6], -(dx * r[8]));
  const float pz = fmaf(dx, r[7], -(dy * r[6]));
  const float det = fmaf(r[5], pz, fmaf(r[4], py, r[3] * px));
  const float dsign = det >= 0.0f ? 1.0f : -1.0f;
  const float w = 1.0f - bu - bv;
  const float nx = w * r[9] + bu * r[12] + bv * r[15];
  const float ny = w * r[10] + bu * r[13] + bv * r[16];
  const float nz = w * r[11] + bu * r[14] + bv * r[17];
  const float inv_len = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f));
  const float flip = dsign * inv_len;
  n[0] = nx * flip;
  n[1] = ny * flip;
  n[2] = nz * flip;
  uv[0] = w * r[18] + bu * r[20] + bv * r[22];
  uv[1] = w * r[19] + bu * r[21] + bv * r[23];
  *mat = static_cast<int>(r[24]);
}

}  // namespace strolle
