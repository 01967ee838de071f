// Möller-Trumbore split where a ray may leave a row early, shared by the
// brute-force kernels (A, B and 4: trace_kernels.cu) and the warp walk of
// kernels 5, 6, 8 and 9 (warp_walk.cuh). Every value a row yields is
// moller_trumbore()'s (moller_trumbore.cuh), from its operations in its
// order, so t, u and v stay bit-identical to the plain versions'.
//
// The split: few ray-row pairs pass the first half of the test (|det| >=
// eps and 0 <= u <= 1: 13.7% of Cornell's primaries against its rows,
// 0.6% of random rays against the dungeon's), so the rest is computed only
// where it passes, in branches that a warp skips once none of its lanes
// passes. Rows are three float4 of shared memory, (v0, e1.x), (e1.y, e1.z,
// e2.x, e2.y), (e2.z, pad), kQuads float4 apart.

#pragma once

#include <math.h>

#include "moller_trumbore.cuh"

namespace strolle {

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  return {o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

// The closest hit found so far: t = +inf and tri = -1 until one is.
struct Closest {
  float t, u, v;
  int tri;
};

// The any-hit test of one row in two parts: mt_front computes the
// determinant and u, mt_back the rest, and a lane runs mt_back only where
// mt_front passes.
struct MtFront {
  float px, py, pz, inv_det, u, tx, ty, tz;
  bool pass;  // |det| >= eps and 0 <= u <= 1
};

__device__ __forceinline__ MtFront mt_front(float4 a, float4 b, float4 c, float ox, float oy,
                                            float oz, float dx, float dy, float dz) {
  MtFront f;
  // pvec = d x e2
  f.px = fmaf(dy, c.x, -(dz * b.w));
  f.py = fmaf(dz, b.z, -(dx * c.x));
  f.pz = fmaf(dx, b.w, -(dy * b.z));
  const float det = fmaf(b.y, f.pz, fmaf(b.x, f.py, a.w * f.px));
  f.inv_det = fabsf(det) < kEps ? 0.0f : 1.0f / (det == 0.0f ? 1.0f : det);
  f.tx = ox - a.x, f.ty = oy - a.y, f.tz = oz - a.z;
  f.u = fmaf(f.tz, f.pz, fmaf(f.ty, f.py, f.tx * f.px)) * f.inv_det;
  f.pass = fabsf(det) >= kEps && f.u >= 0.0f && f.u <= 1.0f;
  return f;
}

// True where the ray hits the row at t < tm, given mt_front's pass.
__device__ __forceinline__ bool mt_back(const MtFront& f, float4 a, float4 b, float4 c,
                                        float dx, float dy, float dz, float tm) {
  // qvec = tvec x e1
  const float qx = fmaf(f.ty, b.y, -(f.tz * b.x));
  const float qy = fmaf(f.tz, a.w, -(f.tx * b.y));
  const float qz = fmaf(f.tx, b.x, -(f.ty * a.w));
  const float v = fmaf(dz, qz, fmaf(dy, qy, dx * qx)) * f.inv_det;
  const float t = fmaf(c.x, qz, fmaf(b.w, qy, b.z * qx)) * f.inv_det;
  return v >= 0.0f && f.u + v <= 1.0f && t > 0.0f && t < tm;
}

// Does a hit at t on row ``row`` beat ``best``? By t alone (kRowTies
// false: rows come in ascending order, so strict < leaves a tie to the
// lowest row), or by (t, row) where rows come in any order; a hit at
// +inf then still never beats a miss.
template <bool kRowTies>
__device__ __forceinline__ bool beats(float t, int row, const Closest& best) {
  if constexpr (kRowTies) {
    return t < best.t || (t == best.t && best.tri >= 0 && row < best.tri);
  } else {
    return t < best.t;
  }
}

// The closest-hit loop: rows [begin, end) of a shared-memory tile whose
// rows lie kQuads float4 apart ([T, 12] rows: 3; [T, 28]: 7), row k
// numbered first + k, in ascending order. Each row takes
// moller_trumbore()'s operations in its order, in steps that a warp skips
// once none of its lanes needs the next:
// 1. pvec, det, tvec and u's numerator. The row is dropped here, before
//    the division, only where the exact test is certain to reject it:
//    |det| < eps (the test's own rule); or, with eps <= |det| <= 2^20,
//    |u_num| > |det| (1 + 2^-20), or u_num of the other sign than det
//    with |u_num| >= 2^-100. (The product |det| (1 + 2^-20), 1/det and
//    u = u_num (1/det) each round by at most 2^-24 of themselves, so u >
//    (1 + 2^-20)(1 - 2^-24)^3 > 1; and |u| >= 2^-100 2^-20 is a normal
//    float, so u < 0, not the -0.0 of an underflow, which passes u >= 0.)
//    A NaN fails every comparison and goes on to the exact test.
// 2. 1/det (the test's inv_det wherever |det| >= eps) and u.
// 3. Where 0 <= u <= 1: qvec and t; v only where t > 0 beats the best hit
//    (``beats``).
template <int kQuads, bool kRowTies = false>
__device__ __forceinline__ void closest_rows(const float4* __restrict__ s, int begin, int end,
                                             int first, const Ray& r, Closest& best) {
  for (int k = begin; k < end; ++k) {
    const float4 a = s[kQuads * k], b = s[kQuads * k + 1], c = s[kQuads * k + 2];
    // pvec = d x e2
    const float px = fmaf(r.dy, c.x, -(r.dz * b.w));
    const float py = fmaf(r.dz, b.z, -(r.dx * c.x));
    const float pz = fmaf(r.dx, b.w, -(r.dy * b.z));
    const float det = fmaf(b.y, pz, fmaf(b.x, py, a.w * px));
    const float tx = r.ox - a.x, ty = r.oy - a.y, tz = r.oz - a.z;
    const float u_num = fmaf(tz, pz, fmaf(ty, py, tx * px));
    const float ad = fabsf(det), au = fabsf(u_num);
    if (ad < kEps ||
        (ad <= 0x1p20f && (au > ad * (1.0f + 0x1p-20f) ||
                           ((__float_as_int(u_num) ^ __float_as_int(det)) < 0 &&
                            au >= 0x1p-100f)))) {
      continue;
    }
    const float inv_det = 1.0f / det;
    const float u = u_num * inv_det;
    if (!(u >= 0.0f && u <= 1.0f)) continue;
    // qvec = tvec x e1
    const float qx = fmaf(ty, b.y, -(tz * b.x));
    const float qy = fmaf(tz, a.w, -(tx * b.y));
    const float qz = fmaf(tx, b.x, -(ty * a.w));
    const float t = fmaf(c.x, qz, fmaf(b.w, qy, b.z * qx)) * inv_det;
    if (!(t > 0.0f && beats<kRowTies>(t, first + k, best))) continue;
    const float v = fmaf(r.dz, qz, fmaf(r.dy, qy, r.dx * qx)) * inv_det;
    if (v >= 0.0f && u + v <= 1.0f) best = {t, u, v, first + k};
  }
}

}  // namespace strolle
