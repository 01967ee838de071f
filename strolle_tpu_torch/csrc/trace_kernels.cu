// Brute-force closest-hit (kernel A), any-hit (kernel B) and closest hit
// with the surface attributes resolved (kernel 4) for NVIDIA Hopper
// (sm_90a).
//
// Replaces: strolle_tpu/ops/pallas/trace_kernels.py
//   trace_closest_brute_pallas (_brute_closest_kernel),
//   trace_anyhit_brute_pallas (_brute_anyhit_kernel) and
//   trace_surface_pallas (_surface_closest_kernel).
//
// What they compute: for every ray, Möller-Trumbore against all packed
// [T, 12] rows (v0, e1, e2, pad). A: the closest hit (t, tri, u, v),
// t = +inf and tri = -1 on a miss, the lowest index winning ties
// (strict < in ascending order). B: whether any row is hit at t < t_max.
//
// What bounds them on this card: operations. Each ray-triangle test is
// about 40 fp32 operations on 24 bytes of ray, reused against every row,
// so at Cornell size (40 rows) the work is ~50x the bytes at the card's
// fp32 balance. The TPU kernel tiled rays into (128, 128) planes to keep
// its vector unit dense and broadcast one row per step; here it is one
// thread per ray (the ragged tail masked), and the block copies all rows
// into shared memory once, so every row read in the loop is a broadcast
// from shared memory that all 32 lanes of a warp take in one go. B leaves
// its loop at the first occluder, which does not change its answer.
//
// Floating point: built with --fmad=false and no fast math (see
// ops/kernels/cuda_lib.py), with explicit fmaf exactly where the plain
// version (ops/intersect.py) fuses; each operation then rounds as there,
// so t is bit-identical to it and tri equal, coplanar ties included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1.1920929e-07f;  // float32 machine epsilon
constexpr int kRowWidth = 12;
constexpr int kGeomWidth = 28;
constexpr int kThreads = 256;

struct MtHit {
  float t, u, v;
};

__device__ __forceinline__ MtHit moller_trumbore(const float* r, float ox, float oy,
                                                 float oz, float dx, float dy,
                                                 float dz) {
  const float v0x = r[0], v0y = r[1], v0z = r[2];
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  // Multiply-adds fused exactly where XLA:CPU fuses them in the JAX
  // package (and where ops/intersect.py's plain version does):
  // cross = fma(a1, b2, -(a2 * b1)), dot = fma(a2, b2, fma(a1, b1, a0 * b0)).
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

__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    closest_brute_kernel(const float* __restrict__ rows, int n_rows,
                         const float* __restrict__ o, const float* __restrict__ d,
                         int n_rays, float* __restrict__ t_out,
                         int* __restrict__ tri_out, float* __restrict__ u_out,
                         float* __restrict__ v_out) {
  extern __shared__ float s_rows[];
  load_rows(s_rows, rows, n_rows * kRowWidth);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float bt = INFINITY, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  for (int k = 0; k < n_rows; ++k) {
    const MtHit h = moller_trumbore(s_rows + k * kRowWidth, ox, oy, oz, dx, dy, dz);
    if (h.t < bt) {
      bt = h.t;
      btri = k;
      bu = h.u;
      bv = h.v;
    }
  }
  t_out[i] = bt;
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
}

__global__ void __launch_bounds__(kThreads)
    anyhit_brute_kernel(const float* __restrict__ rows, int n_rows,
                        const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ t_max, int n_rays,
                        bool* __restrict__ occluded) {
  extern __shared__ float s_rows[];
  load_rows(s_rows, rows, n_rows * kRowWidth);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = t_max[i];
  bool occ = false;
  for (int k = 0; k < n_rows; ++k) {
    if (moller_trumbore(s_rows + k * kRowWidth, ox, oy, oz, dx, dy, dz).t < tm) {
      occ = true;
      break;
    }
  }
  occluded[i] = occ;
}

__global__ void __launch_bounds__(kThreads)
    surface_closest_kernel(const float* __restrict__ rows, int n_rows,
                           const float* __restrict__ o, const float* __restrict__ d,
                           int n_rays, float* __restrict__ t_out,
                           int* __restrict__ tri_out, float* __restrict__ u_out,
                           float* __restrict__ v_out, float* __restrict__ normal_out,
                           float* __restrict__ uv_out, int* __restrict__ mat_out) {
  extern __shared__ float s_rows[];
  load_rows(s_rows, rows, n_rows * kGeomWidth);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float bt = INFINITY, bu = 0.0f, bv = 0.0f;
  int btri = -1;
  for (int k = 0; k < n_rows; ++k) {
    const MtHit h = moller_trumbore(s_rows + k * kGeomWidth, ox, oy, oz, dx, dy, dz);
    if (h.t < bt) {
      bt = h.t;
      btri = k;
      bu = h.u;
      bv = h.v;
    }
  }
  // A miss resolves to zeros, as the TPU kernel's where-selects leave it.
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, uvx = 0.0f, uvy = 0.0f;
  int mat = 0;
  if (btri >= 0) {
    const float* r = s_rows + btri * kGeomWidth;
    // det sign for the normal flip, with the fused multiply-adds of the
    // closest-hit test (so the sign is the one that test saw)
    const float px = fmaf(dy, r[8], -(dz * r[7]));
    const float py = fmaf(dz, r[6], -(dx * r[8]));
    const float pz = fmaf(dx, r[7], -(dy * r[6]));
    const float det = fmaf(r[5], pz, fmaf(r[4], py, r[3] * px));
    const float dsign = det >= 0.0f ? 1.0f : -1.0f;
    const float w = 1.0f - bu - bv;
    nx = w * r[9] + bu * r[12] + bv * r[15];
    ny = w * r[10] + bu * r[13] + bv * r[16];
    nz = w * r[11] + bu * r[14] + bv * r[17];
    // a correctly rounded sqrt and divide rather than the approximate
    // rsqrtf, to stay within an ulp of the plain version's torch.rsqrt
    const float inv_len = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-20f));
    const float flip = dsign * inv_len;
    nx *= flip;
    ny *= flip;
    nz *= flip;
    uvx = w * r[18] + bu * r[20] + bv * r[22];
    uvy = w * r[19] + bu * r[21] + bv * r[23];
    mat = static_cast<int>(r[24]);
  }
  t_out[i] = bt;
  tri_out[i] = btri;
  u_out[i] = bu;
  v_out[i] = bv;
  normal_out[3 * i] = nx;
  normal_out[3 * i + 1] = ny;
  normal_out[3 * i + 2] = nz;
  uv_out[2 * i] = uvx;
  uv_out[2 * i + 1] = uvy;
  mat_out[i] = mat;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int strolle_trace_closest_brute(const float* rows, int n_rows, const float* o,
                                           const float* d, int n_rays, float* t, int* tri,
                                           float* u, float* v, void* stream) {
  const size_t smem = sizeof(float) * kRowWidth * static_cast<size_t>(n_rows);
  cudaError_t err = prepare(closest_brute_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  closest_brute_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, o, d, n_rays, t, tri, u, v);
  return cudaGetLastError();
}

extern "C" int strolle_trace_anyhit_brute(const float* rows, int n_rows, const float* o,
                                          const float* d, const float* t_max, int n_rays,
                                          bool* occluded, void* stream) {
  const size_t smem = sizeof(float) * kRowWidth * static_cast<size_t>(n_rows);
  cudaError_t err = prepare(anyhit_brute_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  anyhit_brute_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, o, d, t_max, n_rays, occluded);
  return cudaGetLastError();
}


extern "C" int strolle_trace_surface(const float* rows, int n_rows, const float* o,
                                     const float* d, int n_rays, float* t, int* tri,
                                     float* u, float* v, float* normal, float* uv,
                                     int* mat, void* stream) {
  const size_t smem = sizeof(float) * kGeomWidth * static_cast<size_t>(n_rows);
  cudaError_t err = prepare(surface_closest_kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  surface_closest_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, o, d, n_rays, t, tri, u, v, normal, uv, mat);
  return cudaGetLastError();
}
