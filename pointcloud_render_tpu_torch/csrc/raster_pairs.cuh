// Per-pair evaluations shared by the port's tile kernels
// (csr6_raster.cu, csr2_raster.cu, csr5_raster.cu): one (row, pixel) pair of a
// disc, a capsule or a triangle, in the exact float32 expression order of the
// JAX package's evaluators (pallas_csr._eval_capsule / _eval_tri,
// pallas_csr4._make_row_body16, cpu_reference.rasterize_reference).
// Exactness needs IEEE float32 per operation: every includer builds with
// -fmad=false and without --use_fast_math (1 / iz correctly rounded).
#pragma once

#include <cuda_runtime.h>

namespace {

// jnp.clip / torch.clamp semantics: NaN propagates.
__device__ __forceinline__ float clip01(float v) {
  const float t = v < 0.0f ? 0.0f : v;
  return t > 1.0f ? 1.0f : t;
}

// The capsule body (a disc is a capsule with a zero axis) at one pair,
// (dx, dy) = (qx - x0, qy - y0), with dxs = dx * sdx (the same for a
// whole pixel column of a row): covered, with the depth in *z.
__device__ __forceinline__ bool capsule_pair_col(float dx, float dxs,
                                                 float dy, float z0,
                                                 float r0, float sdx,
                                                 float sdy, float sdz,
                                                 float sdr, float il2,
                                                 float* z) {
  const float t = clip01((dxs + dy * sdy) * il2);
  const float cx = dx - t * sdx;
  const float cy = dy - t * sdy;
  const float rad = r0 + sdr * t;
  *z = z0 + sdz * t;
  return cx * cx + cy * cy <= rad * rad;
}

// capsule_pair_col with dx * sdx evaluated here.
__device__ __forceinline__ bool capsule_pair(float dx, float dy, float z0,
                                             float r0, float sdx, float sdy,
                                             float sdz, float sdr, float il2,
                                             float* z) {
  return capsule_pair_col(dx, dx * sdx, dy, z0, r0, sdx, sdy, sdz, sdr, il2,
                          z);
}

// The triangle body's coverage at one pair: three edge functions e_k =
// a_k * qy - b_k * qx + c_k and the inverse-depth plane iz = e0 * w0 +
// e1 * w1 + e2 * w2 (in *iz); covered where every edge is >= 0 and
// iz > 0.
__device__ __forceinline__ bool tri_cover(float a0, float b0, float c0,
                                          float a1, float b1, float c1,
                                          float a2, float b2, float c2,
                                          float w0, float w1, float w2,
                                          float qx, float qy, float* iz) {
  const float e0 = a0 * qy - b0 * qx + c0;
  const float e1 = a1 * qy - b1 * qx + c1;
  const float e2 = a2 * qy - b2 * qx + c2;
  *iz = e0 * w0 + e1 * w1 + e2 * w2;
  return (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f) & (*iz > 0.0f);
}

// The triangle body at one pair: tri_cover's expressions, with the depth
// 1 / iz in *z.
__device__ __forceinline__ bool tri_pair(float a0, float b0, float c0,
                                         float a1, float b1, float c1,
                                         float a2, float b2, float c2,
                                         float w0, float w1, float w2,
                                         float qx, float qy, float* z) {
  const float e0 = a0 * qy - b0 * qx + c0;
  const float e1 = a1 * qy - b1 * qx + c1;
  const float e2 = a2 * qy - b2 * qx + c2;
  const float iz = e0 * w0 + e1 * w1 + e2 * w2;
  *z = 1.0f / (iz > 0.0f ? iz : 1.0f);
  return (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f) & (iz > 0.0f);
}

// The lexicographic (depth, id) merge of one covered pair into a pixel's
// running minimum (strict compares: the walk order does not matter).
__device__ __forceinline__ void merge_pair(bool cov, float z, float idf,
                                           float* d, float* di) {
  if (cov && ((z < *d) || ((z == *d) && (idf < *di)))) {
    *d = z;
    *di = idf;
  }
}

}  // namespace
