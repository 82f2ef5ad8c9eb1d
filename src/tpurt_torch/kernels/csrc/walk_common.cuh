// Device helpers shared by the BVH walks (traverse8.cu, traverse.cu): the
// ray record, tpurt's _safe_inv, NaN-propagating min/max and Möller–Trumbore
// in tpurt's op order.  Everything here has internal linkage, so each
// source that includes it gets its own copy.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kTMax = 1e30f;
constexpr float kDetEps = 1e-12f;
constexpr int kBlock = 128;         // threads a block; one ray a thread
constexpr int kKMax = 16;           // largest k the k-nearest kernels keep
constexpr int kBigId = 0x7FFFFFFF;  // empty k-list slot id (tpurt's big_id)

// tpurt _safe_inv: where(|d| > 1e-30, 1/d, sign(d) * 1e30 + 1e30).  Zero
// maps to 1e30, a tiny negative to 0 (so every slab test fails for it).
__device__ __forceinline__ float safe_inv(float d) {
  if (fabsf(d) > 1e-30f) return 1.0f / d;
  float s = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);  // sign; keeps 0 and NaN
  return s * 1e30f + 1e30f;
}

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN (fminf and
// fmaxf would drop it).
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz, oix, oiy, oiz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, int i) {
  Ray r;
  r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
  r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  r.oix = r.ox * r.ix; r.oiy = r.oy * r.iy; r.oiz = r.oz * r.iz;
  return r;
}

// tpurt _mt_scalar_tri: triangle j of a row holds (v0, e1, e2) at 9j..9j+8.
__device__ __forceinline__ void mt(const float* tri, const Ray& r, float& t,
                                   float& u, float& v, float& det) {
  float v0x = tri[0], v0y = tri[1], v0z = tri[2];
  float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  det = e1x * px + e1y * py + e1z * pz;
  float inv_det = det / (det * det + kDetEps);
  float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  float qx = tvy * e1z - tvz * e1y;
  float qy = tvz * e1x - tvx * e1z;
  float qz = tvx * e1y - tvy * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
}

}  // namespace
