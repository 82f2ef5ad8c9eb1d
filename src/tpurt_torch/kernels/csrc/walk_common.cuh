// Device helpers shared by the BVH walks (traverse8.cu, traverse.cu,
// packet.cu): the ray record, tpurt's _safe_inv, NaN-propagating min/max, the
// binary slab test and Möller–Trumbore in tpurt's op order; for the two
// k-nearest kernels, the sorted k-list and their half-row test; for the two
// any-hit kernels, theirs.  Everything here has internal linkage, so each
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

// The same as one instruction each (min.NaN / max.NaN, sm_80 and later):
// NaN in either operand gives NaN.  They can differ from jmin/jmax only in
// which zero (+0 or -0) or which NaN payload they return, which no
// comparison tells apart, so a walk that only compares their results (a
// slab test, a cull bound) decides exactly as with jmin/jmax.  jmin and
// jmax cost five or six instructions each.
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

// tpurt's binary slab test (kernels/traverse.py _slab, accel/packet.py
// _slab) for one ray: a = (lo.x, lo.y, lo.z, hi.x), b = (hi.y, hi.z, 0, 0),
// the node's node_f32 row; its NaN-propagating min/max as nmin/nmax, the
// same decision as jmin/jmax in fewer instructions.
__device__ __forceinline__ bool slab_bin_n(const float4& a, const float4& b,
                                           const Ray& r, float t_min,
                                           float t_upper) {
  float tx0 = (a.x - r.ox) * r.ix, tx1 = (a.w - r.ox) * r.ix;
  float ty0 = (a.y - r.oy) * r.iy, ty1 = (b.x - r.oy) * r.iy;
  float tz0 = (a.z - r.oz) * r.iz, tz1 = (b.y - r.oz) * r.iz;
  float t_near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                      nmax(nmin(tz0, tz1), t_min));
  float t_far = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                     nmin(nmax(tz0, tz1), t_upper));
  return t_near <= t_far;
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

// ---------------------------------------------------------------------------
// The k-nearest kernels' shared parts (knear8, knear_bin)
// ---------------------------------------------------------------------------

// The k nearest band hits of one ray, sorted by (t, id): tpurt's bubble
// insert, one candidate at a time.  The list length KM is a compile-time
// bound (4, 8 or 16, the smallest >= k); every loop over the list is
// unrolled to KM and guarded by i < k, so ts/ids stay in registers.  A
// candidate enters only if it sorts before the k-th entry, which is also
// tpurt's outcome (a later one falls off the end of the bubble, an equal
// one is a duplicate).  kDedup (knear8): a candidate whose id is already
// listed is dropped, since boundary rows shared by adjacent fat leaves
// repeat a triangle; a binary leaf holds each triangle once.
template <int KM, bool kDedup>
struct KList {
  int k;
  float ts[KM];
  int ids[KM];

  __device__ explicit KList(int kk) : k(kk) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      ts[i] = kTMax;
      ids[i] = kBigId;
    }
  }
  __device__ __forceinline__ void kth(float& t, int& id) const {
    t = ts[KM - 1];
    id = ids[KM - 1];
#pragma unroll
    for (int i = 0; i < KM - 1; ++i)
      if (i == k - 1) { t = ts[i]; id = ids[i]; }
  }
  // The walk's cull bound min(k-th t, t_max), with jnp.minimum's NaN rule.
  __device__ __forceinline__ float upper(float tmax) const {
    float t;
    int id;
    kth(t, id);
    return jmin(t, tmax);
  }
  __device__ __forceinline__ void insert(float tc, int ic) {
    float kt;
    int kid;
    kth(kt, kid);
    if (!((tc < kt) || ((tc == kt) && (ic < kid)))) return;
    if (kDedup) {
      bool dup = false;
#pragma unroll
      for (int i = 0; i < KM; ++i) dup |= (i < k) && (ids[i] == ic);
      if (dup) return;
    }
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      bool less = (i < k) && ((tc < ts[i]) || ((tc == ts[i]) && (ic < ids[i])));
      float tt = ts[i];
      int ii = ids[i];
      ts[i] = less ? tc : tt;
      ids[i] = less ? ic : ii;
      tc = less ? tt : tc;
      ic = less ? ii : ic;
    }
  }
  // Row-major (N, k) output, the empty slots as -1.
  __device__ __forceinline__ void store(int* out, size_t i) const {
#pragma unroll
    for (int j = 0; j < KM; ++j)
      if (j < k) out[i * k + j] = ids[j] == kBigId ? -1 : ids[j];
  }
};

// Half h (0 or 1) of a leaf row's 8 triangles: triangles 4h..4h+3, their
// (v0, e1, e2) at 36h..36h+35, as 9 16-byte loads through the read-only
// path, all issued before any is used.  The row must be 16-byte aligned
// (rows are 512 bytes; the wrappers check the base pointer).  A half row
// holds 36 floats in registers where a whole row would hold 72, which
// leaves room for a fourth or fifth block on each SM.
__device__ __forceinline__ void load_half(const float* row, int h, float (&f)[36]) {
  const float4* p = reinterpret_cast<const float4*>(row) + 9 * h;
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float4 v = __ldg(p + q);
    f[4 * q] = v.x; f[4 * q + 1] = v.y; f[4 * q + 2] = v.z; f[4 * q + 3] = v.w;
  }
}

// Accept, then insert: a half row's 4 band tests unrolled into an accept
// mask (which also drops what cannot sort before the k-th entry at the
// half's start: the k-th only falls while inserting, so insert() would
// drop it too), then the accepted candidates inserted in slot order by a
// loop that is not unrolled, so a warp runs it as often as its busiest lane
// accepts.  The same candidates reach insert() in the same order as a
// one-slot-at-a-time test, so the list is the same.
template <int KM, bool kDedup>
__device__ __forceinline__ void knear_half(const float (&f)[36], const int (&tid)[4],
                                           const Ray& r, float t_min, float tmax,
                                           float neg_band, float band_hi,
                                           KList<KM, kDedup>& L) {
  float kt;
  int kid;
  L.kth(kt, kid);
  float t[4];
  unsigned ok = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float u, v, det;
    mt(f + 9 * j, r, t[j], u, v, det);
    const bool a = (fabsf(det) > kDetEps) && (u >= neg_band) && (v >= neg_band) &&
                   (u + v <= band_hi) && (t[j] > t_min) && (t[j] < tmax) &&
                   (tid[j] >= 0) &&
                   ((t[j] < kt) || ((t[j] == kt) && (tid[j] < kid)));
    ok |= (unsigned)a << j;
  }
#pragma unroll 1
  while (ok) {
    const int j = __ffs(ok) - 1;
    ok &= ok - 1;
    float tc = t[0];
    int ic = tid[0];
#pragma unroll
    for (int q = 1; q < 4; ++q)
      if (q == j) { tc = t[q]; ic = tid[q]; }
    L.insert(tc, ic);
  }
}

// ---------------------------------------------------------------------------
// The any-hit kernels' shared part (occluded8, occluded_bin)
// ---------------------------------------------------------------------------

// Whether a half row blocks: any of its 4 triangles (the half's (v0, e1,
// e2) from load_half, ids tid) lies at t_min < t < tmax, tpurt's any-hit
// test.  The 4 tests run unrolled and fold into one flag, so a walk can end
// after the first half row that blocks.
__device__ __forceinline__ bool occluded_half(const float (&f)[36], const int (&tid)[4],
                                              const Ray& r, float t_min, float tmax) {
  bool blocked = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float t, u, v, det;
    mt(f + 9 * j, r, t, u, v, det);
    blocked |= (fabsf(det) > kDetEps) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
               (t > t_min) && (t < tmax) && (tid[j] >= 0);
  }
  return blocked;
}

}  // namespace
