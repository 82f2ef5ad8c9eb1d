// BVH8 closest-hit and any-hit walks for NVIDIA Hopper (sm_90a).
//
// Replaces, in tpurt/kernels/traverse8.py:
//   _closest8_kernel  (traverse_pallas8 with shade_out=True)
//   _occluded8_kernel (occluded_pallas8)
//
// What they compute is tpurt's; how is not.  The TPU kernels walk (sub, 128)
// ray packets through a row stack in VMEM.  Here one thread walks one ray
// with its own stack.  The selection (lexicographic (t, id) closest hit, any
// hit in (t_min, t_max)) does not depend on visit order, so a per-ray walk
// gives the packet walk's hits wherever the ray's own box tests are
// conservative (see tpurt_torch/kernels/traverse8.py for the one exception,
// inherited from tpurt's _safe_inv).
//
// The arithmetic copies tpurt's op for op: the slab as lo*inv - o*inv,
// _safe_inv, Möller–Trumbore with the smooth inverse det/(det*det + 1e-12)
// in _mt_scalar_tri's order, and NaN-propagating min/max like jnp's.  The
// library is built with -fmad=false so nvcc contracts nothing into FMAs; the
// plain-torch twin then agrees with this kernel bit for bit.
//
// What bounds it on this card: every visit is a dependent 256-byte load of
// a node record (the next node's address comes out of the previous visit),
// followed by up to 8 dependent 512-byte triangle-row loads, so a thread is
// mostly waiting on memory latency; and the 32 rays of a warp take different
// paths, so the warp runs the union of their visits (divergence).  The
// simple design keeps the node and triangle rows in global memory, read
// through L1/L2 (at 1M triangles the node rows are 14 MB and fit the 50 MB
// L2; the 99 MB of triangle rows do not), relies on Morton-ordered rays so
// neighbouring threads walk similar paths, and keeps the stack in
// thread-local memory.  Making it fast
// (packet or warp-cooperative walks, persistent threads, compressed nodes)
// is left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kStackV = 192;       // tpurt's STACKV
constexpr int kEntries = 8;
constexpr int kLaneOff = 1 << 25;  // lane codec offset
constexpr float kTMax = 1e30f;
constexpr float kDetEps = 1e-12f;
constexpr int kBlock = 128;

// Lane codec: integers travel as the bit patterns of negative normal floats.
// Read the bits, never convert the value.
__device__ __forceinline__ int decode_lane(float f) {
  return (__float_as_int(f) & 0x3FFFFFFF) - kLaneOff;
}

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

// tpurt _slab8 for one box (lox, loy, loz, hix, hiy, hiz).
__device__ __forceinline__ bool slab(const float* b, const Ray& r, float t_min,
                                     float t_upper) {
  float tx0 = b[0] * r.ix - r.oix, tx1 = b[3] * r.ix - r.oix;
  float ty0 = b[1] * r.iy - r.oiy, ty1 = b[4] * r.iy - r.oiy;
  float tz0 = b[2] * r.iz - r.oiz, tz1 = b[5] * r.iz - r.oiz;
  float t_near = jmax(jmax(jmin(tx0, tx1), jmin(ty0, ty1)),
                      jmax(jmin(tz0, tz1), t_min));
  float t_far = jmin(jmin(jmax(tx0, tx1), jmax(ty0, ty1)),
                     jmin(jmax(tz0, tz1), t_upper));
  return t_near <= t_far;
}

// Slab-test the 8 children of node `cur` against [t_min, t_upper]; bit c of
// the result is child c.  Fills the decoded metas.
__device__ __forceinline__ unsigned visit_mask(const float* wrow, int cur,
                                               const Ray& r, float t_min,
                                               float t_upper, int meta[kEntries]) {
  const float* node = wrow + (size_t)cur * 64;  // row cur/2, lanes 64*(cur%2)
  unsigned mask = 0;
#pragma unroll
  for (int c = 0; c < kEntries; ++c) {
    meta[c] = decode_lane(node[48 + c]);
    if (slab(node + 6 * c, r, t_min, t_upper)) mask |= 1u << c;
  }
  return mask;
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

// tpurt _stack_push / _stack_pop, clamps included.
__device__ __forceinline__ void push(int* stack, int& sp, int m) {
  stack[min(sp, kStackV - 1)] = m;
  ++sp;
}
__device__ __forceinline__ int pop(const int* stack, int& sp) {
  if (sp <= 0) return -1;
  int top = stack[min(max(sp - 1, 0), kStackV - 1)];
  --sp;
  return top;
}

template <bool kShade>
__global__ void __launch_bounds__(kBlock)
closest8_kernel(const float* __restrict__ wrow, const float* __restrict__ rows,
                const float* __restrict__ o, const float* __restrict__ d, int n,
                int max_rows, float t_min, float* __restrict__ t_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ id_out, float* __restrict__ alb_out,
                float* __restrict__ emi_out, float* __restrict__ nrm_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  float t_b = kTMax, u_b = 0.0f, v_b = 0.0f;
  int id_b = -1;
  float sh[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int stack[kStackV];
  int sp = 0;
  int cur = 0;
  while (cur >= 0) {
    int meta[kEntries];
    // The cull bound is the best t at the start of the visit, as in tpurt.
    unsigned mask = visit_mask(wrow, cur, r, t_min, t_b, meta);
    for (int c = 0; c < kEntries; ++c) {
      if (!((mask >> c) & 1u)) continue;
      int m = meta[c];
      if (m >= 0) {
        push(stack, sp, m);
        continue;
      }
      int nm = ~m;
      int row0 = nm >> 3, n_rows = (nm & 7) + 1;
      for (int rr = 0; rr < max_rows && rr < n_rows; ++rr) {
        const float* tr = rows + (size_t)(row0 + rr) * 128;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float t, u, v, det;
          mt(tr + 9 * j, r, t, u, v, det);
          int tid = decode_lane(tr[72 + j]);
          bool better = (t < t_b) || ((t == t_b) && (tid < id_b) && (id_b >= 0));
          bool ok = (fabsf(det) > kDetEps) && (u >= 0.0f) && (v >= 0.0f) &&
                    (u + v <= 1.0f) && (t > t_min) && better && (tid >= 0);
          if (ok) {
            t_b = t; u_b = u; v_b = v; id_b = tid;
            if (kShade) {
              const float* e = tr + 9 * j;  // e1 at 3..5, e2 at 6..8
              sh[0] = tr[80 + 3 * j]; sh[1] = tr[81 + 3 * j]; sh[2] = tr[82 + 3 * j];
              sh[3] = tr[104 + 3 * j]; sh[4] = tr[105 + 3 * j]; sh[5] = tr[106 + 3 * j];
              sh[6] = e[4] * e[8] - e[5] * e[7];
              sh[7] = e[5] * e[6] - e[3] * e[8];
              sh[8] = e[3] * e[7] - e[4] * e[6];
            }
          }
        }
      }
    }
    cur = pop(stack, sp);
  }
  t_out[i] = t_b;
  u_out[i] = u_b;
  v_out[i] = v_b;
  id_out[i] = id_b;
  if (kShade) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      alb_out[3 * i + k] = sh[k];
      emi_out[3 * i + k] = sh[3 + k];
      nrm_out[3 * i + k] = sh[6 + k];
    }
  }
}

__global__ void __launch_bounds__(kBlock)
occluded8_kernel(const float* __restrict__ wrow, const float* __restrict__ rows,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tm, int n, int max_rows, float t_min,
                 unsigned char* __restrict__ blk_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = tm[i];
  bool blocked = false;
  // An empty window (t_max <= t_min, e.g. the t_max = 0 of a missed primary
  // ray) can never block: the ray starts dead.
  if (tmax > t_min) {
    const Ray r = load_ray(o, d, i);
    int stack[kStackV];
    int sp = 0;
    int cur = 0;
    while (cur >= 0 && !blocked) {
      int meta[kEntries];
      unsigned mask = visit_mask(wrow, cur, r, t_min, tmax, meta);
      for (int c = 0; c < kEntries && !blocked; ++c) {
        if (!((mask >> c) & 1u)) continue;
        int m = meta[c];
        if (m >= 0) {
          push(stack, sp, m);
          continue;
        }
        int nm = ~m;
        int row0 = nm >> 3, n_rows = (nm & 7) + 1;
        for (int rr = 0; rr < max_rows && rr < n_rows && !blocked; ++rr) {
          const float* tr = rows + (size_t)(row0 + rr) * 128;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float t, u, v, det;
            mt(tr + 9 * j, r, t, u, v, det);
            blocked |= (fabsf(det) > kDetEps) && (u >= 0.0f) && (v >= 0.0f) &&
                       (u + v <= 1.0f) && (t > t_min) && (t < tmax) &&
                       (decode_lane(tr[72 + j]) >= 0);
          }
        }
      }
      cur = pop(stack, sp);
    }
  }
  blk_out[i] = blocked ? 1 : 0;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, never synchronise, and return
// cudaGetLastError() of the launch (0 on success).
int tpurt_closest8(const float* wrow, const float* rows, const float* o,
                   const float* d, int n, int max_rows, float t_min, float* t,
                   float* u, float* v, int* id, float* alb, float* emi,
                   float* nrm, cudaStream_t stream) {
  if (n <= 0) return 0;
  int grid = (n + kBlock - 1) / kBlock;
  if (alb != nullptr) {
    closest8_kernel<true><<<grid, kBlock, 0, stream>>>(
        wrow, rows, o, d, n, max_rows, t_min, t, u, v, id, alb, emi, nrm);
  } else {
    closest8_kernel<false><<<grid, kBlock, 0, stream>>>(
        wrow, rows, o, d, n, max_rows, t_min, t, u, v, id, nullptr, nullptr,
        nullptr);
  }
  return (int)cudaGetLastError();
}

int tpurt_occluded8(const float* wrow, const float* rows, const float* o,
                    const float* d, const float* tm, int n, int max_rows,
                    float t_min, unsigned char* blocked, cudaStream_t stream) {
  if (n <= 0) return 0;
  int grid = (n + kBlock - 1) / kBlock;
  occluded8_kernel<<<grid, kBlock, 0, stream>>>(wrow, rows, o, d, tm, n,
                                                max_rows, t_min, blocked);
  return (int)cudaGetLastError();
}

const char* tpurt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
