// tpurt's packet engine (accel/packet.py, method="packet") for NVIDIA Hopper
// (sm_90a), over the packed layout of tpurt_torch/accel/packet.py.
//
// Counterparts, in tpurt/accel/packet.py (pure XLA there, no Pallas kernel):
//   traverse_packet       -> packet_closest_kernel
//   occluded_packet       -> packet_occluded_kernel
//   k_nearest_ids_packet  -> packet_knear_kernel<KM>
//
// The packet is part of the function.  The rays are taken 1,024 at a time
// (packet p is rays [1024 p, 1024 p + 1024), the last one padded with zero
// rays), and a packet walks the escape chain with ONE cursor: a node is
// wanted when any ray of the packet passes its slab test; a wanted internal
// node moves the cursor to node + 1, anything else to its escape link, and
// -1 ends the walk.  A wanted leaf's 8 triangles are tested against every ray
// of the packet, whatever the ray's own slab test said, so a ray can take a
// hit that its own walk would never reach (a direction component in
// [-1e-30, 0), whose inverse is 0; a band hit outside its own inflated box).
// The pad rays (o = d = 0) vote too: for the closest hit their bound is
// T_MAX, so they want every box that holds the origin; the any-hit and
// k-nearest walks give them t_max = 0, so they never do.
//
// On this card the packet is a thread block: one CTA a packet, one thread a
// ray (1,024 threads), the cursor uniform over the CTA.  `want` is
// __syncthreads_or of the rays' slab tests; the any-hit walk ends once every
// ray of the packet is blocked (__syncthreads_and, pad rays included, as
// tpurt's `~all(blocked)`); a wanted leaf's 72 floats and 8 ids are staged
// once in shared memory, from where every thread reads them as broadcasts.
// A 1,024-thread CTA leaves each thread 64 registers, so the k-nearest lists
// (up to 16 (t, id) pairs a ray) live in shared memory, slot-major, one bank
// per thread; the closest hit and the flags live in registers.
//
// What bounds them is latency, not bytes or operations: a visit is one
// dependent node load and one CTA-wide barrier around ~25 slab operations a
// thread, and the cursor cannot move before every warp has voted.  The
// operations the function needs (1,024 slab tests a visit, 8,192
// Möller–Trumbore tests a leaf visit) bound it; the kernels run at a sixth
// of that bound or less (PERF.md).  A design that fills the barrier's wait
// (several packets a CTA, or the next node's record loaded before the vote)
// is later work.
//
// The arithmetic is tpurt's packet engine's: _safe_inv, the slab as
// (lo - o) * inv with NaN-propagating min/max (slab_bin_n), and
// Möller–Trumbore with the smooth inverse in _mt_packet's order (mt(), which
// is _mt_scalar_tri's: tpurt's _mt_packet matches intersect_tri bit for bit).
// The closest hit keeps tpurt's (t, id) selection slot by slot, the k-lists
// tpurt's insertion (position = the count of entries lexicographically below
// the candidate, the rest shifted up, no dedup, -1 in empty slots).  Built
// with -fmad=false, the kernels agree with their plain-torch twins
// (kernels/packet.py) bit for bit.

#include "walk_common.cuh"

namespace {

constexpr int kPacket = 1024;        // rays a packet: tpurt's PACKET_RAYS
constexpr int kRowFloats = 72;       // LEAF_CAP x (v0, e1, e2)
constexpr int kLeafCap = 8;

// Ray i of the flat batch, or a pad ray (o = d = 0, so inv = 1e30) past n.
__device__ __forceinline__ Ray packet_ray(const float* o, const float* d, size_t i,
                                          int n) {
  if (i < (size_t)n) return load_ray(o, d, (int)i);
  Ray r;
  r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = 0.0f;
  r.ix = r.iy = r.iz = safe_inv(0.0f);
  r.oix = r.oiy = r.oiz = 0.0f;
  return r;
}

// A wanted leaf's row (72 floats) and ids into shared memory, for the whole
// CTA.  The caller's next barrier orders the reads of the previous leaf
// before these writes; the __syncthreads here orders them before the tests.
__device__ __forceinline__ void stage_leaf(const float* __restrict__ rows,
                                           const int* __restrict__ ids, int leaf_row,
                                           float* s_tri, int* s_id) {
  const int t = threadIdx.x;
  if (t < kRowFloats)
    s_tri[t] = __ldg(rows + (size_t)leaf_row * 128 + t);
  else if (t < kRowFloats + kLeafCap)
    s_id[t - kRowFloats] = __ldg(ids + (size_t)leaf_row * kLeafCap + (t - kRowFloats));
  __syncthreads();
}

__global__ void __launch_bounds__(kPacket, 1)
packet_closest_kernel(const float4* __restrict__ nf, const int4* __restrict__ ni,
                      const float* __restrict__ rows, const int* __restrict__ ids,
                      const float* __restrict__ o, const float* __restrict__ d, int n,
                      float t_min, float* __restrict__ t_out, float* __restrict__ u_out,
                      float* __restrict__ v_out, int* __restrict__ id_out) {
  __shared__ float s_tri[kRowFloats];
  __shared__ int s_id[kLeafCap];
  const size_t i = (size_t)blockIdx.x * kPacket + threadIdx.x;
  const Ray r = packet_ray(o, d, i, n);
  float tb = kTMax, ub = 0.0f, vb = 0.0f;
  int ib = -1;
  int node = 0;
  while (node >= 0) {
    const float4 a = __ldg(nf + 2 * node), b = __ldg(nf + 2 * node + 1);
    const int4 rec = __ldg(ni + node);
    const bool want = __syncthreads_or(slab_bin_n(a, b, r, t_min, tb));
    const bool leaf = rec.w > 0;
    if (want && leaf) {
      stage_leaf(rows, ids, rec.y, s_tri, s_id);
#pragma unroll 1
      for (int j = 0; j < kLeafCap; ++j) {
        float t, u, v, det;
        mt(s_tri + 9 * j, r, t, u, v, det);
        const int tid = s_id[j];
        const bool better = (t < tb) || ((t == tb) && (tid < ib) && (ib >= 0));
        if ((fabsf(det) > kDetEps) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
            (t > t_min) && better && (tid >= 0)) {
          tb = t; ub = u; vb = v; ib = tid;
        }
      }
    }
    node = (want && !leaf) ? node + 1 : rec.x;
  }
  if (i < (size_t)n) {
    t_out[i] = tb; u_out[i] = ub; v_out[i] = vb; id_out[i] = ib;
  }
}

__global__ void __launch_bounds__(kPacket, 1)
packet_occluded_kernel(const float4* __restrict__ nf, const int4* __restrict__ ni,
                       const float* __restrict__ rows, const int* __restrict__ ids,
                       const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ tm, int n, float t_min,
                       unsigned char* __restrict__ blocked_out) {
  __shared__ float s_tri[kRowFloats];
  __shared__ int s_id[kLeafCap];
  const size_t i = (size_t)blockIdx.x * kPacket + threadIdx.x;
  const Ray r = packet_ray(o, d, i, n);
  const float tmax = i < (size_t)n ? tm[i] : 0.0f;
  bool blocked = false;
  int node = 0;
  while (node >= 0) {
    const float4 a = __ldg(nf + 2 * node), b = __ldg(nf + 2 * node + 1);
    const int4 rec = __ldg(ni + node);
    const bool want = __syncthreads_or(slab_bin_n(a, b, r, t_min, tmax) && !blocked);
    const bool leaf = rec.w > 0;
    node = (want && !leaf) ? node + 1 : rec.x;
    if (want && leaf) {
      stage_leaf(rows, ids, rec.y, s_tri, s_id);
#pragma unroll 1
      for (int j = 0; j < kLeafCap; ++j) {
        float t, u, v, det;
        mt(s_tri + 9 * j, r, t, u, v, det);
        blocked |= (fabsf(det) > kDetEps) && (u >= 0.0f) && (v >= 0.0f) &&
                   (u + v <= 1.0f) && (t > t_min) && (t < tmax) && (s_id[j] >= 0);
      }
      // tpurt's loop condition, ~all(blocked): the flags change only here.
      // The barrier also orders this leaf's reads before the next staging.
      if (__syncthreads_and(blocked)) break;
    }
  }
  if (i < (size_t)n) blocked_out[i] = blocked;
}

// The k nearest band hits of each ray by (t, id), tpurt's insertion, the
// lists slot-major in dynamic shared memory: ts[s * kPacket + thread], then
// ids the same.  KM (4, 8 or 16, the smallest >= k) bounds the unrolled
// loops; k <= KM entries are live.
template <int KM>
__global__ void __launch_bounds__(kPacket, 1)
packet_knear_kernel(const float4* __restrict__ nf, const int4* __restrict__ ni,
                    const float* __restrict__ rows, const int* __restrict__ ids,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tm, int n, float t_min, int k,
                    float neg_band, float band_hi, int* __restrict__ ids_out) {
  extern __shared__ float s_dyn[];
  __shared__ float s_tri[kRowFloats];
  __shared__ int s_id[kLeafCap];
  float* ts = s_dyn + threadIdx.x;
  int* li = reinterpret_cast<int*>(s_dyn + KM * kPacket) + threadIdx.x;
  const size_t i = (size_t)blockIdx.x * kPacket + threadIdx.x;
  const Ray r = packet_ray(o, d, i, n);
  const float tmax = i < (size_t)n ? tm[i] : 0.0f;
#pragma unroll
  for (int s = 0; s < KM; ++s) {
    ts[s * kPacket] = kTMax;
    li[s * kPacket] = -1;
  }
  int node = 0;
  while (node >= 0) {
    const float4 a = __ldg(nf + 2 * node), b = __ldg(nf + 2 * node + 1);
    const int4 rec = __ldg(ni + node);
    const float upper = jmin(ts[(k - 1) * kPacket], tmax);
    const bool want = __syncthreads_or(slab_bin_n(a, b, r, t_min, upper));
    const bool leaf = rec.w > 0;
    if (want && leaf) {
      stage_leaf(rows, ids, rec.y, s_tri, s_id);
#pragma unroll 1
      for (int j = 0; j < kLeafCap; ++j) {
        float t, u, v, det;
        mt(s_tri + 9 * j, r, t, u, v, det);
        const int tid = s_id[j];
        const float lt = ts[(k - 1) * kPacket];
        const int lid = li[(k - 1) * kPacket];
        const bool ok = (fabsf(det) > kDetEps) && (u >= neg_band) && (v >= neg_band) &&
                        (u + v <= band_hi) && (t > t_min) && (t < tmax) && (tid >= 0) &&
                        ((t < lt) || ((t == lt) && (tid < lid)));
        if (ok) {
          int pos = 0;
#pragma unroll
          for (int s = 0; s < KM; ++s) {
            const float e = ts[s * kPacket];
            pos += (s < k) && ((e < t) || ((e == t) && (li[s * kPacket] < tid)));
          }
#pragma unroll
          for (int s = KM - 1; s > 0; --s) {
            if (s < k && s > pos) {
              ts[s * kPacket] = ts[(s - 1) * kPacket];
              li[s * kPacket] = li[(s - 1) * kPacket];
            }
          }
          ts[pos * kPacket] = t;
          li[pos * kPacket] = tid;
        }
      }
    }
    node = (want && !leaf) ? node + 1 : rec.x;
  }
  if (i < (size_t)n) {
    for (int s = 0; s < k; ++s) ids_out[i * k + s] = li[s * kPacket];
  }
}

template <int KM>
int launch_knear(int grid, const float4* nf, const int4* ni, const float* rows,
                 const int* ids, const float* o, const float* d, const float* tm, int n,
                 float t_min, int k, float neg_band, float band_hi, int* out,
                 cudaStream_t stream) {
  const int smem = 2 * KM * kPacket * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(packet_knear_kernel<KM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  packet_knear_kernel<KM><<<grid, kPacket, smem, stream>>>(
      nf, ni, rows, ids, o, d, tm, n, t_min, k, neg_band, band_hi, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point launches one CTA of 1,024 threads a packet on `stream`,
// never synchronises, and returns cudaGetLastError() of the launch (0 on
// success).  node_f32 is (M, 8) f32, node_i32 (M, 4) i32, rows (L, 128) f32
// and ids (L, 8) i32, all contiguous, node rows 16-byte aligned (the wrapper
// checks); o and d (n, 3) f32; tm (n,) f32.
int tpurt_packet_closest(const float* node_f32, const int* node_i32, const float* rows,
                         const int* ids, const float* o, const float* d, int n, float t_min,
                         float* t, float* u, float* v, int* id, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kPacket - 1) / kPacket;
  packet_closest_kernel<<<grid, kPacket, 0, stream>>>(
      reinterpret_cast<const float4*>(node_f32), reinterpret_cast<const int4*>(node_i32),
      rows, ids, o, d, n, t_min, t, u, v, id);
  return (int)cudaGetLastError();
}

int tpurt_packet_occluded(const float* node_f32, const int* node_i32, const float* rows,
                          const int* ids, const float* o, const float* d, const float* tm,
                          int n, float t_min, unsigned char* blocked, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kPacket - 1) / kPacket;
  packet_occluded_kernel<<<grid, kPacket, 0, stream>>>(
      reinterpret_cast<const float4*>(node_f32), reinterpret_cast<const int4*>(node_i32),
      rows, ids, o, d, tm, n, t_min, blocked);
  return (int)cudaGetLastError();
}

// out: (n, k) int32, k in [1, 16].  neg_band and band_hi are -band and
// 1 + band rounded once to f32, as the twin compares.
int tpurt_packet_knear(const float* node_f32, const int* node_i32, const float* rows,
                       const int* ids, const float* o, const float* d, const float* tm, int n,
                       float t_min, int k, float neg_band, float band_hi, int* out,
                       cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kKMax) return (int)cudaErrorInvalidValue;
  const int grid = (n + kPacket - 1) / kPacket;
  const float4* nf = reinterpret_cast<const float4*>(node_f32);
  const int4* ni = reinterpret_cast<const int4*>(node_i32);
  if (k <= 4)
    return launch_knear<4>(grid, nf, ni, rows, ids, o, d, tm, n, t_min, k, neg_band, band_hi,
                           out, stream);
  if (k <= 8)
    return launch_knear<8>(grid, nf, ni, rows, ids, o, d, tm, n, t_min, k, neg_band, band_hi,
                           out, stream);
  return launch_knear<16>(grid, nf, ni, rows, ids, o, d, tm, n, t_min, k, neg_band, band_hi,
                          out, stream);
}

}  // extern "C"
