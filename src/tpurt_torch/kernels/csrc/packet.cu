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
// On this card a packet is a thread block, the cursor uniform over it.  A
// visit is a chain no thread of the packet can run ahead of: the node's
// record, ~25 slab operations a ray, a CTA-wide vote (`want`, a
// __syncthreads_or), and under a wanted leaf its row's load, a barrier and
// 8 Möller–Trumbore tests a ray.  With one 1,024-thread packet an SM the
// SM idled through each record's dependent load and each barrier; the
// hard-frame walks (closest hit, any hit) are built to fill those waits:
//  - R = 2 rays a thread, 512 threads a packet, two packets resident on each
//    SM (__launch_bounds__(512, 2): 64 registers a thread, no spill), so one
//    packet's loads and barriers overlap the other's tests, and a vote
//    gathers 16 warps, not 32.
//  - The node records stream forward through shared memory.  In the packed
//    layout the cursor only moves forward (node + 1 or an escape link past
//    the node), so a packet keeps a window of the next kWindow records
//    (48 bytes each, cp.async) and reads a visit's record there; only a
//    cursor that lands past the window waits for a refill, from itself on.
// Measured against other designs in turns (PERF.md): fetching both
// successors' records and the leaf's row by cp.async before the vote, in
// place of the window, lost (its waits are exposed every visit); so did the
// leaf row fetched early beside the window, persistent CTAs on an atomic
// counter, and 4 rays a thread (faster on the 1M closest-hit frames, slower
// on the any-hit and bunny frames; 3 packets an SM spill).  At the card's
// f32 instruction rate the closest-hit walk runs at ~60% of the operations
// its function needs on the 1M frames, the any-hit walk at 30-45% (short
// walks, a barrier at every leaf).
//
// The k-nearest walk is the same walk with a list of up to 16 (t, id)
// pairs a ray.  The lists live in dynamic shared memory, slot-major, a
// warp's lanes on distinct banks: KM x 8 KB a packet (KM = 4, 8 or 16, the
// smallest >= k), so two packets and their windows fit an SM at KM 4 and 8
// (~35 and ~67 KB a packet) and one at KM 16 (~131 KB; 1,024 threads of
// one ray there).  A visit's bound and a candidate's reject test read the
// k-th entry there; an accepted candidate runs tpurt's insertion over the
// live slots.  Its bound is the same count of slab and Möller–Trumbore
// tests as the hard-frame walks' (PERF.md).  Measured in turns and left
// out (PERF.md): each ray's k-th entry kept in registers (~1% slower on 5
// of 6 cells at 64 registers), the KM 4 list wholly in registers (up to
// 17% slower), a leaf's accepted slots collected first and inserted after
// (faster on the bunny, slower on the sponza cells), and 512 threads of 2
// rays at KM 16 (18% slower than 1,024 of one).
//
// The arithmetic is tpurt's packet engine's: _safe_inv, the slab as
// (lo - o) * inv with NaN-propagating min/max (slab_bin_n), and
// Möller–Trumbore with the smooth inverse in _mt_packet's order (mt(), which
// is _mt_scalar_tri's: tpurt's _mt_packet matches intersect_tri bit for bit).
// The closest hit keeps tpurt's (t, id) selection slot by slot, the k-lists
// tpurt's insertion (position = the count of entries lexicographically below
// the candidate, the rest shifted up, no dedup, -1 in empty slots).  Which
// thread walks which ray changes no result: each ray's tests and selections
// run in the same order.  Built with -fmad=false, the kernels agree with
// their plain-torch twins (kernels/packet.py) bit for bit.

#include "walk_common.cuh"

namespace {

constexpr int kPacket = 1024;        // rays a packet: tpurt's PACKET_RAYS
constexpr int kRowFloats = 72;       // LEAF_CAP x (v0, e1, e2)
constexpr int kLeafCap = 8;
constexpr int kRays = 2;             // rays a thread of the hard-frame walks
constexpr int kThreads = 512;        // threads a packet: kPacket / kRays
constexpr int kCtas = 2;             // packets resident on an SM
constexpr int kWindow = 64;          // node records a packet keeps ahead
static_assert(kThreads * kRays == kPacket, "a thread block walks one packet");

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
// CTA (at least 80 threads).  The caller's next barrier orders the reads of
// the previous leaf before these writes; the __syncthreads here orders them
// before the tests.
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

// A node's record: its node_f32 row (two float4) and node_i32 row.
struct __align__(16) NodeRec {
  float4 a, b;
  int4 r;
};

// A hard-frame walk's shared memory: the packet's window of node records and
// the wanted leaf's staged row and ids.
struct PacketShared {
  NodeRec win[kWindow];
  float tri[kRowFloats];
  int id[kLeafCap];
};

// The record of the visit's node from the packet's window of records
// [base, base + kWindow) in shared memory.  A cursor past the window (or
// before it: base starts at -kWindow) refills it from itself on, 3 x 16
// bytes of cp.async a record below num_nodes, each thread waiting for its
// copies, then a barrier.  node and base are uniform over the CTA, so the
// refill is too; the visit before read its record before its vote's
// barrier, so nothing reads the window while it is rewritten.
// THREADS: the CTA's threads, which share the copies.
template <int THREADS = kThreads>
__device__ __forceinline__ NodeRec window_record(NodeRec* win, int& base, int node,
                                                 const float4* __restrict__ nf,
                                                 const int4* __restrict__ ni, int num_nodes) {
  if ((unsigned)(node - base) >= (unsigned)kWindow) {
    base = node;
    for (int q = threadIdx.x; q < 3 * kWindow; q += THREADS) {
      const int m = base + q / 3, part = q % 3;
      if (m < num_nodes) {
        const void* src = part < 2 ? static_cast<const void*>(nf + 2 * (size_t)m + part)
                                   : static_cast<const void*>(ni + m);
        const unsigned dst = (unsigned)__cvta_generic_to_shared(
            reinterpret_cast<float4*>(win + q / 3) + part);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
                     : "memory");
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  return win[node - base];
}

__global__ void __launch_bounds__(kThreads, kCtas)
packet_closest_kernel(const float4* __restrict__ nf, const int4* __restrict__ ni,
                      const float* __restrict__ rows, const int* __restrict__ ids,
                      const float* __restrict__ o, const float* __restrict__ d, int n,
                      int num_nodes, float t_min, float* __restrict__ t_out,
                      float* __restrict__ u_out, float* __restrict__ v_out,
                      int* __restrict__ id_out) {
  __shared__ PacketShared s;
  // ray j of this thread: i0 + j kThreads
  const size_t i0 = (size_t)blockIdx.x * kPacket + threadIdx.x;
  Ray r[kRays];
  float tb[kRays], ub[kRays], vb[kRays];
  int ib[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    r[j] = packet_ray(o, d, i0 + (size_t)j * kThreads, n);
    tb[j] = kTMax; ub[j] = 0.0f; vb[j] = 0.0f; ib[j] = -1;
  }
  int node = 0, base = -kWindow;
  while (node >= 0) {
    const NodeRec c = window_record(s.win, base, node, nf, ni, num_nodes);
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRays; ++j) any |= slab_bin_n(c.a, c.b, r[j], t_min, tb[j]);
    const bool want = __syncthreads_or(any);
    const bool leaf = c.r.w > 0;
    if (want && leaf) {
      stage_leaf(rows, ids, c.r.y, s.tri, s.id);
#pragma unroll 1
      for (int k = 0; k < kLeafCap; ++k) {
        const int tid = s.id[k];
#pragma unroll
        for (int j = 0; j < kRays; ++j) {
          float t, u, v, det;
          mt(s.tri + 9 * k, r[j], t, u, v, det);
          const bool better = (t < tb[j]) || ((t == tb[j]) && (tid < ib[j]) && (ib[j] >= 0));
          if ((fabsf(det) > kDetEps) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
              (t > t_min) && better && (tid >= 0)) {
            tb[j] = t; ub[j] = u; vb[j] = v; ib[j] = tid;
          }
        }
      }
    }
    node = (want && !leaf) ? node + 1 : c.r.x;
  }
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const size_t i = i0 + (size_t)j * kThreads;
    if (i < (size_t)n) {
      t_out[i] = tb[j]; u_out[i] = ub[j]; v_out[i] = vb[j]; id_out[i] = ib[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kCtas)
packet_occluded_kernel(const float4* __restrict__ nf, const int4* __restrict__ ni,
                       const float* __restrict__ rows, const int* __restrict__ ids,
                       const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ tm, int n, int num_nodes, float t_min,
                       unsigned char* __restrict__ blocked_out) {
  __shared__ PacketShared s;
  const size_t i0 = (size_t)blockIdx.x * kPacket + threadIdx.x;
  Ray r[kRays];
  float tmax[kRays];
  bool blocked[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const size_t i = i0 + (size_t)j * kThreads;
    r[j] = packet_ray(o, d, i, n);
    tmax[j] = i < (size_t)n ? tm[i] : 0.0f;
    blocked[j] = false;
  }
  int node = 0, base = -kWindow;
  while (node >= 0) {
    const NodeRec c = window_record(s.win, base, node, nf, ni, num_nodes);
    bool any = false;
#pragma unroll
    for (int j = 0; j < kRays; ++j)
      any |= slab_bin_n(c.a, c.b, r[j], t_min, tmax[j]) && !blocked[j];
    const bool want = __syncthreads_or(any);
    const bool leaf = c.r.w > 0;
    if (want && leaf) {
      stage_leaf(rows, ids, c.r.y, s.tri, s.id);
      bool all = true;
#pragma unroll 1
      for (int k = 0; k < kLeafCap; ++k) {
        const int tid = s.id[k];
#pragma unroll
        for (int j = 0; j < kRays; ++j) {
          float t, u, v, det;
          mt(s.tri + 9 * k, r[j], t, u, v, det);
          blocked[j] |= (fabsf(det) > kDetEps) && (u >= 0.0f) && (v >= 0.0f) &&
                        (u + v <= 1.0f) && (t > t_min) && (t < tmax[j]) && (tid >= 0);
        }
      }
#pragma unroll
      for (int j = 0; j < kRays; ++j) all &= blocked[j];
      // tpurt's loop condition, ~all(blocked): the flags change only here.
      // The barrier also orders this leaf's reads before the next staging.
      if (__syncthreads_and(all)) break;
    }
    node = (want && !leaf) ? node + 1 : c.r.x;
  }
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const size_t i = i0 + (size_t)j * kThreads;
    if (i < (size_t)n) blocked_out[i] = blocked[j];
  }
}

// The k-nearest walk's shape for a list bound KM: rays a thread and packets
// resident on an SM.  Two packets' lists (2 x KM x 1,024 x 8 bytes) and
// windows fit an SM's shared memory at KM 4 and 8, not at 16, where one
// packet runs alone on its SM, 1,024 threads of one ray (faster there than
// 512 of two, PERF.md).
template <int KM>
struct KnearShape {
  static constexpr int rays = KM <= 8 ? kRays : 1;
  static constexpr int threads = kPacket / rays;
  static constexpr int ctas = KM <= 8 ? kCtas : 1;
};

// tpurt's insertion of a candidate (t, id) that sorts before the k-th entry
// into one ray's list, whose slot s is lt[s * kPacket], li[s * kPacket]:
// position = the count of live entries lexicographically below (t, id),
// the later live entries shifted up one slot (the last falls off).
template <int KM>
__device__ __forceinline__ void list_insert(float* lt, int* li, int k, float t, int id) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < KM; ++s) {
    const float e = lt[s * kPacket];
    pos += (s < k) && ((e < t) || ((e == t) && (li[s * kPacket] < id)));
  }
#pragma unroll
  for (int s = KM - 1; s > 0; --s) {
    if (s < k && s > pos) {
      lt[s * kPacket] = lt[(s - 1) * kPacket];
      li[s * kPacket] = li[(s - 1) * kPacket];
    }
  }
  lt[pos * kPacket] = t;
  li[pos * kPacket] = id;
}

// The k nearest band hits of each ray by (t, id), tpurt's insertion.  The
// walk is the hard-frame walks' (R rays a thread, the window of records,
// the staged leaf), the lists slot-major in dynamic shared memory: slot s
// of ray j of thread t at ts[s * kPacket + j * threads + t], then ids the
// same, so a warp's lanes read distinct banks for each of a thread's rays.
// The k-th entry gives the visit's bound min(k-th t, t_max) and a
// candidate's reject test.  KM (4, 8 or 16, the smallest >= k) bounds the
// unrolled loops; k <= KM entries are live.
template <int KM>
__global__ void __launch_bounds__(KnearShape<KM>::threads, KnearShape<KM>::ctas)
packet_knear_kernel(const float4* __restrict__ nf, const int4* __restrict__ ni,
                    const float* __restrict__ rows, const int* __restrict__ ids,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tm, int n, int num_nodes, float t_min, int k,
                    float neg_band, float band_hi, int* __restrict__ ids_out) {
  constexpr int R = KnearShape<KM>::rays, T = KnearShape<KM>::threads;
  __shared__ PacketShared s;
  extern __shared__ float s_dyn[];
  float* ts = s_dyn + threadIdx.x;
  int* li = reinterpret_cast<int*>(s_dyn + KM * kPacket) + threadIdx.x;
  const size_t i0 = (size_t)blockIdx.x * kPacket + threadIdx.x;
  const float* kt = ts + (k - 1) * kPacket;  // ray j's k-th entry: kt[j * T], kid[j * T]
  const int* kid = li + (k - 1) * kPacket;
  Ray r[R];
  float tmax[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const size_t i = i0 + (size_t)j * T;
    r[j] = packet_ray(o, d, i, n);
    tmax[j] = i < (size_t)n ? tm[i] : 0.0f;
#pragma unroll
    for (int q = 0; q < KM; ++q) {
      ts[q * kPacket + j * T] = kTMax;
      li[q * kPacket + j * T] = -1;
    }
  }
  int node = 0, base = -kWindow;
  while (node >= 0) {
    const NodeRec c = window_record<T>(s.win, base, node, nf, ni, num_nodes);
    bool any = false;
#pragma unroll
    for (int j = 0; j < R; ++j)
      any |= slab_bin_n(c.a, c.b, r[j], t_min, jmin(kt[j * T], tmax[j]));
    const bool want = __syncthreads_or(any);
    const bool leaf = c.r.w > 0;
    if (want && leaf) {
      stage_leaf(rows, ids, c.r.y, s.tri, s.id);
#pragma unroll 1
      for (int q = 0; q < kLeafCap; ++q) {
        const int tid = s.id[q];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          float t, u, v, det;
          mt(s.tri + 9 * q, r[j], t, u, v, det);
          if ((fabsf(det) > kDetEps) && (u >= neg_band) && (v >= neg_band) &&
              (u + v <= band_hi) && (t > t_min) && (t < tmax[j]) && (tid >= 0) &&
              ((t < kt[j * T]) || ((t == kt[j * T]) && (tid < kid[j * T]))))
            list_insert<KM>(ts + j * T, li + j * T, k, t, tid);
        }
      }
    }
    node = (want && !leaf) ? node + 1 : c.r.x;
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const size_t i = i0 + (size_t)j * T;
    if (i < (size_t)n) {
      for (int q = 0; q < k; ++q) ids_out[i * k + q] = li[q * kPacket + j * T];
    }
  }
}

template <int KM>
int launch_knear(int grid, const float4* nf, const int4* ni, const float* rows,
                 const int* ids, const float* o, const float* d, const float* tm, int n,
                 int num_nodes, float t_min, int k, float neg_band, float band_hi, int* out,
                 cudaStream_t stream) {
  const int smem = 2 * KM * kPacket * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(packet_knear_kernel<KM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  packet_knear_kernel<KM><<<grid, KnearShape<KM>::threads, smem, stream>>>(
      nf, ni, rows, ids, o, d, tm, n, num_nodes, t_min, k, neg_band, band_hi, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point launches one CTA a packet on `stream` (kThreads
// threads; the k-nearest walk KnearShape's), never synchronises, and
// returns cudaGetLastError() of the launch (0 on success).  node_f32 is
// (num_nodes, 8) f32, node_i32 (num_nodes, 4) i32, rows (L, 128) f32 and
// ids (L, 8) i32, all contiguous and 16-byte aligned (the wrapper checks);
// o and d (n, 3) f32; tm (n,) f32.
int tpurt_packet_closest(const float* node_f32, const int* node_i32, const float* rows,
                         const int* ids, const float* o, const float* d, int n, float t_min,
                         float* t, float* u, float* v, int* id, int num_nodes,
                         cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kPacket - 1) / kPacket;
  packet_closest_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(node_f32), reinterpret_cast<const int4*>(node_i32),
      rows, ids, o, d, n, num_nodes, t_min, t, u, v, id);
  return (int)cudaGetLastError();
}

int tpurt_packet_occluded(const float* node_f32, const int* node_i32, const float* rows,
                          const int* ids, const float* o, const float* d, const float* tm,
                          int n, float t_min, unsigned char* blocked, int num_nodes,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kPacket - 1) / kPacket;
  packet_occluded_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(node_f32), reinterpret_cast<const int4*>(node_i32),
      rows, ids, o, d, tm, n, num_nodes, t_min, blocked);
  return (int)cudaGetLastError();
}

// out: (n, k) int32, k in [1, 16].  neg_band and band_hi are -band and
// 1 + band rounded once to f32, as the twin compares.
int tpurt_packet_knear(const float* node_f32, const int* node_i32, const float* rows,
                       const int* ids, const float* o, const float* d, const float* tm, int n,
                       float t_min, int k, float neg_band, float band_hi, int* out,
                       int num_nodes, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kKMax) return (int)cudaErrorInvalidValue;
  const int grid = (n + kPacket - 1) / kPacket;
  const float4* nf = reinterpret_cast<const float4*>(node_f32);
  const int4* ni = reinterpret_cast<const int4*>(node_i32);
  if (k <= 4)
    return launch_knear<4>(grid, nf, ni, rows, ids, o, d, tm, n, num_nodes, t_min, k,
                           neg_band, band_hi, out, stream);
  if (k <= 8)
    return launch_knear<8>(grid, nf, ni, rows, ids, o, d, tm, n, num_nodes, t_min, k,
                           neg_band, band_hi, out, stream);
  return launch_knear<16>(grid, nf, ni, rows, ids, o, d, tm, n, num_nodes, t_min, k,
                          neg_band, band_hi, out, stream);
}

}  // extern "C"
