// BVH8 closest-hit, any-hit and k-nearest walks for NVIDIA Hopper (sm_90a).
//
// Replaces, in tpurt/kernels/traverse8.py:
//   _closest8_kernel  (traverse_pallas8 with shade_out=True)
//   _occluded8_kernel (occluded_pallas8)
//   _knear8_kernel    (k_nearest_ids_pallas8)
//
// What they compute is tpurt's; how is not.  The TPU kernels walk (sub, 128)
// ray packets through a row stack in VMEM.  Here one thread walks one ray
// with its own stack.  The selections (lexicographic (t, id) closest hit, any
// hit in (t_min, t_max), the k nearest band hits by (t, id)) do not depend on
// visit order, so a per-ray walk gives the packet walk's hits wherever the
// ray's own box tests are conservative (see tpurt_torch/kernels/traverse8.py
// for the one exception, inherited from tpurt's _safe_inv).  Each kernel
// has a walk of its own: occluded8_walk, knear8_walk and closest8_walk.  All
// three push a visit's passing children in entry order, and each visits,
// pushes, pops and tests rows per ray in the order of its plain-torch twin
// (_Walk).
//
// The arithmetic copies tpurt's op for op: the slab as lo*inv - o*inv,
// _safe_inv, Möller–Trumbore with the smooth inverse det/(det*det + 1e-12)
// in _mt_scalar_tri's order, and NaN-propagating min/max like jnp's.  The
// library is built with -fmad=false so nvcc contracts nothing into FMAs; the
// plain-torch twins then agree with these kernels bit for bit.
//
// What bounds occluded8 is what bounds the other two walks: issued
// instructions and divergence, not bytes.  Its shadow rays touch few
// distinct nodes and rows (on the 1M sponza's overview ~10K nodes and ~17K
// rows, which stay in L1/L2), but each makes ~9 visits of 8 slab tests and
// tests ~1.5 rows, and the rays of a warp end their walks at very different
// times: on the overview a third of them stop at their first blocker and
// the rest walk until the stack is empty.  Its design takes the levers the
// other walks measured: min.NaN/max.NaN slab tests and node records as
// 16-byte loads (visit_mask_v); visits repeating until a lane's visit passed
// a leaf (while-while) and one flat loop over the rows of a visit's passing
// leaves, so lanes meet at the row tests; each row read as two half rows of
// 16-byte loads whose 4 tests fold into one flag, the walk ending after the
// first half row that blocks; and persistent warps, so the long walks of a
// launch do not leave SMs idle while its last blocks finish.  Two levers
// lost and were left out: pushing the nearest child last (near-first by
// slab entry distance) made the walks slower on both 1M views, and lanes
// taking a new ray while their warp walks on (lane refill) cost more than
// the idle lanes it fills (PERF.md's levers table).
//
// What bounds closest8 is what bounded knear8 (below): issued instructions
// and divergence.  On the 1M sponza's main view a ray makes ~36 visits of 8
// slab tests and tests ~8 rows, from node and triangle rows that stay in
// L1/L2.  Its design takes knear8's levers for the instructions: min.NaN/
// max.NaN slab tests, node records and half rows as 16-byte read-only
// loads, one flat loop over a visit's rows, and persistent warps, which on
// the overview (misses and long walks side by side) keep SMs from idling
// in a launch's tail.  It reads the shading lanes once, for the winner,
// after the walk, so an accepted candidate copies four values, not
// thirteen.  Two levers lost and were left out: tpurt's near-first order
// (children pushed by descending (lo + hi) . d) made the walks longer on
// both 1M views, and repeating visits until a lane has rows (knear8's
// while-while) cost more than it gathered (PERF.md's levers table).
//
// What bounds knear8 is issued instructions and divergence, not memory: a
// fit chunk's walks touch a few hundred distinct nodes and rows, which stay
// in L1/L2, but each ray makes ~60 visits of 8 slab tests and tests ~35 rows
// of 8 triangles, and the warp runs the union of its rays' walks.  Its
// design cuts the instructions and the idle lanes: the slab test takes
// NaN-propagating min/max as one instruction each (min.NaN/max.NaN), not
// jmin/jmax's five or six; node records (14) and leaf rows (9 a half row)
// come as 16-byte read-only loads issued together; a half row's 4 tests run
// unrolled into an accept mask before a non-unrolled insert loop; visits
// repeat until a lane has rows to test (while-while) and all rows of a
// visit form one flat loop, so lanes meet at the row tests; and warps take
// 32 rays at a time from a global counter for as long as there are rays
// (persistent warps), so a launch's long walks do not leave SMs idle while
// its last blocks finish.  The stack stays thread-local, as closest8's:
// its hot entries sit in L1 (a copy with the first 16 in shared memory was
// slower).  Its sorted k-list (KList, walk_common.cuh) lives in registers,
// the length a compile-time bound (4, 8 or 16, the smallest >= k), every
// loop over it unrolled and guarded by i < k; its cull bound min(k-th t,
// t_max) shrinks only once k candidates are found, so its walks are longer
// than closest8's.

#include "walk_common.cuh"

namespace {

constexpr int kStackV = 192;       // tpurt's STACKV
constexpr int kEntries = 8;
constexpr int kLaneOff = 1 << 25;  // lane codec offset

// Lane codec: integers travel as the bit patterns of negative normal floats.
// Read the bits, never convert the value.
__device__ __forceinline__ int decode_lane(float f) {
  return (__float_as_int(f) & 0x3FFFFFFF) - kLaneOff;
}

// tpurt _slab8 for one box (lox, loy, loz, hix, hiy, hiz), its NaN-propagating
// min/max as nmin/nmax: the same decision as jmin/jmax in 25 instructions,
// not about 80.
__device__ __forceinline__ bool slab_n(const float* b, const Ray& r,
                                       float t_min, float t_upper) {
  float tx0 = b[0] * r.ix - r.oix, tx1 = b[3] * r.ix - r.oix;
  float ty0 = b[1] * r.iy - r.oiy, ty1 = b[4] * r.iy - r.oiy;
  float tz0 = b[2] * r.iz - r.oiz, tz1 = b[5] * r.iz - r.oiz;
  float t_near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                      nmax(nmin(tz0, tz1), t_min));
  float t_far = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                     nmin(nmax(tz0, tz1), t_upper));
  return t_near <= t_far;
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

// ---------------------------------------------------------------------------
// knear8: the k nearest band hits, on a walk of its own
// ---------------------------------------------------------------------------

// Slab-test the 8 children of node `cur` against [t_min, t_upper]; bit c of
// the result is child c.  Fills the decoded metas.  The node record's 56
// used lanes (8 boxes, 8 metas) are read as 14 16-byte loads through the
// read-only path, all issued before the first slab test.  Node records are
// 256 bytes, 16-byte aligned.
__device__ __forceinline__ unsigned visit_mask_v(const float* wrow, int cur,
                                                 const Ray& r, float t_min,
                                                 float t_upper,
                                                 int meta[kEntries]) {
  const float4* p = reinterpret_cast<const float4*>(wrow) + (size_t)cur * 16;
  float f[56];
#pragma unroll
  for (int q = 0; q < 14; ++q) {
    const float4 v = __ldg(p + q);
    f[4 * q] = v.x; f[4 * q + 1] = v.y; f[4 * q + 2] = v.z; f[4 * q + 3] = v.w;
  }
  unsigned mask = 0;
#pragma unroll
  for (int c = 0; c < kEntries; ++c) {
    meta[c] = decode_lane(f[48 + c]);
    if (slab_n(f + 6 * c, r, t_min, t_upper)) mask |= 1u << c;
  }
  return mask;
}

// One ray's k-nearest walk.  Per ray it visits, pushes, pops and tests rows
// in the twin's order: a visit slab-tests the 8 children against the bound
// at its start, pushes the passing internal ones in entry order, and the
// passing leaves' rows are tested, child by child and row by row, before the
// next node is visited.  How a warp runs it differs: node
// visits repeat (while-while) until this lane's visit passed a leaf, so lanes
// meet at the row tests; the rows of all passing leaves form one flat loop,
// one row a trip, so a warp makes as many trips as its busiest lane has rows
// (not the sum over children of each child's busiest lane); and each half
// row is read as 9 16-byte loads and its ids as one, and tested
// accept-then-insert (knear_half).  Pushing before the rows are tested does
// not change the stack: rows touch only the k-list.
template <int KM>
__device__ __forceinline__ void knear8_walk(const float* __restrict__ wrow,
                                            const float* __restrict__ rows,
                                            const Ray& r, int max_rows,
                                            float t_min, float tmax,
                                            float neg_band, float band_hi,
                                            KList<KM, true>& L) {
  int stack[kStackV];
  int sp = 0;
  int cur = 0;
  while (cur >= 0) {
    const float upper = L.upper(tmax);
    int meta[kEntries];
    unsigned leaves = 0;
    while (cur >= 0 && leaves == 0) {
      const unsigned mask = visit_mask_v(wrow, cur, r, t_min, upper, meta);
#pragma unroll
      for (int c = 0; c < kEntries; ++c) {
        if (!((mask >> c) & 1u)) continue;
        if (meta[c] >= 0) push(stack, sp, meta[c]);
        else leaves |= 1u << c;
      }
      cur = pop(stack, sp);
    }
    int row = 0, left = 0;
#pragma unroll 1
    for (;;) {
      while (left == 0 && leaves != 0) {
        const int c = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int m = meta[0];
#pragma unroll
        for (int q = 1; q < kEntries; ++q)
          if (q == c) m = meta[q];
        const int nm = ~m;
        row = nm >> 3;
        left = max(0, min((nm & 7) + 1, max_rows));
      }
      if (left == 0) break;
      const float* tr = rows + (size_t)row * 128;
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        float f[36];
        load_half(tr, h, f);
        const float4 ia = __ldg(reinterpret_cast<const float4*>(tr + 72) + h);
        const int tid[4] = {decode_lane(ia.x), decode_lane(ia.y), decode_lane(ia.z),
                            decode_lane(ia.w)};
        knear_half(f, tid, r, t_min, tmax, neg_band, band_hi, L);
      }
      ++row;
      --left;
    }
  }
}

// Persistent warps: each warp takes the next 32 rays from a global counter
// (zeroed by the wrapper for every launch) until none are left, so the
// long walks of a launch no longer leave an SM idle while its last blocks
// finish.  Returns the first ray of the warp's batch, or n when the work
// is done; every lane of the warp gets the same value.
__device__ __forceinline__ int next_batch(int* next) {
  int base = 0;
  if ((threadIdx.x & 31) == 0) base = atomicAdd(next, 32);
  return __shfl_sync(0xffffffffu, base, 0);
}

// Blocks of a persistent launch: as many as stay resident on the card at
// once (the occupancy the compiled kernel allows on every SM), but no more
// than the rays need.
template <class Kernel>
__host__ int resident_blocks(Kernel kernel, int n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
  const int need = (n + kBlock - 1) / kBlock;
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  return need < most ? need : most;
}

// Launch a persistent kernel for n rays on `stream`.
template <class Kernel, class... Args>
__host__ void launch_persistent(Kernel kernel, int n, cudaStream_t stream, Args... args) {
  kernel<<<resident_blocks(kernel, n), kBlock, 0, stream>>>(args...);
}

template <int KM>
__global__ void __launch_bounds__(kBlock)
knear8_kernel(const float* __restrict__ wrow, const float* __restrict__ rows,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ tm, int n, int max_rows, float t_min,
              int k, float neg_band, float band_hi, int* __restrict__ ids_out,
              int* __restrict__ next) {
  for (;;) {
    const int base = next_batch(next);
    if (base >= n) return;
    const int i = base + (threadIdx.x & 31);
    if (i >= n) continue;
    const float tmax = tm[i];
    KList<KM, true> L(k);
    // An empty window (t_max <= t_min, the pipeline's miss rays) accepts no
    // candidate: the ray starts dead and emits k empty slots.
    if (tmax > t_min) {
      const Ray r = load_ray(o, d, i);
      knear8_walk<KM>(wrow, rows, r, max_rows, t_min, tmax, neg_band, band_hi, L);
    }
    L.store(ids_out, (size_t)i);
  }
}

// ---------------------------------------------------------------------------
// occluded8: any hit, on a walk of its own
// ---------------------------------------------------------------------------

// Row ri's 8 any-hit tests as two half rows of 9 16-byte loads and one of
// ids each (load_half); true once a half row blocks, the second half then
// left unread.
__device__ __forceinline__ bool occluded8_row(const float* __restrict__ rows, int ri,
                                              const Ray& r, float t_min, float tmax) {
  const float* tr = rows + (size_t)ri * 128;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    float f[36];
    load_half(tr, h, f);
    const float4 ia = __ldg(reinterpret_cast<const float4*>(tr + 72) + h);
    const int tid[4] = {decode_lane(ia.x), decode_lane(ia.y), decode_lane(ia.z),
                        decode_lane(ia.w)};
    if (occluded_half(f, tid, r, t_min, tmax)) return true;
  }
  return false;
}

// One ray's any-hit walk: true once a triangle lies at t_min < t < tmax.  A
// visit slab-tests the 8 children against the fixed window (visit_mask_v),
// pushes the passing internal ones in entry order and pops the next node;
// the passing leaves' rows are then tested child by child, row by row and
// half row by half row, and the walk ends at the first half row that
// blocks: the twin's order (occluded_wide8_ref).  The window never shrinks,
// so which leaves a ray tests does not depend on the order; pushing before
// the rows are tested changes only the stack of a walk that is over.  How a
// warp runs it: visits repeat (while-while) until this lane's visit passed
// a leaf, so lanes meet at the row tests, and the rows of all passing
// leaves form one flat loop, one row a trip.
__device__ __forceinline__ bool occluded8_walk(const float* __restrict__ wrow,
                                               const float* __restrict__ rows, const Ray& r,
                                               int max_rows, float t_min, float tmax) {
  int stack[kStackV];
  int sp = 0;
  int cur = 0;
  while (cur >= 0) {
    int meta[kEntries];
    unsigned leaves = 0;
    while (cur >= 0 && leaves == 0) {
      const unsigned mask = visit_mask_v(wrow, cur, r, t_min, tmax, meta);
#pragma unroll
      for (int c = 0; c < kEntries; ++c) {
        if (!((mask >> c) & 1u)) continue;
        if (meta[c] >= 0) push(stack, sp, meta[c]);
        else leaves |= 1u << c;
      }
      cur = pop(stack, sp);
    }
    int row = 0, left = 0;
#pragma unroll 1
    for (;;) {
      while (left == 0 && leaves != 0) {
        const int c = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int m = meta[0];
#pragma unroll
        for (int q = 1; q < kEntries; ++q)
          if (q == c) m = meta[q];
        const int nm = ~m;
        row = nm >> 3;
        left = max(0, min((nm & 7) + 1, max_rows));
      }
      if (left == 0) break;
      if (occluded8_row(rows, row, r, t_min, tmax)) return true;
      ++row;
      --left;
    }
  }
  return false;
}

// Persistent warps, as closest8: each warp takes 32 rays at a time until
// none are left.
__global__ void __launch_bounds__(kBlock)
occluded8_kernel(const float* __restrict__ wrow, const float* __restrict__ rows,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tm, int n, int max_rows, float t_min,
                 unsigned char* __restrict__ blk_out, int* __restrict__ next) {
  for (;;) {
    const int base = next_batch(next);
    if (base >= n) return;
    const int i = base + (threadIdx.x & 31);
    if (i >= n) continue;
    const float tmax = tm[i];
    bool blocked = false;
    // An empty window (t_max <= t_min, e.g. the t_max = 0 of a missed
    // primary ray) can never block: the ray starts dead.
    if (tmax > t_min) {
      const Ray r = load_ray(o, d, i);
      blocked = occluded8_walk(wrow, rows, r, max_rows, t_min, tmax);
    }
    blk_out[i] = blocked ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// closest8: the closest hit, on a walk of its own
// ---------------------------------------------------------------------------

// albedo, emission and unnormalised e1 x e2 of triangle j of row tr, in
// tpurt's op order.
__device__ __forceinline__ void shade_lanes(const float* tr, int j, float (&sh)[9]) {
  const float* e = tr + 9 * j;  // e1 at 3..5, e2 at 6..8
  sh[0] = tr[80 + 3 * j]; sh[1] = tr[81 + 3 * j]; sh[2] = tr[82 + 3 * j];
  sh[3] = tr[104 + 3 * j]; sh[4] = tr[105 + 3 * j]; sh[5] = tr[106 + 3 * j];
  sh[6] = e[4] * e[8] - e[5] * e[7];
  sh[7] = e[5] * e[6] - e[3] * e[8];
  sh[8] = e[3] * e[7] - e[4] * e[6];
}

// The best hit so far by (t, id).  The walk keeps only the winner's row and
// lane; the shading lanes are read once after it (kShade).
template <bool kShade>
struct Best8 {
  float t = kTMax, u = 0.0f, v = 0.0f;
  int id = -1;
  int row = -1;  // the winner's row index (a 32-bit index, not a pointer, keeps
  int lane = 0;  // closest8<true> from spilling)

  // tpurt's accept-and-better test for one candidate, slot by slot.
  __device__ __forceinline__ void take(float tc, float uc, float vc, float det, int tid,
                                       float t_min, int ri, int j) {
    const bool better = (tc < t) || ((tc == t) && (tid < id) && (id >= 0));
    const bool ok = (fabsf(det) > kDetEps) && (uc >= 0.0f) && (vc >= 0.0f) &&
                    (uc + vc <= 1.0f) && (tc > t_min) && better && (tid >= 0);
    if (ok) {
      t = tc; u = uc; v = vc; id = tid;
      if constexpr (kShade) {
        row = ri;
        lane = j;
      }
    }
  }
};

// Row ri's 8 tests, slot by slot, as two half rows of 9 16-byte loads and
// one of ids each (load_half).
template <bool kShade>
__device__ __forceinline__ void closest8_row(const float* __restrict__ rows, int ri,
                                             const Ray& r, float t_min, Best8<kShade>& b) {
  const float* tr = rows + (size_t)ri * 128;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    float f[36];
    load_half(tr, h, f);
    const float4 ia = __ldg(reinterpret_cast<const float4*>(tr + 72) + h);
    const int tid[4] = {decode_lane(ia.x), decode_lane(ia.y), decode_lane(ia.z),
                        decode_lane(ia.w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float t, u, v, det;
      mt(f + 9 * j, r, t, u, v, det);
      b.take(t, u, v, det, tid[j], t_min, ri, 4 * h + j);
    }
  }
}

// One ray's closest-hit walk.  A visit slab-tests the 8 children against
// the bound at its start (visit_mask_v), pushes the passing internal ones in
// entry order and pops the next node; the passing leaves' rows are tested
// before that node is visited, child by child and row by row: the twin's
// order (traverse_wide8_ref).  How a warp runs it: the rows of all passing
// leaves form one flat loop, one row a trip.  Popping before the rows are
// tested does not change the walk: rows touch only the best hit, and a
// visit reads the bound when it starts.
template <bool kShade>
__device__ __forceinline__ void closest8_walk(const float* __restrict__ wrow,
                                              const float* __restrict__ rows, const Ray& r,
                                              int max_rows, float t_min, Best8<kShade>& b) {
  int stack[kStackV];
  int sp = 0;
  int cur = 0;
  while (cur >= 0) {
    int meta[kEntries];
    const unsigned mask = visit_mask_v(wrow, cur, r, t_min, b.t, meta);
    unsigned leaves = 0;
#pragma unroll
    for (int c = 0; c < kEntries; ++c) {
      if (!((mask >> c) & 1u)) continue;
      if (meta[c] >= 0) push(stack, sp, meta[c]);
      else leaves |= 1u << c;
    }
    cur = pop(stack, sp);
    int row = 0, left = 0;
#pragma unroll 1
    for (;;) {
      while (left == 0 && leaves != 0) {
        const int c = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        int m = meta[0];
#pragma unroll
        for (int q = 1; q < kEntries; ++q)
          if (q == c) m = meta[q];
        const int nm = ~m;
        row = nm >> 3;
        left = max(0, min((nm & 7) + 1, max_rows));
      }
      if (left == 0) break;
      closest8_row(rows, row, r, t_min, b);
      ++row;
      --left;
    }
  }
}

// Persistent warps, as knear8: each warp takes 32 rays at a time until none
// are left.
template <bool kShade>
__global__ void __launch_bounds__(kBlock)
closest8_kernel(const float* __restrict__ wrow, const float* __restrict__ rows,
                const float* __restrict__ o, const float* __restrict__ d, int n,
                int max_rows, float t_min, float* __restrict__ t_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ id_out, float* __restrict__ alb_out,
                float* __restrict__ emi_out, float* __restrict__ nrm_out,
                int* __restrict__ next) {
  for (;;) {
    const int base = next_batch(next);
    if (base >= n) return;
    const int i = base + (threadIdx.x & 31);
    if (i >= n) continue;
    const Ray r = load_ray(o, d, i);
    Best8<kShade> b;
    closest8_walk(wrow, rows, r, max_rows, t_min, b);
    t_out[i] = b.t;
    u_out[i] = b.u;
    v_out[i] = b.v;
    id_out[i] = b.id;
    if constexpr (kShade) {
      float sh[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (b.row >= 0) shade_lanes(rows + (size_t)b.row * 128, b.lane, sh);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        alb_out[3 * i + k] = sh[k];
        emi_out[3 * i + k] = sh[3 + k];
        nrm_out[3 * i + k] = sh[6 + k];
      }
    }
  }
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, never synchronises, and returns
// cudaGetLastError() of the launch (0 on success).
// alb, emi, nrm: (n, 3) shading outputs, or all null.  next: one int32 the
// wrapper zeroed on this stream, the persistent warps' ray counter.  wrow
// and rows must be 16-byte aligned (the wrapper checks).
int tpurt_closest8(const float* wrow, const float* rows, const float* o,
                   const float* d, int n, int max_rows, float t_min, float* t,
                   float* u, float* v, int* id, float* alb, float* emi,
                   float* nrm, int* next, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (alb != nullptr)
    launch_persistent(closest8_kernel<true>, n, stream, wrow, rows, o, d, n, max_rows,
                      t_min, t, u, v, id, alb, emi, nrm, next);
  else
    launch_persistent(closest8_kernel<false>, n, stream, wrow, rows, o, d, n, max_rows,
                      t_min, t, u, v, id, (float*)nullptr, (float*)nullptr,
                      (float*)nullptr, next);
  return (int)cudaGetLastError();
}

// next: as for closest8.  wrow and rows must be 16-byte aligned (the
// wrapper checks).
int tpurt_occluded8(const float* wrow, const float* rows, const float* o,
                    const float* d, const float* tm, int n, int max_rows,
                    float t_min, unsigned char* blocked, int* next, cudaStream_t stream) {
  if (n <= 0) return 0;
  launch_persistent(occluded8_kernel, n, stream, wrow, rows, o, d, tm, n, max_rows,
                    t_min, blocked, next);
  return (int)cudaGetLastError();
}

// ids: (n, k) int32, k in [1, 16] (the wrapper checks).  neg_band and
// band_hi are -band and 1 + band rounded once to f32, as the twin compares.
// next: one int32 the wrapper zeroed on this stream, the persistent warps'
// ray counter.  wrow and rows must be 16-byte aligned (the wrapper checks).
int tpurt_knear8(const float* wrow, const float* rows, const float* o,
                 const float* d, const float* tm, int n, int max_rows,
                 float t_min, int k, float neg_band, float band_hi, int* ids,
                 int* next, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kKMax) return (int)cudaErrorInvalidValue;
  if (k <= 4) {
    launch_persistent(knear8_kernel<4>, n, stream, wrow, rows, o, d, tm, n,
                      max_rows, t_min, k, neg_band, band_hi, ids, next);
  } else if (k <= 8) {
    launch_persistent(knear8_kernel<8>, n, stream, wrow, rows, o, d, tm, n,
                      max_rows, t_min, k, neg_band, band_hi, ids, next);
  } else {
    launch_persistent(knear8_kernel<16>, n, stream, wrow, rows, o, d, tm, n,
                      max_rows, t_min, k, neg_band, band_hi, ids, next);
  }
  return (int)cudaGetLastError();
}

const char* tpurt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
