// Binary-BVH closest-hit, any-hit and k-nearest walks for NVIDIA Hopper
// (sm_90a), over the packed layout of tpurt_torch/accel/packet.py.
//
// Replaces, in tpurt/kernels/traverse.py:
//   _closest_kernel  (traverse_pallas)        -> closest_bin
//   _occluded_kernel (occluded_pallas)        -> occluded_bin
//   _knear_kernel    (k_nearest_ids_pallas)   -> knear_bin
//
// What they compute is tpurt's; how is not.  The TPU kernels walk a
// (sub, 128) ray packet with one scalar node cursor, descending where any ray
// of the packet wants to, with the nodes lane-packed into VMEM and one-hot
// lane extracts to read them.  Here one thread walks one ray.  knear_bin
// walks its stackless escape chain: a node whose box passes is entered at
// index + 1 (a leaf's 8 triangle slots are tested), any other is skipped
// through its escape link, and -1 ends the walk.  closest_bin and
// occluded_bin walk near-first with a short stack (bin_descend, below): the
// layout holds both children of internal node n, n + 1 and escape[n + 1].
// A node visit reads its 32-byte node_f32 row as two float4 and its 16-byte
// node_i32 row as one int4; a leaf visit reads the 72 floats of its triangle
// row and its 8 ids.  The selections (lexicographic (t, id) closest hit, any
// hit in (t_min, t_max), the k nearest band hits by (t, id)) do not depend
// on visit order, so per-ray walks give the packet walks' hits wherever a
// ray's own slab test is conservative.
//
// The arithmetic copies tpurt's op for op: the binary slab as (lo - o) * inv
// (not the wide walks' lo*inv - o*inv) with tpurt's max/min nesting and
// NaN-propagating min/max, _safe_inv, and Möller–Trumbore with the smooth
// inverse in _mt_scalar_tri's order (walk_common.cuh).  Built with
// -fmad=false, the kernels agree with their plain-torch twins bit for bit.
//
// What bounded occluded_bin was latency: on the escape chain every visit is
// one dependent load (the next node's index comes out of the previous
// record), ~47 of them a bunny shadow ray, and the 32 rays of a warp run the
// union of their chains.  Its design walks as closest_bin does, with the
// fixed bound t_max: at an internal node whose box passed, both children are
// slab-tested with their loads issued together (bin_descend), the nearer
// passing one is entered and the other pushed.  The set of boxes tested is
// the escape chain's (each child of a passing internal node once), so the
// flag is too; only the order and the overlap of the loads change.  With it,
// the levers of the other walks: min.NaN/max.NaN slab tests, descents
// repeating until a lane holds a leaf (while-while), and leaves read as two
// half rows of 16-byte loads whose 4 tests fold into one flag, the walk
// ending after the first half row that blocks.  What bounds it now is what
// bounds the other walks: issued instructions and divergence.  It keeps one
// thread a ray in one pass: persistent warps gained nothing on the 1M main
// view (PERF.md's levers table).
//
// What bounded closest_bin was the length of its walks: the escape chain's
// order is fixed, left subtree first, and a node is culled only once the
// best hit has shrunk, which happens only when the chain reaches the near
// leaf; on the 1M sponza's main view a ray made 552 visits though it hits a
// box 0.15 units away.  Its design walks near-first: at an internal node
// both children are slab-tested against [t_min, t_b], the walk goes on into
// the nearer and pushes the farther with its entry distance onto a stack
// of at most one entry a level, and a pop drops what lies beyond the best
// hit.  With it, knear_bin's levers: min.NaN/max.NaN slab tests, descents
// repeating until a lane holds a leaf (while-while), and leaves read as
// half rows of 16-byte loads.
//
// knear_bin has a walk of its own (knear_bin_walk), in the same order per
// ray.  What bounds it is issued instructions and divergence: on the 70K
// bunny a ray makes ~95 visits and tests ~9 leaves, from arrays that stay
// in L2.  Its design is knear8's (traverse8.cu): the slab test's min/max as
// min.NaN/max.NaN instructions; visits repeat until a lane's node is a
// passing leaf or its chain ends (while-while), so lanes meet at the leaf
// tests instead of the warp running a leaf test on almost every visit; a
// leaf read as two half rows of 9 16-byte loads and one int4 of ids, each
// tested accept-then-insert.  It keeps one thread a ray in one pass over
// the launch: persistent warps, which pay in knear8's short fit launches,
// did not pay on the bunny's one launch of 262,144 rays.  Its sorted k-list
// (KList, walk_common.cuh) lives in registers, as knear8's, without the
// dedup: a binary leaf holds each triangle once.

#include "walk_common.cuh"

namespace {

// One ray's k-nearest walk down the escape chain.  Per ray it visits and
// tests leaves in the twin's order (accel/traverse_ref.py knear_walk): a node is slab-tested
// against the bound at the start of its visit, a passing leaf's 8 slots are
// tested before the next visit.  How a warp runs it differs: visits repeat
// (while-while) until this lane's node is a passing leaf or its chain ends,
// so lanes meet at the leaf test instead of the warp running a leaf test on
// almost every visit for whichever lane is at a leaf; and the leaf is read
// as two half rows (9 16-byte loads and one int4 of ids each) and tested
// accept-then-insert (knear_half).  The bound changes only in a leaf test,
// so it is computed once per run of visits.
template <int KM>
__device__ __forceinline__ void knear_bin_walk(const float4* __restrict__ nf,
                                               const int4* __restrict__ ni,
                                               const float* __restrict__ rows,
                                               const int* __restrict__ ids,
                                               const Ray& r, float t_min,
                                               float tmax, float neg_band,
                                               float band_hi,
                                               KList<KM, false>& L) {
  int node = 0;
  while (node >= 0) {
    const float upper = L.upper(tmax);
    int leaf_row = -1;
    while (node >= 0) {
      const float4 a = __ldg(nf + 2 * node), b = __ldg(nf + 2 * node + 1);
      const int4 rec = __ldg(ni + node);
      const bool boxed = slab_bin_n(a, b, r, t_min, upper);
      const bool leaf = rec.w > 0;
      node = (boxed && !leaf) ? node + 1 : rec.x;
      if (boxed && leaf) {
        leaf_row = rec.y;
        break;
      }
    }
    if (leaf_row < 0) break;
    const float* tr = rows + (size_t)leaf_row * 128;
    const int4* ip = reinterpret_cast<const int4*>(ids + (size_t)leaf_row * 8);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float f[36];
      load_half(tr, h, f);
      const int4 ia = __ldg(ip + h);
      const int tid[4] = {ia.x, ia.y, ia.z, ia.w};
      knear_half(f, tid, r, t_min, tmax, neg_band, band_hi, L);
    }
  }
}

// ---------------------------------------------------------------------------
// The near-first walk with a short stack (closest_bin, occluded_bin)
// ---------------------------------------------------------------------------

// Entries of the near-first walk's stack: one a level at most, so a tree as
// deep as this fits (kernels/traverse.py's BIN_STACK; its wrappers refuse a
// deeper tree).  An LBVH over 30-bit Morton codes is at most 63 levels deep.
constexpr int kBinStack = 64;
// A walk position: an internal node (>= 0) whose box passed, a passing leaf
// as ~leaf_row (< 0), or the end of the walk.
constexpr int kWalkEnd = -0x7FFFFFFF - 1;

// slab_bin_n's test, also returning the box's entry distance t_near.
__device__ __forceinline__ bool slab_bin_near(const float4& a, const float4& b, const Ray& r,
                                              float t_min, float t_upper, float& t_near) {
  float tx0 = (a.x - r.ox) * r.ix, tx1 = (a.w - r.ox) * r.ix;
  float ty0 = (a.y - r.oy) * r.iy, ty1 = (b.x - r.oy) * r.iy;
  float tz0 = (a.z - r.oz) * r.iz, tz1 = (b.y - r.oz) * r.iz;
  t_near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)), nmax(nmin(tz0, tz1), t_min));
  const float t_far =
      nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)), nmin(nmax(tz0, tz1), t_upper));
  return t_near <= t_far;
}

// The near-first walk's stack of (position, t_near) pairs, with tpurt's
// clamp at the last entry.  A pop drops entries whose box lies beyond the
// walk's bound (t_near > t_b): for closest_bin the best hit, against which
// the slab test that passed when the entry was pushed would fail now; for
// occluded_bin t_max, which drops nothing (every entry passed against it).
struct BinStack {
  int pos[kBinStack];
  float t_near[kBinStack];
  int sp = 0;

  __device__ __forceinline__ void push(int p, float tn) {
    const int s = min(sp, kBinStack - 1);
    pos[s] = p;
    t_near[s] = tn;
    ++sp;
  }
  __device__ __forceinline__ int pop(float t_b) {
    while (sp > 0) {
      --sp;
      const int s = min(sp, kBinStack - 1);
      if (!(t_near[s] > t_b)) return pos[s];
    }
    return kWalkEnd;
  }
};

// The walk's first position: the root's box tested against [t_min, t_b],
// the root (0, or ~leaf_row for a one-leaf tree) if it passes.
__device__ __forceinline__ int bin_root(const float4* __restrict__ nf,
                                        const int4* __restrict__ ni, const Ray& r,
                                        float t_min, float t_b) {
  const float4 a = __ldg(nf), c = __ldg(nf + 1);
  const int4 rec = __ldg(ni);
  float tn;
  if (!slab_bin_near(a, c, r, t_min, t_b, tn)) return kWalkEnd;
  return rec.w > 0 ? ~rec.y : 0;
}

// From internal node n (its box passed): slab-test both children, n + 1 and
// escape[n + 1], against [t_min, t_b], their loads issued together; go to
// the nearer passing child (the smaller t_near, the left on a tie) and push
// the other one, or go to the only passing child, or pop.  Returns the next
// position.
__device__ __forceinline__ int bin_descend(const float4* __restrict__ nf,
                                           const int4* __restrict__ ni, int n, const Ray& r,
                                           float t_min, float t_b, BinStack& st) {
  const int left = n + 1;
  const int4 li = __ldg(ni + left);
  const float4 la = __ldg(nf + 2 * left), lb = __ldg(nf + 2 * left + 1);
  const int right = li.x;
  const int4 ri = __ldg(ni + right);
  const float4 ra = __ldg(nf + 2 * right), rb = __ldg(nf + 2 * right + 1);
  float tl, trn;
  const bool pl = slab_bin_near(la, lb, r, t_min, t_b, tl);
  const bool pr = slab_bin_near(ra, rb, r, t_min, t_b, trn);
  const int cl = li.w > 0 ? ~li.y : left, cr = ri.w > 0 ? ~ri.y : right;
  if (pl && pr) {
    const bool left_first = tl <= trn;
    st.push(left_first ? cr : cl, left_first ? trn : tl);
    return left_first ? cl : cr;
  }
  if (pl) return cl;
  if (pr) return cr;
  return st.pop(t_b);
}

// ---------------------------------------------------------------------------
// closest_bin: the closest hit
// ---------------------------------------------------------------------------

// The best hit so far by (t, id).
struct BestBin {
  float t = kTMax, u = 0.0f, v = 0.0f;
  int id = -1;
};

// A leaf's 8 tests, slot by slot (tpurt's `better` test), as two half rows
// of 9 16-byte loads and one int4 of ids each.
__device__ __forceinline__ void closest_bin_leaf(const float* __restrict__ tr,
                                                 const int4* __restrict__ ip, const Ray& r,
                                                 float t_min, BestBin& b) {
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    float f[36];
    load_half(tr, h, f);
    const int4 ia = __ldg(ip + h);
    const int tid[4] = {ia.x, ia.y, ia.z, ia.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float t, u, v, det;
      mt(f + 9 * j, r, t, u, v, det);
      const bool better = (t < b.t) || ((t == b.t) && (tid[j] < b.id) && (b.id >= 0));
      const bool ok = (fabsf(det) > kDetEps) && (u >= 0.0f) && (v >= 0.0f) &&
                      (u + v <= 1.0f) && (t > t_min) && better && (tid[j] >= 0);
      if (ok) {
        b.t = t; b.u = u; b.v = v; b.id = tid[j];
      }
    }
  }
}

// One ray's closest-hit walk, near-first: the root's box is tested, then
// each internal node's two children (bin_descend); a passing leaf is tested
// when the walk reaches it, then the stack is popped.  The best hit tightens
// as early as the near geometry allows, and every pop culls against it.
// How a warp runs it: descents repeat (while-while) until this lane holds a
// leaf or its walk ends, so lanes meet at the leaf tests.  The twin
// (kernels/traverse.py closest_near_walk) walks in the same order.
__device__ __forceinline__ void closest_bin_walk(const float4* __restrict__ nf,
                                                 const int4* __restrict__ ni,
                                                 const float* __restrict__ rows,
                                                 const int* __restrict__ ids, const Ray& r,
                                                 float t_min, BestBin& b) {
  BinStack st;
  int pos = bin_root(nf, ni, r, t_min, b.t);
  while (pos != kWalkEnd) {
    while (pos >= 0) pos = bin_descend(nf, ni, pos, r, t_min, b.t, st);
    if (pos == kWalkEnd) break;
    const int leaf_row = ~pos;
    closest_bin_leaf(rows + (size_t)leaf_row * 128,
                     reinterpret_cast<const int4*>(ids + (size_t)leaf_row * 8), r, t_min, b);
    pos = st.pop(b.t);
  }
}

__global__ void __launch_bounds__(kBlock)
closest_bin_kernel(const float4* __restrict__ nf, const int4* __restrict__ ni,
                   const float* __restrict__ rows, const int* __restrict__ ids,
                   const float* __restrict__ o, const float* __restrict__ d,
                   int n, float t_min, float* __restrict__ t_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   int* __restrict__ id_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  BestBin b;
  closest_bin_walk(nf, ni, rows, ids, r, t_min, b);
  t_out[i] = b.t;
  u_out[i] = b.u;
  v_out[i] = b.v;
  id_out[i] = b.id;
}

// ---------------------------------------------------------------------------
// occluded_bin: any hit
// ---------------------------------------------------------------------------

// A leaf's 8 any-hit tests as two half rows of 9 16-byte loads and one int4
// of ids each; true once a half row blocks, the second half then left
// unread.
__device__ __forceinline__ bool occluded_bin_leaf(const float* __restrict__ tr,
                                                  const int4* __restrict__ ip, const Ray& r,
                                                  float t_min, float tmax) {
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    float f[36];
    load_half(tr, h, f);
    const int4 ia = __ldg(ip + h);
    const int tid[4] = {ia.x, ia.y, ia.z, ia.w};
    if (occluded_half(f, tid, r, t_min, tmax)) return true;
  }
  return false;
}

// One ray's any-hit walk: true once a triangle lies at t_min < t < tmax.
// closest_bin_walk's order with the fixed bound tmax: the root's box, then
// each internal node's two children (bin_descend), descents repeating until
// this lane holds a leaf or its walk ends (while-while); a passing leaf is
// tested when reached, and the walk ends at its first half row that blocks.
// The window never shrinks, so the boxes tested are the escape chain's and
// the flag is its flag.  The twin (kernels/traverse.py occluded_packed_ref)
// walks in the same order.
__device__ __forceinline__ bool occluded_bin_walk(const float4* __restrict__ nf,
                                                  const int4* __restrict__ ni,
                                                  const float* __restrict__ rows,
                                                  const int* __restrict__ ids, const Ray& r,
                                                  float t_min, float tmax) {
  BinStack st;
  int pos = bin_root(nf, ni, r, t_min, tmax);
  while (pos != kWalkEnd) {
    while (pos >= 0) pos = bin_descend(nf, ni, pos, r, t_min, tmax, st);
    if (pos == kWalkEnd) break;
    const int leaf_row = ~pos;
    if (occluded_bin_leaf(rows + (size_t)leaf_row * 128,
                          reinterpret_cast<const int4*>(ids + (size_t)leaf_row * 8), r,
                          t_min, tmax))
      return true;
    pos = st.pop(tmax);
  }
  return false;
}

__global__ void __launch_bounds__(kBlock)
occluded_bin_kernel(const float4* __restrict__ nf, const int4* __restrict__ ni,
                    const float* __restrict__ rows, const int* __restrict__ ids,
                    const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tm, int n, float t_min,
                    unsigned char* __restrict__ blk_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = tm[i];
  bool blocked = false;
  // An empty window (t_max <= t_min, e.g. the t_max = 0 of a missed primary
  // ray) can never block: the ray starts dead.
  if (tmax > t_min) {
    const Ray r = load_ray(o, d, i);
    blocked = occluded_bin_walk(nf, ni, rows, ids, r, t_min, tmax);
  }
  blk_out[i] = blocked ? 1 : 0;
}

template <int KM>
__global__ void __launch_bounds__(kBlock)
knear_bin_kernel(const float4* __restrict__ nf, const int4* __restrict__ ni,
                 const float* __restrict__ rows, const int* __restrict__ ids,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tm, int n, float t_min, int k,
                 float neg_band, float band_hi, int* __restrict__ ids_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tmax = tm[i];
  KList<KM, false> L(k);
  // An empty window accepts no candidate: the ray starts dead.
  if (tmax > t_min) {
    const Ray r = load_ray(o, d, i);
    knear_bin_walk<KM>(nf, ni, rows, ids, r, t_min, tmax, neg_band, band_hi, L);
  }
  L.store(ids_out, (size_t)i);
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, never synchronises, and returns
// cudaGetLastError() of the launch (0 on success).  node_f32 is (M, 8) f32,
// node_i32 (M, 4) i32, rows (L, 128) f32 and ids (L, 8) i32, all contiguous
// (the wrapper checks, and that each starts on a 16-byte boundary for the
// vector loads).
int tpurt_closest_bin(const float* node_f32, const int* node_i32,
                      const float* rows, const int* ids, const float* o,
                      const float* d, int n, float t_min, float* t, float* u,
                      float* v, int* id, cudaStream_t stream) {
  if (n <= 0) return 0;
  int grid = (n + kBlock - 1) / kBlock;
  closest_bin_kernel<<<grid, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(node_f32),
      reinterpret_cast<const int4*>(node_i32), rows, ids, o, d, n, t_min, t, u,
      v, id);
  return (int)cudaGetLastError();
}

int tpurt_occluded_bin(const float* node_f32, const int* node_i32,
                       const float* rows, const int* ids, const float* o,
                       const float* d, const float* tm, int n, float t_min,
                       unsigned char* blocked, cudaStream_t stream) {
  if (n <= 0) return 0;
  int grid = (n + kBlock - 1) / kBlock;
  occluded_bin_kernel<<<grid, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(node_f32),
      reinterpret_cast<const int4*>(node_i32), rows, ids, o, d, tm, n, t_min,
      blocked);
  return (int)cudaGetLastError();
}

// out: (n, k) int32, k in [1, 16] (the wrapper checks).  neg_band and
// band_hi are -band and 1 + band rounded once to f32, as the twin compares.
int tpurt_knear_bin(const float* node_f32, const int* node_i32,
                    const float* rows, const int* ids, const float* o,
                    const float* d, const float* tm, int n, float t_min, int k,
                    float neg_band, float band_hi, int* out,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > kKMax) return (int)cudaErrorInvalidValue;
  int grid = (n + kBlock - 1) / kBlock;
  const float4* nf = reinterpret_cast<const float4*>(node_f32);
  const int4* ni = reinterpret_cast<const int4*>(node_i32);
  if (k <= 4) {
    knear_bin_kernel<4><<<grid, kBlock, 0, stream>>>(
        nf, ni, rows, ids, o, d, tm, n, t_min, k, neg_band, band_hi, out);
  } else if (k <= 8) {
    knear_bin_kernel<8><<<grid, kBlock, 0, stream>>>(
        nf, ni, rows, ids, o, d, tm, n, t_min, k, neg_band, band_hi, out);
  } else {
    knear_bin_kernel<16><<<grid, kBlock, 0, stream>>>(
        nf, ni, rows, ids, o, d, tm, n, t_min, k, neg_band, band_hi, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
