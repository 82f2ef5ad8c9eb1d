// LBVH build stages for NVIDIA Hopper (sm_90a): 30-bit Morton codes of the
// triangle centroids and the Karras (2012) binary radix tree over the
// sorted codes.
//
// Replaces, in tpurt/kernels/treebuild.py:
//   _morton_kernel (morton_codes_pallas) -> morton_kernel
//   _radix_kernel  (radix_tree_pallas)   -> radix_kernel
//
// What they compute is tpurt's (accel/morton.py morton3d and accel/lbvh.py
// build_radix_tree, whose plain-torch copies in kernels/treebuild.py are the
// twins); how is not.  The TPU's Morton kernel runs over (8, 128) tiles of
// the three coordinate columns; its radix kernel runs the per-node searches
// one node after another on the scalar core, because Mosaic scalarises the
// data-dependent code loads, so tpurt kept its XLA build (62 vectorised
// gather passes) as the default.  On the GPU one thread per point and one
// thread per internal node are the natural shapes, and these kernels are
// the build's route for CUDA tensors.
//
// morton: one thread a point.  (p - lo) * inv with inv = 1 / max(hi - lo,
// 1e-12) computed by the wrapper in torch (so the kernel divides nothing),
// clamped to [0, clamp_hi] with clamp_hi passed in as the exact f32 the twin
// clamps to, times 2^10, truncated, then the four magic-number expand steps
// and x << 2 | y << 1 | z in uint32, stored widened to int64 (the BVH keeps
// codes as int64 holding uint32).  fminf/fmaxf drop a NaN where torch.clamp
// keeps it; scene points are finite, so the two agree on every input the
// build sees.  Bound: bytes, 12 bytes read and 8 written a point (about
// 20 MB at 1M points, 6 us at 3.35 TB/s); a handful of integer operations a
// point is far below the card's integer rate.  The simple design reads the
// points as plain f32 (three 4-byte loads a thread, neighbouring threads on
// neighbouring points) and writes one int64 a thread.
//
// radix: Karras's search (2012, fig. 4), one thread per internal node, and
// the whole stage in one launch.  delta(i, j) is the common prefix length of
// the sorted keys (code, index): clz(code_i ^ code_j), or 32 + clz(i ^ j)
// for equal codes, and -1 for j out of range.  The direction d = sign(
// delta(i, i + 1) - delta(i, i - 1)); the far end of the node's range by an
// exponential search (l_max = 2, 4, ... while the candidate stays inside)
// and a binary search below l_max; the split over t = ceil(l/2), ceil(l/4),
// ..., 1.  The predicates are monotone along the range, so this finds the
// same l and split as the twin's fixed 31-step ladders, with 2 log2(range)
// + 6 delta evaluations a node instead of 62 (most nodes' ranges are a few
// keys).  Index arithmetic is 32-bit: the wrapper refuses N > 2^30, so
// i < 2^30 and a candidate i +- m with m < 2^31 stays below 2^32 as an
// unsigned value, where one below 0 wraps above N and both fail the single
// range test (unsigned)j < n.  Thread t of a grid over N threads builds
// internal node t (t < N - 1: left, right, first = min(i, j), last =
// max(i, j), and the parent of both children; each child has exactly one
// parent, so the parent writes never race), writes leaf t's first = last =
// t, and thread 0 the root's parent -1: the wrapper allocates its outputs
// with torch.empty and launches nothing else.  Bound: operations and
// bytes, the work Karras's search needs (about 0.01 ms at 1M keys on the
// H100, chip_smoke.py karras_work).  What the kernel loses to it is
// divergence: a warp runs as long as its node of the longest range.  The
// codes (8 MB at 1M as int64, 40 MB at 5M) stay in the 50 MB L2, read
// through L1 with no shared memory, and a thread's own code is loaded once;
// blocks of 128 threads.  Measured and left out (PERF.md): a shared-memory
// tile of the block's codes, blocks of 256 and 512, and lane refill (one
// search step a loop iteration over grid-strided nodes).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBuildBlock = 256;  // morton
constexpr int kRadixBlock = 128;
constexpr int kMortonBits = 10;

// tpurt's _expand: insert two zero bits after each of the low 10 bits
// (uint32 arithmetic wraps as tpurt's does).
__device__ __forceinline__ uint32_t expand_bits(uint32_t x) {
  x = (x * 0x00010001u) & 0xFF0000FFu;
  x = (x * 0x00000101u) & 0x0F00F00Fu;
  x = (x * 0x00000011u) & 0xC30C30C3u;
  x = (x * 0x00000005u) & 0x49249249u;
  return x;
}

__device__ __forceinline__ uint32_t quantize(float p, float lo, float inv,
                                             float clamp_hi) {
  float x = (p - lo) * inv;
  x = fminf(fmaxf(x, 0.0f), clamp_hi);
  return (uint32_t)(x * (float)(1 << kMortonBits));
}

__global__ void __launch_bounds__(kBuildBlock)
morton_kernel(const float* __restrict__ points, const float* __restrict__ lo,
              const float* __restrict__ inv, float clamp_hi, int n,
              int64_t* __restrict__ codes) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = points + (size_t)i * 3;
  uint32_t qx = quantize(p[0], lo[0], inv[0], clamp_hi);
  uint32_t qy = quantize(p[1], lo[1], inv[1], clamp_hi);
  uint32_t qz = quantize(p[2], lo[2], inv[2], clamp_hi);
  codes[i] = (int64_t)((expand_bits(qx) << 2) | (expand_bits(qy) << 1) |
                       expand_bits(qz));
}

// delta(i, j) of the sorted keys; ci is code i, j a candidate in uint32
// arithmetic (below 0 it has wrapped above n).  i ^ j < 2^30.
__device__ __forceinline__ int delta(const int64_t* __restrict__ codes,
                                     uint32_t n, uint32_t i, uint32_t ci,
                                     uint32_t j) {
  if (j >= n) return -1;
  uint32_t x = ci ^ (uint32_t)codes[j];
  if (x == 0) return 32 + __clz((int)(i ^ j));
  return __clz((int)x);
}

// i + m d in uint32 arithmetic (d is +1 or -1).
__device__ __forceinline__ uint32_t step(uint32_t i, uint32_t m, int d) {
  return d > 0 ? i + m : i - m;
}

__global__ void __launch_bounds__(kRadixBlock)
radix_kernel(const int64_t* __restrict__ codes, int n, int* __restrict__ left,
             int* __restrict__ right, int* __restrict__ parent,
             int* __restrict__ first, int* __restrict__ last) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  first[n - 1 + t] = t;  // leaf t
  last[n - 1 + t] = t;
  if (t == 0) parent[0] = -1;  // the root
  if (t >= n - 1) return;
  uint32_t un = (uint32_t)n, i = (uint32_t)t;
  uint32_t ci = (uint32_t)codes[i];
  int up = delta(codes, un, i, ci, i + 1), down = delta(codes, un, i, ci, i - 1);
  int d = up - down >= 0 ? 1 : -1;
  int delta_min = d > 0 ? down : up;
  // the range end: l_max doubles while its candidate stays in the range,
  // then the largest l < l_max with delta(i, i + l d) > delta_min
  uint32_t lmax = 2;
  while (delta(codes, un, i, ci, step(i, lmax, d)) > delta_min) lmax <<= 1;
  uint32_t l = 0;
  for (uint32_t h = lmax >> 1; h > 0; h >>= 1)
    if (delta(codes, un, i, ci, step(i, l + h, d)) > delta_min) l += h;
  uint32_t j = step(i, l, d);
  int delta_node = delta(codes, un, i, ci, j);
  // the split: the largest s in [0, l - 1] with delta(i, i + s d) >
  // delta_node, over h = ceil(l/2), ceil(l/4), ..., 1
  uint32_t s = 0, h = l;
  do {
    h = (h + 1) >> 1;
    if (delta(codes, un, i, ci, step(i, s + h, d)) > delta_node) s += h;
  } while (h > 1);
  int gamma = (int)step(i, s, d) + (d < 0 ? -1 : 0);
  int lo = (int)min(i, j), hi = (int)max(i, j);
  int lc = lo == gamma ? n - 1 + gamma : gamma;
  int rc = hi == gamma + 1 ? n + gamma : gamma + 1;
  left[t] = lc;
  right[t] = rc;
  first[t] = lo;
  last[t] = hi;
  parent[lc] = t;
  parent[rc] = t;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, never synchronise, and return
// cudaGetLastError() of the launch (0 on success).  points is (n, 3) f32,
// lo and inv (3,) f32 on the device, codes (n,) int64.
int tpurt_morton(const float* points, const float* lo, const float* inv,
                 float clamp_hi, int n, int64_t* codes, cudaStream_t stream) {
  if (n <= 0) return 0;
  int grid = (n + kBuildBlock - 1) / kBuildBlock;
  morton_kernel<<<grid, kBuildBlock, 0, stream>>>(points, lo, inv, clamp_hi, n,
                                                  codes);
  return (int)cudaGetLastError();
}

// codes (n,) int64 holding sorted uint32, 2 <= n <= 2^30; left, right
// (n - 1,) i32; parent, first, last (2n - 1,) i32, every element of which
// the kernel writes.
int tpurt_radix(const int64_t* codes, int n, int* left, int* right,
                int* parent, int* first, int* last, cudaStream_t stream) {
  if (n <= 1) return 0;
  int grid = (n + kRadixBlock - 1) / kRadixBlock;
  radix_kernel<<<grid, kRadixBlock, 0, stream>>>(codes, n, left, right, parent,
                                                 first, last);
  return (int)cudaGetLastError();
}

}  // extern "C"
