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
// radix: one thread per internal node i < N - 1.  delta(i, j) is the common
// prefix length of the sorted keys (code, index): clz(code_i ^ code_j), or
// 32 + clz(i ^ j) for equal codes, and -1 for j out of range.  The direction
// d = sign(delta(i, i + 1) - delta(i, i - 1)), then a 31-step power-of-two
// search for the far end j of the node's range and a 31-step search for the
// split gamma, exactly the twin's ladders (no early exit, so the same
// candidates are tested).  Index arithmetic is 64-bit, as in the twin.  The
// kernel writes left, right (leaf ids offset by N - 1), first = min(i, j),
// last = max(i, j) of node i, and parent of both children; each child has
// exactly one parent, so the parent writes never race.  The wrapper writes
// the leaves' first/last and the root's parent -1 (the kernel allocates
// nothing).  Bound: bytes.  The function needs Karras's search, an
// exponential then a binary search for the range end and a binary search
// for the split, about 2 log2(range) + 6 delta evaluations a node (a
// handful for most nodes); its operations then weigh less than reading the
// codes once and writing 24 bytes a node (32 MB at 1M nodes, about 0.01 ms
// at 3.35 TB/s).  The simple design runs the twin's fixed ladders instead:
// 62 steps a node, of which every in-range candidate loads a code; on the
// 1M sponza that is 2.3 times the code loads and 6.7 times the delta
// evaluations the function needs.  The codes (8 MB at
// 1M as int64, 40 MB at 5M) stay in the 50 MB L2; each is read through
// L1/L2 with no shared memory, and a thread's own code is loaded once.
// Making either kernel fast is left to later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBuildBlock = 256;
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

// delta(i, j) of the sorted keys; ci is code i.  i ^ j < 2^31, so its clz
// as a 32-bit value is the twin's clz32 of the int64.
__device__ __forceinline__ int delta(const int64_t* __restrict__ codes,
                                     int64_t n, int64_t i, uint32_t ci,
                                     int64_t j) {
  if (j < 0 || j >= n) return -1;
  uint32_t x = ci ^ (uint32_t)codes[j];
  if (x == 0) return 32 + __clz((int)(uint32_t)(i ^ j));
  return __clz((int)x);
}

__global__ void __launch_bounds__(kBuildBlock)
radix_kernel(const int64_t* __restrict__ codes, int64_t n,
             int* __restrict__ left, int* __restrict__ right,
             int* __restrict__ parent, int* __restrict__ first,
             int* __restrict__ last) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n - 1) return;
  uint32_t ci = (uint32_t)codes[i];
  int64_t d = delta(codes, n, i, ci, i + 1) - delta(codes, n, i, ci, i - 1) >= 0
                  ? 1 : -1;
  int delta_min = delta(codes, n, i, ci, i - d);
  // largest l >= 1 with delta(i, i + l d) > delta_min
  int64_t l = 0;
  for (int b = 0; b < 31; ++b) {
    int64_t cand = l + ((int64_t)1 << (30 - b));
    if (delta(codes, n, i, ci, i + cand * d) > delta_min) l = cand;
  }
  int64_t j = i + l * d;
  int delta_node = delta(codes, n, i, ci, j);
  // largest s in [0, l - 1] with delta(i, i + s d) > delta_node
  int64_t s = 0;
  for (int b = 0; b < 31; ++b) {
    int64_t cand = s + ((int64_t)1 << (30 - b));
    if (cand <= l - 1 && delta(codes, n, i, ci, i + cand * d) > delta_node)
      s = cand;
  }
  int64_t gamma = i + s * d + (d < 0 ? d : 0);
  int64_t lo = i < j ? i : j, hi = i < j ? j : i;
  int64_t lc = lo == gamma ? n - 1 + gamma : gamma;
  int64_t rc = hi == gamma + 1 ? n - 1 + gamma + 1 : gamma + 1;
  left[i] = (int)lc;
  right[i] = (int)rc;
  first[i] = (int)lo;
  last[i] = (int)hi;
  parent[lc] = (int)i;
  parent[rc] = (int)i;
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

// codes (n,) int64 holding sorted uint32; left, right (n - 1,) i32; parent,
// first, last (2n - 1,) i32, of which the kernel writes the children's
// parents and the internal nodes' first/last.
int tpurt_radix(const int64_t* codes, int n, int* left, int* right,
                int* parent, int* first, int* last, cudaStream_t stream) {
  if (n <= 1) return 0;
  int grid = (n - 1 + kBuildBlock - 1) / kBuildBlock;
  radix_kernel<<<grid, kBuildBlock, 0, stream>>>(codes, n, left, right, parent,
                                                 first, last);
  return (int)cudaGetLastError();
}

}  // extern "C"
