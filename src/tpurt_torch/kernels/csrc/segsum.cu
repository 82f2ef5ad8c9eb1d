// Sorted segment-sum for NVIDIA Hopper (sm_90a): the deterministic backward
// of a row gather, out[v] = sum of the rows cot[i] with idx[i] == v.
//
// Replaces tpurt/diff/gather_grad.py segment_accumulate, which has no
// Pallas kernel: tpurt computes it in XLA.  What is computed, and the order
// of every f32 addition, is tpurt's (kernels/segsum.py
// segment_accumulate_ref is the twin); the kernels built with -fmad=false
// agree with it bit for bit, +0 and -0 aside.  The wrapper sorts the ids
// first (torch.sort, stable, int32 keys: the library sort, as tpurt's
// lax.sort), then:
//
// (a) segsum_scan_kernel: one CTA a block of 256 sorted rows.  It reads
//     each row's `use` columns through the permutation (no permuted copy
//     in HBM; a row is `use` consecutive floats at stride ld, so 12 of 15
//     columns or 9 of a 9-wide slice, neither 16-byte aligned, are read as
//     single floats, neighbouring threads on neighbouring columns of a
//     row), runs tpurt's 8 Hillis-Steele passes (y = blk ? y : y + y[j -
//     sh], then blk |= blk[j - sh]) in double-buffered shared memory, 16
//     columns at a time, and writes the scanned rows.  A thread whose
//     sorted row ends a segment writes end[id] = its row (the ids' last
//     positions, which tpurt gets from cumsum(counts) - 1), into an end
//     array set to -1 first.
// (b) segsum_carry_init and segsum_carry_pass: the block carries, carry[b]
//     = g[b] + a[b] * carry[b - 1] with g the previous block's last
//     scanned row where its tail id continues into b and a = 1 where the
//     previous block is one whole segment that continues, solved by
//     tpurt's log-shift composition (g = g + a * g[b - sh]; a = a *
//     a[b - sh]) in ceil(log2 nb) passes, one launch a pass over (nb, use)
//     threads, ping-ponging between two buffers.  The order is tpurt's,
//     not a sequential loop's.  The head, tail and full flags of a block
//     are read from the sorted ids where needed, not stored.
// (c) segsum_ends_kernel: one thread an output element (v, c): e =
//     end[v]; out = y[e] + carry[e / 256] * first, first = 1 where e's id
//     is its block's head id, else 0, or 0 where no row has id v.  tpurt
//     adds the carries to every row and then gathers the end rows; only
//     the end rows are read here, with the same two operations.
//
// Bound: bytes.  The three kernels' function reads the sorted ids and the
// permutation once (12 bytes a row) and the `use` columns of every row once,
// and writes (num_rows, use): 12 + 4 use bytes a row plus 4 use a table row.
// The arithmetic (8 adds a column a row, and the carry's on nb rows) is far
// below the f32 rate.  What this design moves beyond that: the scanned rows
// written and the end rows read back (4 use bytes a row, and up to 4 use a
// table row), the gather of the input rows in sorted order (scattered
// rows, a 32-byte sector for 12 to 48 bytes), and the carry's launches, one
// a pass (12 to 15 at the fit's shapes), each over a few hundred KB that
// stay in the L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kB = 256;         // rows of a scan block (tpurt's B)
constexpr int kCols = 16;       // columns scanned at a time
constexpr int kStride = kB + 1; // shared row of a column, padded against bank conflicts
constexpr int kThreads = 256;   // carry and ends

__global__ void __launch_bounds__(kB)
segsum_scan_kernel(const int* __restrict__ sid, const int64_t* __restrict__ perm,
                   const float* __restrict__ cot, long long ld, int n, int use,
                   int num_rows, float* __restrict__ y, int* __restrict__ end) {
  __shared__ float s[2][kCols * kStride];
  __shared__ unsigned char f[2][kB];
  __shared__ int64_t srow[kB];
  const int j = threadIdx.x;
  const long long base = (long long)blockIdx.x * kB;
  const int rows = (int)min((long long)kB, n - base);  // real rows of the block
  const long long i = base + j;
  const int id = j < rows ? sid[i] : num_rows;         // padded rows: id num_rows
  srow[j] = j < rows ? perm[i] : 0;
  if (j < rows && (i + 1 == n || sid[i + 1] != id) && (unsigned)id < (unsigned)num_rows)
    end[id] = (int)i;
  // row 0 of a block always starts a segment (tpurt's prev = -1)
  const int prev = j == 0 ? -1 : (j - 1 < rows ? sid[i - 1] : num_rows);
  const bool start = id != prev;
  __syncthreads();
  for (int c0 = 0; c0 < use; c0 += kCols) {
    const int cg = min(kCols, use - c0);
    for (int k = j; k < kB * cg; k += kB) {
      const int r = k / cg, c = k - r * cg;
      s[0][c * kStride + r] = r < rows ? cot[srow[r] * ld + c0 + c] : 0.0f;
    }
    bool blk = start;
    f[0][j] = blk;
    __syncthreads();
    int cur = 0;
    for (int sh = 1; sh < kB; sh <<= 1) {
      const bool bpad = j >= sh ? f[cur][j - sh] != 0 : true;
      for (int c = 0; c < cg; ++c) {
        const float v = s[cur][c * kStride + j];
        const float w = j >= sh ? s[cur][c * kStride + j - sh] : 0.0f;
        s[cur ^ 1][c * kStride + j] = blk ? v : v + w;
      }
      blk = blk || bpad;
      f[cur ^ 1][j] = blk;
      cur ^= 1;
      __syncthreads();
    }
    for (int k = j; k < rows * cg; k += kB) {
      const int r = k / cg, c = k - r * cg;
      y[(base + r) * use + c0 + c] = s[cur][c * kStride + r];
    }
    __syncthreads();  // the next column group overwrites s[0]
  }
}

// carry[b] before the passes: g = the previous block's last scanned row
// where its tail id is b's head id (tpurt's cont), else 0; a = 1 where
// also the previous block is full (one id throughout).  Block b - 1 is
// whole whenever block b exists, so its tail is a real row.
__global__ void __launch_bounds__(kThreads)
segsum_carry_init(const int* __restrict__ sid, const float* __restrict__ y, int nb,
                  int use, float* __restrict__ g, float* __restrict__ a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)nb * use) return;
  const int b = (int)(t / use), c = (int)(t - (long long)b * use);
  bool cont = false, full_prev = false;
  if (b > 0) {
    const long long tail_row = (long long)b * kB - 1;
    const int tail_prev = sid[tail_row];
    cont = tail_prev == sid[(long long)b * kB];
    full_prev = sid[(long long)(b - 1) * kB] == tail_prev;
  }
  g[t] = cont ? y[((long long)b * kB - 1) * use + c] : 0.0f;
  if (c == 0) a[b] = (cont && full_prev) ? 1.0f : 0.0f;
}

// One log-shift pass: g = g + a * g[b - sh]; a = a * a[b - sh] (0 past
// the front, as tpurt's pad).
__global__ void __launch_bounds__(kThreads)
segsum_carry_pass(const float* __restrict__ g_in, const float* __restrict__ a_in,
                  int nb, int use, int sh, float* __restrict__ g_out,
                  float* __restrict__ a_out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)nb * use) return;
  const int b = (int)(t / use);
  const float av = a_in[b];
  const float gp = b >= sh ? g_in[t - (long long)sh * use] : 0.0f;
  g_out[t] = g_in[t] + av * gp;
  if (t - (long long)b * use == 0) a_out[b] = av * (b >= sh ? a_in[b - sh] : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
segsum_ends_kernel(const int* __restrict__ sid, const int* __restrict__ end,
                   const float* __restrict__ y, const float* __restrict__ carry,
                   int num_rows, int use, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)num_rows * use) return;
  const int v = (int)(t / use), c = (int)(t - (long long)v * use);
  const int e = end[v];
  if (e < 0) {
    out[t] = 0.0f;
    return;
  }
  const int b = e / kB;
  const float first = sid[e] == sid[(long long)b * kB] ? 1.0f : 0.0f;
  out[t] = y[(long long)e * use + c] + carry[(long long)b * use + c] * first;
}

int grid_of(long long threads) { return (int)((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Every entry point launches on `stream`, never synchronises, and returns
// cudaGetLastError() of its launches (0 on success).  sid (n,) int32 sorted
// ids; perm (n,) int64, sorted row -> input row; cot rows of `use` f32 at
// row stride ld; y (n, use) f32; end (num_rows,) int32; n >= 1, use >= 1.
int tpurt_segsum_scan(const int* sid, const int64_t* perm, const float* cot,
                      long long ld, int n, int use, int num_rows, float* y, int* end,
                      cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(end, 0xFF, sizeof(int) * (size_t)num_rows, stream);
  if (err != cudaSuccess) return (int)err;
  int nb = (n + kB - 1) / kB;
  segsum_scan_kernel<<<nb, kB, 0, stream>>>(sid, perm, cot, ld, n, use, num_rows, y,
                                            end);
  return (int)cudaGetLastError();
}

// g0, g1 (nb, use) f32 and a0, a1 (nb,) f32, nb = ceil(n / 256); the
// carries end in g0 after an even number of passes, in g1 after an odd
// one (passes = ceil(log2 nb)).
int tpurt_segsum_carry(const int* sid, const float* y, int n, int use, float* g0,
                       float* g1, float* a0, float* a1, cudaStream_t stream) {
  int nb = (n + kB - 1) / kB;
  int grid = grid_of((long long)nb * use);
  segsum_carry_init<<<grid, kThreads, 0, stream>>>(sid, y, nb, use, g0, a0);
  cudaError_t err = cudaGetLastError();
  for (int sh = 1; sh < nb && err == cudaSuccess; sh <<= 1) {
    segsum_carry_pass<<<grid, kThreads, 0, stream>>>(g0, a0, nb, use, sh, g1, a1);
    err = cudaGetLastError();
    float* t = g0; g0 = g1; g1 = t;
    t = a0; a0 = a1; a1 = t;
  }
  return (int)err;
}

// carry: the buffer the passes ended in; out (num_rows, use) f32.
int tpurt_segsum_ends(const int* sid, const int* end, const float* y, const float* carry,
                      int num_rows, int use, float* out, cudaStream_t stream) {
  if (num_rows <= 0) return 0;
  segsum_ends_kernel<<<grid_of((long long)num_rows * use), kThreads, 0, stream>>>(
      sid, end, y, carry, num_rows, use, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
