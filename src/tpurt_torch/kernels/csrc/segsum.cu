// Sorted segment-sum for NVIDIA Hopper (sm_90a): the deterministic backward
// of a row gather, out[v] = sum of the rows cot[i] with idx[i] == v.
//
// Replaces tpurt/diff/gather_grad.py segment_accumulate, which has no
// Pallas kernel: tpurt computes it in XLA.  What is computed, and the order
// of every f32 addition, is tpurt's (kernels/segsum.py
// segment_accumulate_ref is the twin); the kernels built with -fmad=false
// agree with it bit for bit, +0 and -0 aside.  The wrapper sorts the ids
// first (torch.sort, stable, int32 keys: the library sort, as tpurt's
// lax.sort), then four launches:
//
// (a) a memset of the output: 0 for every id that no row has.
// (b) segsum_scan_kernel: one CTA a block of 256 sorted rows.  It reads
//     each row's `use` columns through the permutation into shared memory
//     (no permuted copy in HBM; neighbouring threads on neighbouring
//     columns of a row, since 12 of 15 or 9 of a 9-wide slice are not
//     16-byte aligned), 16 columns at a time, then gives each column to one
//     warp, each lane holding 8 consecutive rows and their segment-start
//     flags in registers.  tpurt's 8 Hillis-Steele passes (y = blk ? y : y
//     + y[j - sh], then blk |= blk[j - sh]) take y[j - sh] from the lane's
//     own registers or from lane - ceil(sh / 8) by __shfl_up_sync, every
//     pass reading the previous pass's values only, so no barrier separates
//     the passes.  Nothing scanned goes back to HBM but what is read later:
//     each segment's last row into out[id] (the block's end rows,
//     compacted, so a warp writes whole rows), and the block's last row as
//     block b + 1's g (0 where b + 1 does not continue its tail id) with
//     a[b + 1] = 1 where block b also is one whole segment (tpurt's cont
//     and full).
// (c) segsum_carry_kernel: the block carries, carry[b] = g[b] + a[b] *
//     carry[b - 1], by tpurt's log-shift composition (g = g + a * g[b -
//     sh]; a = a * a[b - sh]) in ceil(log2 nb) passes: one CTA a column,
//     g and a ping-ponging in shared memory, a barrier between passes, the
//     carries written back over g.  The order is tpurt's, not a sequential
//     loop's.  g and a take 16 bytes a block: up to kCarryMaxBlocks blocks
//     (3,719,168 rows) they fit the 227 KB a CTA may use.  Above that size
//     (a rule on nb alone, stated here only)
//     segsum_carry_pass runs one launch a pass over global buffers: the
//     same operations in the same order.
// (d) segsum_ends_kernel: one thread a sorted row; at a segment's last row
//     out[v] = out[v] + carry[b] * first, in place, with first = 1 where v
//     is block b's head id (its first piece) and 0 for the other ids that
//     end in b.  For those, y + carry * 0 is y (+0 and -0 aside) unless the
//     carry is inf or NaN, so they are rewritten only then: a non-finite
//     carry reaches every end row of its block, as in tpurt.
//
// Bound: bytes.  The function reads the sorted ids and the permutation once
// (12 bytes a row) and the `use` columns of every row once, and writes
// (num_rows, use): 12 + 4 use bytes a row plus 4 use a table row.  The
// arithmetic (8 adds a column a row, and the carry's on nb rows) is far
// below the f32 rate.  What this design moves beyond that: the gather of
// the input rows in sorted order (scattered rows, a 32-byte sector for 12
// to 48 bytes), the output's rows with ids written twice (the memset,
// then the end row), the ids read again by (d), g and a (a few hundred KB,
// in the L2), and the head rows read and rewritten by (d).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kB = 256;                      // rows of a scan block (tpurt's B)
constexpr int kLaneRows = 8;                 // consecutive rows a lane scans
constexpr int kWarps = kB / 32;              // warps of a scan CTA (one thread a row)
constexpr int kCols = 16;                    // columns scanned at a time
constexpr int kBatch = 4;                    // rows' loads a thread issues together
constexpr int kColStride = kB + kB / kLaneRows;  // a column in shared memory
constexpr int kCarryThreads = 1024;          // the one-CTA carry
constexpr int kCarryMaxBlocks = 14528;       // 227 KB / 16 bytes a block
constexpr int kThreads = 256;                // the pass kernels above it
static_assert(kB == 32 * kLaneRows && kB == 256, "a warp's lanes hold a block's 8 passes");

// Row r of a column in shared memory, one word of padding every 8 rows, so
// the 32 lanes of a warp, each reading its own row 8 lane + i, hit 32
// distinct banks.
__device__ __forceinline__ int srow(int r) { return r + r / kLaneRows; }

__global__ void __launch_bounds__(kB)
segsum_scan_kernel(const int* __restrict__ sid, const int64_t* __restrict__ perm,
                   const float* __restrict__ cot, long long ld, int n, int nb, int use,
                   int num_rows, float* __restrict__ out, float* __restrict__ g,
                   float* __restrict__ a) {
  __shared__ float s[kCols * kColStride];
  __shared__ int s_sid[kB];
  __shared__ int64_t s_perm[kB];
  __shared__ int s_end[kB];
  __shared__ int s_count[kWarps + 1];
  const int j = threadIdx.x, lane = j % 32, warp = j / 32, b = blockIdx.x;
  const long long base = (long long)b * kB;
  const int rows = (int)min((long long)kB, n - base);  // real rows of the block
  const int id = j < rows ? sid[base + j] : num_rows;  // padded rows: id num_rows
  s_sid[j] = id;
  s_perm[j] = j < rows ? perm[base + j] : 0;
  // the block's rows that end their id's segment, compacted in order into
  // s_end[0, ends): a warp's by ballot, the warps' offsets by a prefix of
  // their counts
  __syncthreads();
  const bool is_end = j < rows && (unsigned)id < (unsigned)num_rows &&
                      (base + j + 1 == n || (j + 1 < kB ? s_sid[j + 1] : sid[base + kB]) != id);
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, is_end);
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  if (j == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      s_count[w] = sum;
      sum += c;
    }
    s_count[kWarps] = sum;
  }
  __syncthreads();
  if (is_end) s_end[s_count[warp] + __popc(ballot & ((1u << lane) - 1u))] = j;
  const int ends = s_count[kWarps];
  // the lane's rows 8 lane + i that start a segment, as bits i (row 0 of a
  // block always starts one: tpurt's prev = -1)
  unsigned start = 0;
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i) {
    const int r = kLaneRows * lane + i;
    start |= (unsigned)(r == 0 || s_sid[r] != s_sid[r - 1]) << i;
  }
  // tpurt's cont and full for block b + 1's carry
  const bool cont_next = b + 1 < nb && s_sid[kB - 1] == sid[base + kB];
  const bool full = s_sid[0] == s_sid[kB - 1];
  for (int c0 = 0; c0 < use; c0 += kCols) {
    const int cg = min(kCols, use - c0);
    // element m of this thread, m < cg, is q = j + m kB: row q / cg, column
    // q % cg (stepping q by kB steps the row by dr and the column by dc);
    // kBatch loads are issued before their stores
    const int dr = kB / cg, dc = kB % cg;
    int r = j / cg, c = j % cg;
    for (int m0 = 0; m0 < cg; m0 += kBatch) {
      float v[kBatch];
      int at[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        at[i] = c * kColStride + srow(r);
        if (m0 + i < cg) v[i] = r < rows ? cot[s_perm[r] * ld + c0 + c] : 0.0f;
        r += dr;
        c += dc;
        if (c >= cg) { c -= cg; ++r; }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (m0 + i < cg) s[at[i]] = v[i];
    }
    __syncthreads();
    for (int c = warp; c < cg; c += kWarps) {
      float* col = s + c * kColStride;
      float y[kLaneRows];
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i) y[i] = col[srow(kLaneRows * lane + i)];
      unsigned blk = start;
#pragma unroll
      for (int p = 0; p < 8; ++p) {  // sh = 1, 2, ..., 128
        const int sh = 1 << p;
        // w[i] = y[8 lane + i - sh] and bpad's bits, from before this pass;
        // rows below sh are segment starts by now, so what lane 0 reads
        // there is never added
        float w[kLaneRows];
        unsigned bpad;
        if (sh < kLaneRows) {
#pragma unroll
          for (int i = 0; i < kLaneRows; ++i)
            w[i] = i >= sh ? y[(i - sh + kLaneRows) % kLaneRows]
                           : __shfl_up_sync(0xFFFFFFFFu, y[(i - sh + kLaneRows) % kLaneRows], 1);
          const unsigned prev = __shfl_up_sync(0xFFFFFFFFu, blk, 1);
          bpad = (blk << sh) | ((lane > 0 ? prev : 0xFFu) >> (kLaneRows - sh));
        } else {
          const int q = sh / kLaneRows;
#pragma unroll
          for (int i = 0; i < kLaneRows; ++i) w[i] = __shfl_up_sync(0xFFFFFFFFu, y[i], q);
          const unsigned prev = __shfl_up_sync(0xFFFFFFFFu, blk, q);
          bpad = lane >= q ? prev : 0xFFu;
        }
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i) y[i] = (blk >> i) & 1u ? y[i] : y[i] + w[i];
        blk = (blk | bpad) & 0xFFu;
      }
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i) col[srow(kLaneRows * lane + i)] = y[i];
    }
    __syncthreads();
    // the block's last scanned row: block b + 1's g
    if (b + 1 < nb) {
      for (int c = j; c < cg; c += kB)
        g[(long long)(c0 + c) * nb + b + 1] = cont_next ? s[c * kColStride + srow(kB - 1)] : 0.0f;
    }
    if (b == 0) {
      for (int c = j; c < cg; c += kB) g[(long long)(c0 + c) * nb] = 0.0f;
    }
    // each end row into out[its id], element q = j + m kB of ends x cg
    for (int m = j / cg, c = j % cg; m < ends;) {
      const int e = s_end[m];
      out[(long long)s_sid[e] * use + c0 + c] = s[c * kColStride + srow(e)];
      m += dr;
      c += dc;
      if (c >= cg) { c -= cg; ++m; }
    }
    __syncthreads();  // the next column group overwrites s
  }
  if (j == 0) {
    if (b + 1 < nb) a[b + 1] = (cont_next && full) ? 1.0f : 0.0f;
    if (b == 0) a[0] = 0.0f;
  }
}

// One CTA a column c: the carry's passes over g[c], a in shared memory
// (g, then a, each two buffers of nb), the carries written back over g[c].
__global__ void __launch_bounds__(kCarryThreads)
segsum_carry_kernel(int nb, float* __restrict__ g, const float* __restrict__ a0) {
  extern __shared__ float sm[];
  float* gs = sm;
  float* as = sm + 2 * nb;
  const int c = blockIdx.x, t = threadIdx.x;
  float* gc = g + (long long)c * nb;
  for (int b = t; b < nb; b += kCarryThreads) {
    gs[b] = gc[b];
    as[b] = a0[b];
  }
  __syncthreads();
  int cur = 0;
  for (int sh = 1; sh < nb; sh <<= 1) {
    const float* gi = gs + cur * nb;
    const float* ai = as + cur * nb;
    float* go = gs + (cur ^ 1) * nb;
    float* ao = as + (cur ^ 1) * nb;
    for (int b = t; b < nb; b += kCarryThreads) {
      const float av = ai[b];
      const float gp = b >= sh ? gi[b - sh] : 0.0f;
      go[b] = gi[b] + av * gp;
      ao[b] = av * (b >= sh ? ai[b - sh] : 0.0f);
    }
    cur ^= 1;
    __syncthreads();
  }
  for (int b = t; b < nb; b += kCarryThreads) gc[b] = gs[cur * nb + b];
}

// Above kCarryMaxBlocks: one log-shift pass over every (column, block) of
// the global buffers, g = g + a * g[b - sh]; a = a * a[b - sh] (0 past the
// front, as tpurt's pad).
__global__ void __launch_bounds__(kThreads)
segsum_carry_pass(const float* __restrict__ g_in, const float* __restrict__ a_in, int nb,
                  int use, int sh, float* __restrict__ g_out, float* __restrict__ a_out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)nb * use) return;
  const int b = (int)(t % nb);
  const float av = a_in[b];
  const float gp = b >= sh ? g_in[t - sh] : 0.0f;
  g_out[t] = g_in[t] + av * gp;
  if (t < nb) a_out[b] = av * (b >= sh ? a_in[b - sh] : 0.0f);
}

// (d): at sorted row r, the last of id v's segment, in block b: out[v] =
// out[v] + carry[b] * first, first = 1 for b's head id; for the others
// (first = 0) only where the carry is not finite, since otherwise y + carry
// * 0 is y, +0 and -0 aside.
__global__ void __launch_bounds__(kThreads)
segsum_ends_kernel(const int* __restrict__ sid, int n, int nb, int use, int num_rows,
                   const float* __restrict__ carry, float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const int v = sid[r];
  if ((unsigned)v >= (unsigned)num_rows || (r + 1 < n && sid[r + 1] == v)) return;
  const int b = (int)(r / kB);
  const bool first = v == sid[(long long)b * kB];
  for (int c = 0; c < use; ++c) {
    const float cv = carry[(long long)c * nb + b];
    if (first || !isfinite(cv)) {
      float* p = out + (long long)v * use + c;
      *p = *p + cv * (first ? 1.0f : 0.0f);
    }
  }
}

int grid_of(long long threads) { return (int)((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Both entry points launch on `stream`, never synchronise, and return
// cudaGetLastError() of their launches (0 on success).  sid (n,) int32
// sorted ids; perm (n,) int64, sorted row -> input row; cot rows of `use`
// f32 at row stride ld; out (num_rows, use) f32; g (use, nb) f32 and a
// (nb,) f32, nb = ceil(n / 256); n >= 1, use >= 1.
int tpurt_segsum_scan(const int* sid, const int64_t* perm, const float* cot, long long ld,
                      int n, int use, int num_rows, float* out, float* g, float* a,
                      cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)num_rows * use, stream);
  if (err != cudaSuccess) return (int)err;
  const int nb = (n + kB - 1) / kB;
  segsum_scan_kernel<<<nb, kB, 0, stream>>>(sid, perm, cot, ld, n, nb, use, num_rows, out, g,
                                            a);
  return (int)cudaGetLastError();
}

// (c) and (d): g0 and a0 as the scan left them; g1 and a1 the same sizes,
// used above kCarryMaxBlocks blocks only (the passes' other buffers).
int tpurt_segsum_carry(const int* sid, int n, int use, int num_rows, float* g0, float* g1,
                       float* a0, float* a1, float* out, cudaStream_t stream) {
  const int nb = (n + kB - 1) / kB;
  cudaError_t err = cudaSuccess;
  if (nb <= kCarryMaxBlocks) {
    const int smem = 4 * nb * (int)sizeof(float);
    err = cudaFuncSetAttribute(segsum_carry_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    segsum_carry_kernel<<<use, kCarryThreads, smem, stream>>>(nb, g0, a0);
    err = cudaGetLastError();
  } else {
    const int grid = grid_of((long long)nb * use);
    for (int sh = 1; sh < nb && err == cudaSuccess; sh <<= 1) {
      segsum_carry_pass<<<grid, kThreads, 0, stream>>>(g0, a0, nb, use, sh, g1, a1);
      err = cudaGetLastError();
      float* t = g0; g0 = g1; g1 = t;
      t = a0; a0 = a1; a1 = t;
    }
  }
  if (err != cudaSuccess) return (int)err;
  segsum_ends_kernel<<<grid_of(n), kThreads, 0, stream>>>(sid, n, nb, use, num_rows, g0, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
