// Soft shadow transmittance for NVIDIA Hopper (sm_90a): the forward and
// the backward of diff/softvis.py soft_occlusion_layers_soa, each one
// launch.
//
// Replaces no Pallas kernel: tpurt computes this function in XLA
// (tpurt/diff/softvis.py soft_occlusion_layers_soa), and the port computed
// it as a chain of ~110 PyTorch operations over (K, L, C, R) tensors, whose
// autograd saved most of them and ran the broadcasts' gradients back
// through reductions and torch.prod's backward through two scans.  K
// layers, L lights (or area samples), C candidate occluders shared by the
// layers, R rays:
//
//   vis[k, l, r] = prod_c (1 - a[k, l, c, r]),
//   a = coverage(u, v) * shadow_t_ramp(t, t_max) * det_gate(cos_dn),
//
// with (t, u, v) the Moller-Trumbore intersection of the segment from the
// layer's surface point o[k, r] along d[k, l, r] with candidate ids[l, c,
// r]'s triangle (table row: v0, e1, e2), a = 0 where the id is -1 or the
// hit is not valid (softvis.py's mask).  Every operation is softvis.py's,
// in its order, its constants as torch rounds them; built with -fmad=false
// nothing is contracted.
//
// (a) softocc_fwd_kernel<C>: one thread a ray r.  For each l it gathers the
//     C candidates' 9 geometry floats from the table once into registers,
//     then for each k takes the layer's origin, direction and length (r
//     innermost in every array, so a warp's loads and stores are
//     coalesced; only the table rows are gathered) and multiplies out the
//     C factors in order c = 0 .. C - 1.
// (b) softocc_bwd_kernel<C>: the vector-Jacobian product for a cotangent
//     g[k, l, r], recomputed from the inputs (nothing of the forward is
//     saved).  For each (l, k): a first sweep over c recomputes 1 - a and
//     turns it, in place, into the exclusive suffix products; a second
//     sweep carries the exclusive prefix product, so d vis / d a_c = -prod
//     of the other factors with no division (1 - a = 0 exactly stays
//     right), and back-propagates through coverage, ramp, gate and
//     Moller-Trumbore.  The origin's gradient is summed over c and l, the
//     direction's and the length's over c, and each candidate's 9-float
//     table cotangent over k, in registers; the rows (L, C, R, 9) go to
//     the wrapper, which sums them into the table through segsum
//     (segment_accumulate), in its fixed order.  Every sum runs in a fixed
//     order and nothing is atomic, so a backward repeats bit for bit.
//
// C is a template parameter, the candidate count rounded up to 4, 8 or 16
// (kMaxC); the tail is masked as -1 ids are.  K and L are runtime loops.
//
// Bound: bytes.  The forward reads the ids (4 bytes), the candidates' 9
// floats (36 bytes, gathered: up to two 32-byte sectors a row), and the
// layers' origins, directions and lengths, and writes K L R floats; the
// backward reads the same and g, and writes the 7 input gradients and the
// (L, C, R, 9) rows.  At ~100 f32 operations an element forward and ~300
// backward, both far below the card's f32 rate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // rays a CTA
constexpr int kMaxC = 16;      // the most candidates a ray (KMAX)

// softvis.py's constants, each rounded to f32 the way torch rounds a Python
// float operand of an f32 tensor operation (differences taken in double).
constexpr float kDetEps = 1e-12f;                                    // accel/intersect.py DET_EPS
constexpr float kGateLo = (float)2e-3;                               // DET_GATE_LO
constexpr float kGateSpan = (float)(2e-2 - 2e-3);                    // DET_GATE_HI - DET_GATE_LO
constexpr float kRampNear0 = (float)0.004;                           // RAMP_NEAR0
constexpr float kRampNearSpan = (float)(0.04 - 0.004);               // RAMP_NEAR1 - RAMP_NEAR0
constexpr float kRampFar1 = (float)0.996;                            // RAMP_FAR1
constexpr float kRampFarSpan = (float)(0.996 - 0.96);                // RAMP_FAR1 - RAMP_FAR0
constexpr float kTmaxMin = (float)1e-12;                             // shadow_t_ramp's clamp
constexpr float kCosMin = (float)1e-30;                              // cos_dn's clamp

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ void add_to(V3& acc, V3 a) {
  acc.x += a.x;
  acc.y += a.y;
  acc.z += a.z;
}

// torch.clamp(x, 0, 1): NaN passes through.
__device__ __forceinline__ float clamp01(float x) { return x < 0.f ? 0.f : (x > 1.f ? 1.f : x); }
__device__ __forceinline__ bool in01(float x) { return x >= 0.f && x <= 1.f; }
// _smoothstep01 and its derivative.
__device__ __forceinline__ float smooth01(float x) { return x * x * (3.0f - 2.0f * x); }
__device__ __forceinline__ float dsmooth01(float x) { return 6.0f * x * (1.0f - x); }

// torch.minimum's backward: the gradient to the smaller operand, half to
// each on a tie.
__device__ __forceinline__ void min_grad(float a, float b, float g, float& ga, float& gb) {
  if (a < b) {
    ga += g;
  } else if (a > b) {
    gb += g;
  } else {
    ga += 0.5f * g;
    gb += 0.5f * g;
  }
}

struct Tri {
  V3 v0, e1, e2;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ table, long long ld, int id) {
  const float* p = table + (long long)id * ld;
  return {{__ldg(p + 0), __ldg(p + 1), __ldg(p + 2)},
          {__ldg(p + 3), __ldg(p + 4), __ldg(p + 5)},
          {__ldg(p + 6), __ldg(p + 7), __ldg(p + 8)}};
}

struct Args {
  const float* o[3];     // (K, R) each
  const float* d[3];     // (K, L, R) each
  const float* tm;       // (K, L, R)
  const int* ids;        // (L, C, R) at strides sl, sc, sr; -1 padded
  long long sl, sc, sr;
  int c_real;            // candidates a ray (<= the template's C)
  const float* table;    // (T, ld) rows, columns 0..8 read
  long long ld;
  int K, L, R;
  float sharp, band, one_band, half_band, t_min;
};

struct Grads {
  const float* g;        // (K, L, R): the cotangent of vis
  float* o[3];           // (K, R) each
  float* d[3];           // (K, L, R) each
  float* tm;             // (K, L, R)
  float* rows;           // (L, c_real, R, 9): each candidate's table cotangent
};

// One (layer, light, candidate) of a ray: returns a (0 where not valid).
// With kGrad, also back-propagates ga = d loss / d a into the origin's,
// direction's and length's gradient and the candidate row's.
template <bool kGrad>
__device__ __forceinline__ float alpha(const Tri& tr, V3 o, V3 d, float tm, const Args& p,
                                       float ga, V3& go, V3& gd, float& gtm, float* grow) {
  const V3 nrm = cross(tr.e1, tr.e2);
  const V3 pv = cross(d, tr.e2);
  const float det = dot(tr.e1, pv);
  const float den = det * det + kDetEps;
  const float inv = det / den;
  const V3 tv = sub(o, tr.v0);
  const float uu = dot(tv, pv);
  const float u = uu * inv;
  const V3 qv = cross(tv, tr.e1);
  const float vv = dot(d, qv);
  const float v = vv * inv;
  const float tt = dot(tr.e2, qv);
  const float t = tt * inv;
  const float dd = dot(d, d);
  const float nn = dot(nrm, nrm);
  const float q = dd * nn;
  const float qc = q < kCosMin ? kCosMin : q;
  const float rs = rsqrtf(qc);
  const float cos_dn = det * rs;
  const bool ok = fabsf(det) > kDetEps && u >= -p.band && v >= -p.band &&
                  u + v <= p.one_band && t > p.t_min && t < 2.0f * tm;
  if (!ok) return 0.f;
  // coverage: sigmoid(sharpness * s) times the band's window
  const float w3 = 1.0f - u - v;
  const float m1 = fminf(u, v);
  const float s = fminf(m1, w3);
  const float sig = 1.0f / (1.0f + expf(-(p.sharp * s)));
  float wr = 0.f, wc = 1.f, win = 1.f, cov = sig;
  if (p.band > 0.f) {
    wr = (s + p.band) / p.half_band;
    wc = clamp01(wr);
    win = smooth01(wc);
    cov = sig * win;
  }
  // shadow_t_ramp
  const float tmc = tm < kTmaxMin ? kTmaxMin : tm;
  const float x = t / tmc;
  const float ur = (x - kRampNear0) / kRampNearSpan;
  const float dr = (kRampFar1 - x) / kRampFarSpan;
  const float uc = clamp01(ur), dc = clamp01(dr);
  const float su = smooth01(uc), sd = smooth01(dc);
  const float ramp = su * sd;
  // det_gate
  const float ac = fabsf(cos_dn);
  const float gr = (ac - kGateLo) / kGateSpan;
  const float gc = clamp01(gr);
  const float gate = smooth01(gc);
  const float cr = cov * ramp;
  const float a = cr * gate;
  if (!kGrad) return a;

  // a = (cov * ramp) * gate
  const float g_cr = ga * gate;
  const float g_gate = ga * cr;
  const float g_cov = g_cr * ramp;
  const float g_ramp = g_cr * cov;
  // coverage
  float g_s = 0.f;
  const float g_sig = g_cov * win;
  if (p.band > 0.f) {
    const float g_win = g_cov * sig;
    const float g_wc = g_win * dsmooth01(wc);
    if (in01(wr)) g_s += g_wc / p.half_band;
  }
  g_s += g_sig * (1.0f - sig) * sig * p.sharp;
  float g_m1 = 0.f, g_w3 = 0.f, g_u = 0.f, g_v = 0.f;
  min_grad(m1, w3, g_s, g_m1, g_w3);
  min_grad(u, v, g_m1, g_u, g_v);
  g_u -= g_w3;
  g_v -= g_w3;
  // ramp
  float g_x = 0.f;
  if (in01(ur)) g_x += g_ramp * sd * dsmooth01(uc) / kRampNearSpan;
  if (in01(dr)) g_x -= g_ramp * su * dsmooth01(dc) / kRampFarSpan;
  const float g_t = g_x / tmc;
  if (tm >= kTmaxMin) gtm += -g_x * t / (tmc * tmc);
  // gate
  float g_cos = 0.f;
  if (in01(gr)) {
    const float g_ac = g_gate * dsmooth01(gc) / kGateSpan;
    g_cos = cos_dn > 0.f ? g_ac : (cos_dn < 0.f ? -g_ac : 0.f);
  }
  // cos_dn = det * rsqrt(max(dd * nn, 1e-30))
  float g_det = g_cos * rs;
  const float g_rs = g_cos * det;
  const float g_q = q >= kCosMin ? -0.5f * g_rs * rs * rs * rs : 0.f;
  const float g_dd = g_q * nn;
  const float g_nn = g_q * dd;
  // (u, v, t) = (uu, vv, tt) * inv, inv = det / (det * det + eps)
  const float g_inv = g_u * uu + g_v * vv + g_t * tt;
  const float g_uu = g_u * inv, g_vv = g_v * inv, g_tt = g_t * inv;
  g_det += g_inv / den;
  g_det += -g_inv * inv / den * 2.0f * det;
  // the vectors
  V3 g_d = scale(d, 2.0f * g_dd);
  const V3 g_nrm = scale(nrm, 2.0f * g_nn);
  V3 g_e1 = scale(pv, g_det);
  V3 g_pv = scale(tr.e1, g_det);
  V3 g_tv = scale(pv, g_uu);
  add_to(g_pv, scale(tv, g_uu));
  add_to(g_d, scale(qv, g_vv));
  V3 g_qv = scale(d, g_vv);
  V3 g_e2 = scale(qv, g_tt);
  add_to(g_qv, scale(tr.e2, g_tt));
  add_to(g_tv, cross(tr.e1, g_qv));  // qv = tv x e1
  add_to(g_e1, cross(g_qv, tv));
  add_to(g_d, cross(tr.e2, g_pv));   // pv = d x e2
  add_to(g_e2, cross(g_pv, d));
  add_to(g_e1, cross(tr.e2, g_nrm)); // nrm = e1 x e2
  add_to(g_e2, cross(g_nrm, tr.e1));
  add_to(go, g_tv);                  // tv = o - v0
  add_to(gd, g_d);
  grow[0] -= g_tv.x;
  grow[1] -= g_tv.y;
  grow[2] -= g_tv.z;
  grow[3] += g_e1.x;
  grow[4] += g_e1.y;
  grow[5] += g_e1.z;
  grow[6] += g_e2.x;
  grow[7] += g_e2.y;
  grow[8] += g_e2.z;
  return a;
}

__device__ __forceinline__ int load_id(const Args& p, int l, int c, int r) {
  return c < p.c_real ? p.ids[l * p.sl + c * p.sc + r * p.sr] : -1;
}

template <int C>
__global__ void __launch_bounds__(kThreads) softocc_fwd_kernel(Args p, float* __restrict__ vis) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= p.R) return;
  V3 go_, gd_;
  float gtm_;
  for (int l = 0; l < p.L; ++l) {
    int id[C];
    Tri tr[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      id[c] = load_id(p, l, c, r);
      if (id[c] >= 0) tr[c] = load_tri(p.table, p.ld, id[c]);
    }
    for (int k = 0; k < p.K; ++k) {
      const long long kr = (long long)k * p.R + r;
      const long long klr = ((long long)k * p.L + l) * p.R + r;
      const V3 o = {p.o[0][kr], p.o[1][kr], p.o[2][kr]};
      const V3 d = {p.d[0][klr], p.d[1][klr], p.d[2][klr]};
      const float tm = p.tm[klr];
      float v = 1.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (id[c] >= 0) v *= 1.0f - alpha<false>(tr[c], o, d, tm, p, 0.f, go_, gd_, gtm_, nullptr);
      }
      vis[klr] = v;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) softocc_bwd_kernel(Args p, Grads q) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= p.R) return;
  for (int l = 0; l < p.L; ++l) {
    int id[C];
#pragma unroll
    for (int c = 0; c < C; ++c) id[c] = load_id(p, l, c, r);
    float grow[C][9];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < 9; ++j) grow[c][j] = 0.f;
    }
    for (int k = 0; k < p.K; ++k) {
      const long long kr = (long long)k * p.R + r;
      const long long klr = ((long long)k * p.L + l) * p.R + r;
      const V3 o = {p.o[0][kr], p.o[1][kr], p.o[2][kr]};
      const V3 d = {p.d[0][klr], p.d[1][klr], p.d[2][klr]};
      const float tm = p.tm[klr];
      const float g = q.g[klr];
      V3 go = {0.f, 0.f, 0.f}, gd = {0.f, 0.f, 0.f};
      float gtm = 0.f;
      // 1 - a of every candidate, then in place the exclusive suffix products
      float sfx[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sfx[c] = id[c] >= 0 ? 1.0f - alpha<false>(load_tri(p.table, p.ld, id[c]), o, d, tm, p,
                                                  0.f, go, gd, gtm, nullptr)
                            : 1.f;
      }
      float run = 1.f;
#pragma unroll
      for (int c = C - 1; c >= 0; --c) {
        const float om = sfx[c];
        sfx[c] = run;
        run *= om;
      }
      // the exclusive prefix products, and the chain
      float pre = 1.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (id[c] < 0) continue;
        const float ga = -(g * (pre * sfx[c]));
        pre *= 1.0f - alpha<true>(load_tri(p.table, p.ld, id[c]), o, d, tm, p, ga, go, gd, gtm,
                                  grow[c]);
      }
      q.d[0][klr] = gd.x;
      q.d[1][klr] = gd.y;
      q.d[2][klr] = gd.z;
      q.tm[klr] = gtm;
      if (l == 0) {
        q.o[0][kr] = go.x;
        q.o[1][kr] = go.y;
        q.o[2][kr] = go.z;
      } else {
        q.o[0][kr] += go.x;
        q.o[1][kr] += go.y;
        q.o[2][kr] += go.z;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < p.c_real) {
        float* row = q.rows + (((long long)l * p.c_real + c) * p.R + r) * 9;
#pragma unroll
        for (int j = 0; j < 9; ++j) row[j] = grow[c][j];
      }
    }
  }
}

Args make_args(const float* ox, const float* oy, const float* oz, const float* dx,
               const float* dy, const float* dz, const float* tm, const int* ids, long long sl,
               long long sc, long long sr, int c_real, const float* table, long long ld, int K,
               int L, int R, float sharp, float band, float one_band, float half_band,
               float t_min) {
  Args p;
  p.o[0] = ox;
  p.o[1] = oy;
  p.o[2] = oz;
  p.d[0] = dx;
  p.d[1] = dy;
  p.d[2] = dz;
  p.tm = tm;
  p.ids = ids;
  p.sl = sl;
  p.sc = sc;
  p.sr = sr;
  p.c_real = c_real;
  p.table = table;
  p.ld = ld;
  p.K = K;
  p.L = L;
  p.R = R;
  p.sharp = sharp;
  p.band = band;
  p.one_band = one_band;
  p.half_band = half_band;
  p.t_min = t_min;
  return p;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, never synchronise, and return
// cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for c_real outside [0, 16].  ox, oy, oz (K, R) f32;
// dx, dy, dz, tm (K, L, R) f32, all contiguous; ids int32 (L, c_real, R)
// at element strides sl, sc, sr; table f32 rows of ld floats; R >= 1.
// one_band = 1 + band and half_band = 0.5 band, rounded from double as
// torch rounds them.  Forward: vis (K, L, R) f32.
int tpurt_softocc_fwd(const float* ox, const float* oy, const float* oz, const float* dx,
                      const float* dy, const float* dz, const float* tm, const int* ids,
                      long long sl, long long sc, long long sr, int c_real, const float* table,
                      long long ld, int K, int L, int R, float sharp, float band,
                      float one_band, float half_band, float t_min, float* vis,
                      cudaStream_t stream) {
  const Args p = make_args(ox, oy, oz, dx, dy, dz, tm, ids, sl, sc, sr, c_real, table, ld, K, L,
                           R, sharp, band, one_band, half_band, t_min);
  const int grid = (R + kThreads - 1) / kThreads;
  if (c_real < 0 || c_real > kMaxC) return (int)cudaErrorInvalidValue;
  if (c_real <= 4) {
    softocc_fwd_kernel<4><<<grid, kThreads, 0, stream>>>(p, vis);
  } else if (c_real <= 8) {
    softocc_fwd_kernel<8><<<grid, kThreads, 0, stream>>>(p, vis);
  } else {
    softocc_fwd_kernel<16><<<grid, kThreads, 0, stream>>>(p, vis);
  }
  return (int)cudaGetLastError();
}

// Backward: g (K, L, R) f32 the cotangent of vis; writes go_xyz (K, R),
// gd_xyz and gtm (K, L, R), and rows (L, c_real, R, 9), every element.
int tpurt_softocc_bwd(const float* ox, const float* oy, const float* oz, const float* dx,
                      const float* dy, const float* dz, const float* tm, const int* ids,
                      long long sl, long long sc, long long sr, int c_real, const float* table,
                      long long ld, int K, int L, int R, float sharp, float band,
                      float one_band, float half_band, float t_min, const float* g,
                      float* gox, float* goy, float* goz, float* gdx, float* gdy, float* gdz,
                      float* gtm, float* rows, cudaStream_t stream) {
  const Args p = make_args(ox, oy, oz, dx, dy, dz, tm, ids, sl, sc, sr, c_real, table, ld, K, L,
                           R, sharp, band, one_band, half_band, t_min);
  Grads q;
  q.g = g;
  q.o[0] = gox;
  q.o[1] = goy;
  q.o[2] = goz;
  q.d[0] = gdx;
  q.d[1] = gdy;
  q.d[2] = gdz;
  q.tm = gtm;
  q.rows = rows;
  const int grid = (R + kThreads - 1) / kThreads;
  if (c_real < 0 || c_real > kMaxC) return (int)cudaErrorInvalidValue;
  if (c_real <= 4) {
    softocc_bwd_kernel<4><<<grid, kThreads, 0, stream>>>(p, q);
  } else if (c_real <= 8) {
    softocc_bwd_kernel<8><<<grid, kThreads, 0, stream>>>(p, q);
  } else {
    softocc_bwd_kernel<16><<<grid, kThreads, 0, stream>>>(p, q);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
