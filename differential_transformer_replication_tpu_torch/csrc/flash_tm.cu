// Token-major multi-stream causal flash attention for Hopper (sm_90a),
// forward (kernel D) and backward (kernel E):
//
//   out = sum_s c[s, h] * softmax(Q_s K_s^T / sqrt(d) + causal) V
//
// Replaces the TPU kernels of differential_transformer_replication_tpu/
// ops/flash.py: _tm_fwd_call and _tm_fwd_call_packed (forward, one body
// _tm_fwd_kernel) and _tm_bwd_call and _tm_bwd_call_packed (backward, one
// body _tm_bwd_columns). Packed versus per-array is only a stride choice
// here: every operand is a base pointer plus a row stride (ld, elements
// per token row) with the head's columns at h * width. The per-array
// route passes S + S + 1 buffers whose ld is their own width; the packed
// route passes column windows of one (B, T, 2*S*H*d + H*dv) projection,
// all with ld = W, and the backward writes its dq/dk/dv windows straight
// into one packed dproj.
//
// Layouts (the JAX package's): q_s, k_s (B, T, H*d) rows of ld_qk; v
// (B, T, H*dv) rows of ld_v; coeffs (S, H) fp32; out (B, T, H*dv)
// contiguous; o_all (B, H, S, T, dv) in the storage type; lse and delta
// (B, T, H*S) fp32, column h*S + s; g (B, T, H*dv) contiguous.
//
// What bounds it on the H100: at the recipe (T = 512, d = 96, dv = 192,
// S = 2) the work is ~19 GFLOP of products per layer forward and about
// three times that backward, over ~40 MB of operands: far above the
// card's ~295 FLOP/byte ridge, so the bound is arithmetic. This first
// version is SIMT fp32 FMA on operands widened from the storage type
// (exact for bf16) with fp32 accumulation, like the TPU kernel's
// preferred_element_type=float32 dots; tensor-core tiles are later work.
// Every SM gets work from the start: one block per (b, h, 32-row tile),
// B*H*T/32 blocks (2048 at the diff recipe).
//
// Numerics follow _tm_fwd_kernel exactly: the scores of a row are all
// kept (T <= 512, so a 32-row tile's scores fit in shared memory), the
// FULL-row max is taken before any exponent (no online rescale), p =
// exp(s*scale - m) is rounded to the storage type before the PV product,
// o_s = PV / max(l, 1e-30) with l the sum of the unrounded p, the streams
// combine in fp32 and are rounded once; lse = m + log(max(l, 1e-30)).
// Keys past the diagonal are never staged past the tile's last row and
// are masked inside it (the TPU kernel's -1e30 bias is an exact 0 after
// exp, as is skipping). The backward follows _tm_bwd_columns: p =
// exp(s*scale - lse), ds = p*(gv*c - delta) rounded to the storage type,
// dq = ds K * scale and dk = ds^T Q * scale with fp32 accumulation, dv =
// (sum_s c_s p_s, rounded)^T g. It is split FlashAttention-2 style into
// a dq kernel (one block per (b, h, q tile)) and a dk/dv kernel (one
// block per (b, h, key tile)); g V^T is computed once per tile pair and
// shared by the streams. Head widths are looped, never padded (d = 96
// and dv = 192 are not powers of two).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;        // query rows per tile
constexpr int KT = 32;        // keys per tile
constexpr int THREADS = 256;  // 8 warps; warp w owns tile rows 4w .. 4w+3
constexpr int RPW = BQ / (THREADS / 32);
constexpr int MAX_S = 4;
constexpr int MAX_D = 128;
constexpr int MAX_DV = 256;
constexpr int DG = MAX_D / 32;   // lane groups over a q/k row
constexpr int VG = MAX_DV / 32;  // lane groups over a v row
constexpr int SMEM_LIMIT = 227 * 1024;

struct InPtrs { const void* p[MAX_S]; };
struct OutPtrs { void* p[MAX_S]; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the value a float takes once stored in T and read back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [t0, t0 + rows) of one head's columns (width w) of a token-major
// operand, widened to fp32 into dst with row stride dst_ld; rows past T
// are zero
template <typename T>
__device__ __forceinline__ void stage(float* dst, int dst_ld, const T* src,
                                      int ld, int b, int T_len, int t0,
                                      int rows, int col0, int w) {
  for (int i = threadIdx.x; i < rows * w; i += THREADS) {
    const int r = i / w, c = i - r * w;
    const int t = t0 + r;
    dst[r * dst_ld + c] =
        t < T_len ? to_f(src[((size_t)b * T_len + t) * ld + col0 + c]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: one block per (b, h, 32-row q tile)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
tm_fwd_kernel(InPtrs qs, InPtrs ks, const T* __restrict__ v,
              const float* __restrict__ coeffs, T* __restrict__ out,
              T* __restrict__ o_all, float* __restrict__ lse, int S, int T_len,
              int H, int d, int dv, int ld_qk, int ld_v, float scale) {
  extern __shared__ float smem[];
  const int DP = d | 1;  // odd row stride: lane-per-row reads hit 32 banks
  const int KVW = DP > dv ? DP : dv;
  float* Qs = smem;                 // [BQ][DP]
  float* Ss = Qs + BQ * DP;         // [BQ][T]: scores, then rounded p
  float* KV = Ss + BQ * T_len;      // [KT][KVW]: a K tile, then a V tile
  float* row_m = KV + KT * KVW;     // [BQ]
  float* row_l = row_m + BQ;        // [BQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nqt = (T_len + BQ - 1) / BQ;
  const int qt = blockIdx.x % nqt, bh = blockIdx.x / nqt;
  const int h = bh % H, b = bh / H;
  const int q0 = qt * BQ;
  const int kend = min(T_len, q0 + BQ);  // keys any row of the tile sees
  const int r0 = warp * RPW;             // the warp's rows; they are its own
                                         // in Ss, row_m and row_l throughout
  float comb[RPW][VG];
#pragma unroll
  for (int j = 0; j < RPW; ++j)
#pragma unroll
    for (int g = 0; g < VG; ++g) comb[j][g] = 0.f;

  for (int s = 0; s < S; ++s) {
    const T* q = static_cast<const T*>(qs.p[s]);
    const T* k = static_cast<const T*>(ks.p[s]);
    __syncthreads();  // the previous stream is done with Qs and KV
    stage<T>(Qs, DP, q, ld_qk, b, T_len, q0, BQ, h * d, d);

    // scores of rows r0..r0+3 against key k0 + lane, tile by tile
    for (int k0 = 0; k0 < kend; k0 += KT) {
      __syncthreads();
      stage<T>(KV, DP, k, ld_qk, b, T_len, k0, KT, h * d, d);
      __syncthreads();
      float acc[RPW] = {0.f, 0.f, 0.f, 0.f};
      const float* kr = KV + lane * DP;
      for (int c = 0; c < d; ++c) {
        const float kv = kr[c];
#pragma unroll
        for (int j = 0; j < RPW; ++j) acc[j] = fmaf(Qs[(r0 + j) * DP + c], kv, acc[j]);
      }
      const int key = k0 + lane;
      if (key < kend) {
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const int row = q0 + r0 + j;
          Ss[(r0 + j) * T_len + key] = key <= row ? acc[j] * scale : -INFINITY;
        }
      }
    }
    __syncwarp();

    // full-row max, then p = exp(s - m), rounded to T, and l = sum(p)
    for (int j = 0; j < RPW; ++j) {
      const int r = r0 + j, row = q0 + r;
      float* sr = Ss + r * T_len;
      if (row < T_len) {
        float m = -INFINITY;
        for (int key = lane; key <= row; key += 32) m = fmaxf(m, sr[key]);
        m = warp_max(m);
        float l = 0.f;
        for (int key = lane; key < kend; key += 32) {
          const float p = key <= row ? expf(sr[key] - m) : 0.f;
          l += p;
          sr[key] = round_to<T>(p);
        }
        l = warp_sum(l);
        if (lane == 0) {
          row_m[r] = m;
          row_l[r] = l;
        }
      } else {
        for (int key = lane; key < kend; key += 32) sr[key] = 0.f;
      }
    }
    __syncwarp();

    // PV over V tiles: rows r0..r0+3, columns lane + 32 g
    float acc[RPW][VG];
#pragma unroll
    for (int j = 0; j < RPW; ++j)
#pragma unroll
      for (int g = 0; g < VG; ++g) acc[j][g] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += KT) {
      __syncthreads();
      stage<T>(KV, dv, v, ld_v, b, T_len, k0, KT, h * dv, dv);
      __syncthreads();
      const int nk = min(KT, kend - k0);
      for (int kk = 0; kk < nk; ++kk) {
        float p[RPW];
#pragma unroll
        for (int j = 0; j < RPW; ++j) p[j] = Ss[(r0 + j) * T_len + k0 + kk];
#pragma unroll
        for (int g = 0; g < VG; ++g) {
          const int c = lane + 32 * g;
          if (c < dv) {
            const float vv = KV[kk * dv + c];
#pragma unroll
            for (int j = 0; j < RPW; ++j) acc[j][g] = fmaf(p[j], vv, acc[j][g]);
          }
        }
      }
    }

    const float cs = coeffs[s * H + h];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = r0 + j, row = q0 + r;
      if (row >= T_len) continue;
      const float l_safe = fmaxf(row_l[r], 1e-30f);
#pragma unroll
      for (int g = 0; g < VG; ++g) {
        const int c = lane + 32 * g;
        if (c < dv) {
          const float o = acc[j][g] / l_safe;
          comb[j][g] += o * cs;
          if (o_all != nullptr)
            o_all[(((size_t)b * H + h) * S + s) * T_len * dv + (size_t)row * dv + c] =
                from_f<T>(o);
        }
      }
      if (lse != nullptr && lane == 0)
        lse[((size_t)b * T_len + row) * H * S + h * S + s] = row_m[r] + logf(l_safe);
    }
  }

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = q0 + r0 + j;
    if (row >= T_len) continue;
#pragma unroll
    for (int g = 0; g < VG; ++g) {
      const int c = lane + 32 * g;
      if (c < dv) out[((size_t)b * T_len + row) * H * dv + h * dv + c] = from_f<T>(comb[j][g]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dq: one block per (b, h, 32-row q tile)
// ---------------------------------------------------------------------------

template <typename T, int S>
__global__ void __launch_bounds__(THREADS)
tm_bwd_dq_kernel(InPtrs qs, InPtrs ks, const T* __restrict__ v,
                 const T* __restrict__ gr, const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ coeffs, OutPtrs dqs, int T_len,
                 int H, int d, int dv, int ld_qk, int ld_v, int ld_dqk,
                 float scale) {
  extern __shared__ float smem[];
  const int DP = d | 1, VP = dv | 1;
  float* Qs = smem;                 // [S][BQ][DP]
  float* Gs = Qs + S * BQ * DP;     // [BQ][dv]
  float* Vs = Gs + BQ * dv;         // [KT][VP]
  float* Ks = Vs + KT * VP;         // [KT][DP]
  float* DS = Ks + KT * DP;         // [BQ][KT + 1], rows private to a warp

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nqt = (T_len + BQ - 1) / BQ;
  const int qt = blockIdx.x % nqt, bh = blockIdx.x / nqt;
  const int h = bh % H, b = bh / H;
  const int q0 = qt * BQ;
  const int kend = min(T_len, q0 + BQ);
  const int r0 = warp * RPW;

  for (int s = 0; s < S; ++s)
    stage<T>(Qs + s * BQ * DP, DP, static_cast<const T*>(qs.p[s]), ld_qk, b,
             T_len, q0, BQ, h * d, d);
  stage<T>(Gs, dv, gr, H * dv, b, T_len, q0, BQ, h * dv, dv);

  float lse_r[S][RPW], dl_r[S][RPW], cs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    cs[s] = coeffs[s * H + h];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int row = min(q0 + r0 + j, T_len - 1);
      const size_t at = ((size_t)b * T_len + row) * H * S + h * S + s;
      lse_r[s][j] = lse[at];
      dl_r[s][j] = delta[at];
    }
  }
  float dq[S][RPW][DG];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < RPW; ++j)
#pragma unroll
      for (int g = 0; g < DG; ++g) dq[s][j][g] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();
    stage<T>(Vs, VP, v, ld_v, b, T_len, k0, KT, h * dv, dv);
    __syncthreads();
    // gv[q][key] = <g_q, v_key>, once per tile pair, shared by the streams
    float gv[RPW] = {0.f, 0.f, 0.f, 0.f};
    {
      const float* vr = Vs + lane * VP;
      for (int c = 0; c < dv; ++c) {
        const float vv = vr[c];
#pragma unroll
        for (int j = 0; j < RPW; ++j) gv[j] = fmaf(Gs[(r0 + j) * dv + c], vv, gv[j]);
      }
    }
    const int key = k0 + lane;
    const int nk = min(KT, kend - k0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      __syncthreads();
      stage<T>(Ks, DP, static_cast<const T*>(ks.p[s]), ld_qk, b, T_len, k0, KT,
               h * d, d);
      __syncthreads();
      float sc[RPW] = {0.f, 0.f, 0.f, 0.f};
      const float* kr = Ks + lane * DP;
      const float* qb = Qs + s * BQ * DP;
      for (int c = 0; c < d; ++c) {
        const float kv = kr[c];
#pragma unroll
        for (int j = 0; j < RPW; ++j) sc[j] = fmaf(qb[(r0 + j) * DP + c], kv, sc[j]);
      }
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int row = q0 + r0 + j;
        const bool live = key < kend && key <= row && row < T_len;
        const float p = live ? expf(sc[j] * scale - lse_r[s][j]) : 0.f;
        DS[(r0 + j) * (KT + 1) + lane] =
            round_to<T>(p * (gv[j] * cs[s] - dl_r[s][j]));
      }
      __syncwarp();
      for (int kk = 0; kk < nk; ++kk) {
        float ds[RPW];
#pragma unroll
        for (int j = 0; j < RPW; ++j) ds[j] = DS[(r0 + j) * (KT + 1) + kk];
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          const int c = lane + 32 * g;
          if (c < d) {
            const float kv = Ks[kk * DP + c];
#pragma unroll
            for (int j = 0; j < RPW; ++j) dq[s][j][g] = fmaf(ds[j], kv, dq[s][j][g]);
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    T* dst = static_cast<T*>(dqs.p[s]);
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int row = q0 + r0 + j;
      if (row >= T_len) continue;
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const int c = lane + 32 * g;
        if (c < d)
          dst[((size_t)b * T_len + row) * ld_dqk + h * d + c] = from_f<T>(dq[s][j][g] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: one block per (b, h, 32-key tile); a thread owns
// keys r0..r0+3 of the tile and walks the q tiles at or past them
// ---------------------------------------------------------------------------

template <typename T, int S>
__global__ void __launch_bounds__(THREADS)
tm_bwd_dkdv_kernel(InPtrs qs, InPtrs ks, const T* __restrict__ v,
                   const T* __restrict__ gr, const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ coeffs, OutPtrs dks,
                   T* __restrict__ dvo, int T_len, int H, int d, int dv,
                   int ld_qk, int ld_v, int ld_dqk, int ld_dv, float scale) {
  extern __shared__ float smem[];
  const int DP = d | 1, VP = dv | 1;
  float* Ks = smem;                 // [S][KT][DP]
  float* Vs = Ks + S * KT * DP;     // [KT][dv]
  float* Qs = Vs + KT * dv;         // [BQ][DP]
  float* Gs = Qs + BQ * DP;         // [BQ][VP]
  float* DT = Gs + BQ * VP;         // [KT][BQ + 1] ds^T, rows private to a warp
  float* PT = DT + KT * (BQ + 1);   // [KT][BQ + 1] (sum_s c p)^T, likewise

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nkt = (T_len + KT - 1) / KT;
  const int kt = blockIdx.x % nkt, bh = blockIdx.x / nkt;
  const int h = bh % H, b = bh / H;
  const int k0 = kt * KT;
  const int r0 = warp * RPW;

  for (int s = 0; s < S; ++s)
    stage<T>(Ks + s * KT * DP, DP, static_cast<const T*>(ks.p[s]), ld_qk, b,
             T_len, k0, KT, h * d, d);
  stage<T>(Vs, dv, v, ld_v, b, T_len, k0, KT, h * dv, dv);

  float cs[S];
#pragma unroll
  for (int s = 0; s < S; ++s) cs[s] = coeffs[s * H + h];
  float dk[S][RPW][DG];
  float dva[RPW][VG];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int g = 0; g < DG; ++g) dk[s][j][g] = 0.f;
#pragma unroll
    for (int g = 0; g < VG; ++g) dva[j][g] = 0.f;
  }

  // the first q tile that sees any key of this tile (BQ == KT)
  for (int q0 = k0; q0 < T_len; q0 += BQ) {
    __syncthreads();
    stage<T>(Gs, VP, gr, H * dv, b, T_len, q0, BQ, h * dv, dv);
    const int qrow = q0 + lane;
    const int qc = min(qrow, T_len - 1);
    float lse_q[S], dl_q[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t at = ((size_t)b * T_len + qc) * H * S + h * S + s;
      lse_q[s] = lse[at];
      dl_q[s] = delta[at];
    }
    __syncthreads();
    // gv[q][key] for keys r0+j of this tile and query q0 + lane
    float gv[RPW] = {0.f, 0.f, 0.f, 0.f};
    {
      const float* gq = Gs + lane * VP;
      for (int c = 0; c < dv; ++c) {
        const float gg = gq[c];
#pragma unroll
        for (int j = 0; j < RPW; ++j) gv[j] = fmaf(Vs[(r0 + j) * dv + c], gg, gv[j]);
      }
    }
    float pc[RPW] = {0.f, 0.f, 0.f, 0.f};
    const int nq = min(BQ, T_len - q0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      __syncthreads();
      stage<T>(Qs, DP, static_cast<const T*>(qs.p[s]), ld_qk, b, T_len, q0, BQ,
               h * d, d);
      __syncthreads();
      float sc[RPW] = {0.f, 0.f, 0.f, 0.f};
      const float* qr = Qs + lane * DP;
      const float* kb = Ks + s * KT * DP;
      for (int c = 0; c < d; ++c) {
        const float qv = qr[c];
#pragma unroll
        for (int j = 0; j < RPW; ++j) sc[j] = fmaf(kb[(r0 + j) * DP + c], qv, sc[j]);
      }
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int key = k0 + r0 + j;
        const bool live = qrow < T_len && key <= qrow;
        const float p = live ? expf(sc[j] * scale - lse_q[s]) : 0.f;
        DT[(r0 + j) * (BQ + 1) + lane] = round_to<T>(p * (gv[j] * cs[s] - dl_q[s]));
        pc[j] += p * cs[s];
      }
      __syncwarp();
      for (int qq = 0; qq < nq; ++qq) {
        float ds[RPW];
#pragma unroll
        for (int j = 0; j < RPW; ++j) ds[j] = DT[(r0 + j) * (BQ + 1) + qq];
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          const int c = lane + 32 * g;
          if (c < d) {
            const float qv = Qs[qq * DP + c];
#pragma unroll
            for (int j = 0; j < RPW; ++j) dk[s][j][g] = fmaf(ds[j], qv, dk[s][j][g]);
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < RPW; ++j) PT[(r0 + j) * (BQ + 1) + lane] = round_to<T>(pc[j]);
    __syncwarp();
    for (int qq = 0; qq < nq; ++qq) {
      float pr[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) pr[j] = PT[(r0 + j) * (BQ + 1) + qq];
#pragma unroll
      for (int g = 0; g < VG; ++g) {
        const int c = lane + 32 * g;
        if (c < dv) {
          const float gg = Gs[qq * VP + c];
#pragma unroll
          for (int j = 0; j < RPW; ++j) dva[j][g] = fmaf(pr[j], gg, dva[j][g]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int key = k0 + r0 + j;
    if (key >= T_len) continue;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      T* dst = static_cast<T*>(dks.p[s]);
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const int c = lane + 32 * g;
        if (c < d)
          dst[((size_t)b * T_len + key) * ld_dqk + h * d + c] = from_f<T>(dk[s][j][g] * scale);
      }
    }
#pragma unroll
    for (int g = 0; g < VG; ++g) {
      const int c = lane + 32 * g;
      if (c < dv) dvo[((size_t)b * T_len + key) * ld_dv + h * dv + c] = from_f<T>(dva[j][g]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

size_t fwd_smem(int T_len, int d, int dv) {
  const int DP = d | 1;
  const int KVW = DP > dv ? DP : dv;
  return sizeof(float) * ((size_t)BQ * DP + (size_t)BQ * T_len + (size_t)KT * KVW + 2 * BQ);
}

size_t dq_smem(int S, int d, int dv) {
  const int DP = d | 1, VP = dv | 1;
  return sizeof(float) * ((size_t)S * BQ * DP + (size_t)BQ * dv + (size_t)KT * VP +
                          (size_t)KT * DP + (size_t)BQ * (KT + 1));
}

size_t dkdv_smem(int S, int d, int dv) {
  const int DP = d | 1, VP = dv | 1;
  return sizeof(float) * ((size_t)S * KT * DP + (size_t)KT * dv + (size_t)BQ * DP +
                          (size_t)BQ * VP + 2 * (size_t)KT * (BQ + 1));
}

// lets launches of ``kernel`` take ``smem`` bytes of dynamic shared
// memory (above 48 KB a launch without it is refused, error 1); the
// attribute is set again only when a launch needs more than before, so
// launches captured into a CUDA graph make no attribute calls
template <auto Kernel>
int allow_smem(size_t smem) {
  static size_t granted = 0;  // one per kernel
  if (smem <= granted) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) granted = smem;
  return static_cast<int>(err);
}

bool shapes_ok(int S, int B, int T_len, int H, int d, int dv) {
  return S >= 1 && S <= MAX_S && B > 0 && T_len > 0 && H > 0 && d > 0 &&
         d <= MAX_D && dv > 0 && dv <= MAX_DV;
}

template <typename T>
int fwd(const void* const* qs, const void* const* ks, const void* v,
        const float* coeffs, void* out, void* o_all, float* lse, int S, int B,
        int T_len, int H, int d, int dv, int ld_qk, int ld_v, float scale,
        cudaStream_t stream) {
  InPtrs q{}, k{};
  for (int s = 0; s < S; ++s) {
    q.p[s] = qs[s];
    k.p[s] = ks[s];
  }
  const size_t smem = fwd_smem(T_len, d, dv);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H * ((T_len + BQ - 1) / BQ));
  int rc = allow_smem<tm_fwd_kernel<T>>(smem);
  if (rc != 0) return rc;
  tm_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      q, k, static_cast<const T*>(v), coeffs, static_cast<T*>(out),
      static_cast<T*>(o_all), lse, S, T_len, H, d, dv, ld_qk, ld_v, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int bwd_s(const InPtrs& q, const InPtrs& k, const void* v, const void* g,
          const float* lse, const float* delta, const float* coeffs,
          const OutPtrs& dq, const OutPtrs& dk, void* dvo, int B, int T_len,
          int H, int d, int dv, int ld_qk, int ld_v, int ld_dqk, int ld_dv,
          float scale, cudaStream_t stream) {
  const size_t s1 = dq_smem(S, d, dv), s2 = dkdv_smem(S, d, dv);
  if (s1 > SMEM_LIMIT || s2 > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g1(B * H * ((T_len + BQ - 1) / BQ)), g2(B * H * ((T_len + KT - 1) / KT));
  int rc = allow_smem<tm_bwd_dq_kernel<T, S>>(s1);
  if (rc != 0) return rc;
  rc = allow_smem<tm_bwd_dkdv_kernel<T, S>>(s2);
  if (rc != 0) return rc;
  tm_bwd_dq_kernel<T, S><<<g1, THREADS, s1, stream>>>(
      q, k, static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      coeffs, dq, T_len, H, d, dv, ld_qk, ld_v, ld_dqk, scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  tm_bwd_dkdv_kernel<T, S><<<g2, THREADS, s2, stream>>>(
      q, k, static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      coeffs, dk, static_cast<T*>(dvo), T_len, H, d, dv, ld_qk, ld_v, ld_dqk,
      ld_dv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* const* qs, const void* const* ks, const void* v,
        const void* g, const float* lse, const float* delta,
        const float* coeffs, void* const* dqs, void* const* dks, void* dvo,
        int S, int B, int T_len, int H, int d, int dv, int ld_qk, int ld_v,
        int ld_dqk, int ld_dv, float scale, cudaStream_t stream) {
  InPtrs q{}, k{};
  OutPtrs dq{}, dk{};
  for (int s = 0; s < S; ++s) {
    q.p[s] = qs[s];
    k.p[s] = ks[s];
    dq.p[s] = dqs[s];
    dk.p[s] = dks[s];
  }
#define TM_BWD_CASE(N)                                                          \
  case N:                                                                       \
    return bwd_s<T, N>(q, k, v, g, lse, delta, coeffs, dq, dk, dvo, B, T_len, H, \
                       d, dv, ld_qk, ld_v, ld_dqk, ld_dv, scale, stream);
  switch (S) {
    TM_BWD_CASE(1)
    TM_BWD_CASE(2)
    TM_BWD_CASE(3)
    TM_BWD_CASE(4)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TM_BWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. o_all and lse may be null (the
// forward without residuals, for eval). Returns the launch's CUDA error
// code (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int flash_tm_fwd(const void* const* qs, const void* const* ks,
                            const void* v, const void* coeffs, void* out,
                            void* o_all, void* lse, int S, int B, int T_len,
                            int H, int d, int dv, int ld_qk, int ld_v,
                            float scale, int dtype, void* stream) {
  if (!shapes_ok(S, B, T_len, H, d, dv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coeffs);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return fwd<float>(qs, ks, v, c, out, o_all, l, S, B, T_len, H, d, dv, ld_qk, ld_v, scale, st);
    case 1: return fwd<__nv_bfloat16>(qs, ks, v, c, out, o_all, l, S, B, T_len, H, d, dv, ld_qk, ld_v, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_tm_bwd(const void* const* qs, const void* const* ks,
                            const void* v, const void* g, const void* lse,
                            const void* delta, const void* coeffs,
                            void* const* dqs, void* const* dks, void* dv_out,
                            int S, int B, int T_len, int H, int d, int dv,
                            int ld_qk, int ld_v, int ld_dqk, int ld_dv,
                            float scale, int dtype, void* stream) {
  if (!shapes_ok(S, B, T_len, H, d, dv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* c = static_cast<const float*>(coeffs);
  switch (dtype) {
    case 0: return bwd<float>(qs, ks, v, g, l, dl, c, dqs, dks, dv_out, S, B, T_len, H, d, dv, ld_qk, ld_v, ld_dqk, ld_dv, scale, st);
    case 1: return bwd<__nv_bfloat16>(qs, ks, v, g, l, dl, c, dqs, dks, dv_out, S, B, T_len, H, d, dv, ld_qk, ld_v, ld_dqk, ld_dv, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
