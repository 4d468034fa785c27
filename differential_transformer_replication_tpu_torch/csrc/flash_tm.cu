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
// What bounds it on the H100: at the diff recipe (B 32, T 512, d 96,
// dv 192, S 2) the forward does ~19 GFLOP of products (~20 us at the
// bf16 tensor-core peak) and moves over 110 MB (35-45 us), so its
// least time is set by bytes; the backward is about twice both. Both
// kernels run near 10x that: what holds them back is register and
// shared-memory room per SM, which sets how many warps hide the latency
// of each product and load (chip_smoke.py prints the times and bounds).
//
// bf16, the training path: tensor cores. Every product is
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators in registers), its
// fragments read from shared memory by ldmatrix (.trans for operands
// stored [depth][column]: V in PV, K in dS K, Q in dS^T Q, g in P^T g);
// a product's result is the next product's A operand straight from
// registers (the C and A fragment layouts line up), so p and ds are
// rounded to bf16 exactly where the JAX kernel and the plain twin round
// them. A block is 4 warps and 64 rows (16 per warp); it walks column
// tiles of 32 (keys in D and dq, queries in dk and dv), staged by 16-byte
// cp.async double-buffered, so the next tile's copy overlaps this tile's
// products. 32 and not 64 columns keeps a block under half the SM's
// shared memory (two blocks per SM at the diff recipe; 64-key tiles ran
// D 1.34x and E 1.44x slower there, one block per SM). Head widths are
// zero-padded to 16 in shared memory (rows +16 bytes, so ldmatrix rows hit
// all bank groups) and stores are masked. Operands whose rows or head
// windows are not 16-byte aligned take the 2-byte-load instance (VEC =
// false) of the same kernels. Causal: column tiles past a block's last
// row are never visited, and only tiles that reach past its first row
// are masked. Instances by accumulator width: dv padded to 64/128/192/
// 256 (VN = 8..32 fragments) and d to 64/96/128 (DN = 8, 12, 16).
//
// D, forward (one block per (b, h, 64-row q tile), longest rows first):
// two passes per stream over its key tiles, (a) of the two ways to keep
// the full-row max before any exponent: pass 1 computes Q K^T and only
// the row max; pass 2 recomputes Q K^T, p = exp(s*scale - m), l += p
// (unrounded), and PV with p rounded. It costs a third more products at
// d 96 / dv 192, where (b), the block's fp32 scores in shared memory
// (64 x 512 x 4 = 128 KB), would leave one block per SM and no room to
// double-buffer. o_s = PV / max(l, 1e-30); lse = m + log(l_safe). The
// fp32 stream combine lives in shared memory (64 x dv x 4 bytes, S > 1
// only), each thread owning its fragments' slots, so it needs no
// barrier; the output is rounded once after the last stream.
//
// E, backward, FlashAttention-2 style: every output has one writer and
// there are no atomics (two launches give the same bits). Three kernels:
//  - dq: one block per (b, h, q tile, group of streams); g V^T once per
//    tile pair, shared by the group; ds = p (gv c_s - delta) rounded;
//    dq_s += ds K_s. A group is two streams where both dq fit the
//    registers (d <= 96: 2 x 48 fp32), else one (S 3, 4 compute g V^T
//    twice).
//  - dk: one block per (b, h, key tile, stream), walking the q tiles at
//    or past its keys: dS^T = P^T o (V g^T c_s - delta), dk_s += dS^T Q_s.
//    One stream's dk per block is what fits beside the score fragments;
//    V g^T is recomputed per stream (S times instead of once).
//  - dv: one block per (b, h, key tile): dv needs sum_s c_s P_s rounded
//    once, so it recomputes every stream's scores (S more Q K^T) and
//    accumulates dv += (sum_s c_s P_s^T, rounded) g.
//  At the diff recipe that is ~1.8x the backward's minimal products; the
//  register budget (dk for S streams plus dv: 288 fp32 at S 4, d 96,
//  dv 192) is what it buys. registers per instance: `ptxas -v`, printed
//  by chip_smoke.py; no bf16 instance spills.
//
// fp32: the first version's SIMT kernels (fp32 FMA, 32-row tiles, the
// scores of a row kept in shared memory), exact against the plain twin;
// the fp32 tests and the card-vs-CPU train step use them.
//
// Numerics follow _tm_fwd_kernel and _tm_bwd_columns in both: the
// FULL-row max before any exponent (no online rescale), p rounded to the
// storage type before PV, l from the unrounded p, o_s = PV / max(l,
// 1e-30), the streams combined in fp32 and rounded once, lse = m +
// log(max(l, 1e-30)); backward p = exp(s*scale - lse), ds = p*(gv*c -
// delta) rounded, dq = ds K * scale and dk = ds^T Q * scale with fp32
// accumulation, dv = (sum_s c_s p_s, rounded)^T g. Keys past the diagonal
// are skipped or masked (the TPU kernel's -1e30 bias is an exact 0 after
// exp, as is skipping).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

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

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

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

// ===========================================================================
// bf16: tensor-core kernels (mma.sync m16n8k16, fp32 accumulators)
// ===========================================================================

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;      // rows per block: queries (D, dq) or keys (dk, dv)
constexpr int KC = 32;        // columns per step: keys (D, dq) or queries (dk, dv)
constexpr int MT = 128;       // 4 warps; warp w owns tile rows 16w .. 16w+15
constexpr int SKT = KC / 8;   // 8-column score fragments across a column tile

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; thread t gives the address of row t % 8 of
// matrix t / 8 and gets, of matrix i, elements (t / 4, 2 (t % 4) + {0,1})
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the lower column in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [t0, t0 + rows) of one head's w columns of a token-major operand
// into a bf16 tile of row stride sld; rows past T are zeros, columns past
// w are never written (zeroed once at the kernel's start). VEC: 16-byte
// cp.async copies (the wrapper checked 16-byte aligned rows and columns);
// else 2-byte loads.
template <bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, int sld, const bf16* src,
                                          int ld, int b, int T_len, int t0,
                                          int rows, int col0, int w) {
  const size_t row0 = (size_t)b * T_len;
  if (VEC) {
    const int chunks = w >> 3;
    for (int i = threadIdx.x; i < rows * chunks; i += MT) {
      const int r = i / chunks, c = (i - r * chunks) << 3;
      const int t = t0 + r;
      const bool ok = t < T_len;
      cp_async16(dst + r * sld + c, src + (row0 + (ok ? t : 0)) * ld + col0 + c, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += MT) {
      const int r = i / w, c = i - r * w;
      const int t = t0 + r;
      dst[r * sld + c] = t < T_len ? src[(row0 + t) * ld + col0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  int4* q = static_cast<int4*>(p);
  for (size_t i = threadIdx.x; i < bytes / 16; i += MT) q[i] = make_int4(0, 0, 0, 0);
}

// s (16 rows x KC columns, fp32 fragments) = A B^T over depth kd (a
// multiple of 16): A rows 16w.. of a tile of stride lda, B the KC rows of
// a tile of stride ldb, both [row][depth]
__device__ __forceinline__ void tile_abt(float (&s)[SKT][4], const bf16* A, int lda,
                                         const bf16* B, int ldb, int kd) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < SKT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const bf16* a_row = A + (16 * warp + (lane & 15)) * lda + (lane >> 4) * 8;
  const bf16* b_row = B + ((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 8;
  for (int k = 0; k < kd; k += 16) {
    unsigned a[4];
    ldsm4(a, a_row + k);
#pragma unroll
    for (int np = 0; np < SKT / 2; ++np) {
      unsigned bb[4];
      ldsm4(bb, b_row + np * 16 * ldb + k);
      mma16816(s[2 * np], a, bb[0], bb[1]);
      mma16816(s[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (16 x 8N fp32 fragments, N of them live: n < nlive) += P (16 x KC,
// bf16 A fragments pa[kk] for columns 16kk..16kk+15) times the KC x 8N
// tile B of stride ldb stored [P column][acc column] (read transposed)
template <int N>
__device__ __forceinline__ void tile_pb(float (&acc)[N][4], const unsigned (&pa)[KC / 16][4],
                                        const bf16* B, int ldb, int nlive) {
  const int lane = threadIdx.x & 31;
  const bf16* b_row = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      if (2 * np < nlive) {
        unsigned bb[4];
        ldsm4t(bb, b_row + kk * 16 * ldb + np * 16);
        mma16816(acc[2 * np], pa[kk], bb[0], bb[1]);
        mma16816(acc[2 * np + 1], pa[kk], bb[2], bb[3]);
      }
    }
  }
}

// the C fragments of s (16 x KC) as A fragments of the next product
__device__ __forceinline__ void to_a(unsigned (&pa)[KC / 16][4], const float (&s)[SKT][4]) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// one row's pair of adjacent columns (c, c + 1) of a bf16 output
template <bool VEC>
__device__ __forceinline__ void store2(bf16* dst, int c, int w, float x0, float x1) {
  if (VEC) {
    if (c < w) *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < w) dst[0] = __float2bfloat16_rn(x0);
    if (c + 1 < w) dst[1] = __float2bfloat16_rn(x1);
  }
}

// ---------------------------------------------------------------------------
// forward D: one block per (b, h, 64-row q tile); two passes per stream
// over the key tiles (max, then p and PV), K/V double-buffered
// ---------------------------------------------------------------------------

template <int VN, bool VEC>
__global__ void __launch_bounds__(MT)
tm_fwd_mma(InPtrs qs, InPtrs ks, const bf16* __restrict__ v,
           const float* __restrict__ coeffs, bf16* __restrict__ out,
           bf16* __restrict__ o_all, float* __restrict__ lse, int S, int T_len,
           int H, int d, int dv, int ld_qk, int ld_v, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;  // +16 bytes: ldmatrix rows hit 8 bank groups
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TILE][QS]
  bf16* Kb = Qs + TILE * QS;                     // [2][KC][QS]
  bf16* Vb = Kb + 2 * KC * QS;                   // [2][KC][VS]
  float* comb = reinterpret_cast<float*>(Vb + 2 * KC * VS);  // [4][VN][32][4]
  zero_smem(smem_raw, sizeof(bf16) * ((size_t)TILE * QS + 2 * (size_t)KC * (QS + VS)));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nqt = (T_len + TILE - 1) / TILE;
  const int BH = gridDim.x / nqt;
  const int qt = nqt - 1 - blockIdx.x / BH;  // the longest rows first
  const int bh = blockIdx.x % BH, h = bh % H, b = bh / H;
  const int q0 = qt * TILE, nsteps = 2 * ((min(T_len, q0 + TILE) + KC - 1) / KC);
  const int nk = nsteps / 2;
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const int vlive = VP / 8;

  for (int s = 0; s < S; ++s) {
    const bf16* q = static_cast<const bf16*>(qs.p[s]);
    const bf16* k = static_cast<const bf16*>(ks.p[s]);
    // step i < nk stages K tile i (pass 1); step nk + j stages K and V
    // tile j (pass 2); buffer i & 1
    auto stage = [&](int i) {
      const int j = i < nk ? i : i - nk;
      load_tile<VEC>(Kb + (i & 1) * KC * QS, QS, k, ld_qk, b, T_len, j * KC, KC, h * d, d);
      if (i >= nk)
        load_tile<VEC>(Vb + (i & 1) * KC * VS, VS, v, ld_v, b, T_len, j * KC, KC, h * dv, dv);
    };
    __syncthreads();  // the previous stream is done with Qs and the buffers
    load_tile<VEC>(Qs, QS, q, ld_qk, b, T_len, q0, TILE, h * d, d);
    stage(0);
    cp_commit();

    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[VN][4];
#pragma unroll
    for (int n = 0; n < VN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    for (int i = 0; i < nsteps; ++i) {
      if (i + 1 < nsteps) {
        stage(i + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int j = i < nk ? i : i - nk;
      const bool diag = j * KC + KC - 1 > q0;  // keys past some row of the block
      float sc[SKT][4];
      tile_abt(sc, Qs, QS, Kb + (i & 1) * KC * QS, QS, DP);
      if (i < nk) {
#pragma unroll
        for (int n = 0; n < SKT; ++n) {
          const int key = j * KC + n * 8 + 2 * tq;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (!diag || key + e <= row0) m0 = fmaxf(m0, sc[n][e] * scale);
            if (!diag || key + e <= row1) m1 = fmaxf(m1, sc[n][2 + e] * scale);
          }
        }
        if (i == nk - 1) {  // the full-row max, before any exponent
#pragma unroll
          for (int o2 = 1; o2 < 4; o2 <<= 1) {
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o2));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o2));
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < SKT; ++n) {
          const int key = j * KC + n * 8 + 2 * tq;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = (!diag || key + e <= row0) ? expf(sc[n][e] * scale - m0) : 0.f;
            const float p1 = (!diag || key + e <= row1) ? expf(sc[n][2 + e] * scale - m1) : 0.f;
            l0 += p0;
            l1 += p1;
            sc[n][e] = p0;
            sc[n][2 + e] = p1;
          }
        }
        unsigned pa[KC / 16][4];
        to_a(pa, sc);  // p rounded to bf16: the PV operand
        tile_pb<VN>(o, pa, Vb + (i & 1) * KC * VS, VS, vlive);
      }
      __syncthreads();
    }

#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
    }
    const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
    const float cs = coeffs[s * H + h];
    bf16* oa = o_all == nullptr ? nullptr
                                : o_all + (((size_t)b * H + h) * S + s) * T_len * dv;
#pragma unroll
    for (int n = 0; n < VN; ++n) {
      if (n >= vlive) continue;
      const int c = n * 8 + 2 * tq;
      float x[4] = {o[n][0] / ls0, o[n][1] / ls0, o[n][2] / ls1, o[n][3] / ls1};
      if (oa != nullptr) {
        if (row0 < T_len) store2<VEC>(oa + (size_t)row0 * dv + c, c, dv, x[0], x[1]);
        if (row1 < T_len) store2<VEC>(oa + (size_t)row1 * dv + c, c, dv, x[2], x[3]);
      }
      // the fp32 stream combine: each thread owns its fragments' slots
      float4* cb = reinterpret_cast<float4*>(comb) + (warp * VN + n) * 32 + lane;
      float4 acc = make_float4(x[0] * cs, x[1] * cs, x[2] * cs, x[3] * cs);
      if (s > 0) {
        const float4 prev = *cb;
        acc = make_float4(prev.x + acc.x, prev.y + acc.y, prev.z + acc.z, prev.w + acc.w);
      }
      if (s + 1 < S) {
        *cb = acc;
      } else {
        bf16* ob = out + (size_t)b * T_len * H * dv + h * dv + c;
        if (row0 < T_len) store2<VEC>(ob + (size_t)row0 * H * dv, c, dv, acc.x, acc.y);
        if (row1 < T_len) store2<VEC>(ob + (size_t)row1 * H * dv, c, dv, acc.z, acc.w);
      }
    }
    if (lse != nullptr && tq == 0) {
      const size_t at = (size_t)b * T_len * H * S + h * S + s;
      if (row0 < T_len) lse[at + (size_t)row0 * H * S] = m0 + logf(ls0);
      if (row1 < T_len) lse[at + (size_t)row1 * H * S] = m1 + logf(ls1);
    }
  }
}

// ---------------------------------------------------------------------------
// backward E, dq: one block per (b, h, 64-row q tile, group of NS streams);
// g V^T once per tile pair, shared by the group's streams
// ---------------------------------------------------------------------------

template <int NS, int DN, bool VEC>
__global__ void __launch_bounds__(MT)
tm_bwd_dq_mma(InPtrs qs, InPtrs ks, const bf16* __restrict__ v,
              const bf16* __restrict__ gr, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ coeffs,
              OutPtrs dqs, int S, int T_len, int H, int d, int dv, int ld_qk,
              int ld_v, int ld_dqk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [NS][TILE][QS]
  bf16* Gs = Qs + NS * TILE * QS;                // [TILE][VS]
  bf16* Kb = Gs + TILE * VS;                     // [2][NS][KC][QS]
  bf16* Vb = Kb + 2 * NS * KC * QS;              // [2][KC][VS]
  zero_smem(smem_raw, sizeof(bf16) * ((size_t)TILE * (NS * QS + VS) +
                                      2 * (size_t)KC * (NS * QS + VS)));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nqt = (T_len + TILE - 1) / TILE;
  const int ngrp = (S + NS - 1) / NS;
  const int BH = gridDim.x / (nqt * ngrp);
  const int bh = blockIdx.x % BH, rest = blockIdx.x / BH;
  const int grp = rest % ngrp, qt = nqt - 1 - rest / ngrp;
  const int h = bh % H, b = bh / H;
  const int s0 = grp * NS, ns = min(NS, S - s0);
  const int q0 = qt * TILE, nk = (min(T_len, q0 + TILE) + KC - 1) / KC;
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const int dlive = DP / 8;

  auto stage = [&](int j) {
    for (int u = 0; u < ns; ++u)
      load_tile<VEC>(Kb + ((j & 1) * NS + u) * KC * QS, QS,
                     static_cast<const bf16*>(ks.p[s0 + u]), ld_qk, b, T_len,
                     j * KC, KC, h * d, d);
    load_tile<VEC>(Vb + (j & 1) * KC * VS, VS, v, ld_v, b, T_len, j * KC, KC, h * dv, dv);
  };
  __syncthreads();  // the zeroed pads before any copy lands
  for (int u = 0; u < ns; ++u)
    load_tile<VEC>(Qs + u * TILE * QS, QS, static_cast<const bf16*>(qs.p[s0 + u]),
                   ld_qk, b, T_len, q0, TILE, h * d, d);
  load_tile<VEC>(Gs, VS, gr, H * dv, b, T_len, q0, TILE, h * dv, dv);
  stage(0);
  cp_commit();

  float lse_r[NS][2], dl_r[NS][2], cs[NS];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    const int su = min(s0 + u, S - 1);
    cs[u] = coeffs[su * H + h];
    const int rows[2] = {min(row0, T_len - 1), min(row1, T_len - 1)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t at = ((size_t)b * T_len + rows[r]) * H * S + h * S + su;
      lse_r[u][r] = lse[at];
      dl_r[u][r] = delta[at];
    }
  }
  float dq[NS][DN][4];
#pragma unroll
  for (int u = 0; u < NS; ++u)
#pragma unroll
    for (int n = 0; n < DN; ++n) dq[u][n][0] = dq[u][n][1] = dq[u][n][2] = dq[u][n][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      stage(j + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bool diag = j * KC + KC - 1 > q0;
    const bf16* Vt = Vb + (j & 1) * KC * VS;
    float gv[SKT][4];
    tile_abt(gv, Gs, VS, Vt, VS, VP);
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      if (u >= ns) break;
      const bf16* Kt = Kb + ((j & 1) * NS + u) * KC * QS;
      float sc[SKT][4];
      tile_abt(sc, Qs + u * TILE * QS, QS, Kt, QS, DP);
#pragma unroll
      for (int n = 0; n < SKT; ++n) {
        const int key = j * KC + n * 8 + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = (!diag || key + e <= row0) ? expf(sc[n][e] * scale - lse_r[u][0]) : 0.f;
          const float p1 = (!diag || key + e <= row1) ? expf(sc[n][2 + e] * scale - lse_r[u][1]) : 0.f;
          sc[n][e] = p0 * (gv[n][e] * cs[u] - dl_r[u][0]);
          sc[n][2 + e] = p1 * (gv[n][2 + e] * cs[u] - dl_r[u][1]);
        }
      }
      unsigned da[KC / 16][4];
      to_a(da, sc);  // ds rounded to bf16
      tile_pb<DN>(dq[u], da, Kt, QS, dlive);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < NS; ++u) {
    if (u >= ns) break;
    bf16* dst = static_cast<bf16*>(dqs.p[s0 + u]) + (size_t)b * T_len * ld_dqk + h * d;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      if (n >= dlive) continue;
      const int c = n * 8 + 2 * tq;
      if (row0 < T_len)
        store2<VEC>(dst + (size_t)row0 * ld_dqk + c, c, d, dq[u][n][0] * scale, dq[u][n][1] * scale);
      if (row1 < T_len)
        store2<VEC>(dst + (size_t)row1 * ld_dqk + c, c, d, dq[u][n][2] * scale, dq[u][n][3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward E, dk: one block per (b, h, 64-key tile, stream); it walks the
// q tiles at or past its keys. The tile's keys are the rows of every
// product (dS^T = P^T o (V g^T c - delta), dk += dS^T Q)
// ---------------------------------------------------------------------------

template <int DN, bool VEC>
__global__ void __launch_bounds__(MT)
tm_bwd_dk_mma(InPtrs qs, InPtrs ks, const bf16* __restrict__ v,
              const bf16* __restrict__ gr, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ coeffs,
              OutPtrs dks, int S, int T_len, int H, int d, int dv, int ld_qk,
              int ld_v, int ld_dqk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [TILE][QS]
  bf16* Vs = Ks + TILE * QS;                     // [TILE][VS]
  bf16* Qb = Vs + TILE * VS;                     // [2][KC][QS]
  bf16* Gb = Qb + 2 * KC * QS;                   // [2][KC][VS]
  float* Lb = reinterpret_cast<float*>(Gb + 2 * KC * VS);  // [2][KC] lse
  float* Db = Lb + 2 * KC;                                 // [2][KC] delta
  zero_smem(smem_raw, sizeof(bf16) * ((size_t)TILE + 2 * KC) * (QS + VS));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nt = (T_len + TILE - 1) / TILE;
  const int BH = gridDim.x / (nt * S);
  const int bh = blockIdx.x % BH, rest = blockIdx.x / BH;
  const int s = rest % S, kt = rest / S;  // the first key tiles see the most rows
  const int h = bh % H, b = bh / H;
  const int k0 = kt * TILE, nsteps = (T_len - k0 + KC - 1) / KC;
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;
  const int dlive = DP / 8;
  const bf16* q = static_cast<const bf16*>(qs.p[s]);
  const float cs = coeffs[s * H + h];

  auto stage = [&](int i) {
    const int t0 = k0 + i * KC;
    load_tile<VEC>(Qb + (i & 1) * KC * QS, QS, q, ld_qk, b, T_len, t0, KC, h * d, d);
    load_tile<VEC>(Gb + (i & 1) * KC * VS, VS, gr, H * dv, b, T_len, t0, KC, h * dv, dv);
    for (int r = threadIdx.x; r < KC; r += MT) {
      const size_t at = ((size_t)b * T_len + min(t0 + r, T_len - 1)) * H * S + h * S + s;
      Lb[(i & 1) * KC + r] = lse[at];
      Db[(i & 1) * KC + r] = delta[at];
    }
  };
  __syncthreads();
  load_tile<VEC>(Ks, QS, static_cast<const bf16*>(ks.p[s]), ld_qk, b, T_len, k0, TILE, h * d, d);
  load_tile<VEC>(Vs, VS, v, ld_v, b, T_len, k0, TILE, h * dv, dv);
  stage(0);
  cp_commit();

  float dk[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) {
      stage(i + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int qb = k0 + i * KC;
    const bool diag = qb < k0 + TILE - 1;  // queries before some key of the block
    const bf16* Qt = Qb + (i & 1) * KC * QS;
    const float* L = Lb + (i & 1) * KC;
    const float* D = Db + (i & 1) * KC;
    float gvt[SKT][4], st[SKT][4];
    tile_abt(gvt, Vs, VS, Gb + (i & 1) * KC * VS, VS, VP);
    tile_abt(st, Ks, QS, Qt, QS, DP);
#pragma unroll
    for (int n = 0; n < SKT; ++n) {
      const int cl = n * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qrow = qb + cl + e;
        const bool live = qrow < T_len;
        const float lq = L[cl + e], dl = D[cl + e];
        const float p0 = (live && (!diag || key0 <= qrow)) ? expf(st[n][e] * scale - lq) : 0.f;
        const float p1 = (live && (!diag || key1 <= qrow)) ? expf(st[n][2 + e] * scale - lq) : 0.f;
        st[n][e] = p0 * (gvt[n][e] * cs - dl);
        st[n][2 + e] = p1 * (gvt[n][2 + e] * cs - dl);
      }
    }
    unsigned da[KC / 16][4];
    to_a(da, st);  // dS^T rounded to bf16
    tile_pb<DN>(dk, da, Qt, QS, dlive);
    __syncthreads();
  }

  bf16* dst = static_cast<bf16*>(dks.p[s]) + (size_t)b * T_len * ld_dqk + h * d;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    if (n >= dlive) continue;
    const int c = n * 8 + 2 * tq;
    if (key0 < T_len)
      store2<VEC>(dst + (size_t)key0 * ld_dqk + c, c, d, dk[n][0] * scale, dk[n][1] * scale);
    if (key1 < T_len)
      store2<VEC>(dst + (size_t)key1 * ld_dqk + c, c, d, dk[n][2] * scale, dk[n][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward E, dv: one block per (b, h, 64-key tile); per q tile it
// recomputes every stream's P^T (dv needs sum_s c_s P_s, rounded once)
// ---------------------------------------------------------------------------

template <int VN, bool VEC>
__global__ void __launch_bounds__(MT, 2)  // up to 255 registers: VN 16 spilled at 168
tm_bwd_dv_mma(InPtrs qs, InPtrs ks, const bf16* __restrict__ gr,
              const float* __restrict__ lse, const float* __restrict__ coeffs,
              bf16* __restrict__ dvo, int S, int T_len, int H, int d, int dv,
              int ld_qk, int ld_dv, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;
  const int step_elems = S * KC * QS + KC * VS;  // Q_s tiles, then g
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [S][TILE][QS]
  bf16* Bb = Ks + S * TILE * QS;                 // [2][step]
  float* Lb = reinterpret_cast<float*>(Bb + 2 * step_elems);  // [2][S][KC]
  zero_smem(smem_raw, sizeof(bf16) * ((size_t)S * TILE * QS + 2 * (size_t)step_elems));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nt = (T_len + TILE - 1) / TILE;
  const int BH = gridDim.x / nt;
  const int kt = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int h = bh % H, b = bh / H;
  const int k0 = kt * TILE, nsteps = (T_len - k0 + KC - 1) / KC;
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;
  const int vlive = VP / 8;

  auto stage = [&](int i) {
    const int t0 = k0 + i * KC, bi = i & 1;
    bf16* base = Bb + bi * step_elems;
    for (int s = 0; s < S; ++s)
      load_tile<VEC>(base + s * KC * QS, QS, static_cast<const bf16*>(qs.p[s]), ld_qk,
                     b, T_len, t0, KC, h * d, d);
    load_tile<VEC>(base + S * KC * QS, VS, gr, H * dv, b, T_len, t0, KC, h * dv, dv);
    for (int r = threadIdx.x; r < S * KC; r += MT) {
      const int s = r / KC, t = min(t0 + r - s * KC, T_len - 1);
      Lb[bi * S * KC + r] = lse[((size_t)b * T_len + t) * H * S + h * S + s];
    }
  };
  __syncthreads();
  for (int s = 0; s < S; ++s)
    load_tile<VEC>(Ks + s * TILE * QS, QS, static_cast<const bf16*>(ks.p[s]), ld_qk, b,
                   T_len, k0, TILE, h * d, d);
  stage(0);
  cp_commit();

  float dva[VN][4];
#pragma unroll
  for (int n = 0; n < VN; ++n) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) {
      stage(i + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int bi = i & 1;
    const bf16* base = Bb + bi * step_elems;
    const int qb = k0 + i * KC;
    const bool diag = qb < k0 + TILE - 1;
    float pc[SKT][4];
#pragma unroll
    for (int n = 0; n < SKT; ++n) pc[n][0] = pc[n][1] = pc[n][2] = pc[n][3] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float cs = coeffs[s * H + h];
      const float* L = Lb + (bi * S + s) * KC;
      float st[SKT][4];
      tile_abt(st, Ks + s * TILE * QS, QS, base + s * KC * QS, QS, DP);
#pragma unroll
      for (int n = 0; n < SKT; ++n) {
        const int cl = n * 8 + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qrow = qb + cl + e;
          const bool live = qrow < T_len;
          const float lq = L[cl + e];
          const float p0 = (live && (!diag || key0 <= qrow)) ? expf(st[n][e] * scale - lq) : 0.f;
          const float p1 = (live && (!diag || key1 <= qrow)) ? expf(st[n][2 + e] * scale - lq) : 0.f;
          pc[n][e] += p0 * cs;
          pc[n][2 + e] += p1 * cs;
        }
      }
    }
    unsigned pa[KC / 16][4];
    to_a(pa, pc);  // sum_s c_s P_s^T rounded to bf16
    tile_pb<VN>(dva, pa, base + S * KC * QS, VS, vlive);
    __syncthreads();
  }

  bf16* dst = dvo + (size_t)b * T_len * ld_dv + h * dv;
#pragma unroll
  for (int n = 0; n < VN; ++n) {
    if (n >= vlive) continue;
    const int c = n * 8 + 2 * tq;
    if (key0 < T_len) store2<VEC>(dst + (size_t)key0 * ld_dv + c, c, dv, dva[n][0], dva[n][1]);
    if (key1 < T_len) store2<VEC>(dst + (size_t)key1 * ld_dv + c, c, dv, dva[n][2], dva[n][3]);
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


// --- bf16 launchers --------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the 16-byte copy instance needs every row and head window 16-byte
// aligned: base pointers, row strides and head widths in multiples of 8
// bf16 (the recipe's are); other shapes take the 2-byte-load instance
bool vec_loads(const void* const* ptrs, int n_ptrs, const int* lds, int n_lds,
               int d, int dv) {
  if (d % 8 != 0 || dv % 8 != 0) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (ptrs[i] != nullptr && !aligned16(ptrs[i])) return false;
  for (int i = 0; i < n_lds; ++i)
    if (lds[i] % 8 != 0) return false;
  return true;
}

int pad16(int x) { return (x + 15) & ~15; }
// fragment columns (8 each) of an accumulator, by bucket: one instance
// per bucket, the columns past the head's width skipped at run time
int v_bucket(int dv) {
  const int n = pad16(dv) / 8;
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 24 ? 24 : 32;
}
int d_bucket(int d) {
  const int n = pad16(d) / 8;
  return n <= 8 ? 8 : n <= 12 ? 12 : 16;
}

size_t fwd_mma_smem(int S, int d, int dv, int vn) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  return 2 * ((size_t)TILE * QS + 2 * (size_t)KC * (QS + VS)) +
         (S > 1 ? (size_t)2048 * vn : 0);
}
size_t dq_mma_smem(int ns, int d, int dv) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  return 2 * ((size_t)TILE * (ns * QS + VS) + 2 * (size_t)KC * (ns * QS + VS));
}
size_t dk_mma_smem(int d, int dv) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  return 2 * ((size_t)TILE + 2 * KC) * (QS + VS) + 4 * 4 * (size_t)KC;
}
size_t dv_mma_smem(int S, int d, int dv) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  const size_t step = (size_t)S * KC * QS + (size_t)KC * VS;
  return 2 * ((size_t)S * TILE * QS + 2 * step) + 4 * 2 * (size_t)S * KC;
}

template <int VN, bool VEC>
int fwd_mma_run(const InPtrs& q, const InPtrs& k, const void* v, const float* coeffs,
                void* out, void* o_all, float* lse, int S, int B, int T_len, int H,
                int d, int dv, int ld_qk, int ld_v, float scale, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem(S, d, dv, VN);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<tm_fwd_mma<VN, VEC>>(smem);
  if (rc != 0) return rc;
  const dim3 grid(B * H * ((T_len + TILE - 1) / TILE));
  tm_fwd_mma<VN, VEC><<<grid, MT, smem, stream>>>(
      q, k, static_cast<const bf16*>(v), coeffs, static_cast<bf16*>(out),
      static_cast<bf16*>(o_all), lse, S, T_len, H, d, dv, ld_qk, ld_v, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int fwd_mma_vn(const InPtrs& q, const InPtrs& k, const void* v, const float* c,
               void* out, void* o_all, float* lse, int S, int B, int T_len, int H,
               int d, int dv, int ld_qk, int ld_v, float scale, cudaStream_t st) {
  switch (v_bucket(dv)) {
    case 8: return fwd_mma_run<8, VEC>(q, k, v, c, out, o_all, lse, S, B, T_len, H, d, dv, ld_qk, ld_v, scale, st);
    case 16: return fwd_mma_run<16, VEC>(q, k, v, c, out, o_all, lse, S, B, T_len, H, d, dv, ld_qk, ld_v, scale, st);
    case 24: return fwd_mma_run<24, VEC>(q, k, v, c, out, o_all, lse, S, B, T_len, H, d, dv, ld_qk, ld_v, scale, st);
    default: return fwd_mma_run<32, VEC>(q, k, v, c, out, o_all, lse, S, B, T_len, H, d, dv, ld_qk, ld_v, scale, st);
  }
}

int fwd_mma(const void* const* qs, const void* const* ks, const void* v,
            const float* coeffs, void* out, void* o_all, float* lse, int S, int B,
            int T_len, int H, int d, int dv, int ld_qk, int ld_v, float scale,
            cudaStream_t stream) {
  InPtrs q{}, k{};
  const void* ptrs[2 * MAX_S + 3];
  int n = 0;
  for (int s = 0; s < S; ++s) {
    q.p[s] = ptrs[n++] = qs[s];
    k.p[s] = ptrs[n++] = ks[s];
  }
  ptrs[n++] = v;
  ptrs[n++] = out;
  ptrs[n++] = o_all;
  const int lds[2] = {ld_qk, ld_v};
  if (vec_loads(ptrs, n, lds, 2, d, dv))
    return fwd_mma_vn<true>(q, k, v, coeffs, out, o_all, lse, S, B, T_len, H, d, dv, ld_qk, ld_v, scale, stream);
  return fwd_mma_vn<false>(q, k, v, coeffs, out, o_all, lse, S, B, T_len, H, d, dv, ld_qk, ld_v, scale, stream);
}

struct BwdArgs {
  InPtrs q, k;
  OutPtrs dq, dk;
  const bf16 *v, *g;
  const float *lse, *delta, *coeffs;
  bf16* dvo;
  int S, B, T_len, H, d, dv, ld_qk, ld_v, ld_dqk, ld_dv;
  float scale;
};

template <int NS, int DN, bool VEC>
int bwd_dq_run(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dq_mma_smem(NS, a.d, a.dv);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<tm_bwd_dq_mma<NS, DN, VEC>>(smem);
  if (rc != 0) return rc;
  const int nqt = (a.T_len + TILE - 1) / TILE, ngrp = (a.S + NS - 1) / NS;
  tm_bwd_dq_mma<NS, DN, VEC><<<a.B * a.H * nqt * ngrp, MT, smem, stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.coeffs, a.dq, a.S, a.T_len, a.H, a.d,
      a.dv, a.ld_qk, a.ld_v, a.ld_dqk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DN, bool VEC>
int bwd_dk_run(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dk_mma_smem(a.d, a.dv);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<tm_bwd_dk_mma<DN, VEC>>(smem);
  if (rc != 0) return rc;
  const int nt = (a.T_len + TILE - 1) / TILE;
  tm_bwd_dk_mma<DN, VEC><<<a.B * a.H * nt * a.S, MT, smem, stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.coeffs, a.dk, a.S, a.T_len, a.H, a.d,
      a.dv, a.ld_qk, a.ld_v, a.ld_dqk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int VN, bool VEC>
int bwd_dv_run(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dv_mma_smem(a.S, a.d, a.dv);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<tm_bwd_dv_mma<VN, VEC>>(smem);
  if (rc != 0) return rc;
  const int nt = (a.T_len + TILE - 1) / TILE;
  tm_bwd_dv_mma<VN, VEC><<<a.B * a.H * nt, MT, smem, stream>>>(
      a.q, a.k, a.g, a.lse, a.coeffs, a.dvo, a.S, a.T_len, a.H, a.d, a.dv, a.ld_qk,
      a.ld_dv, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int bwd_mma_vec(const BwdArgs& a, cudaStream_t st) {
  const int db = d_bucket(a.d);
  int rc;
  // dq: two streams per block where their dq fits the registers
  if (a.S >= 2 && db == 8) rc = bwd_dq_run<2, 8, VEC>(a, st);
  else if (a.S >= 2 && db == 12) rc = bwd_dq_run<2, 12, VEC>(a, st);
  else if (db == 8) rc = bwd_dq_run<1, 8, VEC>(a, st);
  else if (db == 12) rc = bwd_dq_run<1, 12, VEC>(a, st);
  else rc = bwd_dq_run<1, 16, VEC>(a, st);
  if (rc != 0) return rc;
  switch (db) {
    case 8: rc = bwd_dk_run<8, VEC>(a, st); break;
    case 12: rc = bwd_dk_run<12, VEC>(a, st); break;
    default: rc = bwd_dk_run<16, VEC>(a, st); break;
  }
  if (rc != 0) return rc;
  switch (v_bucket(a.dv)) {
    case 8: return bwd_dv_run<8, VEC>(a, st);
    case 16: return bwd_dv_run<16, VEC>(a, st);
    case 24: return bwd_dv_run<24, VEC>(a, st);
    default: return bwd_dv_run<32, VEC>(a, st);
  }
}

int bwd_mma(const void* const* qs, const void* const* ks, const void* v,
            const void* g, const float* lse, const float* delta,
            const float* coeffs, void* const* dqs, void* const* dks, void* dvo,
            int S, int B, int T_len, int H, int d, int dv, int ld_qk, int ld_v,
            int ld_dqk, int ld_dv, float scale, cudaStream_t stream) {
  BwdArgs a{};
  const void* ptrs[4 * MAX_S + 3];
  int n = 0;
  for (int s = 0; s < S; ++s) {
    a.q.p[s] = ptrs[n++] = qs[s];
    a.k.p[s] = ptrs[n++] = ks[s];
    a.dq.p[s] = dqs[s];
    a.dk.p[s] = dks[s];
    ptrs[n++] = dqs[s];
    ptrs[n++] = dks[s];
  }
  ptrs[n++] = v;
  ptrs[n++] = g;
  ptrs[n++] = dvo;
  a.v = static_cast<const bf16*>(v);
  a.g = static_cast<const bf16*>(g);
  a.lse = lse;
  a.delta = delta;
  a.coeffs = coeffs;
  a.dvo = static_cast<bf16*>(dvo);
  a.S = S; a.B = B; a.T_len = T_len; a.H = H; a.d = d; a.dv = dv;
  a.ld_qk = ld_qk; a.ld_v = ld_v; a.ld_dqk = ld_dqk; a.ld_dv = ld_dv;
  a.scale = scale;
  const int lds[5] = {ld_qk, ld_v, ld_dqk, ld_dv, H * dv};
  return vec_loads(ptrs, n, lds, 5, d, dv) ? bwd_mma_vec<true>(a, stream)
                                           : bwd_mma_vec<false>(a, stream);
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
    case 1: return fwd_mma(qs, ks, v, c, out, o_all, l, S, B, T_len, H, d, dv, ld_qk, ld_v, scale, st);
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
    case 1: return bwd_mma(qs, ks, v, g, l, dl, c, dqs, dks, dv_out, S, B, T_len, H, d, dv, ld_qk, ld_v, ld_dqk, ld_dv, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
