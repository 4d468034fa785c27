// Kernel K1 of the head-major multi-stream causal flash attention for
// Hopper (sm_90a), the forward, with in-kernel attention-probability
// dropout (K2-K4, the backward, and the layouts: flash_bh.cu):
//
//   out = sum_s c[s, h] * dropout(softmax(Q_s K_s^T / sqrt(d) + causal)) V
//
// Replaces the TPU kernel bodies _fwd_kernel (_fwd_call, route resident),
// _tiled_fwd_kernel (_tiled_fwd_call, route tiled, T > 4096) and
// _chunk_fwd_kernel (_chunk_fwd_call, the ring chunk) of
// differential_transformer_replication_tpu/ops/flash.py. Column c is
// visible to row r iff c <= r + off: off = 0 on the aligned path, where
// the streams combine into out; the ring chunk's mode (RING) takes any
// offset and writes only the per-stream (o_all, lse). The route picks no
// kernel here: every T streams its key tiles through shared memory.
//
// Numerics (the plain twin ops/flash.py:bh_attention_fwd_reference, and
// the JAX kernels): online softmax over key tiles of 32 from key 0; the
// normalizer l sums the UNDROPPED p; p, dropped by the JAX counter hash at
// (b*H + h, stream, row, column - off) and scaled by 1/(1-rate), is
// rounded to the storage type before PV; o_s = acc / max(l, 1e-30); the
// streams combine s = 0..S-1 in fp32 and round once; lse = m + log(max(l,
// 1e-30)); a row with no visible key ends with o = 0 and lse = NEG_INF +
// log(1e-30) = -1e30.
//
// bf16, the training path: tensor cores, after kernel D (flash_tm.cu). A
// block is 4 warps and 64 q rows (16 per warp), longest rows first. It
// walks the streams one after another with one stream's O accumulator in
// registers (16 x dv fp32 per warp: 96 per thread at dv 192; S at once
// would not fit) and that stream's Q rows as mma A fragments, loaded once
// by ldmatrix and held across the key tiles. Per 32-key tile: S = Q K^T by
// mma.sync.m16n8k16 into registers; scale and, only on tiles that reach
// past the block's first row, the causal/offset mask; the tile's row max
// by quad shuffles, the rescale alpha, p = exp(s - m) and l += p; the keep
// bit per fragment element (the hash's row and column factors hoisted out
// of the element loop); p rounded to bf16 as the A fragment of PV (the C
// and A fragment layouts line up, so p is rounded where the twin rounds
// it); O rescaled by alpha in registers (skipped where no row of the warp
// moved its max) and O += P V with V read transposed by ldmatrix. K and V
// tiles are double-buffered by 16-byte cp.async, so the next tile's copy
// overlaps this tile's products, with one barrier a tile; V is staged
// once per stream (from L2 after the first). Key tiles past the
// block's last visible key are never visited; a ring chunk wholly in the
// block's future does no products. Each stream writes its o_all and lse,
// and folds into the fp32 combine in shared memory (64 x dv fp32; each
// thread owns its fragments' slots, so it needs no barrier). Head widths
// are zero-padded to 16 in shared memory (rows +16 bytes, so ldmatrix
// rows hit all bank groups). Instances: dv padded to 64/128/192/256 (VN 8..
// 32 O fragments) x d to 64/96/128 (DN 8, 12, 16 Q fragments) x RING x
// VEC (16-byte copies; head widths not a multiple of 8 take 2-byte loads).
// Registers per instance: `ptxas -v`, printed by chip_smoke.py, which
// fails if one spills.
//
// What bounds it on the H100: at the diff shapes (d 96, dv 192, S 2) the
// products need ~500 operations per byte moved at T 2048 (more at longer
// T), above the card's ~295 ridge, so the least time is the tensor
// cores'; the kernel runs over 10x that. What holds it back is
// instruction throughput and latency, not memory: per 32-key tile a
// warp does 72 mma.sync to ~1000 other instructions (softmax, the
// dropout hash's ~20 per element, ldmatrix, copies), two blocks (8
// warps) fit an SM by registers, and a q-tile-major block order beats a
// head-major one (whose tail is unbalanced); wgmma, which reads K and V
// from shared memory once per warpgroup, is the next step (PERF.md).
//
// fp32: the first version's kernel (SIMT FMA products, 32-row tiles, the
// accumulators in shared memory, at most MAX_SC streams a pass), exact
// against the plain twin; the fp32 tests and the card-vs-CPU steps use it.

#include "flash_bh_common.cuh"
#include "flash_bh_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1, fp32: one block per (bh, 32-row q tile); key tiles outer, streams
// inner, so each V tile is staged once for all S streams
// ---------------------------------------------------------------------------

// sc streams per pass; Comb holds the combined output between passes
// (S > sc only)
struct FwdSmem {
  float *Qs, *Ks, *Vs, *Ps, *Sc, *Acc, *Mx, *Lx, *Comb;
  size_t bytes;
  __host__ __device__ FwdSmem(unsigned char* base, int S, int sc, int d, int dv) {
    Carve cv{base};
    Qs = cv.take<float>((size_t)sc * BQ * ld_in<float>(d));
    Ks = cv.take<float>((size_t)BK * ld_in<float>(d));
    Vs = cv.take<float>((size_t)BK * ld_in<float>(dv));
    Ps = cv.take<float>((size_t)BQ * ld_in<float>(BK));
    Sc = cv.take<float>((size_t)BQ * SC_LD);
    Acc = cv.take<float>((size_t)sc * BQ * ld_acc(dv));
    Mx = cv.take<float>((size_t)sc * BQ);
    Lx = cv.take<float>((size_t)sc * BQ);
    Comb = S > sc ? cv.take<float>((size_t)BQ * ld_acc(dv)) : nullptr;
    bytes = cv.off;
  }
};

// RING: the ring chunk's mode, no combine (out and coeffs unread; o_all and
// lse given) under the causal offset off; else the aligned combined forward
// (off = 0), compiled as its own instance
template <bool RING>
__global__ void __launch_bounds__(THREADS)
bh_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ coeffs,
              float* __restrict__ out, float* __restrict__ o_all, float* __restrict__ lse,
              int S, int sc, int T_len, int H, int d, int dv, int off, float scale, Drop dr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem sm(smem, S, sc, d, dv);
  const int ldq = ld_in<float>(d), ldv = ld_in<float>(dv), ldp = ld_in<float>(BK);
  const int lda = ld_acc(dv), dp = round16(d), dvp = round16(dv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nqt = (T_len + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);  // longest rows first
  const int bh = blockIdx.x / nqt, h = bh % H;
  const int q0 = qt * BQ;
  // key tiles past kend lie in the future of every row of the tile
  const int kend = RING ? max(0, min(T_len, q0 + BQ + off)) : min(T_len, q0 + BQ);
  constexpr bool emit = !RING;
  const size_t slab = (size_t)T_len * d;
  const float* qb = q + (size_t)bh * S * slab;
  const float* kb = k + (size_t)bh * S * slab;
  const float* vb = v + (size_t)bh * T_len * dv;

  for (int s0 = 0; s0 < S; s0 += sc) {  // a pass over streams [s0, s0 + sn)
    const int sn = min(sc, S - s0);
    __syncthreads();  // the last pass has read its results out
    for (int s = 0; s < sn; ++s)
      stage<float>(sm.Qs + s * BQ * ldq, ldq, qb + (s0 + s) * slab, T_len, q0, BQ, d);
    for (int i = threadIdx.x; i < sn * BQ * lda; i += THREADS) sm.Acc[i] = 0.f;
    for (int i = threadIdx.x; i < sn * BQ; i += THREADS) {
      sm.Mx[i] = -INFINITY;
      sm.Lx[i] = 0.f;
    }

    for (int k0 = 0; k0 < kend; k0 += BK) {
      __syncthreads();  // the last tile's PV products are done with Vs
      stage<float>(sm.Vs, ldv, vb, T_len, k0, BK, dv);
      for (int s = 0; s < sn; ++s) {
        stage<float>(sm.Ks, ldq, kb + (s0 + s) * slab, T_len, k0, BK, d);
        __syncthreads();
        mm<true, false, false>(sm.Sc, SC_LD, sm.Qs + s * BQ * ldq, ldq, sm.Ks, ldq, BQ, BK, dp);
        __syncthreads();
        const uint32_t skey = dr.on ? stream_key(dr, bh, s0 + s) : 0u;
        float* acc = sm.Acc + s * BQ * lda;
        float* mx = sm.Mx + s * BQ;
        float* lx = sm.Lx + s * BQ;
        // the warp's RPW rows together: their shuffle reductions interleave
        const int r0 = warp * RPW, key = k0 + lane;
        float sv[RPW], mn[RPW], alpha[RPW], p[RPW], ps[RPW];
        bool vis[RPW];
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          vis[j] = RING ? key < T_len && key <= q0 + r0 + j + off : key <= q0 + r0 + j;
          sv[j] = vis[j] ? sm.Sc[(r0 + j) * SC_LD + lane] * scale : -INFINITY;
          mn[j] = sv[j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < RPW; ++j) mn[j] = fmaxf(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], o));
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const float m_old = mx[r0 + j];
          mn[j] = fmaxf(m_old, mn[j]);
          // a ring row that has seen no visible key yet: nothing to rescale
          alpha[j] = RING && mn[j] == -INFINITY ? 1.f : expf(m_old - mn[j]);
          p[j] = vis[j] ? expf(sv[j] - mn[j]) : 0.f;
          ps[j] = p[j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < RPW; ++j) ps[j] += __shfl_xor_sync(0xffffffffu, ps[j], o);
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const int r = r0 + j;
          float pp = p[j];
          if (dr.on)
            pp = keep_bit(dr, skey, q0 + r, RING ? key - off : key) ? p[j] * dr.inv_keep : 0.f;
          sm.Ps[r * ldp + lane] = pp;
          if (alpha[j] != 1.f)  // warp-uniform: the row's max moved
            for (int c = lane; c < dvp; c += 32) acc[r * lda + c] *= alpha[j];
        }
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < RPW; ++j) {
            mx[r0 + j] = mn[j];
            lx[r0 + j] = lx[r0 + j] * alpha[j] + ps[j];
          }
        }
        __syncthreads();
        mm<true, true, true>(acc, lda, sm.Ps, ldp, sm.Vs, ldv, BQ, dvp, BK);
      }
    }
    __syncthreads();

    // the streams combine in order s = 0..S-1 in fp32; a thread keeps the
    // same (row, column) elements in every pass, so Comb needs no barrier
    const bool last = s0 + sn == S;
    for (int j = 0; j < RPW; ++j) {
      const int r = warp * RPW + j, row = q0 + r;
      if (row >= T_len) continue;
      for (int c = lane; c < dv; c += 32) {
        float comb = (!emit || s0 == 0) ? 0.f : sm.Comb[r * lda + c];
        for (int s = 0; s < sn; ++s) {
          const float l_safe = fmaxf(sm.Lx[s * BQ + r], 1e-30f);
          const float o = sm.Acc[(s * BQ + r) * lda + c] / l_safe;
          if (emit) {
            const float co = coeffs[(s0 + s) * H + h] * o;
            comb = s0 + s == 0 ? co : comb + co;
          }
          if (o_all != nullptr)
            o_all[((size_t)(bh * S + s0 + s) * T_len + row) * dv + c] = o;
        }
        if (!emit) continue;
        if (last)
          out[((size_t)bh * T_len + row) * dv + c] = comb;
        else
          sm.Comb[r * lda + c] = comb;
      }
      if (lse != nullptr && lane < sn) {
        const float m = sm.Mx[lane * BQ + r];  // -inf: no visible key
        lse[(size_t)(bh * S + s0 + lane) * T_len + row] =
            (RING && m == -INFINITY ? NEG_INF : m) + logf(fmaxf(sm.Lx[lane * BQ + r], 1e-30f));
      }
    }
  }
}

template <bool RING>
int fwd(const void* q, const void* k, const void* v, const float* coeffs, void* out,
        void* o_all, float* lse, int S, int BH, int T_len, int H, int d, int dv, int off,
        float scale, Drop dr, cudaStream_t stream) {
  size_t smem = 0;
  const int sc = streams_per_pass<FwdSmem>(S, d, dv, &smem);
  if (sc == 0) return static_cast<int>(cudaErrorInvalidValue);
  int rc = allow_smem<bh_fwd_kernel<RING>>(smem);
  if (rc != 0) return rc;
  const int nqt = (T_len + BQ - 1) / BQ;
  bh_fwd_kernel<RING><<<BH * nqt, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      coeffs, static_cast<float*>(out), static_cast<float*>(o_all), lse, S, sc, T_len, H, d, dv,
      off, scale, dr);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulators in registers)
// ===========================================================================

// K1, bf16: one block per (bh, 64-row q tile), longest rows first; the
// streams one after another, each stream's O accumulator in registers
// (16 rows x dv per warp: VN fragments of 8 columns), its Q fragments
// held in registers across the key tiles (DN / 2 depth steps of 16).
// RING: the ring chunk's no-combine mode under the causal offset off
// (out and coeffs unread; o_all and lse given); else the aligned combined
// forward (off = 0), with o_all and lse optional (the eval variant)
template <int VN, int DN, bool RING, bool VEC>
__global__ void __launch_bounds__(MT)
bh_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const float* __restrict__ coeffs, bf16* __restrict__ out, bf16* __restrict__ o_all,
           float* __restrict__ lse, int S, int T_len, int H, int d, int dv, int off,
           float scale, Drop dr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;  // +16 bytes: ldmatrix rows hit 8 bank groups
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TILE][QS]
  bf16* Kb = Qs + TILE * QS;                     // [2][KC][QS]
  bf16* Vb = Kb + 2 * KC * QS;                   // [2][KC][VS]
  float4* comb = reinterpret_cast<float4*>(Vb + 2 * KC * VS);  // [4][VN][32], !RING, S > 1
  zero_smem(smem_raw, sizeof(bf16) * ((size_t)TILE * QS + 2 * (size_t)KC * (QS + VS)));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nqt = (T_len + TILE - 1) / TILE;
  const int BH = gridDim.x / nqt;
  const int qt = nqt - 1 - (int)(blockIdx.x / BH);  // the longest rows first
  const int bh = blockIdx.x % BH, h = bh % H;
  const int q0 = qt * TILE;
  const int offv = RING ? off : 0;
  // key tiles from kend on lie in the future of every row of the tile
  const int kend = RING ? max(0, min(T_len, q0 + TILE + off)) : min(T_len, q0 + TILE);
  const int nk = (kend + KC - 1) / KC;
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const int klive = DP / 16, vlive = VP / 8;
  const size_t slab = (size_t)T_len * d;
  const bf16* vb = v + (size_t)bh * T_len * dv;
  // the dropout hash's row factors
  const uint32_t rf0 = (uint32_t)row0 * 0x85EBCA77u, rf1 = (uint32_t)row1 * 0x85EBCA77u;

  for (int s = 0; s < S; ++s) {
    const bf16* qs = q + ((size_t)bh * S + s) * slab;
    const bf16* ks = k + ((size_t)bh * S + s) * slab;
    auto stage = [&](int j) {
      load_rows<VEC>(Kb + (j & 1) * KC * QS, QS, ks, T_len, j * KC, KC, d);
      load_rows<VEC>(Vb + (j & 1) * KC * VS, VS, vb, T_len, j * KC, KC, dv);
    };
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[VN][4];
#pragma unroll
    for (int n = 0; n < VN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    const uint32_t skey = dr.on ? stream_key(dr, bh, s) : 0u;

    if (nk > 0) {  // a ring chunk wholly in the tile's future does no products
      __syncthreads();  // the zeroed padding, and the previous stream done with Qs
      load_rows<VEC>(Qs, QS, qs, T_len, q0, TILE, d);
      cp_commit();
      stage(0);
      cp_commit();
      cp_wait<1>();
      __syncthreads();
    }
    unsigned qa[DN / 2][4];  // the warp's 16 Q rows as A fragments
    {
      const bf16* a_row = Qs + (16 * warp + (lane & 15)) * QS + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < DN / 2; ++kk)
        if (nk > 0 && kk < klive) ldsm4(qa[kk], a_row + kk * 16);
    }

    for (int j = 0; j < nk; ++j) {
      // one barrier a tile: past it tile j has landed and every warp is
      // done with tile j - 1, whose buffers then take tile j + 1
      cp_wait<0>();
      __syncthreads();
      if (j + 1 < nk) {
        stage(j + 1);
        cp_commit();
      }
      const int k0 = j * KC;
      // S = Q K^T, 16 x KC per warp
      float sc[SKT][4];
#pragma unroll
      for (int n = 0; n < SKT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      {
        const bf16* Kt = Kb + (j & 1) * KC * QS;
        const bf16* b_row = Kt + ((lane & 7) + ((lane >> 4) << 3)) * QS + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < DN / 2; ++kk) {
          if (kk < klive) {
#pragma unroll
            for (int np = 0; np < SKT / 2; ++np) {
              unsigned bb[4];
              ldsm4(bb, b_row + np * 16 * QS + kk * 16);
              mma16816(sc[2 * np], qa[kk], bb[0], bb[1]);
              mma16816(sc[2 * np + 1], qa[kk], bb[2], bb[3]);
            }
          }
        }
      }
      // scale, then mask where some row of the block does not see the
      // whole tile (key <= row + off; on the ring also key < T_len)
      const bool diag = k0 + KC - 1 > q0 + offv || (RING && k0 + KC > T_len);
      float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < SKT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + 2 * tq + e;
          const bool in = !RING || key < T_len;
          sc[n][e] = (!diag || (in && key <= row0 + offv)) ? sc[n][e] * scale : -INFINITY;
          sc[n][2 + e] = (!diag || (in && key <= row1 + offv)) ? sc[n][2 + e] * scale : -INFINITY;
          mt0 = fmaxf(mt0, sc[n][e]);
          mt1 = fmaxf(mt1, sc[n][2 + e]);
        }
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, o2));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, o2));
      }
      // the running max; a row that has seen no visible key yet keeps
      // -inf and exponentiates against 0 (its p are all 0, its O and l 0)
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      const float mb0 = mn0 == -INFINITY ? 0.f : mn0, mb1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = expf(m0 - mb0), al1 = expf(m1 - mb1);
      m0 = mn0;
      m1 = mn1;
      // p = exp(s - m), l from the unrounded, undropped p
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < SKT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] = expf(sc[n][e] - mb0);
          sc[n][2 + e] = expf(sc[n][2 + e] - mb1);
          ps0 += sc[n][e];
          ps1 += sc[n][2 + e];
        }
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      if (dr.on) {  // the keep mask at (row, key - off), then 1 / (1 - rate)
#pragma unroll
        for (int n = 0; n < SKT; ++n) {
          const uint32_t cf = (uint32_t)(k0 + n * 8 + 2 * tq - offv) * 0xC2B2AE3Du;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t ce = cf + (e ? 0xC2B2AE3Du : 0u);
            sc[n][e] = keep_x(dr, skey, rf0 ^ ce) ? sc[n][e] * dr.inv_keep : 0.f;
            sc[n][2 + e] = keep_x(dr, skey, rf1 ^ ce) ? sc[n][2 + e] * dr.inv_keep : 0.f;
          }
        }
      }
      unsigned pa[KC / 16][4];
      to_a(pa, sc);  // p rounded to bf16: the PV operand
      if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {  // some row's max moved
#pragma unroll
        for (int n = 0; n < VN; ++n) {
          o[n][0] *= al0;
          o[n][1] *= al0;
          o[n][2] *= al1;
          o[n][3] *= al1;
        }
      }
      tile_pb<VN>(o, pa, Vb + (j & 1) * KC * VS, VS, vlive);
    }

#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
    }
    const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
    const float cs = RING ? 0.f : coeffs[s * H + h];
    bf16* oa = o_all == nullptr ? nullptr : o_all + ((size_t)bh * S + s) * T_len * dv;
#pragma unroll
    for (int n = 0; n < VN; ++n) {
      if (n >= vlive) continue;
      const int c = n * 8 + 2 * tq;
      const float x[4] = {o[n][0] / ls0, o[n][1] / ls0, o[n][2] / ls1, o[n][3] / ls1};
      if (oa != nullptr) {
        if (row0 < T_len) store2<VEC>(oa + (size_t)row0 * dv + c, c, dv, x[0], x[1]);
        if (row1 < T_len) store2<VEC>(oa + (size_t)row1 * dv + c, c, dv, x[2], x[3]);
      }
      if (RING) continue;
      // the fp32 stream combine, s = 0..S-1: each thread owns its
      // fragments' slots, so it needs no barrier; rounded once
      float4 acc = make_float4(x[0] * cs, x[1] * cs, x[2] * cs, x[3] * cs);
      float4* cb = comb + (warp * VN + n) * 32 + lane;
      if (s > 0) {
        const float4 prev = *cb;
        acc = make_float4(prev.x + acc.x, prev.y + acc.y, prev.z + acc.z, prev.w + acc.w);
      }
      if (s + 1 < S) {
        *cb = acc;
      } else {
        bf16* ob = out + (size_t)bh * T_len * dv + c;
        if (row0 < T_len) store2<VEC>(ob + (size_t)row0 * dv, c, dv, acc.x, acc.y);
        if (row1 < T_len) store2<VEC>(ob + (size_t)row1 * dv, c, dv, acc.z, acc.w);
      }
    }
    if (lse != nullptr && tq == 0) {
      // a row with no visible key: lse = NEG_INF + log(1e-30), as the twin's
      float* lb = lse + ((size_t)bh * S + s) * T_len;
      if (row0 < T_len) lb[row0] = (m0 == -INFINITY ? NEG_INF : m0) + logf(ls0);
      if (row1 < T_len) lb[row1] = (m1 == -INFINITY ? NEG_INF : m1) + logf(ls1);
    }
  }
}

// --- bf16 launchers --------------------------------------------------------

size_t fwd_mma_smem(bool ring, int S, int d, int dv, int vn) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  return 2 * ((size_t)TILE * QS + 2 * (size_t)KC * (QS + VS)) +
         (!ring && S > 1 ? (size_t)2048 * vn : 0);
}

struct FwdArgs {
  const bf16 *q, *k, *v;
  const float* coeffs;
  bf16 *out, *o_all;
  float* lse;
  int S, BH, T_len, H, d, dv, off;
  float scale;
  Drop dr;
};

template <int VN, int DN, bool RING, bool VEC>
int fwd_mma_run(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem(RING, a.S, a.d, a.dv, VN);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<bh_fwd_mma<VN, DN, RING, VEC>>(smem);
  if (rc != 0) return rc;
  const int nqt = (a.T_len + TILE - 1) / TILE;
  bh_fwd_mma<VN, DN, RING, VEC><<<a.BH * nqt, MT, smem, stream>>>(
      a.q, a.k, a.v, a.coeffs, a.out, a.o_all, a.lse, a.S, a.T_len, a.H, a.d, a.dv, a.off,
      a.scale, a.dr);
  return static_cast<int>(cudaGetLastError());
}

template <int VN, bool RING, bool VEC>
int fwd_mma_d(const FwdArgs& a, cudaStream_t st) {
  switch (d_bucket(a.d)) {
    case 8: return fwd_mma_run<VN, 8, RING, VEC>(a, st);
    case 12: return fwd_mma_run<VN, 12, RING, VEC>(a, st);
    default: return fwd_mma_run<VN, 16, RING, VEC>(a, st);
  }
}

template <bool RING, bool VEC>
int fwd_mma_v(const FwdArgs& a, cudaStream_t st) {
  switch (v_bucket(a.dv)) {
    case 8: return fwd_mma_d<8, RING, VEC>(a, st);
    case 16: return fwd_mma_d<16, RING, VEC>(a, st);
    case 24: return fwd_mma_d<24, RING, VEC>(a, st);
    default: return fwd_mma_d<32, RING, VEC>(a, st);
  }
}

// the 16-byte copy instance takes head widths in multiples of 8 (the
// wrapper hands over 16-byte aligned operands); other widths take the
// 2-byte-load instance
int fwd_mma(const FwdArgs& a, bool ring, cudaStream_t st) {
  const bool vec = a.d % 8 == 0 && a.dv % 8 == 0;
  if (ring) return vec ? fwd_mma_v<true, true>(a, st) : fwd_mma_v<true, false>(a, st);
  return vec ? fwd_mma_v<false, true>(a, st) : fwd_mma_v<false, false>(a, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. off: the causal offset (column c is
// visible to row r iff c <= r + off). Dropout: the two 24-bit seed words,
// the keep threshold min(round(rate * 2^32), 2^32 - 1), float32(1 / (1 -
// rate)) and on = rate > 0. Returns the launch's CUDA error code
// (cudaErrorInvalidValue for shapes or modes the kernels do not take).
// out == nullptr (and coeffs == nullptr): the no-combine mode, which needs
// o_all and lse
extern "C" int flash_bh_fwd(const void* q, const void* k, const void* v, const void* coeffs,
                            void* out, void* o_all, void* lse, int S, int BH, int T_len, int H,
                            int d, int dv, int off, float scale, unsigned w0, unsigned w1,
                            unsigned threshold, float inv_keep, int dropout_on, int dtype,
                            void* stream) {
  if (!shapes_ok(S, BH, T_len, H, d, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const bool ring = out == nullptr;
  if (ring ? (o_all == nullptr || lse == nullptr) : (coeffs == nullptr || off != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Drop dr = make_drop(w0, w1, threshold, inv_keep, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coeffs);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: return (ring ? fwd<true> : fwd<false>)(
        q, k, v, c, out, o_all, l, S, BH, T_len, H, d, dv, off, scale, dr, st);
    case 1: {
      const FwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), c, static_cast<bf16*>(out),
                      static_cast<bf16*>(o_all), l, S, BH, T_len, H, d, dv, off, scale, dr};
      return fwd_mma(a, ring, st);
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
