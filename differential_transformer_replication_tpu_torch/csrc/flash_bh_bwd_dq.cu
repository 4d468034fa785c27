// Kernel K2 of the head-major multi-stream causal flash attention for
// Hopper (sm_90a) in bf16, the backward's dq, on tensor cores (K1, the
// forward: flash_bh_fwd.cu; K3, dk and dv: flash_bh_bwd_dkv.cu; the fp32
// instances of K2/K3 and K4: flash_bh.cu, which also sets out the
// layouts):
//
//   dq_s = scale * sum_k round(p_sk (dP~_sk - delta_s)) K_s[k]
//
// Replaces the TPU kernel bodies _bwd_dq_kernel (_bwd_call, route split)
// and _tiled_dq_kernel (_tiled_bwd_call, route tiled) of
// differential_transformer_replication_tpu/ops/flash.py, in both forms:
// the factored one (one cotangent g (BH, T, dv), dP_s = c_s g V^T, off =
// 0) and the ring chunk's per-stream one (RING: g (BH, S, T, dv), dP_s =
// g_s V^T, coefficients unread, column c visible to row r iff c <= r +
// off for any integer off). The route picks no kernel: every T streams its
// key tiles through shared memory.
//
// Numerics (the plain twin ops/flash.py:bh_attention_bwd_reference, and
// the JAX kernels): p = exp(s * scale - lse), masked before the exp (a row
// with no visible key has lse = -1e30); dP~ = keep ? dP / (1 - rate) : 0
// with the JAX counter hash at (b*H + h, stream, row, column - off); ds =
// p (dP~ - delta) rounded to bf16 before the product with K; fp32
// accumulation, rounded once at the end; no atomics, so two launches are
// bit-equal.
//
// Design. A block is 4 warps and 64 q rows (16 a warp) of NS streams
// (two where their dq fits the registers, d <= 96, factored form; else
// one), longest rows first. The streams' Q rows and the g rows stay in
// shared memory, read by ldmatrix as A fragments; per 32-key tile, K (of
// the NS streams) and V are double-buffered by 16-byte cp.async with one
// barrier a tile. Per tile: g V^T once (factored; per stream on the ring),
// then per stream S = Q K^T by mma.sync.m16n8k16 into registers, p, the
// keep bit per fragment element (row and column factors hoisted), ds in C
// fragments turned into A fragments (to_a: rounded where the twin rounds)
// and dq += ds K with K read transposed by ldmatrix. dq stays in fp32
// registers (16 x d a warp per stream). The mask is applied only on tiles
// that reach past some row's last visible key (or past T on the ring); a
// block whose rows see no key (a ring chunk in their future) does no
// products and writes zeros with 16-byte stores. Head widths are padded to
// 16 in shared memory (rows +16 bytes: ldmatrix rows hit all bank
// groups). Instances: d padded to 64/96/128 (DN 8, 12, 16 fragments) x NS
// x RING x VEC (16-byte copies; widths not a multiple of 8 take 2-byte
// loads); dv is a run-time depth.
//
// What bounds it on the H100: at the diff shapes (S 2, d 96, dv 192) the
// products (g V^T, Q K^T, ds K) need ~500 operations per byte moved at T
// 2048, above the ~295 ridge: the tensor cores. What holds a mma.sync
// kernel back is instruction issue (the exp, the dropout hash, ldmatrix
// per warp); wgmma is the later step (PERF.md).

#include "flash_bh_common.cuh"
#include "flash_bh_mma.cuh"

namespace {

template <int NS, int DN, bool RING, bool VEC>
__global__ void __launch_bounds__(MT)
bh_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ coeffs,
              bf16* __restrict__ dq, int S, int T_len, int H, int d, int dv, int off,
              float scale, Drop dr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NG = RING ? NS : 1;  // g tiles: one per stream on the ring
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;  // +16 bytes: ldmatrix rows hit 8 bank groups
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [NS][TILE][QS]
  bf16* Gs = Qs + NS * TILE * QS;                // [NG][TILE][VS]
  bf16* Kb = Gs + NG * TILE * VS;                // [2][NS][KC][QS]
  bf16* Vb = Kb + 2 * NS * KC * QS;              // [2][KC][VS]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int nqt = (T_len + TILE - 1) / TILE, ngrp = (S + NS - 1) / NS;
  const int BH = gridDim.x / (nqt * ngrp);
  const int bh = blockIdx.x % BH, rest = blockIdx.x / BH;
  const int grp = rest % ngrp, qt = nqt - 1 - rest / ngrp;  // the longest rows first
  const int h = bh % H;
  const int s0 = grp * NS, ns = min(NS, S - s0);
  const int q0 = qt * TILE;
  const int offv = RING ? off : 0;
  // key tiles from kend on lie in the future of every row of the tile
  const int kend = RING ? max(0, min(T_len, q0 + TILE + off)) : min(T_len, q0 + TILE);
  const int nk = (kend + KC - 1) / KC;
  const size_t slab = (size_t)T_len * d, gslab = (size_t)T_len * dv;

  if (nk == 0) {  // no row of the block sees a key: dq = 0
    const int rows = min(TILE, T_len - q0);
    for (int u = 0; u < ns; ++u)
      zero_rows<VEC>(dq + ((size_t)bh * S + s0 + u) * slab + (size_t)q0 * d, (size_t)rows * d);
    return;
  }

  zero_smem(smem_raw, sizeof(bf16) * ((size_t)TILE * (NS * QS + NG * VS) +
                                      2 * (size_t)KC * (NS * QS + VS)));
  const int row0 = q0 + 16 * warp + gr, row1 = row0 + 8;
  const int dlive = DP / 8;
  const bf16* vb = v + (size_t)bh * T_len * dv;
  auto stage = [&](int j) {
    for (int u = 0; u < ns; ++u)
      load_rows<VEC>(Kb + ((j & 1) * NS + u) * KC * QS, QS, k + ((size_t)bh * S + s0 + u) * slab,
                     T_len, j * KC, KC, d);
    load_rows<VEC>(Vb + (j & 1) * KC * VS, VS, vb, T_len, j * KC, KC, dv);
  };
  __syncthreads();  // the zeroed padding before any copy lands
  for (int u = 0; u < ns; ++u)
    load_rows<VEC>(Qs + u * TILE * QS, QS, q + ((size_t)bh * S + s0 + u) * slab, T_len, q0,
                   TILE, d);
  for (int u = 0; u < (RING ? ns : 1); ++u)
    load_rows<VEC>(Gs + u * TILE * VS, VS,
                   RING ? g + ((size_t)bh * S + s0 + u) * gslab : g + (size_t)bh * gslab, T_len,
                   q0, TILE, dv);
  stage(0);
  cp_commit();

  // per stream: lse, delta of the thread's two rows (clamped past T_len:
  // those rows are never written), the coefficient, the dropout key
  float lse_r[NS][2], dl_r[NS][2], cs[NS];
  uint32_t skey[NS];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    const int su = min(s0 + u, S - 1);
    cs[u] = RING ? 1.f : coeffs[su * H + h];
    skey[u] = dr.on ? stream_key(dr, bh, su) : 0u;
    const size_t at = ((size_t)bh * S + su) * T_len;
    lse_r[u][0] = lse[at + min(row0, T_len - 1)];
    lse_r[u][1] = lse[at + min(row1, T_len - 1)];
    dl_r[u][0] = delta[at + min(row0, T_len - 1)];
    dl_r[u][1] = delta[at + min(row1, T_len - 1)];
  }
  // the dropout hash's row factors
  const uint32_t rf0 = (uint32_t)row0 * 0x85EBCA77u, rf1 = (uint32_t)row1 * 0x85EBCA77u;
  float acc[NS][DN][4];
#pragma unroll
  for (int u = 0; u < NS; ++u)
#pragma unroll
    for (int n = 0; n < DN; ++n) acc[u][n][0] = acc[u][n][1] = acc[u][n][2] = acc[u][n][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    // one barrier a tile: past it tile j has landed and every warp is done
    // with tile j - 1, whose buffers then take tile j + 1
    cp_wait<0>();
    __syncthreads();
    if (j + 1 < nk) {
      stage(j + 1);
      cp_commit();
    }
    const int k0 = j * KC;
    // mask where some row of the block does not see the whole tile (key
    // <= row + off; on the ring also key < T_len)
    const bool diag = k0 + KC - 1 > q0 + offv || (RING && k0 + KC > T_len);
    const bf16* Vt = Vb + (j & 1) * KC * VS;
    float gv[SKT][4];
    if (!RING) tile_abt(gv, Gs + 16 * warp * VS, VS, Vt, VS, VP);  // g V^T, shared by the streams
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      if (u >= ns) break;
      const bf16* Kt = Kb + ((j & 1) * NS + u) * KC * QS;
      if (RING) tile_abt(gv, Gs + (u * TILE + 16 * warp) * VS, VS, Vt, VS, VP);  // g_s V^T
      float sc[SKT][4];
      tile_abt(sc, Qs + (u * TILE + 16 * warp) * QS, QS, Kt, QS, DP);
#pragma unroll
      for (int n = 0; n < SKT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + 2 * tq + e;
          const bool in = !RING || key < T_len;
          const bool v0 = !diag || (in && key <= row0 + offv);
          const bool v1 = !diag || (in && key <= row1 + offv);
          const float p0 = v0 ? expf(sc[n][e] * scale - lse_r[u][0]) : 0.f;
          const float p1 = v1 ? expf(sc[n][2 + e] * scale - lse_r[u][1]) : 0.f;
          float dp0 = cs[u] * gv[n][e], dp1 = cs[u] * gv[n][2 + e];
          if (dr.on) {  // the keep mask at (row, key - off), then 1 / (1 - rate)
            const uint32_t cf = (uint32_t)(key - offv) * 0xC2B2AE3Du;
            dp0 = keep_x(dr, skey[u], rf0 ^ cf) ? dp0 * dr.inv_keep : 0.f;
            dp1 = keep_x(dr, skey[u], rf1 ^ cf) ? dp1 * dr.inv_keep : 0.f;
          }
          sc[n][e] = p0 * (dp0 - dl_r[u][0]);
          sc[n][2 + e] = p1 * (dp1 - dl_r[u][1]);
        }
      }
      unsigned da[KC / 16][4];
      to_a(da, sc);  // ds rounded to bf16
      tile_pb<DN>(acc[u], da, Kt, QS, dlive);
    }
  }

#pragma unroll
  for (int u = 0; u < NS; ++u) {
    if (u >= ns) break;
    bf16* dst = dq + ((size_t)bh * S + s0 + u) * slab;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      if (n >= dlive) continue;
      const int c = n * 8 + 2 * tq;
      if (row0 < T_len)
        store2<VEC>(dst + (size_t)row0 * d + c, c, d, acc[u][n][0] * scale, acc[u][n][1] * scale);
      if (row1 < T_len)
        store2<VEC>(dst + (size_t)row1 * d + c, c, d, acc[u][n][2] * scale, acc[u][n][3] * scale);
    }
  }
}

// --- launchers ---------------------------------------------------------------

size_t dq_mma_smem(int ns, int ng, int d, int dv) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  return 2 * ((size_t)TILE * (ns * QS + ng * VS) + 2 * (size_t)KC * (ns * QS + VS));
}

struct BwdArgs {
  const bf16 *q, *k, *v, *g;
  const float *lse, *delta, *coeffs;
  bf16* dq;
  int S, BH, T_len, H, d, dv, off;
  float scale;
  Drop dr;
};

template <int NS, int DN, bool RING, bool VEC>
int dq_run(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dq_mma_smem(NS, RING ? NS : 1, a.d, a.dv);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<bh_bwd_dq_mma<NS, DN, RING, VEC>>(smem);
  if (rc != 0) return rc;
  const int nqt = (a.T_len + TILE - 1) / TILE, ngrp = (a.S + NS - 1) / NS;
  bh_bwd_dq_mma<NS, DN, RING, VEC><<<a.BH * nqt * ngrp, MT, smem, stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.coeffs, a.dq, a.S, a.T_len, a.H, a.d, a.dv, a.off,
      a.scale, a.dr);
  return static_cast<int>(cudaGetLastError());
}

// two streams a block where their dq (2 x 16 x d fp32 a warp) fits the
// registers: the factored form (g V^T shared) at d <= 96
template <bool RING, bool VEC>
int dq_mma_d(const BwdArgs& a, cudaStream_t st) {
  const int db = d_bucket(a.d);
  if constexpr (!RING) {
    if (a.S >= 2 && db == 8) return dq_run<2, 8, RING, VEC>(a, st);
    if (a.S >= 2 && db == 12) return dq_run<2, 12, RING, VEC>(a, st);
  }
  switch (db) {
    case 8: return dq_run<1, 8, RING, VEC>(a, st);
    case 12: return dq_run<1, 12, RING, VEC>(a, st);
    default: return dq_run<1, 16, RING, VEC>(a, st);
  }
}

// the 16-byte copy instance takes head widths in multiples of 8 (the
// wrapper hands over 16-byte aligned operands); other widths take the
// 2-byte-load instance
int dq_mma(const BwdArgs& a, bool ring, cudaStream_t st) {
  const bool vec = a.d % 8 == 0 && a.dv % 8 == 0;
  if (ring) return vec ? dq_mma_d<true, true>(a, st) : dq_mma_d<true, false>(a, st);
  return vec ? dq_mma_d<false, true>(a, st) : dq_mma_d<false, false>(a, st);
}

}  // namespace

// The bf16 half of the C entry point flash_bh_bwd_dq (the fp32 half is
// flash_bh.cu's, same signature; ops/flash.py loads the library by
// dtype). dtype must be 1 (bfloat16). off: the causal offset (column c is
// visible to row r iff c <= r + off). Dropout: the two 24-bit seed words,
// the keep threshold min(round(rate * 2^32), 2^32 - 1), float32(1 / (1 -
// rate)) and on = rate > 0. coeffs == nullptr: per-stream cotangents g
// (BH, S, T, dv). Returns the launch's CUDA error code
// (cudaErrorInvalidValue for shapes or modes the kernels do not take).
extern "C" int flash_bh_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                               const void* lse, const void* delta, const void* coeffs,
                               void* dq, int S, int BH, int T_len, int H, int d, int dv,
                               int off, float scale, unsigned w0, unsigned w1,
                               unsigned threshold, float inv_keep, int dropout_on, int dtype,
                               void* stream) {
  if (!shapes_ok(S, BH, T_len, H, d, dv) || dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ring = coeffs == nullptr;  // per-stream cotangents, offset off
  if (!ring && off != 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<const float*>(coeffs), static_cast<bf16*>(dq), S, BH, T_len, H,
                  d, dv, off, scale, make_drop(w0, w1, threshold, inv_keep, dropout_on)};
  return dq_mma(a, ring, static_cast<cudaStream_t>(stream));
}
