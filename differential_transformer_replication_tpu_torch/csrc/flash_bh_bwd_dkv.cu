// Kernel K3 of the head-major multi-stream causal flash attention for
// Hopper (sm_90a) in bf16, the backward's dk and dv, on tensor cores (K1:
// flash_bh_fwd.cu; K2, dq: flash_bh_bwd_dq.cu; the fp32 instances of
// K2/K3 and K4: flash_bh.cu, which also sets out the layouts):
//
//   dk_s = scale * sum_q round(p_sq (dP~_sq - delta_sq)) Q_s[q]
//   dv   = sum_q round(sum_s c_s P~_sq) g[q]    (factored)
//   dv   = sum_s sum_q round(P~_sq) g_s[q]      (RING: per-stream g)
//
// Replaces the TPU kernel bodies _bwd_dkv_kernel (_bwd_call, route split)
// and _tiled_dkv_kernel (_tiled_bwd_call, route tiled) of
// differential_transformer_replication_tpu/ops/flash.py, in the factored
// form (off = 0) and the ring chunk's per-stream form (any offset: key c
// is visible to row r iff c <= r + off). Numerics are the twin's
// (ops/flash.py:bh_attention_bwd_reference) and JAX's: p = exp(s * scale
// - lse) masked before the exp; dP~ and P~ take the same keep bit (the JAX
// counter hash at (b*H + h, stream, row, key - off)) and 1 / (1 - rate);
// ds rounded to bf16 before its product with Q; the factored dv rounds the
// stream-combined map sum_s c_s P~_s once, the ring's each P~_s on its own;
// fp32 accumulation; no atomics (two launches are bit-equal).
//
// Design. Every product is taken with the tile's keys as rows, so p^T
// and ds^T come out of mma.sync as C fragments that are the A fragments
// of the dk and dv products as they stand: S^T = K Q^T, dP^T = V g^T, dk
// += ds^T Q, dv += P~^T g, with lse and delta indexing columns. A block
// owns 64 keys (16 a warp) and walks the 32-row q tiles from the first
// whose rows see its keys, double-buffered by 16-byte cp.async with one
// barrier a tile. Registers decide the shape: a warp's dv accumulator (16
// x dv fp32: 96 a thread at dv 192) and a stream's dk (16 x d: 48 at d
// 96) do not fit one warp together with the operands, except one
// stream's. So, for widths in multiples of 8 and dv <= 192 (every recipe
// and ring shape but ndiff's S 4), one launch:
//   S = 1: bh_bwd_dk_mma with VN: its warps hold dk and dv and add their
//     own P~^T g (but d > 96 with dv > 128, which spilled, as S = 2);
//   S = 2: bh_bwd_dkv_mma, S + 1 warp groups of four warps; group u < S
//     computes stream u's p, keep bits, ds^T and dk, and hands its P~
//     tile (times c_u) through shared memory to group S, which holds dv
//     and adds the tiles one q tile behind.
// Each element's exp and keep bit are then computed once. Else two
// launches, as kernel E does (flash_tm.cu): bh_bwd_dk_mma, one block per
// (bh, key tile, group of NS streams), K and V rows held in shared
// memory, per q tile V g^T once (factored; per stream on the ring) and
// per stream K Q^T, ds^T and dk += ds^T Q; and bh_bwd_dv_mma, one block
// per (bh, key tile), per (q tile, stream) step K_s Q_s^T and P~ again,
// the factored form summing c_s P~_s in fp32 registers over the streams
// (rounded once at the last), the ring adding each stream's P~_s^T g_s;
// it holds every stream's K tile in shared memory where two blocks an SM
// still fit, else stages K_s with each step.
// The mask is applied only on steps that reach past some key's first
// visible row (or past T); a block whose keys no row sees (on the ring,
// keys past every row's last visible key) does no products and writes
// zeros with 16-byte stores. Instances: d padded to 64/96/128 (DN 8, 12,
// 16) x dv padded to 64/128/192 (VN 8, 16, 24) x RING for the one-launch
// kernels (bh_bwd_dkv_mma's 384 threads leave 168 registers a thread: VN
// 32 spilled); DN x NS x RING x VEC for dk alone and dv padded to 64..256
// (VN 8..32) x RING x VEC for dv.
//
// What bounds it on the H100: the tensor cores at the diff shapes (~500
// operations per byte at T 2048). What holds these mma.sync kernels back
// is instruction issue: per element the exp and the dropout hash (~40
// instructions against one sixteenth of a mma), which the one-launch
// kernel computes once where the two launches compute it twice.

#include "flash_bh_common.cuh"
#include "flash_bh_mma.cuh"

namespace {

// the first q row that sees key k0 (row >= k0 - off), down to the q-tile
// grid from 0
__device__ __forceinline__ int q_start(int k0, int off) {
  const int lo = k0 - off;
  return lo <= 0 ? 0 : (lo / KC) * KC;
}

// ---------------------------------------------------------------------------
// dk: one block per (bh, 64-key tile, group of NS streams)
// ---------------------------------------------------------------------------

// VN > 0 (one stream, S = 1): the same warps also hold dv (VN fragments)
// and add their own P~^T g, so dk and dv take one launch
template <int NS, int DN, bool RING, bool VEC, int VN = 0>
__global__ void __launch_bounds__(MT)
bh_bwd_dk_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ coeffs,
              bf16* __restrict__ dk, bf16* __restrict__ dvo, int S, int T_len, int H, int d,
              int dv, int off, float scale, Drop dr) {
  constexpr bool DV = VN > 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NG = RING ? NS : 1;  // g tiles: one per stream on the ring
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [NS][TILE][QS]
  bf16* Vs = Ks + NS * TILE * QS;                // [TILE][VS]
  bf16* Qb = Vs + TILE * VS;                     // [2][NS][KC][QS]
  bf16* Gb = Qb + 2 * NS * KC * QS;              // [2][NG][KC][VS]
  float* Lb = reinterpret_cast<float*>(Gb + 2 * NG * KC * VS);  // [2][NS][KC] lse
  float* Db = Lb + 2 * NS * KC;                                 // [2][NS][KC] delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int nkt = (T_len + TILE - 1) / TILE, ngrp = (S + NS - 1) / NS;
  const int BH = gridDim.x / (nkt * ngrp);
  const int bh = blockIdx.x % BH, rest = blockIdx.x / BH;
  const int grp = rest % ngrp, kt = rest / ngrp;  // the first key tiles see the most rows
  const int h = bh % H;
  const int s0 = grp * NS, ns = min(NS, S - s0);
  const int k0 = kt * TILE;
  const int offv = RING ? off : 0;
  const int qs0 = RING ? q_start(k0, off) : k0;
  const int nsteps = qs0 < T_len ? (T_len - qs0 + KC - 1) / KC : 0;
  const size_t slab = (size_t)T_len * d, gslab = (size_t)T_len * dv;

  if (nsteps == 0) {  // no row sees a key of the block: dk = 0 (and dv)
    const int rows = min(TILE, T_len - k0);
    for (int u = 0; u < ns; ++u)
      zero_rows<VEC>(dk + ((size_t)bh * S + s0 + u) * slab + (size_t)k0 * d, (size_t)rows * d);
    if (DV) zero_rows<VEC>(dvo + (size_t)bh * gslab + (size_t)k0 * dv, (size_t)rows * dv);
    return;
  }

  zero_smem(smem_raw, sizeof(bf16) * ((size_t)TILE * (NS * QS + VS) +
                                      2 * (size_t)KC * (NS * QS + NG * VS)));
  const int key0 = k0 + 16 * warp + gr, key1 = key0 + 8;
  const int dlive = DP / 8;
  auto stage = [&](int i) {
    const int t0 = qs0 + i * KC, bi = i & 1;
    for (int u = 0; u < ns; ++u)
      load_rows<VEC>(Qb + (bi * NS + u) * KC * QS, QS, q + ((size_t)bh * S + s0 + u) * slab,
                     T_len, t0, KC, d);
    for (int u = 0; u < (RING ? ns : 1); ++u)
      load_rows<VEC>(Gb + (bi * NG + u) * KC * VS, VS,
                     RING ? g + ((size_t)bh * S + s0 + u) * gslab : g + (size_t)bh * gslab,
                     T_len, t0, KC, dv);
    for (int r = threadIdx.x; r < ns * KC; r += MT) {
      const int u = r / KC, c = r - u * KC;
      const size_t at = ((size_t)bh * S + s0 + u) * T_len + min(t0 + c, T_len - 1);
      Lb[bi * NS * KC + r] = lse[at];
      Db[bi * NS * KC + r] = delta[at];
    }
  };
  __syncthreads();  // the zeroed padding before any copy lands
  for (int u = 0; u < ns; ++u)
    load_rows<VEC>(Ks + u * TILE * QS, QS, k + ((size_t)bh * S + s0 + u) * slab, T_len, k0,
                   TILE, d);
  load_rows<VEC>(Vs, VS, v + (size_t)bh * gslab, T_len, k0, TILE, dv);
  stage(0);
  cp_commit();

  float cs[NS];
  uint32_t skey[NS];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    const int su = min(s0 + u, S - 1);
    cs[u] = RING ? 1.f : coeffs[su * H + h];
    skey[u] = dr.on ? stream_key(dr, bh, su) : 0u;
  }
  // the dropout hash's column factors (column key - off)
  const uint32_t kf0 = (uint32_t)(key0 - offv) * 0xC2B2AE3Du;
  const uint32_t kf1 = (uint32_t)(key1 - offv) * 0xC2B2AE3Du;
  float acc[NS][DN][4];
#pragma unroll
  for (int u = 0; u < NS; ++u)
#pragma unroll
    for (int n = 0; n < DN; ++n) acc[u][n][0] = acc[u][n][1] = acc[u][n][2] = acc[u][n][3] = 0.f;
  float dva[DV ? VN : 1][4];
#pragma unroll
  for (int n = 0; n < (DV ? VN : 1); ++n) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  const int vlive = VP / 8;

  for (int i = 0; i < nsteps; ++i) {
    cp_wait<0>();
    __syncthreads();
    if (i + 1 < nsteps) {
      stage(i + 1);
      cp_commit();
    }
    const int qb = qs0 + i * KC, bi = i & 1;
    // mask where some key of the block is not seen by every row of the
    // step (key <= row + off), or the step or (ring) the block runs past T
    const bool diag = k0 + TILE - 1 > qb + offv || qb + KC > T_len ||
                      (RING && k0 + TILE > T_len);
    float gv[SKT][4];
    if (!RING) tile_abt(gv, Vs + 16 * warp * VS, VS, Gb + bi * KC * VS, VS, VP);  // V g^T, shared
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      if (u >= ns) break;
      const bf16* Qt = Qb + (bi * NS + u) * KC * QS;
      const float* L = Lb + (bi * NS + u) * KC;
      const float* D = Db + (bi * NS + u) * KC;
      if (RING) tile_abt(gv, Vs + 16 * warp * VS, VS, Gb + (bi * NG + u) * KC * VS, VS, VP);  // V g_s^T
      float st[SKT][4], pv[SKT][4];
      tile_abt(st, Ks + (u * TILE + 16 * warp) * QS, QS, Qt, QS, DP);
#pragma unroll
      for (int n = 0; n < SKT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = n * 8 + 2 * tq + e, qrow = qb + cl;
          const bool in = qrow < T_len;
          const bool v0 = !diag || (in && key0 <= qrow + offv && (!RING || key0 < T_len));
          const bool v1 = !diag || (in && key1 <= qrow + offv && (!RING || key1 < T_len));
          const float lq = L[cl], dl = D[cl];
          const float p0 = v0 ? expf(st[n][e] * scale - lq) : 0.f;
          const float p1 = v1 ? expf(st[n][2 + e] * scale - lq) : 0.f;
          float dp0 = cs[u] * gv[n][e], dp1 = cs[u] * gv[n][2 + e];
          float pv0 = p0, pv1 = p1;
          if (dr.on) {  // the keep mask at (row, key - off), then 1 / (1 - rate)
            const uint32_t rf = (uint32_t)qrow * 0x85EBCA77u;
            const bool kp0 = keep_x(dr, skey[u], rf ^ kf0), kp1 = keep_x(dr, skey[u], rf ^ kf1);
            dp0 = kp0 ? dp0 * dr.inv_keep : 0.f;
            dp1 = kp1 ? dp1 * dr.inv_keep : 0.f;
            pv0 = kp0 ? p0 * dr.inv_keep : 0.f;
            pv1 = kp1 ? p1 * dr.inv_keep : 0.f;
          }
          st[n][e] = p0 * (dp0 - dl);
          st[n][2 + e] = p1 * (dp1 - dl);
          if (DV) {  // c_0 P~ (the factored form's map; the ring's P~)
            pv[n][e] = RING ? pv0 : pv0 * cs[u];
            pv[n][2 + e] = RING ? pv1 : pv1 * cs[u];
          }
        }
      }
      if constexpr (DV) {  // dv += P~^T g, P~ rounded
        unsigned pa[KC / 16][4];
        to_a(pa, pv);
        tile_pb<VN>(dva, pa, Gb + bi * NG * KC * VS, VS, vlive);
      }
      unsigned da[KC / 16][4];
      to_a(da, st);  // ds^T rounded to bf16
      tile_pb<DN>(acc[u], da, Qt, QS, dlive);
    }
  }

#pragma unroll
  for (int u = 0; u < NS; ++u) {
    if (u >= ns) break;
    bf16* dst = dk + ((size_t)bh * S + s0 + u) * slab;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      if (n >= dlive) continue;
      const int c = n * 8 + 2 * tq;
      if (key0 < T_len)
        store2<VEC>(dst + (size_t)key0 * d + c, c, d, acc[u][n][0] * scale, acc[u][n][1] * scale);
      if (key1 < T_len)
        store2<VEC>(dst + (size_t)key1 * d + c, c, d, acc[u][n][2] * scale, acc[u][n][3] * scale);
    }
  }
  if constexpr (DV) {
    bf16* dst = dvo + (size_t)bh * gslab;
#pragma unroll
    for (int n = 0; n < VN; ++n) {
      if (n >= vlive) continue;
      const int c = n * 8 + 2 * tq;
      if (key0 < T_len) store2<VEC>(dst + (size_t)key0 * dv + c, c, dv, dva[n][0], dva[n][1]);
      if (key1 < T_len) store2<VEC>(dst + (size_t)key1 * dv + c, c, dv, dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dv: one block per (bh, 64-key tile); steps (q tile i, stream s)
// ---------------------------------------------------------------------------

template <int VN, bool RING, bool VEC>
__global__ void __launch_bounds__(MT, 2)
bh_bwd_dv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ coeffs, bf16* __restrict__ dvo, int S, int T_len,
              int H, int d, int dv, int off, int hold, float scale, Drop dr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;
  const int nkb = hold ? S : 2;                  // K tiles: every stream's, or two buffers
  bf16* Kh = reinterpret_cast<bf16*>(smem_raw);  // [nkb][TILE][QS]
  bf16* Qb = Kh + nkb * TILE * QS;               // [2][KC][QS]
  bf16* Gb = Qb + 2 * KC * QS;                   // [2][KC][VS]
  float* Lb = reinterpret_cast<float*>(Gb + 2 * KC * VS);  // [2][KC] lse

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int nkt = (T_len + TILE - 1) / TILE;
  const int BH = gridDim.x / nkt;
  const int bh = blockIdx.x % BH, kt = blockIdx.x / BH;
  const int h = bh % H;
  const int k0 = kt * TILE;
  const int offv = RING ? off : 0;
  const int qs0 = RING ? q_start(k0, off) : k0;
  const int nq = qs0 < T_len ? (T_len - qs0 + KC - 1) / KC : 0;
  const int nsteps = nq * S;
  const size_t slab = (size_t)T_len * d, gslab = (size_t)T_len * dv;

  if (nsteps == 0) {  // no row sees a key of the block: dv = 0
    zero_rows<VEC>(dvo + (size_t)bh * gslab + (size_t)k0 * dv,
                   (size_t)min(TILE, T_len - k0) * dv);
    return;
  }

  zero_smem(smem_raw, sizeof(bf16) * ((size_t)nkb * TILE * QS + 2 * (size_t)KC * (QS + VS)));
  const int key0 = k0 + 16 * warp + gr, key1 = key0 + 8;
  const int vlive = VP / 8;
  // step t: q tile t / S, stream t % S; the factored form stages g with a
  // q tile's first stream (buffer by q tile), the ring g_s with every step
  auto stage = [&](int t) {
    const int i = t / S, s = t - i * S, bi = t & 1, t0 = qs0 + i * KC;
    const size_t ss = (size_t)bh * S + s;
    if (!hold)
      load_rows<VEC>(Kh + bi * TILE * QS, QS, k + ss * slab, T_len, k0, TILE, d);
    load_rows<VEC>(Qb + bi * KC * QS, QS, q + ss * slab, T_len, t0, KC, d);
    if (RING || s == 0)
      load_rows<VEC>(Gb + ((RING ? t : i) & 1) * KC * VS, VS,
                     RING ? g + ss * gslab : g + (size_t)bh * gslab, T_len, t0, KC, dv);
    for (int r = threadIdx.x; r < KC; r += MT)
      Lb[bi * KC + r] = lse[ss * T_len + min(t0 + r, T_len - 1)];
  };
  __syncthreads();  // the zeroed padding before any copy lands
  if (hold)
    for (int s = 0; s < S; ++s)
      load_rows<VEC>(Kh + s * TILE * QS, QS, k + ((size_t)bh * S + s) * slab, T_len, k0, TILE,
                     d);
  stage(0);
  cp_commit();

  const uint32_t kf0 = (uint32_t)(key0 - offv) * 0xC2B2AE3Du;
  const uint32_t kf1 = (uint32_t)(key1 - offv) * 0xC2B2AE3Du;
  float acc[VN][4];
#pragma unroll
  for (int n = 0; n < VN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float pc[SKT][4];  // the factored form's sum_s c_s P~_s^T of the q tile
#pragma unroll
  for (int n = 0; n < SKT; ++n) pc[n][0] = pc[n][1] = pc[n][2] = pc[n][3] = 0.f;

  for (int t = 0; t < nsteps; ++t) {
    cp_wait<0>();
    __syncthreads();
    if (t + 1 < nsteps) {
      stage(t + 1);
      cp_commit();
    }
    const int i = t / S, s = t - i * S, bi = t & 1;
    const int qb = qs0 + i * KC;
    const bool diag = k0 + TILE - 1 > qb + offv || qb + KC > T_len ||
                      (RING && k0 + TILE > T_len);
    const float cs = RING ? 1.f : coeffs[s * H + h];
    const uint32_t skey = dr.on ? stream_key(dr, bh, s) : 0u;
    const float* L = Lb + bi * KC;
    float st[SKT][4];
    tile_abt(st, Kh + ((hold ? s : bi) * TILE + 16 * warp) * QS, QS, Qb + bi * KC * QS, QS, DP);
#pragma unroll
    for (int n = 0; n < SKT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = n * 8 + 2 * tq + e, qrow = qb + cl;
        const bool in = qrow < T_len;
        const bool v0 = !diag || (in && key0 <= qrow + offv && (!RING || key0 < T_len));
        const bool v1 = !diag || (in && key1 <= qrow + offv && (!RING || key1 < T_len));
        const float lq = L[cl];
        float p0 = v0 ? expf(st[n][e] * scale - lq) : 0.f;
        float p1 = v1 ? expf(st[n][2 + e] * scale - lq) : 0.f;
        if (dr.on) {
          const uint32_t rf = (uint32_t)qrow * 0x85EBCA77u;
          p0 = keep_x(dr, skey, rf ^ kf0) ? p0 * dr.inv_keep : 0.f;
          p1 = keep_x(dr, skey, rf ^ kf1) ? p1 * dr.inv_keep : 0.f;
        }
        if (RING) {
          st[n][e] = p0;
          st[n][2 + e] = p1;
        } else {  // pc = c_0 P~_0 at s = 0, then + c_s P~_s (the twin's order)
          pc[n][e] = s == 0 ? p0 * cs : pc[n][e] + p0 * cs;
          pc[n][2 + e] = s == 0 ? p1 * cs : pc[n][2 + e] + p1 * cs;
        }
      }
    }
    unsigned pa[KC / 16][4];
    if (RING) {  // dv += P~_s^T g_s, P~_s rounded on its own
      to_a(pa, st);
      tile_pb<VN>(acc, pa, Gb + bi * KC * VS, VS, vlive);
    } else if (s == S - 1) {  // dv += (sum_s c_s P~_s, rounded once)^T g
      to_a(pa, pc);
      tile_pb<VN>(acc, pa, Gb + (i & 1) * KC * VS, VS, vlive);
    }
  }

  bf16* dst = dvo + (size_t)bh * gslab;
#pragma unroll
  for (int n = 0; n < VN; ++n) {
    if (n >= vlive) continue;
    const int c = n * 8 + 2 * tq;
    if (key0 < T_len) store2<VEC>(dst + (size_t)key0 * dv + c, c, dv, acc[n][0], acc[n][1]);
    if (key1 < T_len) store2<VEC>(dst + (size_t)key1 * dv + c, c, dv, acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// dk and dv in one launch (S <= 2 streams, 16-byte loads): one block per
// (bh, 64-key tile) of S + 1 warp groups of four warps (warp w of a group
// owns keys 16w..). Group u < S computes stream u: per q tile V g^T (g_u on
// the ring), K_u Q_u^T, p, the keep bit, ds^T and dk_u += ds^T Q_u, and
// hands its P~ tile (times c_u in the factored form) to group S through
// shared memory in its own fragment order (16 floats a lane); group S
// stages every tile and adds, one q tile behind, the handed tiles into
// dv: the factored form sums c_u P~_u over the streams in fp32 (the twin's
// order) and rounds once, the ring rounds each P~_u and adds P~_u^T g_u.
// Each element's exp and keep bit are computed once. The groups run loops
// of their own with the same named barrier once a q tile; g tiles are
// triple-buffered (group S reads tile i - 1's while tile i + 1's lands).
// ---------------------------------------------------------------------------

template <int DN, int VN, bool RING>
__global__ void __launch_bounds__(3 * MT)
bh_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ coeffs, bf16* __restrict__ dk,
               bf16* __restrict__ dvo, int S, int T_len, int H, int d, int dv, int off,
               float scale, Drop dr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NG = RING ? S : 1;  // g tiles a step: one per stream on the ring
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [S][TILE][QS]
  bf16* Vs = Ks + S * TILE * QS;                 // [TILE][VS]
  bf16* Qb = Vs + TILE * VS;                     // [2][S][KC][QS]
  bf16* Gb = Qb + 2 * S * KC * QS;               // [3][NG][KC][VS]
  float* Hb = reinterpret_cast<float*>(Gb + 3 * NG * KC * VS);  // [2][S][4][16][32]
  float* Lb = Hb + 2 * S * 4 * 16 * 32;                         // [2][S][KC] lse
  float* Db = Lb + 2 * S * KC;                                  // [2][S][KC] delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp >> 2, w = warp & 3, tid = threadIdx.x & (MT - 1);
  const int gr = lane >> 2, tq = lane & 3;
  const int nthreads = (S + 1) * MT;
  const int nkt = (T_len + TILE - 1) / TILE;
  const int BH = gridDim.x / nkt;
  const int bh = blockIdx.x % BH, kt = blockIdx.x / BH;  // the first key tiles see the most rows
  const int h = bh % H;
  const int k0 = kt * TILE;
  const int offv = RING ? off : 0;
  const int qs0 = RING ? q_start(k0, off) : k0;
  const int nsteps = qs0 < T_len ? (T_len - qs0 + KC - 1) / KC : 0;
  const size_t slab = (size_t)T_len * d, gslab = (size_t)T_len * dv;
  const int key0 = k0 + 16 * w + gr, key1 = key0 + 8;

  if (nsteps == 0) {  // no row sees a key of the block: dk = dv = 0
    const size_t rows = min(TILE, T_len - k0);
    if (grp < S)
      zero_rows_by<true>(tid, dk + ((size_t)bh * S + grp) * slab + (size_t)k0 * d, rows * d);
    else
      zero_rows_by<true>(tid, dvo + (size_t)bh * gslab + (size_t)k0 * dv, rows * dv);
    return;
  }

  if (grp == S)
    zero_smem_by(tid, smem_raw, sizeof(bf16) * ((size_t)TILE * (S * QS + VS) +
                                                2 * (size_t)KC * S * QS +
                                                3 * (size_t)KC * NG * VS));
  auto stage = [&](int i) {  // group S: q tile i's Q, g, lse and delta
    const int t0 = qs0 + i * KC, bi = i & 1, gi = i % 3;
    for (int u = 0; u < S; ++u)
      load_rows_by<true>(tid, Qb + (bi * S + u) * KC * QS, QS,
                         q + ((size_t)bh * S + u) * slab, T_len, t0, KC, d);
    for (int u = 0; u < NG; ++u)
      load_rows_by<true>(tid, Gb + (gi * NG + u) * KC * VS, VS,
                         RING ? g + ((size_t)bh * S + u) * gslab : g + (size_t)bh * gslab,
                         T_len, t0, KC, dv);
    for (int r = tid; r < S * KC; r += MT) {
      const int u = r / KC, c = r - u * KC;
      const bool ok = t0 + c < T_len;
      const size_t at = ((size_t)bh * S + u) * T_len + (ok ? t0 + c : 0);
      cp_async4(Lb + bi * S * KC + r, lse + at, ok);
      cp_async4(Db + bi * S * KC + r, delta + at, ok);
    }
  };
  __syncthreads();  // the zeroed padding before any copy lands
  if (grp == S) {
    for (int u = 0; u < S; ++u)
      load_rows_by<true>(tid, Ks + u * TILE * QS, QS, k + ((size_t)bh * S + u) * slab, T_len,
                         k0, TILE, d);
    load_rows_by<true>(tid, Vs, VS, v + (size_t)bh * gslab, T_len, k0, TILE, dv);
    stage(0);
    cp_commit();
  }
  // the P~ tile group u's warp w hands over at step i: 16 floats a lane,
  // [j][lane] (j = 4 n + c of fragment n, element c)
  auto hand = [&](int i, int u) { return Hb + ((((i & 1) * S + u) * 4 + w) * 16) * 32 + lane; };

  if (grp == S) {  // dv, one q tile behind
    const int vlive = VP / 8;
    float acc[VN][4];
#pragma unroll
    for (int n = 0; n < VN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int i = 0; i <= nsteps; ++i) {
      cp_wait<0>();
      bar_sync(nthreads);
      if (i + 1 < nsteps) {
        stage(i + 1);
        cp_commit();
      }
      if (i == 0) continue;
      const int gj = (i - 1) % 3;
      // the handed fragments straight into bf16 A fragments: element j =
      // 4 n + c of C fragment n is, in to_a's order, half (j & 1) of
      // pa[j / 8][(j % 8) / 2]
      const float* h0 = hand(i - 1, 0);
      unsigned pa[KC / 16][4];
      if (RING) {  // dv += P~_u^T g_u, P~_u rounded on its own
        for (int u = 0; u < S; ++u) {
          const float* hr = h0 + u * 4 * 16 * 32;
#pragma unroll
          for (int j = 0; j < 16; j += 2)
            pa[j / 8][(j % 8) / 2] = pack_bf16(hr[j * 32], hr[(j + 1) * 32]);
          tile_pb<VN>(acc, pa, Gb + (gj * NG + u) * KC * VS, VS, vlive);
        }
      } else {  // dv += (c_0 P~_0 + c_1 P~_1, rounded once)^T g
        if (S > 1) {
          const float* h1 = h0 + 4 * 16 * 32;
#pragma unroll
          for (int j = 0; j < 16; j += 2)
            pa[j / 8][(j % 8) / 2] =
                pack_bf16(h0[j * 32] + h1[j * 32], h0[(j + 1) * 32] + h1[(j + 1) * 32]);
        } else {
#pragma unroll
          for (int j = 0; j < 16; j += 2)
            pa[j / 8][(j % 8) / 2] = pack_bf16(h0[j * 32], h0[(j + 1) * 32]);
        }
        tile_pb<VN>(acc, pa, Gb + gj * NG * KC * VS, VS, vlive);
      }
    }
    bf16* dst = dvo + (size_t)bh * gslab;
#pragma unroll
    for (int n = 0; n < VN; ++n) {
      if (n >= vlive) continue;
      const int c = n * 8 + 2 * tq;
      if (key0 < T_len) store2<true>(dst + (size_t)key0 * dv + c, c, dv, acc[n][0], acc[n][1]);
      if (key1 < T_len) store2<true>(dst + (size_t)key1 * dv + c, c, dv, acc[n][2], acc[n][3]);
    }
    return;
  }

  // group u = grp: stream u's dk
  const int u = grp, dlive = DP / 8;
  const float cs = RING ? 1.f : coeffs[u * H + h];
  const uint32_t skey = dr.on ? stream_key(dr, bh, u) : 0u;
  // the dropout hash's column factors (column key - off)
  const uint32_t kf0 = (uint32_t)(key0 - offv) * 0xC2B2AE3Du;
  const uint32_t kf1 = (uint32_t)(key1 - offv) * 0xC2B2AE3Du;
  const bf16* Kw = Ks + (u * TILE + 16 * w) * QS;
  const bf16* Vw = Vs + 16 * w * VS;
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int i = 0; i <= nsteps; ++i) {
    bar_sync(nthreads);
    if (i == nsteps) break;
    const int qb = qs0 + i * KC, bi = i & 1;
    // mask where some key of the block is not seen by every row of the
    // step (key <= row + off), or the step or (ring) the block runs past T
    const bool diag = k0 + TILE - 1 > qb + offv || qb + KC > T_len ||
                      (RING && k0 + TILE > T_len);
    const bf16* Qt = Qb + (bi * S + u) * KC * QS;
    const float* L = Lb + (bi * S + u) * KC;
    const float* D = Db + (bi * S + u) * KC;
    float gv[SKT][4], st[SKT][4];
    tile_abt(gv, Vw, VS, Gb + ((i % 3) * NG + (RING ? u : 0)) * KC * VS, VS, VP);
    tile_abt(st, Kw, QS, Qt, QS, DP);
    float* hw = hand(i, u);
#pragma unroll
    for (int n = 0; n < SKT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = n * 8 + 2 * tq + e, qrow = qb + cl;
        const bool in = qrow < T_len;
        const bool v0 = !diag || (in && key0 <= qrow + offv && (!RING || key0 < T_len));
        const bool v1 = !diag || (in && key1 <= qrow + offv && (!RING || key1 < T_len));
        const float lq = L[cl], dl = D[cl];
        const float p0 = v0 ? expf(st[n][e] * scale - lq) : 0.f;
        const float p1 = v1 ? expf(st[n][2 + e] * scale - lq) : 0.f;
        float dp0 = cs * gv[n][e], dp1 = cs * gv[n][2 + e];
        float pv0 = p0, pv1 = p1;
        if (dr.on) {  // the keep mask at (row, key - off), then 1 / (1 - rate)
          const uint32_t rf = (uint32_t)qrow * 0x85EBCA77u;
          const bool kp0 = keep_x(dr, skey, rf ^ kf0), kp1 = keep_x(dr, skey, rf ^ kf1);
          dp0 = kp0 ? dp0 * dr.inv_keep : 0.f;
          dp1 = kp1 ? dp1 * dr.inv_keep : 0.f;
          pv0 = kp0 ? p0 * dr.inv_keep : 0.f;
          pv1 = kp1 ? p1 * dr.inv_keep : 0.f;
        }
        st[n][e] = p0 * (dp0 - dl);
        st[n][2 + e] = p1 * (dp1 - dl);
        hw[(n * 4 + e) * 32] = RING ? pv0 : pv0 * cs;
        hw[(n * 4 + 2 + e) * 32] = RING ? pv1 : pv1 * cs;
      }
    }
    unsigned da[KC / 16][4];
    to_a(da, st);  // ds^T rounded to bf16
    tile_pb<DN>(acc, da, Qt, QS, dlive);
  }
  bf16* dst = dk + ((size_t)bh * S + u) * slab;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    if (n >= dlive) continue;
    const int c = n * 8 + 2 * tq;
    if (key0 < T_len)
      store2<true>(dst + (size_t)key0 * d + c, c, d, acc[n][0] * scale, acc[n][1] * scale);
    if (key1 < T_len)
      store2<true>(dst + (size_t)key1 * d + c, c, d, acc[n][2] * scale, acc[n][3] * scale);
  }
}

// --- launchers ---------------------------------------------------------------

size_t dk_mma_smem(int ns, int ng, int d, int dv) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  return 2 * ((size_t)TILE * (ns * QS + VS) + 2 * (size_t)KC * (ns * QS + ng * VS)) +
         4 * 4 * (size_t)ns * KC;
}
size_t dv_mma_smem(int nkb, int d, int dv) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  return 2 * ((size_t)nkb * TILE * QS + 2 * (size_t)KC * (QS + VS)) + 4 * 2 * (size_t)KC;
}

size_t dkv_fused_smem(int S, bool ring, int d, int dv) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8, NG = ring ? S : 1;
  return 2 * ((size_t)TILE * (S * QS + VS) + 2 * (size_t)KC * S * QS +
              3 * (size_t)KC * NG * VS) +
         4 * (2 * (size_t)S * 4 * 16 * 32 + 4 * (size_t)S * KC);
}

struct BwdArgs {
  const bf16 *q, *k, *v, *g;
  const float *lse, *delta, *coeffs;
  bf16 *dk, *dvo;
  int S, BH, T_len, H, d, dv, off;
  float scale;
  Drop dr;
};

template <int NS, int DN, bool RING, bool VEC, int VN = 0>
int dk_run(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dk_mma_smem(NS, RING ? NS : 1, a.d, a.dv);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<bh_bwd_dk_mma<NS, DN, RING, VEC, VN>>(smem);
  if (rc != 0) return rc;
  const int nkt = (a.T_len + TILE - 1) / TILE, ngrp = (a.S + NS - 1) / NS;
  bh_bwd_dk_mma<NS, DN, RING, VEC, VN><<<a.BH * nkt * ngrp, MT, smem, stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.coeffs, a.dk, a.dvo, a.S, a.T_len, a.H, a.d, a.dv,
      a.off, a.scale, a.dr);
  return static_cast<int>(cudaGetLastError());
}

// one stream: dk and dv in the dk kernel's warps, where both fit 255
// registers (VN 24 with DN 16 spilled: dk_dv_fits)
bool dk_dv_fits(int d, int dv) { return v_bucket(dv) <= (d_bucket(d) == 16 ? 16 : 24); }

template <int DN, bool RING>
int dk_dv_run(const BwdArgs& a, cudaStream_t st) {
  switch (v_bucket(a.dv)) {
    case 8: return dk_run<1, DN, RING, true, 8>(a, st);
    case 16: return dk_run<1, DN, RING, true, 16>(a, st);
    default:
      if constexpr (DN < 16) return dk_run<1, DN, RING, true, 24>(a, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool RING>
int dk_dv(const BwdArgs& a, cudaStream_t st) {
  switch (d_bucket(a.d)) {
    case 8: return dk_dv_run<8, RING>(a, st);
    case 12: return dk_dv_run<12, RING>(a, st);
    default: return dk_dv_run<16, RING>(a, st);
  }
}

template <int VN, bool RING, bool VEC>
int dv_run(const BwdArgs& a, cudaStream_t stream) {
  // every stream's K tile held where two blocks an SM still fit
  size_t smem = dv_mma_smem(a.S, a.d, a.dv);
  const int hold = smem <= SMEM_LIMIT / 2;
  if (!hold) smem = dv_mma_smem(2, a.d, a.dv);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<bh_bwd_dv_mma<VN, RING, VEC>>(smem);
  if (rc != 0) return rc;
  const int nkt = (a.T_len + TILE - 1) / TILE;
  bh_bwd_dv_mma<VN, RING, VEC><<<a.BH * nkt, MT, smem, stream>>>(
      a.q, a.k, a.g, a.lse, a.coeffs, a.dvo, a.S, a.T_len, a.H, a.d, a.dv, a.off, hold,
      a.scale, a.dr);
  return static_cast<int>(cudaGetLastError());
}

template <int DN, int VN, bool RING>
int dkv_fused_run(const BwdArgs& a, cudaStream_t stream) {
  const size_t smem = dkv_fused_smem(a.S, RING, a.d, a.dv);
  const int rc = allow_smem<bh_bwd_dkv_mma<DN, VN, RING>>(smem);
  if (rc != 0) return rc;
  const int nkt = (a.T_len + TILE - 1) / TILE;
  bh_bwd_dkv_mma<DN, VN, RING><<<a.BH * nkt, (a.S + 1) * MT, smem, stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.coeffs, a.dk, a.dvo, a.S, a.T_len, a.H, a.d, a.dv,
      a.off, a.scale, a.dr);
  return static_cast<int>(cudaGetLastError());
}

template <int DN, bool RING>
int dkv_fused_v(const BwdArgs& a, cudaStream_t st) {
  switch (v_bucket(a.dv)) {
    case 8: return dkv_fused_run<DN, 8, RING>(a, st);
    case 16: return dkv_fused_run<DN, 16, RING>(a, st);
    default: return dkv_fused_run<DN, 24, RING>(a, st);
  }
}

template <bool RING>
int dkv_fused(const BwdArgs& a, cudaStream_t st) {
  switch (d_bucket(a.d)) {
    case 8: return dkv_fused_v<8, RING>(a, st);
    case 12: return dkv_fused_v<12, RING>(a, st);
    default: return dkv_fused_v<16, RING>(a, st);
  }
}

// dk: two streams a block where their dk fits the registers (the factored
// form, d <= 96: V g^T shared); dv: one instance per dv bucket
template <bool RING, bool VEC>
int dk_alone(const BwdArgs& a, cudaStream_t st) {
  const int db = d_bucket(a.d);
  if constexpr (!RING) {
    if (a.S >= 2 && db == 8) return dk_run<2, 8, RING, VEC>(a, st);
    if (a.S >= 2 && db == 12) return dk_run<2, 12, RING, VEC>(a, st);
  }
  switch (db) {
    case 8: return dk_run<1, 8, RING, VEC>(a, st);
    case 12: return dk_run<1, 12, RING, VEC>(a, st);
    default: return dk_run<1, 16, RING, VEC>(a, st);
  }
}

template <bool RING, bool VEC>
int dkv_mma_w(const BwdArgs& a, cudaStream_t st) {
  const int rc = dk_alone<RING, VEC>(a, st);
  if (rc != 0) return rc;
  switch (v_bucket(a.dv)) {
    case 8: return dv_run<8, RING, VEC>(a, st);
    case 16: return dv_run<16, RING, VEC>(a, st);
    case 24: return dv_run<24, RING, VEC>(a, st);
    default: return dv_run<32, RING, VEC>(a, st);
  }
}

// the 16-byte copy instances take head widths in multiples of 8 (the
// wrapper hands over 16-byte aligned operands); other widths take the
// 2-byte-load instances
int dkv_mma(const BwdArgs& a, bool ring, cudaStream_t st) {
  const bool vec = a.d % 8 == 0 && a.dv % 8 == 0;
  // one launch: one stream in the dk kernel's warps where they fit; else
  // up to two streams in warp groups (168 registers a thread: dv <= 192)
  // where the shared memory fits
  if (vec && a.S == 1 && dk_dv_fits(a.d, a.dv))
    return ring ? dk_dv<true>(a, st) : dk_dv<false>(a, st);
  if (vec && a.S <= 2 && v_bucket(a.dv) <= 24 &&
      dkv_fused_smem(a.S, ring, a.d, a.dv) <= SMEM_LIMIT)
    return ring ? dkv_fused<true>(a, st) : dkv_fused<false>(a, st);
  if (ring) return vec ? dkv_mma_w<true, true>(a, st) : dkv_mma_w<true, false>(a, st);
  return vec ? dkv_mma_w<false, true>(a, st) : dkv_mma_w<false, false>(a, st);
}

}  // namespace

// The bf16 half of the C entry point flash_bh_bwd_dkv (the fp32 half is
// flash_bh.cu's, same signature; ops/flash.py loads the library by
// dtype): two device launches, dk then dv. dtype must be 1 (bfloat16);
// the other arguments as flash_bh_bwd_dq's (flash_bh_bwd_dq.cu).
extern "C" int flash_bh_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                const void* lse, const void* delta, const void* coeffs,
                                void* dk, void* dv_out, int S, int BH, int T_len, int H, int d,
                                int dv, int off, float scale, unsigned w0, unsigned w1,
                                unsigned threshold, float inv_keep, int dropout_on, int dtype,
                                void* stream) {
  if (!shapes_ok(S, BH, T_len, H, d, dv) || dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ring = coeffs == nullptr;  // per-stream cotangents, offset off
  if (!ring && off != 0) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                  static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<const float*>(coeffs), static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv_out), S, BH, T_len, H, d, dv, off, scale,
                  make_drop(w0, w1, threshold, inv_keep, dropout_on)};
  return dkv_mma(a, ring, static_cast<cudaStream_t>(stream));
}
