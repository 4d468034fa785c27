// Kernel K4 of the head-major multi-stream causal flash attention for
// Hopper (sm_90a) in bf16, the fused backward (dq, dk and dv from one
// pass over the tile pairs), on tensor cores (K1: flash_bh_fwd.cu; K2:
// flash_bh_bwd_dq.cu; K3: flash_bh_bwd_dkv.cu; the fp32 K4 and its bf16
// instance for S > 2, widths not in multiples of 8 or dv > 192:
// flash_bh.cu, which also sets out the layouts):
//
//   dq_s = scale * sum_k round(p_sk (dP~_sk - delta_s)) K_s[k]
//   dk_s = scale * sum_q round(p_sq (dP~_sq - delta_sq)) Q_s[q]
//   dv   = sum_q round(sum_s c_s P~_sq) g[q]
//
// Replaces the TPU kernel body _bwd_fused_kernel (_fused_bwd_call, route
// fused) of differential_transformer_replication_tpu/ops/flash.py: the
// aligned, factored backward where S * T^2 <= 2 * 512^2. Numerics are the
// twin's (ops/flash.py:bh_attention_bwd_reference) and JAX's: p = exp(s *
// scale - lse) masked before the exp; dP~ and P~ take the same keep bit
// (the JAX counter hash at (b*H + h, stream, row, key)) and 1 / (1 -
// rate); ds rounded to bf16 before its products with Q and K; dv rounds
// the stream-combined map sum_s c_s P~_s once; fp32 accumulation.
//
// Design. K3's one-launch kernels (flash_bh_bwd_dkv.cu) plus a dq leg. A
// block owns 64 keys of one (b, h), 16 a warp, longest key tiles first,
// and walks the 32-row q tiles that see them, double-buffered by 16-byte
// cp.async. Every product of the tile pair is taken with the keys as rows
// (S^T = K Q^T, dP^T = V g^T, dk += ds^T Q, dv += P~^T g), so each visible
// element's exp and keep bit are computed once and dk and dv stay in fp32
// registers. The dq leg: the warps that hold ds^T (bf16 A fragments)
// store it key-major into shared memory; one q tile later the warps of
// the leg read it back transposed (ldmatrix .trans), multiply it by the
// block's resident K_s tile (mma.sync) into a 32 x d partial per stream,
// each warp a quarter, and add that into an fp32 scratch (B*H, S, T_pad,
// d_pad), zeroed by the wrapper, with 16-byte atomic adds (lane pairs
// trade fragment halves, so each adds four adjacent columns). A second
// launch, bh_dq_from_sums, writes dq = scale * sums in bf16. Completing
// dq inside the one launch (an arrival counter per (b*H + h, q tile), the
// block whose increment completes a count converting the tile) was built
// first: on the H100 it ran 670-674 us at the diff shape and 533-534 at
// the control shape (train/attention_bench.py), against 430-432 and 415
// with the second launch. The counter's atomic returns its value, and
// that round trip queues behind the grid's adds, whether taken once a q
// tile inside the loop, where the warps meet at a barrier every tile, or
// once at each block's end, where the SM (one block wide at the diff
// shape) idles.
//   S = 1 where dk and dv fit one warp's registers (dv <= 192; dv <= 128
//     at d > 96): bh_bwd_fused_dk_mma, four warps hold dk and dv of their
//     keys and all four run the dq leg;
//   else (S = 2; S = 1 at d > 96 with dv > 128): bh_bwd_fused_dkv_mma, S
//     + 1 warp groups of four warps: group u < S computes stream u's p,
//     keep bits, ds^T and dk and hands its P~ tile (times c_u) and its ds^T
//     through shared memory to group S, which holds dv and, one q tile
//     behind, adds the handed tiles into dv and runs the dq leg of every
//     stream: at the diff shape (d 96, dv 192) its products then weigh
//     what a dk group's do. The groups meet at one named barrier a q tile.
// Run to run: the order in which the key tiles' partials reach a dq row
// changes, so dq may differ in its last bits between two calls on the
// same inputs (as in SDPA's backward); dk and dv take no atomics and are
// bit-equal. Instances: d padded to 64/96/128 (DN 8, 12, 16) x dv padded
// to 64/128/192 (VN 8, 16, 24), 16-byte loads (widths in multiples of
// 8); the wrapper (ops/flash.py:fused_bwd_instance) sends every other
// shape to flash_bh.cu.
//
// What bounds it on the H100: the bytes at the recipe's T 512 (52.9 us
// at diff and control B 32, against 32.6 us of tensor-core time); what
// holds these mma.sync kernels back is the instruction count (per element
// the exp and the dropout hash) and the dq leg: its product, and its
// adds, since each q tile's partial reaches the L2 once for each key tile
// that sees it (4.5 times on average at T 512).

#include "flash_bh_common.cuh"
#include "flash_bh_mma.cuh"

namespace {

constexpr int DSL = KC + 8;  // row stride (bf16) of a ds^T tile [TILE keys][KC q rows]

// the warp's ds^T (its 16 keys x the q tile's KC rows, as to_a's bf16 A
// fragments) into a key-major tile of row stride DSL
__device__ __forceinline__ void put_ds(bf16* dsT, const unsigned (&da)[KC / 16][4], int w) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  unsigned* r0 = reinterpret_cast<unsigned*>(dsT + (16 * w + gr) * DSL + 2 * tq);
  unsigned* r1 = reinterpret_cast<unsigned*>(dsT + (16 * w + gr + 8) * DSL + 2 * tq);
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {  // columns 16 kk + 2 tq, then + 8
    r0[8 * kk] = da[kk][0];
    r1[8 * kk] = da[kk][1];
    r0[8 * kk + 4] = da[kk][2];
    r1[8 * kk + 4] = da[kk][3];
  }
}

// acc (16 q rows x 8N columns) = ds (rows r0 .. r0 + 15 of the q tile over
// the block's TILE keys; ds^T stored key-major in dsT) times K (the
// block's [TILE][ldk] tile from the fragments' first column); nlive of
// the N fragments are live. One 16-key step's fragments at a time, so
// the leg adds few registers to the warps that hold dv.
template <int N>
__device__ __forceinline__ void dq_part(float (&acc)[N][4], const bf16* dsT, int r0,
                                        const bf16* Kt, int ldk, int nlive) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // A = ds = (ds^T)^T: matrix i of ldmatrix .trans covers q rows 8 (i & 1)
  // and keys 8 (i >> 1); thread t gives key row t % 8 of matrix t / 8
  const bf16* a_row = dsT + ((lane & 7) + (lane >> 4) * 8) * DSL + r0 + ((lane >> 3) & 1) * 8;
  // B = K [key][column], read transposed as tile_pb does
  const bf16* b_row = Kt + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldk + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    unsigned a[4];
    ldsm4t(a, a_row + 16 * kk * DSL);
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      if (2 * np < nlive) {
        unsigned bb[4];
        ldsm4t(bb, b_row + 16 * kk * ldk + np * 16);
        mma16816(acc[2 * np], a, bb[0], bb[1]);
        mma16816(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  }
}

// the warp's quarter of a q tile's dq partial for one stream (rows 16 (wq
// & 1) .., the column half wq >> 1), added into that stream's fp32 slab
// (T_pad rows of DP) at rows qb .., W 8-column fragments at a time
template <int DN, int W>
__device__ __forceinline__ void dq_leg(float* slab, const bf16* dsT, const bf16* Kt, int ldk,
                                       int qb, int T_len, int DP, int wq) {
  constexpr int HALF = DN / 2;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const int lo = (wq >> 1) * HALF, live = min(HALF, DP / 8 - lo);
  const int row0 = qb + 16 * (wq & 1) + gr, row1 = row0 + 8;
#pragma unroll
  for (int c = 0; c < HALF; c += W) {
    if (c >= live) break;
    float acc[W][4];
    dq_part<W>(acc, dsT, 16 * (wq & 1), Kt + (lo + c) * 8, ldk, live - c);
#pragma unroll
    for (int n = 0; n < W; ++n) {
      if (n >= live - c) break;
      // lanes tq and tq ^ 1 trade halves, so each adds four adjacent
      // columns: even tq row0's 2 tq .. 2 tq + 3, odd tq row1's 2 tq - 2 ..
      const bool odd = tq & 1;
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? acc[n][0] : acc[n][2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? acc[n][1] : acc[n][3], 1);
      const int col = (lo + c + n) * 8 + 2 * (tq & ~1), row = odd ? row1 : row0;
      if (row < T_len)
        atomicAdd(reinterpret_cast<float4*>(slab + (size_t)row * DP + col),
                  odd ? make_float4(s0, s1, acc[n][2], acc[n][3])
                      : make_float4(acc[n][0], acc[n][1], s0, s1));
    }
  }
}

// dq = scale * the scratch's fp32 sums, in bf16: BH * S * T_len rows of d
// (the scratch's rows are T_pad to a (bh, stream), DP wide), 8 columns a
// thread
__global__ void __launch_bounds__(256)
bh_dq_from_sums(const float* __restrict__ scratch, bf16* __restrict__ dq, int rows, int T_len,
                int T_pad, int d, int DP, float scale) {
  const int chunks = d >> 3;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)rows * chunks) return;
  const int row = (int)(i / chunks), c = (int)(i - (size_t)row * chunks) * 8;
  const int bs = row / T_len, t = row - bs * T_len;
  const float* src = scratch + ((size_t)bs * T_pad + t) * DP + c;
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  uint4 o;
  o.x = pack_bf16(a.x * scale, a.y * scale);
  o.y = pack_bf16(a.z * scale, a.w * scale);
  o.z = pack_bf16(b.x * scale, b.y * scale);
  o.w = pack_bf16(b.z * scale, b.w * scale);
  *reinterpret_cast<uint4*>(dq + (size_t)row * d + c) = o;
}

// ---------------------------------------------------------------------------
// one stream: one block per (bh, 64-key tile) of four warps, each holding
// dk and dv of its 16 keys; all four run the dq leg one q tile behind
// ---------------------------------------------------------------------------

template <int DN, int VN>
__global__ void __launch_bounds__(MT)
bh_bwd_fused_dk_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ coeffs, bf16* __restrict__ dq,
                    bf16* __restrict__ dk, bf16* __restrict__ dvo, float* __restrict__ scratch,
                    int T_len, int H, int d, int dv, float scale, Drop dr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [TILE][QS]
  bf16* Vs = Ks + TILE * QS;                     // [TILE][VS]
  bf16* Qb = Vs + TILE * VS;                     // [2][KC][QS]
  bf16* Gb = Qb + 2 * KC * QS;                   // [2][KC][VS]
  bf16* Dsb = Gb + 2 * KC * VS;                  // [2][TILE][DSL] ds^T
  float* Lb = reinterpret_cast<float*>(Dsb + 2 * TILE * DSL);  // [2][KC] lse
  float* Db = Lb + 2 * KC;                                     // [2][KC] delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int nkt = (T_len + TILE - 1) / TILE;
  const int BH = gridDim.x / nkt;
  const int bh = blockIdx.x % BH, kt = blockIdx.x / BH;  // the first key tiles see the most rows
  const int h = bh % H;
  const int k0 = kt * TILE;
  const int nsteps = (T_len - k0 + KC - 1) / KC;
  const int T_pad = (T_len + KC - 1) / KC * KC;
  const size_t slab = (size_t)T_len * d, gslab = (size_t)T_len * dv;
  float* dq_slab = scratch + (size_t)bh * T_pad * DP;

  zero_smem(smem_raw, sizeof(bf16) * ((size_t)TILE * (QS + VS) + 2 * (size_t)KC * (QS + VS)));
  auto stage = [&](int i) {
    const int t0 = k0 + i * KC, bi = i & 1;
    load_rows<true>(Qb + bi * KC * QS, QS, q + (size_t)bh * slab, T_len, t0, KC, d);
    load_rows<true>(Gb + bi * KC * VS, VS, g + (size_t)bh * gslab, T_len, t0, KC, dv);
    for (int r = threadIdx.x; r < KC; r += MT) {
      const size_t at = (size_t)bh * T_len + min(t0 + r, T_len - 1);
      Lb[bi * KC + r] = lse[at];
      Db[bi * KC + r] = delta[at];
    }
  };
  __syncthreads();  // the zeroed padding before any copy lands
  load_rows<true>(Ks, QS, k + (size_t)bh * slab, T_len, k0, TILE, d);
  load_rows<true>(Vs, VS, v + (size_t)bh * gslab, T_len, k0, TILE, dv);
  stage(0);
  cp_commit();

  const float cs = coeffs[h];
  const uint32_t skey = dr.on ? stream_key(dr, bh, 0) : 0u;
  const int key0 = k0 + 16 * warp + gr, key1 = key0 + 8;
  // the dropout hash's column factors
  const uint32_t kf0 = (uint32_t)key0 * 0xC2B2AE3Du, kf1 = (uint32_t)key1 * 0xC2B2AE3Du;
  const int dlive = DP / 8, vlive = VP / 8;
  float acc[DN][4], dva[VN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < VN; ++n) dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;

  for (int i = 0; i <= nsteps; ++i) {
    cp_wait<0>();
    __syncthreads();
    if (i + 1 < nsteps) {
      stage(i + 1);
      cp_commit();
    }
    if (i > 0)  // q tile i - 1's dq partial from the ds^T the warps stored
      dq_leg<DN, 4>(dq_slab, Dsb + ((i - 1) & 1) * TILE * DSL, Ks, QS, k0 + (i - 1) * KC,
                    T_len, DP, warp);
    if (i < nsteps) {
      const int qb = k0 + i * KC, bi = i & 1;
      // mask where some key of the block is not seen by every row of the
      // step (key <= row), or the step runs past T
      const bool diag = k0 + TILE - 1 > qb || qb + KC > T_len;
      const bf16* Qt = Qb + bi * KC * QS;
      const float* L = Lb + bi * KC;
      const float* D = Db + bi * KC;
      float gv[SKT][4], st[SKT][4], pv[SKT][4];
      tile_abt(gv, Vs + 16 * warp * VS, VS, Gb + bi * KC * VS, VS, VP);  // V g^T
      tile_abt(st, Ks + 16 * warp * QS, QS, Qt, QS, DP);                  // K Q^T
#pragma unroll
      for (int n = 0; n < SKT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = n * 8 + 2 * tq + e, qrow = qb + cl;
          const bool in = qrow < T_len;
          const bool v0 = !diag || (in && key0 <= qrow);
          const bool v1 = !diag || (in && key1 <= qrow);
          const float lq = L[cl], dl = D[cl];
          const float p0 = v0 ? expf(st[n][e] * scale - lq) : 0.f;
          const float p1 = v1 ? expf(st[n][2 + e] * scale - lq) : 0.f;
          float dp0 = cs * gv[n][e], dp1 = cs * gv[n][2 + e];
          float pv0 = p0, pv1 = p1;
          if (dr.on) {  // the keep mask at (row, key), then 1 / (1 - rate)
            const uint32_t rf = (uint32_t)qrow * 0x85EBCA77u;
            const bool kp0 = keep_x(dr, skey, rf ^ kf0), kp1 = keep_x(dr, skey, rf ^ kf1);
            dp0 = kp0 ? dp0 * dr.inv_keep : 0.f;
            dp1 = kp1 ? dp1 * dr.inv_keep : 0.f;
            pv0 = kp0 ? p0 * dr.inv_keep : 0.f;
            pv1 = kp1 ? p1 * dr.inv_keep : 0.f;
          }
          st[n][e] = p0 * (dp0 - dl);
          st[n][2 + e] = p1 * (dp1 - dl);
          pv[n][e] = pv0 * cs;  // c_0 P~, the factored map
          pv[n][2 + e] = pv1 * cs;
        }
      }
      unsigned pa[KC / 16][4];
      to_a(pa, pv);  // dv += P~^T g, P~ rounded
      tile_pb<VN>(dva, pa, Gb + bi * KC * VS, VS, vlive);
      to_a(pa, st);  // ds^T rounded to bf16: dk += ds^T Q, and kept for dq
      put_ds(Dsb + bi * TILE * DSL, pa, warp);
      tile_pb<DN>(acc, pa, Qt, QS, dlive);
    }
  }

  bf16* dst = dk + (size_t)bh * slab;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    if (n >= dlive) continue;
    const int c = n * 8 + 2 * tq;
    if (key0 < T_len)
      store2<true>(dst + (size_t)key0 * d + c, c, d, acc[n][0] * scale, acc[n][1] * scale);
    if (key1 < T_len)
      store2<true>(dst + (size_t)key1 * d + c, c, d, acc[n][2] * scale, acc[n][3] * scale);
  }
  bf16* dvd = dvo + (size_t)bh * gslab;
#pragma unroll
  for (int n = 0; n < VN; ++n) {
    if (n >= vlive) continue;
    const int c = n * 8 + 2 * tq;
    if (key0 < T_len) store2<true>(dvd + (size_t)key0 * dv + c, c, dv, dva[n][0], dva[n][1]);
    if (key1 < T_len) store2<true>(dvd + (size_t)key1 * dv + c, c, dv, dva[n][2], dva[n][3]);
  }
}

// ---------------------------------------------------------------------------
// S <= 2 streams: one block per (bh, 64-key tile) of S + 1 warp groups of
// four warps (warp w of a group owns keys 16w..). Group u < S: per q tile
// V g^T, K_u Q_u^T, p, the keep bit, ds^T and dk_u += ds^T Q_u; it hands
// its P~ tile (times c_u) in its own fragment order (16 floats a lane)
// and its ds^T (key-major bf16) through shared memory. Group S stages
// every tile and, one q tile behind, runs the dq leg of every stream
// (ds_u K_u, its warp w the quarter w) and adds the handed tiles into dv:
// sum_u c_u P~_u in fp32 (the twin's order), rounded once. The groups run
// loops of their own with the same named barrier once a q tile; g tiles
// are triple-buffered (group S reads tile i - 1's while tile i + 1's
// lands), the handed tiles double-buffered.
// ---------------------------------------------------------------------------

template <int DN, int VN>
__global__ void __launch_bounds__(3 * MT)
bh_bwd_fused_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ coeffs, bf16* __restrict__ dq,
                     bf16* __restrict__ dk, bf16* __restrict__ dvo, float* __restrict__ scratch,
                     int S, int T_len, int H, int d, int dv, float scale, Drop dr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = round16(d), VP = round16(dv);
  const int QS = DP + 8, VS = VP + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [S][TILE][QS]
  bf16* Vs = Ks + S * TILE * QS;                 // [TILE][VS]
  bf16* Qb = Vs + TILE * VS;                     // [2][S][KC][QS]
  bf16* Gb = Qb + 2 * S * KC * QS;               // [3][KC][VS]
  bf16* Dsb = Gb + 3 * KC * VS;                  // [2][S][TILE][DSL] ds^T
  float* Hb = reinterpret_cast<float*>(Dsb + 2 * S * TILE * DSL);  // [2][S][4][16][32]
  float* Lb = Hb + 2 * S * 4 * 16 * 32;                            // [2][S][KC] lse
  float* Db = Lb + 2 * S * KC;                                     // [2][S][KC] delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp >> 2, w = warp & 3, tid = threadIdx.x & (MT - 1);
  const int gr = lane >> 2, tq = lane & 3;
  const int nthreads = (S + 1) * MT;
  const int nkt = (T_len + TILE - 1) / TILE;
  const int BH = gridDim.x / nkt;
  const int bh = blockIdx.x % BH, kt = blockIdx.x / BH;  // the first key tiles see the most rows
  const int h = bh % H;
  const int k0 = kt * TILE;
  const int nsteps = (T_len - k0 + KC - 1) / KC;
  const int T_pad = (T_len + KC - 1) / KC * KC;
  const size_t slab = (size_t)T_len * d, gslab = (size_t)T_len * dv;
  const int key0 = k0 + 16 * w + gr, key1 = key0 + 8;

  if (grp == S) {
    zero_smem_by(tid, smem_raw, sizeof(bf16) * ((size_t)TILE * (S * QS + VS) +
                                                2 * (size_t)KC * S * QS + 3 * (size_t)KC * VS));
  }
  auto stage = [&](int i) {  // group S: q tile i's Q, g, lse and delta
    const int t0 = k0 + i * KC, bi = i & 1;
    for (int u = 0; u < S; ++u)
      load_rows_by<true>(tid, Qb + (bi * S + u) * KC * QS, QS, q + ((size_t)bh * S + u) * slab,
                         T_len, t0, KC, d);
    load_rows_by<true>(tid, Gb + (i % 3) * KC * VS, VS, g + (size_t)bh * gslab, T_len, t0, KC,
                       dv);
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
  auto ds_tile = [&](int i, int u) { return Dsb + ((i & 1) * S + u) * TILE * DSL; };

  if (grp == S) {  // the dq legs and dv, one q tile behind
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
      const int qb = k0 + (i - 1) * KC;
      for (int u = 0; u < S; ++u)
        dq_leg<DN, (DN < 16 && VN < 24 ? 4 : 2)>(scratch + ((size_t)bh * S + u) * T_pad * DP,
                                                 ds_tile(i - 1, u), Ks + u * TILE * QS, QS, qb,
                                                 T_len, DP, w);
      // the handed fragments straight into bf16 A fragments: element j =
      // 4 n + c of C fragment n is, in to_a's order, half (j & 1) of
      // pa[j / 8][(j % 8) / 2]; dv += (c_0 P~_0 + c_1 P~_1, rounded once)^T g
      const float* h0 = hand(i - 1, 0);
      unsigned pa[KC / 16][4];
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
      tile_pb<VN>(acc, pa, Gb + ((i - 1) % 3) * KC * VS, VS, vlive);
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
  const float cs = coeffs[u * H + h];
  const uint32_t skey = dr.on ? stream_key(dr, bh, u) : 0u;
  // the dropout hash's column factors
  const uint32_t kf0 = (uint32_t)key0 * 0xC2B2AE3Du, kf1 = (uint32_t)key1 * 0xC2B2AE3Du;
  const bf16* Kw = Ks + (u * TILE + 16 * w) * QS;
  const bf16* Vw = Vs + 16 * w * VS;
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int i = 0; i <= nsteps; ++i) {
    bar_sync(nthreads);
    if (i == nsteps) break;
    const int qb = k0 + i * KC, bi = i & 1;
    // mask where some key of the block is not seen by every row of the
    // step (key <= row), or the step runs past T
    const bool diag = k0 + TILE - 1 > qb || qb + KC > T_len;
    const bf16* Qt = Qb + (bi * S + u) * KC * QS;
    const float* L = Lb + (bi * S + u) * KC;
    const float* D = Db + (bi * S + u) * KC;
    float gv[SKT][4], st[SKT][4];
    tile_abt(gv, Vw, VS, Gb + (i % 3) * KC * VS, VS, VP);
    tile_abt(st, Kw, QS, Qt, QS, DP);
    float* hw = hand(i, u);
#pragma unroll
    for (int n = 0; n < SKT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = n * 8 + 2 * tq + e, qrow = qb + cl;
        const bool in = qrow < T_len;
        const bool v0 = !diag || (in && key0 <= qrow);
        const bool v1 = !diag || (in && key1 <= qrow);
        const float lq = L[cl], dl = D[cl];
        const float p0 = v0 ? expf(st[n][e] * scale - lq) : 0.f;
        const float p1 = v1 ? expf(st[n][2 + e] * scale - lq) : 0.f;
        float dp0 = cs * gv[n][e], dp1 = cs * gv[n][2 + e];
        float pv0 = p0, pv1 = p1;
        if (dr.on) {  // the keep mask at (row, key), then 1 / (1 - rate)
          const uint32_t rf = (uint32_t)qrow * 0x85EBCA77u;
          const bool kp0 = keep_x(dr, skey, rf ^ kf0), kp1 = keep_x(dr, skey, rf ^ kf1);
          dp0 = kp0 ? dp0 * dr.inv_keep : 0.f;
          dp1 = kp1 ? dp1 * dr.inv_keep : 0.f;
          pv0 = kp0 ? p0 * dr.inv_keep : 0.f;
          pv1 = kp1 ? p1 * dr.inv_keep : 0.f;
        }
        st[n][e] = p0 * (dp0 - dl);
        st[n][2 + e] = p1 * (dp1 - dl);
        hw[(n * 4 + e) * 32] = pv0 * cs;
        hw[(n * 4 + 2 + e) * 32] = pv1 * cs;
      }
    }
    unsigned da[KC / 16][4];
    to_a(da, st);  // ds^T rounded to bf16: kept for dq, and dk += ds^T Q
    put_ds(ds_tile(i, u), da, w);
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

size_t fused_dk_smem(int d, int dv) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  return 2 * ((size_t)TILE * (QS + VS) + 2 * (size_t)KC * (QS + VS) + 2 * (size_t)TILE * DSL) +
         4 * 4 * (size_t)KC;
}

size_t fused_dkv_smem(int S, int d, int dv) {
  const int QS = pad16(d) + 8, VS = pad16(dv) + 8;
  return 2 * ((size_t)TILE * (S * QS + VS) + 2 * (size_t)KC * S * QS + 3 * (size_t)KC * VS +
              2 * (size_t)S * TILE * DSL) +
         4 * (2 * (size_t)S * 4 * 16 * 32 + 4 * (size_t)S * KC);
}

struct FusedArgs {
  const bf16 *q, *k, *v, *g;
  const float *lse, *delta, *coeffs;
  bf16 *dq, *dk, *dvo;
  float* scratch;
  int S, BH, T_len, H, d, dv;
  float scale;
  Drop dr;
};

template <int DN, int VN>
int fused_dk_run(const FusedArgs& a, cudaStream_t stream) {
  const size_t smem = fused_dk_smem(a.d, a.dv);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<bh_bwd_fused_dk_mma<DN, VN>>(smem);
  if (rc != 0) return rc;
  const int nkt = (a.T_len + TILE - 1) / TILE;
  bh_bwd_fused_dk_mma<DN, VN><<<a.BH * nkt, MT, smem, stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.coeffs, a.dq, a.dk, a.dvo, a.scratch, a.T_len, a.H,
      a.d, a.dv, a.scale, a.dr);
  return static_cast<int>(cudaGetLastError());
}

template <int DN, int VN>
int fused_dkv_run(const FusedArgs& a, cudaStream_t stream) {
  const size_t smem = fused_dkv_smem(a.S, a.d, a.dv);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem<bh_bwd_fused_dkv_mma<DN, VN>>(smem);
  if (rc != 0) return rc;
  const int nkt = (a.T_len + TILE - 1) / TILE;
  bh_bwd_fused_dkv_mma<DN, VN><<<a.BH * nkt, (a.S + 1) * MT, smem, stream>>>(
      a.q, a.k, a.v, a.g, a.lse, a.delta, a.coeffs, a.dq, a.dk, a.dvo, a.scratch, a.S, a.T_len,
      a.H, a.d, a.dv, a.scale, a.dr);
  return static_cast<int>(cudaGetLastError());
}

// one stream: dk and dv in the same warps where both fit 255 registers
// (as K3's: VN 24 with DN 16 spilled)
bool dk_dv_fits(int d, int dv) { return v_bucket(dv) <= (d_bucket(d) == 16 ? 16 : 24); }

template <int DN>
int fused_dk_v(const FusedArgs& a, cudaStream_t st) {
  switch (v_bucket(a.dv)) {
    case 8: return fused_dk_run<DN, 8>(a, st);
    case 16: return fused_dk_run<DN, 16>(a, st);
    default:
      if constexpr (DN < 16) return fused_dk_run<DN, 24>(a, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DN>
int fused_dkv_v(const FusedArgs& a, cudaStream_t st) {
  switch (v_bucket(a.dv)) {
    case 8: return fused_dkv_run<DN, 8>(a, st);
    case 16: return fused_dkv_run<DN, 16>(a, st);
    default: return fused_dkv_run<DN, 24>(a, st);
  }
}

int fused_sums(const FusedArgs& a, cudaStream_t st) {
  if (a.S == 1 && dk_dv_fits(a.d, a.dv)) {
    switch (d_bucket(a.d)) {
      case 8: return fused_dk_v<8>(a, st);
      case 12: return fused_dk_v<12>(a, st);
      default: return fused_dk_v<16>(a, st);
    }
  }
  switch (d_bucket(a.d)) {
    case 8: return fused_dkv_v<8>(a, st);
    case 12: return fused_dkv_v<12>(a, st);
    default: return fused_dkv_v<16>(a, st);
  }
}

// dk, dv and dq's fp32 sums, then dq from the sums: two device launches
int fused_mma(const FusedArgs& a, cudaStream_t st) {
  const int rc = fused_sums(a, st);
  if (rc != 0) return rc;
  const int rows = a.BH * a.S * a.T_len, T_pad = (a.T_len + KC - 1) / KC * KC;
  const size_t items = (size_t)rows * (a.d / 8);
  bh_dq_from_sums<<<(unsigned)((items + 255) / 256), 256, 0, st>>>(
      a.scratch, a.dq, rows, a.T_len, T_pad, a.d, pad16(a.d), a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 tensor-core instances of the C entry point flash_bh_bwd_fused
// (flash_bh.cu has the same signature: fp32, and bf16 outside these
// instances; ops/flash.py:fused_bwd_instance picks the library). Two
// device launches (dk, dv and dq's sums; then dq). dtype must be 1
// (bfloat16), S <= 2, d and dv multiples of 8 with dv <= 192, coeffs
// given (the factored form). dq_acc: fp32 scratch of BH * S * ceil(T / 32)
// * 32 * round16(d) floats, zero at the launch. The other arguments as
// flash_bh_bwd_dq's (flash_bh_bwd_dq.cu).
extern "C" int flash_bh_bwd_fused(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, const void* coeffs,
                                  void* dq, void* dk, void* dv_out, void* dq_acc, int S, int BH,
                                  int T_len, int H, int d, int dv, float scale, unsigned w0,
                                  unsigned w1, unsigned threshold, float inv_keep,
                                  int dropout_on, int dtype, void* stream) {
  if (!shapes_ok(S, BH, T_len, H, d, dv) || dtype != 1 || S > 2 || d % 8 != 0 ||
      dv % 8 != 0 || v_bucket(dv) > 24 || coeffs == nullptr || dq_acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<const bf16*>(g),
                    static_cast<const float*>(lse), static_cast<const float*>(delta),
                    static_cast<const float*>(coeffs), static_cast<bf16*>(dq),
                    static_cast<bf16*>(dk), static_cast<bf16*>(dv_out),
                    static_cast<float*>(dq_acc), S, BH, T_len, H, d, dv, scale,
                    make_drop(w0, w1, threshold, inv_keep, dropout_on)};
  return fused_mma(a, static_cast<cudaStream_t>(stream));
}
