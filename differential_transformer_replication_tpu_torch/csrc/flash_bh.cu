// Head-major multi-stream causal flash attention for Hopper (sm_90a), with
// in-kernel attention-probability dropout, the backward:
//
//   out = sum_s c[s, h] * dropout(softmax(Q_s K_s^T / sqrt(d) + causal)) V
//
// Four kernels replace the seven TPU kernel bodies of
// differential_transformer_replication_tpu/ops/flash.py on the head-major
// route and on the sequence-parallel ring; K1, the forward, lives in
// flash_bh_fwd.cu, the bf16 instances of K2 and K3 (tensor cores) in
// flash_bh_bwd_dq.cu and flash_bh_bwd_dkv.cu, and K4's bf16 tensor-core
// instances (S <= 2, widths in multiples of 8, dv <= 192: every fused
// shape of the recipes) in flash_bh_bwd_fused.cu (each its own library, so
// they build side by side; ops/flash.py loads K2/K3's library by dtype and
// K4's by fused_bwd_instance). Here: the fp32 instances of K2 and K3, and
// K4 in fp32 and in bf16 past those instances (S > 2, other widths):
//   K1 bh_fwd_mma (bf16),  _fwd_kernel (_fwd_call, resident, T <= 4096;
//      bh_fwd_kernel       _chunk_fwd_call, the ring chunk) and
//      (fp32)              _tiled_fwd_kernel (_tiled_fwd_call, T > 4096)
//   K2 bh_dq_kernel        _bwd_dq_kernel (_bwd_call) and _tiled_dq_kernel
//      (fp32; bf16:        (_tiled_bwd_call)
//      flash_bh_bwd_dq.cu)
//   K3 bh_dkv_kernel       _bwd_dkv_kernel (_bwd_call) and _tiled_dkv_kernel
//      (fp32; bf16:        (_tiled_bwd_call)
//      flash_bh_bwd_dkv.cu)
//   K4 bh_bwd_fused_kernel _bwd_fused_kernel (_fused_bwd_call)
//      (fp32; bf16 past
//      flash_bh_bwd_fused.cu)
// K1-K3 take a causal offset ``off``: column c is visible to row r iff c <=
// r + off (0 on the aligned path; a multiple of the chunk length on the
// ring, negative where the chunk lies in the row's future). K1 without
// coefficients writes only the per-stream (o_all, lse), the ring chunk's
// no-combine mode; K2/K3 without coefficients take one cotangent per stream
// (g (BH, S, T, dv), JAX ``coeffs=None``) and sum dv = sum_s P~_s^T g_s,
// each P~_s rounded on its own. K4 is aligned and factored only.
// On the TPU the resident/tiled and fused/split splits follow what fits in
// VMEM. Here every kernel streams 32-key tiles through shared memory, so it
// is valid at any T; the route (resident, tiled, fused, split) only picks
// which kernels run (ops/flash.py:fwd_route, bwd_route). Any number of
// streams S (here and in K1's fp32 instances): a block holds sc <= MAX_SC
// streams' tiles and accumulators at once (the launcher picks the largest
// sc that fits) and walks the streams in passes of sc; S <= sc, every
// shape of the recipes, is one pass.
//
// Layouts (the JAX package's): q, k (BH, S, T, d); v (BH, T, dv); g (BH, T,
// dv), or (BH, S, T, dv) per stream; o_all (BH, S, T, dv) in the storage
// type; lse, delta (BH, S, T) fp32; coeffs (S, H) fp32 with h = bh % H. All
// contiguous.
//
// What bounds it on the H100: at the slice's shapes (T = 512..8192, d = 96,
// dv = 192) a head's work is ~T^2 (d + dv) multiply-adds over ~T (d + dv)
// elements, far above the ~295 FLOP/byte ridge: the bound is the tensor
// cores. The bf16 K4 here runs every product of a tile pair (gV^T, QK^T,
// dS K, dS^T Q, P^T g) as WMMA 16x16x16 fragments with fp32 accumulation
// out of shared memory, one block per (b, h) (fp32 operands take a SIMT
// FMA loop instead, exact like the plain version, in K2-K4); it serves
// only the shapes flash_bh_bwd_fused.cu's instances do not take. Tiles
// are 32 x 32 (BK = the warp size, so a row's 32 keys sit one per lane for
// its max and sum), four warps a block.
//
// Numerics follow the TPU kernels: the forward is online softmax over key
// tiles; the normalizer l sums the UNDROPPED p; p (dropped and scaled by
// 1/(1-rate)) is rounded to the storage type before PV; o_s = acc /
// max(l, 1e-30); the streams combine in fp32 and round once; lse = m +
// log(max(l, 1e-30)). The backward recomputes p = exp(s*scale - lse),
// takes dP_s = c_s (g V^T) (the factored form: one product per tile pair
// shared by the streams), masks and scales it with the same keep mask, and
// rounds ds = p (dP - delta) to the storage type before the dq/dk
// products; dv = (sum_s c_s P~_s, rounded)^T g. Causal tiles entirely in
// the future are skipped. A row with no visible key ends with l = 0, o = 0
// and lse = NEG_INF + log(1e-30) = -1e30, as the JAX kernel's (the ring
// merge then gives it zero weight). The dropout keep mask is the JAX
// package's counter hash of (seed words, b*H + h, stream, row, column -
// off) in uint32 arithmetic (flash.py:dropout_keep_ids, _keep_mask_block),
// so all kernels and the plain version regenerate the same bits.

#include "flash_bh_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// the backward's row pass, shared by K2-K4: for the tile pair (q rows q0..,
// keys k0..) and stream s, from Sc = Q_s K_s^T and GV = g V^T (fp32
// [BQ][BK]; g_s V^T per stream, cs = 1), writes ds = round(p (dP - delta))
// into Ds; when PC is given, accumulates PC += c_s P~ (PC = c_0 P~ at s =
// 0); in the RING mode (offset off) when Pr is given, writes the stream's
// own rounded P~ into it
// ---------------------------------------------------------------------------

template <typename T, bool RING>
__device__ __forceinline__ void bwd_rows(const float* Sc, const float* GV, T* Ds, int ldp,
                                         float* PC, T* Pr, const float* lse_r,
                                         const float* dl_r, int q0, int k0, int T_len, int off,
                                         int bh, int s, float cs, float scale, const Drop& dr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t skey = dr.on ? stream_key(dr, bh, s) : 0u;
  for (int j = 0; j < RPW; ++j) {
    const int r = warp * RPW + j, row = q0 + r, key = k0 + lane;
    const bool live = RING ? row < T_len && key < T_len && key <= row + off
                           : key <= row && row < T_len;
    const float p = live ? expf(Sc[r * SC_LD + lane] * scale - lse_r[r]) : 0.f;
    float dpv = cs * GV[r * SC_LD + lane];
    float pv = p;
    if (dr.on) {
      const bool kp = keep_bit(dr, skey, row, RING ? key - off : key);
      dpv = kp ? dpv * dr.inv_keep : 0.f;
      pv = kp ? p * dr.inv_keep : 0.f;
    }
    Ds[r * ldp + lane] = from_f<T>(p * (dpv - dl_r[r]));
    if (PC != nullptr) {
      float* pc = PC + r * SC_LD + lane;
      *pc = s == 0 ? pv * cs : *pc + pv * cs;
    }
    if (RING && Pr != nullptr) Pr[r * ldp + lane] = from_f<T>(pv);
  }
}

// lse and delta of rows [q0, q0 + BQ) for every stream into Lse/Dl [S][BQ]
// (0 past T_len: those rows are masked)
__device__ __forceinline__ void stage_rows(float* Lse, float* Dl, const float* __restrict__ lse,
                                           const float* __restrict__ delta, int bh, int S,
                                           int T_len, int q0) {
  for (int i = threadIdx.x; i < S * BQ; i += THREADS) {
    const int s = i / BQ, r = i - s * BQ, row = q0 + r;
    const size_t at = (size_t)(bh * S + s) * T_len + row;
    Lse[i] = row < T_len ? lse[at] : 0.f;
    Dl[i] = row < T_len ? delta[at] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K2, dq: one block per (bh, 32-row q tile); key tiles outer, streams inner
// (one g V^T per tile pair; per stream with per-stream cotangents, ps)
// ---------------------------------------------------------------------------

template <typename T>
struct DqSmem {
  T *Qs, *Gs, *Ks, *Vs, *Ds;
  float *GV, *Sc, *DQ, *Lse, *Dl;
  size_t bytes;
  __host__ __device__ DqSmem(unsigned char* base, int S, int sc, int d, int dv, bool ps) {
    Carve cv{base};
    Qs = cv.take<T>((size_t)sc * BQ * ld_in<T>(d));
    Gs = cv.take<T>((size_t)(ps ? sc : 1) * BQ * ld_in<T>(dv));
    Ks = cv.take<T>((size_t)BK * ld_in<T>(d));
    Vs = cv.take<T>((size_t)BK * ld_in<T>(dv));
    Ds = cv.take<T>((size_t)BQ * ld_in<T>(BK));
    GV = cv.take<float>((size_t)BQ * SC_LD);
    Sc = cv.take<float>((size_t)BQ * SC_LD);
    DQ = cv.take<float>((size_t)sc * BQ * ld_acc(d));
    Lse = cv.take<float>((size_t)S * BQ);
    Dl = cv.take<float>((size_t)S * BQ);
    bytes = cv.off;
  }
};

// RING: per-stream cotangents g (BH, S, T, dv), coeffs unread, offset off;
// else the factored form (off = 0)
template <typename T, bool RING>
__global__ void __launch_bounds__(THREADS)
bh_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ g, const float* __restrict__ lse,
             const float* __restrict__ delta, const float* __restrict__ coeffs,
             T* __restrict__ dq, int S, int sc, int T_len, int H, int d, int dv, int off,
             float scale, Drop dr) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool ps = RING;
  const DqSmem<T> sm(smem, S, sc, d, dv, ps);
  const int ldq = ld_in<T>(d), ldv = ld_in<T>(dv), ldp = ld_in<T>(BK);
  const int ldd = ld_acc(d), dp = round16(d), dvp = round16(dv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nqt = (T_len + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)(blockIdx.x % nqt);
  const int bh = blockIdx.x / nqt, h = bh % H;
  const int q0 = qt * BQ;
  const int kend = RING ? max(0, min(T_len, q0 + BQ + off)) : min(T_len, q0 + BQ);
  const size_t slab = (size_t)T_len * d, gslab = (size_t)T_len * dv;
  const T* qb = q + (size_t)bh * S * slab;
  const T* kb = k + (size_t)bh * S * slab;
  const T* vb = v + (size_t)bh * T_len * dv;
  const T* gb = g + (size_t)bh * (ps ? S : 1) * gslab;

  if (!ps) stage<T>(sm.Gs, ldv, gb, T_len, q0, BQ, dv);
  stage_rows(sm.Lse, sm.Dl, lse, delta, bh, S, T_len, q0);
  for (int s0 = 0; s0 < S; s0 += sc) {  // a pass over streams [s0, s0 + sn)
    const int sn = min(sc, S - s0);
    __syncthreads();  // the last pass has written its dq out
    for (int s = 0; s < sn; ++s) {
      stage<T>(sm.Qs + s * BQ * ldq, ldq, qb + (s0 + s) * slab, T_len, q0, BQ, d);
      if (ps) stage<T>(sm.Gs + s * BQ * ldv, ldv, gb + (s0 + s) * gslab, T_len, q0, BQ, dv);
    }
    for (int i = threadIdx.x; i < sn * BQ * ldd; i += THREADS) sm.DQ[i] = 0.f;

    for (int k0 = 0; k0 < kend; k0 += BK) {
      __syncthreads();
      stage<T>(sm.Vs, ldv, vb, T_len, k0, BK, dv);
      __syncthreads();
      if (!ps) mm<true, false, false>(sm.GV, SC_LD, sm.Gs, ldv, sm.Vs, ldv, BQ, BK, dvp);
      for (int s = 0; s < sn; ++s) {
        const int gs = s0 + s;
        __syncthreads();  // the previous stream's dq product is done with Ks, Ds, GV
        stage<T>(sm.Ks, ldq, kb + gs * slab, T_len, k0, BK, d);
        __syncthreads();
        mm<true, false, false>(sm.Sc, SC_LD, sm.Qs + s * BQ * ldq, ldq, sm.Ks, ldq, BQ, BK, dp);
        if (ps)  // dP_s = g_s V^T
          mm<true, false, false>(sm.GV, SC_LD, sm.Gs + s * BQ * ldv, ldv, sm.Vs, ldv, BQ, BK,
                                 dvp);
        __syncthreads();
        bwd_rows<T, RING>(sm.Sc, sm.GV, sm.Ds, ldp, nullptr, nullptr, sm.Lse + gs * BQ,
                    sm.Dl + gs * BQ, q0, k0, T_len, off, bh, gs,
                    ps ? 1.f : coeffs[gs * H + h], scale, dr);
        __syncthreads();
        mm<true, true, true>(sm.DQ + s * BQ * ldd, ldd, sm.Ds, ldp, sm.Ks, ldq, BQ, dp, BK);
      }
    }
    __syncthreads();
    for (int j = 0; j < RPW; ++j) {
      const int r = warp * RPW + j, row = q0 + r;
      if (row >= T_len) continue;
      for (int s = 0; s < sn; ++s)
        for (int c = lane; c < d; c += 32)
          dq[((size_t)(bh * S + s0 + s) * T_len + row) * d + c] =
              from_f<T>(sm.DQ[(s * BQ + r) * ldd + c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// K3 (dk, dv: one block per (bh, 32-key tile), q tiles outer, streams
// inner) and K4 (fused: one block per bh walking the key tiles in order;
// each q-tile pass also adds ds K into dq_acc, an fp32 scratch that only
// this block touches, and q tile kt is final once key tile kt is done)
// ---------------------------------------------------------------------------

// sc streams' K tiles and dk accumulators per pass; Kx is the slot the
// first pass stages the other streams' K tiles into for dv (S > sc only)
template <typename T>
struct DkvSmem {
  T *Ks, *Kx, *Vs, *Qs, *Gs, *Ds, *Pr;
  float *GV, *Sc, *PC, *DK, *DV, *Lse, *Dl;
  size_t bytes;
  __host__ __device__ DkvSmem(unsigned char* base, int S, int sc, int d, int dv, bool) {
    Carve cv{base};
    Ks = cv.take<T>((size_t)sc * BK * ld_in<T>(d));
    Kx = S > sc ? cv.take<T>((size_t)BK * ld_in<T>(d)) : nullptr;
    Vs = cv.take<T>((size_t)BK * ld_in<T>(dv));
    Qs = cv.take<T>((size_t)BQ * ld_in<T>(d));
    Gs = cv.take<T>((size_t)BQ * ld_in<T>(dv));
    Ds = cv.take<T>((size_t)BQ * ld_in<T>(BK));
    Pr = cv.take<T>((size_t)BQ * ld_in<T>(BK));
    GV = cv.take<float>((size_t)BQ * SC_LD);
    Sc = cv.take<float>((size_t)BQ * SC_LD);
    PC = cv.take<float>((size_t)BQ * SC_LD);
    DK = cv.take<float>((size_t)sc * BK * ld_acc(d));
    DV = cv.take<float>((size_t)BK * ld_acc(dv));
    Lse = cv.take<float>((size_t)S * BQ);
    Dl = cv.take<float>((size_t)S * BQ);
    bytes = cv.off;
  }
};

// one pass of one key tile's backward over streams [s0, s0 + sn): walks
// the q tiles that see any of its keys, leaves dk of those streams in DK
// and (with_dv) dv of the tile in DV, and (dq_acc != null) adds ds K into
// dq_acc rows (ld = round16(d)), overwriting them when first is set. dv
// needs every stream (the factored form rounds their combined map once;
// per-stream cotangents, coeffs == nullptr, add each stream's own P~_s^T
// g_s), so the pass that makes it also visits the streams outside [s0, s0
// + sn), with their K tiles staged into Kx. RING: per-stream cotangents
// and the offset off; else factored and aligned (off = 0)
template <typename T, bool RING>
__device__ __forceinline__ void dkv_tile(const DkvSmem<T>& sm, const T* __restrict__ q,
                                         const T* __restrict__ k, const T* __restrict__ v,
                                         const T* __restrict__ g, const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         const float* __restrict__ coeffs, float* dq_acc,
                                         bool first, int bh, int kt, int S, int s0, int sn,
                                         bool with_dv, int T_len, int H, int d, int dv, int off,
                                         float scale, const Drop& dr) {
  const int ldq = ld_in<T>(d), ldv = ld_in<T>(dv), ldp = ld_in<T>(BK);
  const int ldd = ld_acc(d), ldva = ld_acc(dv), dp = round16(d), dvp = round16(dv);
  const int h = bh % H, k0 = kt * BK;
  constexpr bool ps = RING;
  const size_t slab = (size_t)T_len * d, gslab = (size_t)T_len * dv;
  const T* qb = q + (size_t)bh * S * slab;
  const T* kb = k + (size_t)bh * S * slab;
  const T* gb = ps ? g + (size_t)bh * S * gslab : g + (size_t)bh * T_len * dv;
  const int s_lo = with_dv ? 0 : s0, s_hi = with_dv ? S : s0 + sn;
  // the first q tile with a row that sees key k0 (row >= k0 - off; BQ ==
  // BK, so tile k0 itself when aligned)
  const int lo = k0 - off, q_first = !RING ? k0 : lo <= 0 ? 0 : (lo / BQ) * BQ;

  __syncthreads();  // the previous tile's results are written out
  for (int s = 0; s < sn; ++s)
    stage<T>(sm.Ks + s * BK * ldq, ldq, kb + (s0 + s) * slab, T_len, k0, BK, d);
  stage<T>(sm.Vs, ldv, v + (size_t)bh * T_len * dv, T_len, k0, BK, dv);
  for (int i = threadIdx.x; i < sn * BK * ldd; i += THREADS) sm.DK[i] = 0.f;
  if (with_dv)
    for (int i = threadIdx.x; i < BK * ldva; i += THREADS) sm.DV[i] = 0.f;

  for (int q0 = q_first; q0 < T_len; q0 += BQ) {
    __syncthreads();  // the last pass is done with Gs, Pr
    if (!ps) stage<T>(sm.Gs, ldv, gb, T_len, q0, BQ, dv);
    stage_rows(sm.Lse, sm.Dl, lse, delta, bh, S, T_len, q0);
    __syncthreads();
    if (!ps) mm<true, false, false>(sm.GV, SC_LD, sm.Gs, ldv, sm.Vs, ldv, BQ, BK, dvp);
    for (int s = s_lo; s < s_hi; ++s) {
      const bool mine = s >= s0 && s < s0 + sn;
      const T* Kt = mine ? sm.Ks + (s - s0) * BK * ldq : sm.Kx;
      __syncthreads();  // the previous stream's products are done with Qs, Ds, Kx, Gs, Pr
      stage<T>(sm.Qs, ldq, qb + s * slab, T_len, q0, BQ, d);
      if (!mine) stage<T>(sm.Kx, ldq, kb + s * slab, T_len, k0, BK, d);
      if (ps) stage<T>(sm.Gs, ldv, gb + s * gslab, T_len, q0, BQ, dv);
      __syncthreads();
      mm<true, false, false>(sm.Sc, SC_LD, sm.Qs, ldq, Kt, ldq, BQ, BK, dp);
      if (ps) mm<true, false, false>(sm.GV, SC_LD, sm.Gs, ldv, sm.Vs, ldv, BQ, BK, dvp);
      __syncthreads();
      bwd_rows<T, RING>(sm.Sc, sm.GV, sm.Ds, ldp, (with_dv && !ps) ? sm.PC : nullptr,
                  (with_dv && ps) ? sm.Pr : nullptr, sm.Lse + s * BQ, sm.Dl + s * BQ, q0, k0,
                  T_len, off, bh, s, ps ? 1.f : coeffs[s * H + h], scale, dr);
      if (with_dv && !ps && s == S - 1) {  // the stream-combined dropped map, rounded once
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        for (int j = 0; j < RPW; ++j) {
          const int r = warp * RPW + j;
          sm.Pr[r * ldp + lane] = from_f<T>(sm.PC[r * SC_LD + lane]);
        }
      }
      __syncthreads();
      // per-stream cotangents: dv += P~_s^T g_s
      if (with_dv && ps) mm<false, true, true>(sm.DV, ldva, sm.Pr, ldp, sm.Gs, ldv, BK, dvp, BQ);
      if (!mine) continue;
      // dk_s += ds^T Q_s
      mm<false, true, true>(sm.DK + (s - s0) * BK * ldd, ldd, sm.Ds, ldp, sm.Qs, ldq, BK, dp,
                            BQ);
      if (dq_acc != nullptr) {
        float* dst = dq_acc + ((size_t)s * (((T_len + BQ - 1) / BQ) * BQ) + q0) * dp;
        if (first)
          mm<true, true, false>(dst, dp, sm.Ds, ldp, Kt, ldq, BQ, dp, BK);
        else
          mm<true, true, true>(dst, dp, sm.Ds, ldp, Kt, ldq, BQ, dp, BK);
      }
    }
    // dv += (sum_s c_s P~_s)^T g
    if (with_dv && !ps) mm<false, true, true>(sm.DV, ldva, sm.Pr, ldp, sm.Gs, ldv, BK, dvp, BQ);
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void write_dkv(const DkvSmem<T>& sm, T* __restrict__ dk,
                                          T* __restrict__ dvo, int bh, int kt, int S, int s0,
                                          int sn, bool with_dv, int T_len, int d, int dv,
                                          float scale) {
  const int ldd = ld_acc(d), ldva = ld_acc(dv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < RPW; ++j) {
    const int r = warp * RPW + j, key = kt * BK + r;
    if (key >= T_len) continue;
    for (int s = 0; s < sn; ++s)
      for (int c = lane; c < d; c += 32)
        dk[((size_t)(bh * S + s0 + s) * T_len + key) * d + c] =
            from_f<T>(sm.DK[(s * BK + r) * ldd + c] * scale);
    if (with_dv)
      for (int c = lane; c < dv; c += 32)
        dvo[((size_t)bh * T_len + key) * dv + c] = from_f<T>(sm.DV[r * ldva + c]);
  }
}

template <typename T, bool RING>
__global__ void __launch_bounds__(THREADS)
bh_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ coeffs,
              T* __restrict__ dk, T* __restrict__ dvo, int S, int sc, int T_len, int H, int d,
              int dv, int off, float scale, Drop dr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvSmem<T> sm(smem, S, sc, d, dv, RING);
  const int nkt = (T_len + BK - 1) / BK;
  const int kt = blockIdx.x % nkt;  // low key tiles have the most q tiles: first
  const int bh = blockIdx.x / nkt;
  for (int s0 = 0; s0 < S; s0 += sc) {
    const int sn = min(sc, S - s0);
    // the aligned instance takes a literal 0 offset (with off passed
    // through, its code measured ~4% slower on the H100)
    dkv_tile<T, RING>(sm, q, k, v, g, lse, delta, coeffs, nullptr, false, bh, kt, S, s0, sn,
                      s0 == 0, T_len, H, d, dv, RING ? off : 0, scale, dr);
    write_dkv<T>(sm, dk, dvo, bh, kt, S, s0, sn, s0 == 0, T_len, d, dv, scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bh_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ coeffs,
                    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dvo,
                    float* __restrict__ dq_acc, int S, int sc, int T_len, int H, int d, int dv,
                    float scale, Drop dr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DkvSmem<T> sm(smem, S, sc, d, dv, false);
  const int nkt = (T_len + BK - 1) / BK;
  const int bh = blockIdx.x;
  const int dp = round16(d);
  const size_t tpad = (size_t)nkt * BQ;
  float* acc = dq_acc + (size_t)bh * S * tpad * dp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int kt = 0; kt < nkt; ++kt) {
    // every q tile is first reached from key tile 0, which overwrites it
    for (int s0 = 0; s0 < S; s0 += sc) {
      const int sn = min(sc, S - s0);
      dkv_tile<T, false>(sm, q, k, v, g, lse, delta, coeffs, acc, kt == 0, bh, kt, S, s0, sn,
                  s0 == 0, T_len, H, d, dv, 0, scale, dr);
      write_dkv<T>(sm, dk, dvo, bh, kt, S, s0, sn, s0 == 0, T_len, d, dv, scale);
    }
    // q tile kt took its last ds K at key tile kt (the diagonal)
    for (int j = 0; j < RPW; ++j) {
      const int r = warp * RPW + j, row = kt * BQ + r;
      if (row >= T_len) continue;
      for (int s = 0; s < S; ++s)
        for (int c = lane; c < d; c += 32)
          dq[((size_t)(bh * S + s) * T_len + row) * d + c] =
              from_f<T>(acc[((size_t)s * tpad + row) * dp + c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, bool RING>
int bwd_dq(const void* q, const void* k, const void* v, const void* g, const float* lse,
           const float* delta, const float* coeffs, void* dq, int S, int BH, int T_len, int H,
           int d, int dv, int off, float scale, Drop dr, cudaStream_t stream) {
  size_t smem = 0;
  const int sc = streams_per_pass<DqSmem<T>>(S, d, dv, &smem, RING);
  if (sc == 0) return static_cast<int>(cudaErrorInvalidValue);
  int rc = allow_smem<bh_dq_kernel<T, RING>>(smem);
  if (rc != 0) return rc;
  const int nqt = (T_len + BQ - 1) / BQ;
  bh_dq_kernel<T, RING><<<BH * nqt, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, coeffs, static_cast<T*>(dq), S, sc, T_len, H, d,
      dv, off, scale, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RING>
int bwd_dkv(const void* q, const void* k, const void* v, const void* g, const float* lse,
            const float* delta, const float* coeffs, void* dk, void* dvo, int S, int BH,
            int T_len, int H, int d, int dv, int off, float scale, Drop dr,
            cudaStream_t stream) {
  size_t smem = 0;
  const int sc = streams_per_pass<DkvSmem<T>>(S, d, dv, &smem, RING);
  if (sc == 0) return static_cast<int>(cudaErrorInvalidValue);
  int rc = allow_smem<bh_dkv_kernel<T, RING>>(smem);
  if (rc != 0) return rc;
  const int nkt = (T_len + BK - 1) / BK;
  bh_dkv_kernel<T, RING><<<BH * nkt, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, coeffs, static_cast<T*>(dk), static_cast<T*>(dvo),
      S, sc, T_len, H, d, dv, off, scale, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_fused(const void* q, const void* k, const void* v, const void* g, const float* lse,
              const float* delta, const float* coeffs, void* dq, void* dk, void* dvo,
              float* dq_acc, int S, int BH, int T_len, int H, int d, int dv, float scale,
              Drop dr, cudaStream_t stream) {
  size_t smem = 0;
  const int sc = streams_per_pass<DkvSmem<T>>(S, d, dv, &smem, false);
  if (sc == 0) return static_cast<int>(cudaErrorInvalidValue);
  int rc = allow_smem<bh_bwd_fused_kernel<T>>(smem);
  if (rc != 0) return rc;
  bh_bwd_fused_kernel<T><<<BH, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, coeffs, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dvo), dq_acc, S, sc, T_len, H, d, dv, scale, dr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (K2, K3; bfloat16 is their tensor-core libraries'),
// 1 = bfloat16 (K4 only, at the shapes flash_bh_bwd_fused.cu's instances
// do not take; it runs any). off: the causal offset (column c is
// visible to row r iff c <= r + off). Dropout: the two 24-bit seed words,
// the keep threshold min(round(rate * 2^32), 2^32 - 1), float32(1 / (1 -
// rate)) and on = rate > 0. Each returns the launch's CUDA error code
// (cudaErrorInvalidValue for shapes or modes the kernels do not take).

// coeffs == nullptr: per-stream cotangents g (BH, S, T, dv)
extern "C" int flash_bh_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                               const void* lse, const void* delta, const void* coeffs,
                               void* dq, int S, int BH, int T_len, int H, int d, int dv,
                               int off, float scale, unsigned w0, unsigned w1,
                               unsigned threshold, float inv_keep, int dropout_on, int dtype,
                               void* stream) {
  if (!shapes_ok(S, BH, T_len, H, d, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const bool ring = coeffs == nullptr;  // per-stream cotangents, offset off
  if (!ring && off != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Drop dr = make_drop(w0, w1, threshold, inv_keep, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* c = static_cast<const float*>(coeffs);
  switch (dtype) {
    case 0: return (ring ? bwd_dq<float, true> : bwd_dq<float, false>)(
        q, k, v, g, l, dl, c, dq, S, BH, T_len, H, d, dv, off, scale, dr, st);
    default: return static_cast<int>(cudaErrorInvalidValue);  // bf16: flash_bh_bwd_dq.cu
  }
}

// coeffs == nullptr: per-stream cotangents g (BH, S, T, dv)
extern "C" int flash_bh_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                const void* lse, const void* delta, const void* coeffs,
                                void* dk, void* dv_out, int S, int BH, int T_len, int H, int d,
                                int dv, int off, float scale, unsigned w0, unsigned w1,
                                unsigned threshold, float inv_keep, int dropout_on, int dtype,
                                void* stream) {
  if (!shapes_ok(S, BH, T_len, H, d, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const bool ring = coeffs == nullptr;  // per-stream cotangents, offset off
  if (!ring && off != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Drop dr = make_drop(w0, w1, threshold, inv_keep, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* c = static_cast<const float*>(coeffs);
  switch (dtype) {
    case 0: return (ring ? bwd_dkv<float, true> : bwd_dkv<float, false>)(
        q, k, v, g, l, dl, c, dk, dv_out, S, BH, T_len, H, d, dv, off, scale, dr, st);
    default: return static_cast<int>(cudaErrorInvalidValue);  // bf16: flash_bh_bwd_dkv.cu
  }
}

// dq_acc: fp32 scratch of (BH, S, ceil(T / 32) * 32, round16(d)) floats,
// written before it is read (no initialization needed)
extern "C" int flash_bh_bwd_fused(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, const void* coeffs,
                                  void* dq, void* dk, void* dv_out, void* dq_acc, int S, int BH,
                                  int T_len, int H, int d, int dv, float scale, unsigned w0,
                                  unsigned w1, unsigned threshold, float inv_keep,
                                  int dropout_on, int dtype, void* stream) {
  if (!shapes_ok(S, BH, T_len, H, d, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const Drop dr = make_drop(w0, w1, threshold, inv_keep, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* c = static_cast<const float*>(coeffs);
  float* acc = static_cast<float*>(dq_acc);
  switch (dtype) {
    case 0: return bwd_fused<float>(q, k, v, g, l, dl, c, dq, dk, dv_out, acc, S, BH, T_len, H, d, dv, scale, dr, st);
    case 1: return bwd_fused<bf16>(q, k, v, g, l, dl, c, dq, dk, dv_out, acc, S, BH, T_len, H, d, dv, scale, dr, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
