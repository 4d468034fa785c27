// Multi-stream decode attention over the serving KV pool, for Hopper
// (sm_90a): one query row per slot (the decode step) or L rows per slot
// (the speculative verify step), over the contiguous ring or through a
// page table, with float or int8 K/V.
//
// Replaces the TPU kernels of differential_transformer_replication_tpu/
// ops/decode_attention.py:
//   _dattn_fwd_kernel      (decode_attention)              L = 1, contiguous
//   _dattn_paged_kernel    (decode_attention_paged)        L = 1, paged
//   _dattn_mq_fwd_kernel   (decode_attention_multi)        L rows, contiguous
//   _dattn_mq_paged_kernel (decode_attention_multi_paged)  L rows, paged
// each with its float and its int8 branch. Layouts are the JAX package's
// head-major pool:
//   q (S, B, L, H, d); contiguous K (S, R, H, M, d), V (R, H, M, dv) with
//   R >= B cache rows (row b of the pool is slot b; rows past B are never
//   read); paged K (S, P, H, ps, d), V (P, H, ps, dv) with a page table
//   (B, M / ps) int32; int8 K/V carry fp32 scales, one per vector:
//   K scale (S, R|P, H, M|ps), V scale (R|P, H, M|ps); pos (B, L) int32;
//   coeffs (S, H) fp32  ->  out (B, L, H, dv)
// with q/out (and float K/V) in one storage type T (float or bf16). For
// L = 1 the layouts are the single-query ones, q (S, B, H, d), pos (B,),
// out (B, H, dv). Row (b, l) sees key m iff m <= pos[b, l] (for pos >= M
// every slot holds a live key):
//
//   out[b, l, h] = sum_s coeffs[s, h] * softmax_m(q_s . K_s[m] / sqrt(d)) @ V
//
// What bounds it on the H100: the K and V reads. A step reads every
// visible key of every stream once (S*d + dv values per position; int8
// halves the bf16 bytes, plus 4 bytes of scale per vector) and does
// ~2*L*(S*d + S*dv) flops per position, far below the tensor-core rate;
// at the recipe's 8 slots the whole read is a few MB, so what the card
// can lose to is latency: serial per-row work inside a block and the
// cross-tile combine. The design reads each visible (b, h) tile ONCE for
// all L rows and all S streams and skips tiles past every row's position
// outright, keeps the per-(stream, row) softmax statistics in fp32, and
// applies the combine coefficients at the end, so no score or
// probability map ever reaches device memory.
//
// Two launches. The split kernel runs one block per (b, h, tile of TK
// keys); TK (a power of two, at most 64) depends on the streams, widths
// and dtype only, never on L (the wrapper's decode_instance picks it and
// halves it until a block's shared memory fits), so the L-row call and
// the single-row call cut the keys into the same tiles. Keys are visited
// in LOGICAL order whatever the storage: the block looks up the storage
// row of each key of its tile (through the page table, or the slot's
// ring), so on the same cache contents a paged call does a contiguous
// call's arithmetic bit for bit. The int8 instances dequantize inside
// the tile copy, float(q8) * scale rounded to T, where the TPU kernel
// does it, so the tile in shared memory is the float instance's tile.
//
// bf16 (K/V bf16 or int8): the split body runs on the tensor cores
// (dattn_split_mma). The block starts the copies of the queries, every
// stream's K tile and the V tile at once (16-byte cp.async for bf16; for
// int8 a batch of 16-byte loads dequantized in registers), then both
// products take the keys as the mma's 16 rows and a stream's 8 query rows
// (L <= 8; rows past L are zeros) as its 8 columns, so no fragment is
// padded: scores^T = K_s Q_s^T over d in 16-steps (warp s holds stream
// s's scores in registers and takes each row's tile max and sum with
// shuffles across the 8 key lanes), then the probabilities, rounded to
// bf16, go to shared memory [stream][row][key], and acc_s^T = V^T P_s^T
// runs as (stream, 16 output columns) items over all warps (V fragments
// by ldmatrix.trans). Rows and columns are padded to 16 in shared memory
// with zeros, so the fp32 sums are exact sums of the real products; K/V
// rows past the tile's last visible key are zeros too. Every output
// element of an mma depends only on its own row, column and accumulator,
// and the L = 1 call runs the same code with one live row, so row l of
// an L-row call equals the single-row call at pos[b, l] bit for bit.
// fp32 keeps the SIMT split body (dattn_split_simt): bf16 or tf32
// products would not hold its plain version's 1e-5.
//
// Each block writes, per (stream, row) that sees a key of its tile, the
// tile's unnormalized accumulator (dv floats) and, in an array of their
// own, its max and sum. The combine kernel (one block per (b, h, row, 64
// output columns), a thread a column) reads the row's visible tiles'
// statistics and accumulators with independent loads, takes each
// stream's max, sums the weights and the weighted accumulators in tile
// order, divides and applies the coefficients: sum_s c[s,h] * acc_s /
// l_s. It is launched as a programmatic dependent of the split kernel, so
// its launch overlaps the split and its blocks wait on the device for the
// split's records. As in the TPU kernel, each stream's probabilities are
// rounded to T before the PV product and the streams are combined only at
// the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TK = 64;    // keys per tile (two per lane in the SIMT softmax)
constexpr int MAX_S = 8;      // streams
constexpr int MAX_L = 8;      // query rows per slot (the verify step's k + 1)
constexpr int MAX_D = 256;    // q/k head width
constexpr int MAX_DV = 512;   // v head width
constexpr int MAX_EPT = MAX_DV / THREADS;  // SIMT: output columns per thread
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int CT = 64;        // combine: output columns (threads) per block
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Programmatic dependent launch: the split kernel lets the combine be
// scheduled at once; the combine waits here until the split kernel has
// completed and its writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}
__host__ __device__ inline int pad16(int w) { return (w + 15) & ~15; }

// Shapes and storage geometry of one call. Contiguous storage is the
// paged one with one page per cache row: NP = R rows, PS = M tokens,
// page of slot b = b.
struct Geom {
  int S, B, L, H, M, d, dv;
  int NP;  // cache rows R (contiguous) or physical pages P (paged)
  int PS;  // tokens per page: M (contiguous) or the page size
  int PP;  // pages per slot (paged): M / PS
  int TK, NS;
  float scale;
  bool vec;   // 16-byte K/V loads
  bool qvec;  // 16-byte query loads (tensor-core instances)
};

// Partial results of (b*H + h, tile, stream*L + row): the unnormalized
// accumulator (dv floats, all tiles' records first), and the tile's max
// and sum as one float2 of an array ordered (b*H + h, stream*L + row,
// tile), so the combine reads a row's statistics contiguously.
__host__ __device__ inline size_t acc_index(int bh, int tile, int sl, int NS,
                                            int SL, int dv) {
  return (((size_t)bh * NS + tile) * SL + sl) * dv;
}
__host__ __device__ inline size_t stat_index(int bh, int sl, int tile, int NS,
                                             int SL) {
  return ((size_t)bh * SL + sl) * NS + tile;
}
// floats of accumulators, rounded up to keep the statistics 8-byte aligned
__host__ __device__ inline size_t acc_floats(const Geom& g) {
  return ((size_t)g.B * g.H * g.NS * g.S * g.L * g.dv + 1) & ~size_t(1);
}

// storage row (of V; of stream s's K: s * NP * H * PS + row) of key m of
// slot b, head h
template <bool PAGED>
__device__ __forceinline__ long long key_row(const Geom& g, const int* tables,
                                             int b, int h, int m) {
  const int page = PAGED ? tables[(size_t)b * g.PP + m / g.PS] : b;
  const int off = PAGED ? m % g.PS : m;
  return ((long long)page * g.H + h) * g.PS + off;
}

// ---------------------------------------------------------------------------
// fp32: the SIMT split body
// ---------------------------------------------------------------------------

constexpr int BATCH = 8;  // 16-byte loads each thread keeps in flight

// Copy n contiguous floats of src into shared memory unchanged. With vec
// (16-byte aligned, n a multiple of 4) each thread starts all of its
// 16-byte loads of a batch before storing any, so a block keeps the whole
// batch in flight; otherwise the scalar loop keeps any width correct.
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int n,
                                      bool vec) {
  if (vec) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    const int n4 = n / 4;
    for (int i0 = threadIdx.x; i0 < n4; i0 += BATCH * THREADS) {
      uint4 r[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n4) r[u] = src4[i];
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n4) dst4[i] = r[u];
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }
}

// The int8 twin of stage: n int8 values of rows of `width` (one fp32
// scale per row) dequantized into shared memory, float(q8) * scale. With
// vec (width a multiple of 16, src 16-byte aligned) a thread loads 16
// values per 16-byte load, all of one row.
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const int8_t* __restrict__ src,
                                      const float* __restrict__ scl, int n,
                                      int width, bool vec) {
  if (vec) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    const int n16 = n / 16;
    for (int i0 = threadIdx.x; i0 < n16; i0 += BATCH * THREADS) {
      uint4 r[BATCH];
      float sc[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n16) {
          r[u] = src4[i];
          sc[u] = scl[i * 16 / width];
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n16) {
          union {
            float t[16];
            uint4 w[4];
          } buf;
          const int8_t* q8 = reinterpret_cast<const int8_t*>(&r[u]);
#pragma unroll
          for (int t = 0; t < 16; ++t) buf.t[t] = static_cast<float>(q8[t]) * sc[u];
#pragma unroll
          for (int w = 0; w < 4; ++w) dst4[i * 4 + w] = buf.w[w];
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS)
      dst[i] = static_cast<float>(src[i]) * scl[i / width];
  }
}

// Byte offsets of the SIMT block's shared memory: the queries (S*L*d
// fp32), the K tile (S*TK rows of d), the V tile (TK*dv), the
// scores/probabilities (S*L*TK), per (stream, row) the tile's max and sum
// (2*S*L), and each row's visible key count in the tile (L ints). All of
// it is dynamic, so the opt-in below can ask for the whole budget. The
// tile length is chosen at L = MAX_L, so every L fits.
struct SmemSimt {
  size_t k, v, p, stats, rows, total;
  __host__ __device__ SmemSimt(int S, int L, int TK, int d, int dv) {
    k = align16((size_t)S * L * d * 4);
    v = align16(k + (size_t)S * TK * d * 4);
    p = align16(v + (size_t)TK * dv * 4);
    stats = p + (size_t)S * L * TK * 4;
    rows = stats + 2 * (size_t)S * L * 4;
    total = rows + (size_t)L * 4;
  }
};

template <typename KV, bool PAGED>
__global__ void __launch_bounds__(THREADS)
dattn_split_simt(const float* __restrict__ q, const KV* __restrict__ k,
                 const KV* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ pos,
                 const int* __restrict__ tables, float* __restrict__ acc_out,
                 float2* __restrict__ stats, const Geom g) {
  launch_dependents();
  constexpr bool INT8 = sizeof(KV) == 1;
  const int S = g.S, H = g.H, L = g.L, d = g.d, dv = g.dv, TK = g.TK;
  const int bh = blockIdx.x;
  const int tile = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = tile * TK;
  // keys 0 .. n_vis-1 are visible to some row; a tile past every row's
  // position is never loaded
  int n_vis = 0;
  for (int l = 0; l < L; ++l) n_vis = max(n_vis, min(pos[b * L + l] + 1, g.M));
  if (t0 >= n_vis) return;
  const int jmax = min(TK, n_vis - t0);

  extern __shared__ __align__(16) unsigned char smem[];
  const SmemSimt lay(S, L, TK, d, dv);
  float* q_sh = reinterpret_cast<float*>(smem);
  float* k_sh = reinterpret_cast<float*>(smem + lay.k);
  float* v_sh = reinterpret_cast<float*>(smem + lay.v);
  float* p_sh = reinterpret_cast<float*>(smem + lay.p);  // scores, then p
  float* m_sh = reinterpret_cast<float*>(smem + lay.stats);  // tile max
  float* l_sh = m_sh + S * L;                                // tile sum
  int* jl_sh = reinterpret_cast<int*>(smem + lay.rows);  // keys row l sees (<= 0: none)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. this slot's queries, each row's visible count, and the tile: each
  //    run of keys on one page is one contiguous stretch of device memory
  for (int i = tid; i < S * L * d; i += THREADS) {
    const int sl = i / d, e = i % d;
    const int s = sl / L, l = sl % L;
    q_sh[i] = q[((((size_t)s * g.B + b) * L + l) * H + h) * d + e];
  }
  if (tid < L) jl_sh[tid] = min(TK, min(pos[b * L + tid] + 1, g.M) - t0);
  for (int j = 0; j < jmax;) {
    const int m = t0 + j;
    const int off = PAGED ? m % g.PS : m;
    const int run = PAGED ? min(jmax - j, g.PS - off) : jmax;
    const long long vrow = key_row<PAGED>(g, tables, b, h, m);
    for (int s = 0; s < S; ++s) {
      const size_t row = (size_t)s * g.NP * H * g.PS + vrow;
      if constexpr (INT8)
        stage(k_sh + ((size_t)s * TK + j) * d,
              reinterpret_cast<const int8_t*>(k) + row * d, ks + row,
              run * d, d, g.vec);
      else
        stage(k_sh + ((size_t)s * TK + j) * d,
              reinterpret_cast<const float*>(k) + row * d, run * d, g.vec);
    }
    if constexpr (INT8)
      stage(v_sh + (size_t)j * dv, reinterpret_cast<const int8_t*>(v) + vrow * dv,
            vs + vrow, run * dv, dv, g.vec);
    else
      stage(v_sh + (size_t)j * dv, reinterpret_cast<const float*>(v) + vrow * dv,
            run * dv, g.vec);
    j += run;
  }
  __syncthreads();

  // 2. scaled scores: one warp per (stream, row, key), lanes over the
  //    head width, KPW keys per warp in flight. Score idx = (s*L + l)*TK
  //    + j; TK is a power of two, so j and the (stream, row) pair come
  //    from a mask and a shift
  constexpr int KPW = 4;
  const int SLT = S * L * TK;
  const int tk_shift = __ffs(TK) - 1;
  for (int base = warp * KPW; base < SLT; base += WARPS * KPW) {
    float dot[KPW];
#pragma unroll
    for (int u = 0; u < KPW; ++u) {
      const int idx = base + u;
      const int sl = idx >> tk_shift;
      const int j = idx & (TK - 1);
      dot[u] = 0.f;
      if (idx < SLT && j < jl_sh[sl % L]) {
        const float* kr = k_sh + (size_t)((sl / L) * TK + j) * d;
        const float* qr = q_sh + sl * d;
        for (int e = lane; e < d; e += 32) dot[u] = fmaf(qr[e], kr[e], dot[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < KPW; ++u) dot[u] = warp_sum(dot[u]);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        const int idx = base + u;
        if (idx < SLT) {
          const int j = idx & (TK - 1);
          p_sh[idx] = j < jl_sh[(idx >> tk_shift) % L] ? dot[u] * g.scale : NEG_INF;
        }
      }
    }
  }
  __syncthreads();

  // 3. the tile's softmax numerators, max and sum, one warp per (stream,
  //    row); a row that sees no key of this tile is skipped (the combine
  //    never reads its record)
  for (int sl = warp; sl < S * L; sl += WARPS) {
    if (jl_sh[sl % L] <= 0) continue;
    const bool has0 = lane < TK, has1 = lane + 32 < TK;
    const float a0 = has0 ? p_sh[sl * TK + lane] : NEG_INF;
    const float a1 = has1 ? p_sh[sl * TK + lane + 32] : NEG_INF;
    const float m = warp_max(fmaxf(a0, a1));
    const float p0 = has0 ? expf(a0 - m) : 0.f;
    const float p1 = has1 ? expf(a1 - m) : 0.f;
    const float l = warp_sum(p0 + p1);
    if (has0) p_sh[sl * TK + lane] = p0;
    if (has1) p_sh[sl * TK + lane + 32] = p1;
    if (lane == 0) {
      m_sh[sl] = m;
      l_sh[sl] = l;
    }
  }
  __syncthreads();

  // 4. acc_s = p_s @ V_tile per row for up to MAX_EPT columns per thread,
  //    V read once for all S streams of a row; write the tile's records
  const int NS = g.NS;
  const int SL = S * L;
#pragma unroll
  for (int c = 0; c < MAX_EPT; ++c) {
    const int e = tid + c * THREADS;
    if (e < dv) {
      for (int l = 0; l < L; ++l) {
        const int jl = jl_sh[l];
        if (jl <= 0) continue;
        float acc[MAX_S];
#pragma unroll
        for (int s = 0; s < MAX_S; ++s) acc[s] = 0.f;
        for (int j = 0; j < jl; ++j) {
          const float vv = v_sh[(size_t)j * dv + e];
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < S) acc[s] = fmaf(p_sh[(s * L + l) * TK + j], vv, acc[s]);
        }
#pragma unroll
        for (int s = 0; s < MAX_S; ++s)
          if (s < S) acc_out[acc_index(bh, tile, s * L + l, NS, SL, dv) + e] = acc[s];
      }
    }
  }
  if (tid < SL && jl_sh[tid % L] > 0)
    stats[stat_index(bh, tid, tile, NS, SL)] = make_float2(m_sh[tid], l_sh[tid]);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core split body
// ---------------------------------------------------------------------------

// Byte offsets of the tensor-core block's shared memory, bf16 tiles whose
// rows are padded to 16 columns plus 8 (so the 8 rows an ldmatrix reads
// fall in distinct banks): the queries (S x 8 rows of d), the K tile
// (S x TK rows of d), the V tile (TK rows of dv), the probabilities (S x 8
// rows of TK keys), each key's storage row (TK, paged), each query row's
// visible key count (MAX_L ints). L does not enter.
struct SmemMma {
  int ldk, ldv, ldp;
  size_t k, v, p, rows, jl, total;
  __host__ __device__ SmemMma(int S, int TK, int d, int dv) {
    ldk = pad16(d) + 8;
    ldv = pad16(dv) + 8;
    ldp = TK + 8;
    k = align16((size_t)S * 8 * ldk * 2);
    v = align16(k + (size_t)S * TK * ldk * 2);
    p = align16(v + (size_t)TK * ldv * 2);
    rows = align16(p + (size_t)S * 8 * ldp * 2);
    jl = rows + (size_t)TK * 8;
    total = jl + MAX_L * 4;
  }
};

// Where row r of a tile comes from: a row of storage (null: a row of
// zeros) and, for int8, its scale.
template <typename KV> struct RowSrc {
  const KV* p;
  float scale;
};

// A thread's walk over the chunks (row r, chunk c < chunks) of a tile,
// chunk i = tid + k THREADS row-major: stepping i by THREADS adds (dr, dc)
// with a carry, so no division per chunk.
struct Walk {
  int r, c, dr, dc, chunks;
  __device__ explicit Walk(int n_chunks) : chunks(n_chunks) {
    dr = THREADS / chunks;
    dc = THREADS - dr * chunks;
    r = threadIdx.x / chunks;
    c = threadIdx.x - r * chunks;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= chunks) {
      c -= chunks;
      ++r;
    }
  }
};

// rows x pad16(w) of a bf16 tile of row stride ld, row r from src(r), the
// columns past w zero. VEC (bf16 rows, w a multiple of 8, 16-byte aligned
// storage): 16-byte cp.async copies, which the caller commits and waits
// for; else 2-byte loads and stores.
template <bool VEC, typename F>
__device__ __forceinline__ void tile_copy(bf16* dst, int ld, int rows, int w, F src) {
  if constexpr (VEC) {
    for (Walk it(pad16(w) / 8); it.r < rows; it.next()) {
      bf16* to = dst + (size_t)it.r * ld + it.c * 8;
      const bf16* from = it.c * 8 < w ? src(it.r).p : nullptr;
      if (from)
        cp_async16(to, from + it.c * 8, true);
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int wp = pad16(w), n = rows * wp;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int r = i / wp, c = i - r * wp;
      const bf16* from = c < w ? src(r).p : nullptr;
      dst[(size_t)r * ld + c] = from ? from[c] : __float2bfloat16_rn(0.f);
    }
  }
}

// The int8 twin, for the K and V tiles at once: rows dequantized,
// float(q8) * scale rounded to bf16. VEC (widths multiples of 16, 16-byte
// aligned storage): 16 values a 16-byte load, a batch of loads of both
// tiles in flight per thread before any is converted, two 16-byte
// stores; else 1-byte loads.
template <bool VEC, typename FK, typename FV>
__device__ __forceinline__ void tiles_int8(bf16* k_dst, int ldk, int k_rows, int dk, FK k_src,
                                           bf16* v_dst, int ldv, int v_rows, int dv,
                                           FV v_src) {
  if constexpr (VEC) {
    Walk wk(dk / 16), wv(dv / 16);
    while (wk.r < k_rows || wv.r < v_rows) {
      uint4 r8[BATCH];
      float sc[BATCH];
      bf16* to[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        r8[u] = make_uint4(0u, 0u, 0u, 0u);
        sc[u] = 0.f;
        to[u] = nullptr;
        RowSrc<int8_t> from{nullptr, 0.f};
        int c = 0;
        if (wk.r < k_rows) {
          from = k_src(wk.r);
          c = wk.c * 16;
          to[u] = k_dst + (size_t)wk.r * ldk + c;
          wk.next();
        } else if (wv.r < v_rows) {
          from = v_src(wv.r);
          c = wv.c * 16;
          to[u] = v_dst + (size_t)wv.r * ldv + c;
          wv.next();
        }
        if (from.p) {
          r8[u] = *reinterpret_cast<const uint4*>(from.p + c);
          sc[u] = from.scale;
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (to[u]) {
          const int8_t* q8 = reinterpret_cast<const int8_t*>(&r8[u]);
          uint4 o[2];
          unsigned* ow = reinterpret_cast<unsigned*>(o);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            ow[t] = pack_bf16(static_cast<float>(q8[2 * t]) * sc[u],
                              static_cast<float>(q8[2 * t + 1]) * sc[u]);
          reinterpret_cast<uint4*>(to[u])[0] = o[0];
          reinterpret_cast<uint4*>(to[u])[1] = o[1];
        }
      }
    }
  } else {
    auto one = [](bf16* dst, int ld, int rows, int w, auto src) {
      const int wp = pad16(w), n = rows * wp;
      for (int i = threadIdx.x; i < n; i += THREADS) {
        const int r = i / wp, c = i - r * wp;
        const RowSrc<int8_t> from = c < w ? src(r) : RowSrc<int8_t>{nullptr, 0.f};
        dst[(size_t)r * ld + c] = __float2bfloat16_rn(
            from.p ? static_cast<float>(from.p[c]) * from.scale : 0.f);
      }
    };
    one(k_dst, ldk, k_rows, dk, k_src);
    one(v_dst, ldv, v_rows, dv, v_src);
  }
}

template <typename KV, bool PAGED>
__global__ void __launch_bounds__(THREADS, 2)
dattn_split_mma(const bf16* __restrict__ q, const KV* __restrict__ k,
                const KV* __restrict__ v, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ pos,
                const int* __restrict__ tables, float* __restrict__ acc_out,
                float2* __restrict__ stats, const Geom g) {
  launch_dependents();
  constexpr bool INT8 = sizeof(KV) == 1;
  constexpr int MT = MAX_TK / 16;  // 16-key row tiles of a tile, at most
  const int S = g.S, H = g.H, L = g.L, d = g.d, dv = g.dv, TK = g.TK;
  const int bh = blockIdx.x;
  const int tile = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = tile * TK;
  int n_vis = 0;
  for (int l = 0; l < L; ++l) n_vis = max(n_vis, min(pos[b * L + l] + 1, g.M));
  if (t0 >= n_vis) return;
  const int jmax = min(TK, n_vis - t0);
  const int nmt = (jmax + 15) / 16;  // row tiles holding a visible key

  extern __shared__ __align__(16) unsigned char smem[];
  const SmemMma lay(S, TK, d, dv);
  const int ldk = lay.ldk, ldv = lay.ldv, ldp = lay.ldp;
  bf16* q_sh = reinterpret_cast<bf16*>(smem);
  bf16* k_sh = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* v_sh = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* p_sh = reinterpret_cast<bf16*>(smem + lay.p);
  int* jl_sh = reinterpret_cast<int*>(smem + lay.jl);
  long long* row_sh = reinterpret_cast<long long*>(smem + lay.rows);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = pad16(d);
  const int tk_shift = __ffs(TK) - 1;

  // 1. each query row's visible keys in the tile (rows past L: none);
  //    the queries (zero past L and d), the K tile of every stream and the
  //    V tile, all in flight together: each thread finds the storage row
  //    of the rows it copies itself (rows past the tile's last visible
  //    key: zeros)
  if (tid < MAX_L) jl_sh[tid] = tid < L ? min(TK, min(pos[b * L + tid] + 1, g.M) - t0) : 0;
  // paged: the tile's storage rows, one table read a key, shared by the
  // copies of all streams (contiguous: computed in place)
  if constexpr (PAGED) {
    if (tid < jmax) row_sh[tid] = key_row<true>(g, tables, b, h, t0 + tid);
    __syncthreads();
  }
  auto store_row = [&](int j) {
    return PAGED ? row_sh[j] : key_row<false>(g, tables, b, h, t0 + j);
  };
  const size_t kstride = (size_t)g.NP * H * g.PS;
  auto q_row = [&](int r) {
    const int s = r >> 3, l = r & 7;
    return RowSrc<bf16>{l < L ? q + ((((size_t)s * g.B + b) * L + l) * H + h) * d : nullptr,
                        0.f};
  };
  auto k_row = [&](int r) {
    const int s = r >> tk_shift, j = r & (TK - 1);
    if (j >= jmax) return RowSrc<KV>{nullptr, 0.f};
    const size_t row = s * kstride + store_row(j);
    return RowSrc<KV>{k + row * d, INT8 ? ks[row] : 0.f};
  };
  auto v_row = [&](int j) {
    if (j >= jmax) return RowSrc<KV>{nullptr, 0.f};
    const size_t row = store_row(j);
    return RowSrc<KV>{v + row * dv, INT8 ? vs[row] : 0.f};
  };
  if (g.qvec)
    tile_copy<true>(q_sh, ldk, S * 8, d, q_row);
  else
    tile_copy<false>(q_sh, ldk, S * 8, d, q_row);
  if constexpr (INT8) {
    if (g.vec)
      tiles_int8<true>(k_sh, ldk, S * TK, d, k_row, v_sh, ldv, TK, dv, v_row);
    else
      tiles_int8<false>(k_sh, ldk, S * TK, d, k_row, v_sh, ldv, TK, dv, v_row);
  } else {
    if (g.vec) {
      tile_copy<true>(k_sh, ldk, S * TK, d, k_row);
      tile_copy<true>(v_sh, ldv, TK, dv, v_row);
    } else {
      tile_copy<false>(k_sh, ldk, S * TK, d, k_row);
      tile_copy<false>(v_sh, ldv, TK, dv, v_row);
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // 2. warp s: scores^T = K_s Q_s^T (keys as rows, the 8 query rows as
  //    columns), masked and scaled; each row's max and sum over the tile
  //    by shuffles across the 8 key lanes; p rounded to bf16 into
  //    p_sh[s][row][key]
  const int NS = g.NS;
  const int SL = S * L;
  const int g8 = lane >> 2;       // key lane: keys g8, g8 + 8 of a row tile
  const int r0 = (lane & 3) * 2;  // query rows r0, r0 + 1
  for (int s = warp; s < S; s += WARPS) {
    float sc[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
    const bf16* a_row = k_sh + ((size_t)s * TK + (lane & 15)) * ldk + (lane >> 4) * 8;
    const bf16* b_row = q_sh + ((size_t)s * 8 + (lane & 7)) * ldk + ((lane >> 3) & 1) * 8;
    for (int kk = 0; kk < dp; kk += 16) {
      unsigned bq[2];
      ldsm2(bq, b_row + kk);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < nmt) {
          unsigned a[4];
          ldsm4(a, a_row + (size_t)i * 16 * ldk + kk);
          mma16816(sc[i], a, bq[0], bq[1]);
        }
      }
    }
    const int jl0 = jl_sh[r0], jl1 = jl_sh[r0 + 1];
    float m0 = NEG_INF, m1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = i * 16 + g8 + hf * 8;
        const bool live = i < nmt;
        sc[i][2 * hf] = live && j < jl0 ? sc[i][2 * hf] * g.scale : NEG_INF;
        sc[i][2 * hf + 1] = live && j < jl1 ? sc[i][2 * hf + 1] * g.scale : NEG_INF;
        m0 = fmaxf(m0, sc[i][2 * hf]);
        m1 = fmaxf(m1, sc[i][2 * hf + 1]);
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
    bf16* p0_row = p_sh + ((size_t)s * 8 + r0) * ldp;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < nmt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = i * 16 + g8 + hf * 8;
          const float p0 = j < jl0 ? expf(sc[i][2 * hf] - m0) : 0.f;
          const float p1 = j < jl1 ? expf(sc[i][2 * hf + 1] - m1) : 0.f;
          l0 += p0;
          l1 += p1;
          p0_row[j] = __float2bfloat16_rn(p0);
          p0_row[ldp + j] = __float2bfloat16_rn(p1);
        }
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    // a row that sees no key of this tile writes no record (the combine
    // never reads it)
    if (g8 == 0) {
      if (r0 < L && jl0 > 0)
        stats[stat_index(bh, s * L + r0, tile, NS, SL)] = make_float2(m0, l0);
      if (r0 + 1 < L && jl1 > 0)
        stats[stat_index(bh, s * L + r0 + 1, tile, NS, SL)] = make_float2(m1, l1);
    }
  }
  __syncthreads();

  // 3. acc_s^T = V^T P_s^T, one (stream, 16 output columns) item a warp
  //    step: V fragments by ldmatrix.trans, P_s fragments by ldmatrix,
  //    over the row tiles holding a visible key
  const bf16* v_frag = v_sh + (size_t)((lane & 7) + ((lane >> 4) << 3)) * ldv
                       + ((lane >> 3) & 1) * 8;
  const int nct = pad16(dv) / 16;
  for (int item = warp; item < S * nct; item += WARPS) {
    const int s = item / nct, ct = item - s * nct;
    const bf16* p_frag = p_sh + ((size_t)s * 8 + (lane & 7)) * ldp + ((lane >> 3) & 1) * 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < nmt) {
        unsigned a[4], pb[2];
        ldsm4t(a, v_frag + (size_t)i * 16 * ldv + ct * 16);
        ldsm2(pb, p_frag + i * 16);
        mma16816(acc, a, pb[0], pb[1]);
      }
    }
    // lane: columns 16 ct + g8 (acc[0..1]) and + 8 (acc[2..3]) of rows
    // r0, r0 + 1
    const int e = ct * 16 + g8;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + rr;
      if (r < L && jl_sh[r] > 0) {
        float* rec = acc_out + acc_index(bh, tile, s * L + r, NS, SL, dv);
        if (e < dv) rec[e] = acc[rr];
        if (e + 8 < dv) rec[e + 8] = acc[2 + rr];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the combine, both dtypes
// ---------------------------------------------------------------------------

// One block per (b*H + h, row l, CT output columns), a thread a column.
// For each stream a thread reads the row's visible tiles' statistics and
// its column's accumulators, eight tiles at a time with independent loads
// (every load at once when the row sees at most eight tiles), takes the
// max, then sums the weights and the weighted accumulators in tile order.
// The order of every sum depends on the row's own position only, so row
// l of an L-row call combines as the single-row call does.
template <typename T>
__global__ void __launch_bounds__(CT)
dattn_combine(const float* __restrict__ acc, const float2* __restrict__ stats,
              const int* __restrict__ pos, const float* __restrict__ coeffs,
              T* __restrict__ out, const Geom g) {
  constexpr int U = 8;  // tiles a thread loads at once
  const int S = g.S, H = g.H, L = g.L, dv = g.dv, TK = g.TK, NS = g.NS;
  const int SL = S * L;
  const int bh = blockIdx.x;
  const int l = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int e = blockIdx.z * CT + threadIdx.x;
  if (e >= dv) return;
  const int n_vis = min(pos[b * L + l] + 1, g.M);
  const int nt = n_vis > 0 ? (n_vis + TK - 1) / TK : 0;  // visible tiles
  const size_t step = (size_t)SL * dv;  // one tile's accumulators
  grid_dependency_wait();  // the split kernel's records are complete
  float o = 0.f;
#pragma unroll
  for (int s = 0; s < MAX_S; ++s) {
    if (s >= S) break;
    const int sl = s * L + l;
    const float* rec = acc + acc_index(bh, 0, sl, NS, SL, dv) + e;
    const float2* st = stats + stat_index(bh, sl, 0, NS, SL);
    float mx = NEG_INF, ls = 0.f, a = 0.f;
    if (nt <= U) {
      float x[U];
      float2 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < nt) {
          x[u] = rec[u * step];
          w[u] = st[u];
          mx = fmaxf(mx, w[u].x);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < nt) {
          const float f = expf(w[u].x - mx);
          ls = fmaf(w[u].y, f, ls);
          a = fmaf(x[u], f, a);
        }
      }
    } else {
      for (int t = 0; t < nt; t += U) {
        float m[U];
#pragma unroll
        for (int u = 0; u < U; ++u) m[u] = t + u < nt ? st[t + u].x : NEG_INF;
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, m[u]);
      }
      for (int t = 0; t < nt; t += U) {
        float x[U];
        float2 w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (t + u < nt) {
            x[u] = rec[(t + u) * step];
            w[u] = st[t + u];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (t + u < nt) {
            const float f = expf(w[u].x - mx);
            ls = fmaf(w[u].y, f, ls);
            a = fmaf(x[u], f, a);
          }
        }
      }
    }
    o += (a / fmaxf(ls, 1e-30f)) * coeffs[s * H + h];
  }
  out[(((size_t)b * L + l) * H + h) * dv + e] = from_f<T>(o);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Shared memory of one block: the tensor-core layout for bf16 queries,
// the SIMT layout (at MAX_L rows) for fp32.
size_t smem_bytes(bool mma, int S, int L, int TK, int d, int dv) {
  return mma ? SmemMma(S, TK, d, dv).total : SmemSimt(S, L, TK, d, dv).total;
}

// The tile lengths a call may ask for: a power of two from 16 (tensor
// cores: whole 16-key row tiles) or 8 (SIMT) to MAX_TK whose block fits.
bool tile_ok(bool mma, int S, int TK, int d, int dv) {
  return TK >= (mma ? 16 : 8) && TK <= MAX_TK && (TK & (TK - 1)) == 0 &&
         smem_bytes(mma, S, MAX_L, TK, d, dv) <= MAX_SMEM;
}

// Pointers of one call.
struct Ptrs {
  const void *q, *k, *v, *ks, *vs, *pos, *tables, *coeffs;
  void *out, *work;
};

template <typename T, typename KV, bool PAGED>
int launch(const Ptrs& a, Geom g, cudaStream_t stream) {
  constexpr bool MMA = std::is_same<T, bf16>::value;
  const size_t bytes = smem_bytes(MMA, g.S, g.L, g.TK, g.d, g.dv);
  static bool opted_in = false;  // the whole sm_90 budget, asked for once
  if (!opted_in) {
    cudaError_t err;
    if constexpr (MMA)
      err = cudaFuncSetAttribute(dattn_split_mma<KV, PAGED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    else
      err = cudaFuncSetAttribute(dattn_split_simt<KV, PAGED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  // 16-byte loads when every K/V row starts 16-byte aligned: a bf16 row a
  // multiple of 8 values (one cp.async holds 8), an int8 row of 16 (one
  // load dequantizes into 16), an fp32 row of 4
  constexpr int VEC = sizeof(KV) == 1 ? 16 : sizeof(KV) == 2 ? 8 : 4;
  g.vec = g.d % VEC == 0 && g.dv % VEC == 0 &&
          reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  g.qvec = g.d % 8 == 0 && reinterpret_cast<uintptr_t>(a.q) % 16 == 0;
  float* acc = static_cast<float*>(a.work);
  float2* stats = reinterpret_cast<float2*>(acc + acc_floats(g));
  const dim3 grid(g.B * g.H, g.NS);
  if constexpr (MMA)
    dattn_split_mma<KV, PAGED><<<grid, THREADS, bytes, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const KV*>(a.k),
        static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
        static_cast<const int*>(a.tables), acc, stats, g);
  else
    dattn_split_simt<KV, PAGED><<<grid, THREADS, bytes, stream>>>(
        static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
        static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
        static_cast<const int*>(a.tables), acc, stats, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the combine may start while the split kernel runs (programmatic
  // dependent launch): its blocks wait for the split's results on the
  // device, so its launch latency hides behind the split
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.B * g.H, g.L, (g.dv + CT - 1) / CT);
  cfg.blockDim = dim3(CT);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, dattn_combine<T>, static_cast<const float*>(acc),
      static_cast<const float2*>(stats), static_cast<const int*>(a.pos),
      static_cast<const float*>(a.coeffs), static_cast<T*>(a.out), g));
}

template <typename T, typename KV>
int dispatch(const Ptrs& a, const Geom& g, bool paged, cudaStream_t s) {
  return paged ? launch<T, KV, true>(a, g, s) : launch<T, KV, false>(a, g, s);
}

bool valid(int S, int B, int L, int H, int M, int d, int dv) {
  return S >= 1 && S <= MAX_S && L >= 1 && L <= MAX_L && d >= 1 &&
         d <= MAX_D && dv >= 1 && dv <= MAX_DV && B >= 1 && H >= 1 && M >= 1;
}

}  // namespace

// Floats of device workspace decode_attention_run needs for these shapes
// and tile length (the per-tile accumulators, then their statistics), or
// -1 for shapes it refuses.
extern "C" int decode_attention_workspace(int S, int B, int L, int H, int M,
                                          int d, int dv, int TK) {
  if (!valid(S, B, L, H, M, d, dv) || TK < 8 || TK > MAX_TK) return -1;
  Geom g{};
  g.S = S; g.B = B; g.L = L; g.H = H; g.dv = dv;
  g.NS = (M + TK - 1) / TK;
  const size_t n = acc_floats(g) + 2 * (size_t)B * H * S * L * g.NS;
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// dtype: the type of q and out, 0 = float32 (the SIMT split body), 1 =
// bfloat16 (the tensor-core one). TK: keys per tile (the wrapper's
// decode_instance). kv_int8: K/V are int8 with fp32 scales (else of the
// dtype, scales ignored). paged: K/V are pages of page_size tokens
// (n_pages of them) reached through tables (B, pages_per_slot); else K/V
// hold n_pages cache rows of M tokens (tables ignored). ``work`` holds
// decode_attention_workspace(...) floats. Returns the CUDA error code of
// the launches.
extern "C" int decode_attention_run(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* tables,
    const void* coeffs, void* out, void* work, int S, int B, int L, int H,
    int M, int d, int dv, int TK, int n_pages, int page_size,
    int pages_per_slot, float scale, int dtype, int kv_int8, int paged,
    void* stream) {
  if (!valid(S, B, L, H, M, d, dv) || n_pages < 1 || (dtype != 0 && dtype != 1) ||
      !tile_ok(dtype == 1, S, TK, d, dv) ||
      (paged && (page_size < 1 || page_size * pages_per_slot != M)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.S = S; g.B = B; g.L = L; g.H = H; g.M = M; g.d = d; g.dv = dv;
  g.NP = n_pages;
  g.PS = paged ? page_size : M;
  g.PP = paged ? pages_per_slot : 1;
  g.TK = TK;
  g.NS = (M + TK - 1) / TK;
  g.scale = scale;
  g.vec = g.qvec = false;
  const Ptrs a{q, k, v, k_scale, v_scale, pos, tables, coeffs, out, work};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (kv_int8 ? 1 : 0)) {
    case 0: return dispatch<float, float>(a, g, paged, s);
    case 1: return dispatch<float, int8_t>(a, g, paged, s);
    case 2: return dispatch<bf16, bf16>(a, g, paged, s);
    default: return dispatch<bf16, int8_t>(a, g, paged, s);
  }
}
