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
// ~2*L*(S*d + S*dv) flops per position, far below the tensor-core rate.
// The design reads each visible (b, h) tile ONCE for all L rows and all
// S streams and skips tiles past every row's position outright, keeps
// the per-(stream, row) softmax statistics in fp32, and applies the
// combine coefficients in-kernel, so no score or probability map ever
// reaches device memory.
//
// Two kernels. The split kernel runs one block per (b, h, tile of TK
// keys) — 64 keys at the recipe's widths, halved on the host until a
// tile fits the shared memory. Keys are visited in LOGICAL order in
// tiles of TK whatever the storage: through a page table a tile is cut
// into runs at page boundaries (pages smaller than the tile: several
// runs; larger: part of one page), each run one contiguous stretch of
// device memory. So on the same cache contents the paged instance does
// the contiguous instance's arithmetic bit for bit, and the row-l
// output of the L-row instance is the L = 1 instance's output at
// pos[b, l] whenever both choose the same tile length. The block copies
// each run into shared memory with coalesced 16-byte loads, a batch in
// flight per thread; the int8 instance dequantizes inside that copy —
// float(q8) * scale rounded to T, where the TPU kernel does it — so the
// tile in shared memory is the float instance's tile. Scores come from
// shared memory (a warp per (stream, row, key), lanes over the head
// width, four keys per warp in flight; d = 96 and dv = 192 are looped,
// never padded), then one warp per (stream, row) takes the tile's max
// and sum, and each thread accumulates p @ V for up to two output
// columns and all S streams of a row in fp32. The block writes, per
// (stream, row), the tile's max, sum and unnormalized accumulator. The
// combine kernel (one block per (b, h)) rescales each row's visible
// tiles to their common max, sums them, divides by the summed weights
// and applies the coefficients: sum_s c[s,h] * acc_s / l_s. As in the
// TPU kernel, each stream's probabilities are rounded to T before the
// PV product and the streams are combined only at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TK = 64;    // keys per tile (two per lane in the softmax)
constexpr int MAX_S = 8;      // streams
constexpr int MAX_L = 8;      // query rows per slot (the verify step's k + 1)
constexpr int MAX_D = 256;    // q/k head width
constexpr int MAX_EPT = 2;    // output columns per thread: dv <= 512
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the value a probability takes once cast to T (the TPU kernel's
// p.astype(v.dtype) before the PV product)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
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

constexpr int BATCH = 8;  // 16-byte loads each thread keeps in flight

// Copy n contiguous elements of src into shared memory unchanged. With
// vec (16-byte aligned, n a multiple of the vector) each thread starts
// all of its 16-byte loads of a batch before storing any, so a block
// keeps the whole batch in flight, and each vector is one 16-byte store;
// otherwise the scalar loop keeps any width correct.
template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst,
                                      const T* __restrict__ src, int n,
                                      bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    const int n4 = n / VEC;
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
// scale per row) dequantized into T in shared memory, float(q8) * scale
// rounded to T. With vec (width a multiple of 16, src 16-byte aligned)
// a thread loads 16 values per 16-byte load, all of one row.
template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst,
                                      const int8_t* __restrict__ src,
                                      const float* __restrict__ scl, int n,
                                      int width, bool vec) {
  if (vec) {
    constexpr int OUT4 = 16 * sizeof(T) / 16;  // 16-byte stores per load
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
            T t[16];
            uint4 w[OUT4];
          } buf;
          const int8_t* q8 = reinterpret_cast<const int8_t*>(&r[u]);
#pragma unroll
          for (int t = 0; t < 16; ++t)
            buf.t[t] = from_f<T>(static_cast<float>(q8[t]) * sc[u]);
#pragma unroll
          for (int w = 0; w < OUT4; ++w) dst4[i * OUT4 + w] = buf.w[w];
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS)
      dst[i] = from_f<T>(static_cast<float>(src[i]) * scl[i / width]);
  }
}

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Byte offsets of one block's shared memory: the queries (S*L*d fp32),
// the K tile (S*TK rows of d, type T), the V tile (TK*dv, type T), the
// scores/probabilities (S*L*TK fp32), per (stream, row) the tile's max
// and sum (2*S*L fp32), and each row's visible key count in the tile (L
// ints). All of it is dynamic, so the opt-in below can ask for the
// whole budget.
struct Smem {
  size_t k, v, p, stats, rows, total;
  __host__ __device__ Smem(int S, int L, int TK, int d, int dv, size_t es) {
    k = align16((size_t)S * L * d * 4);
    v = align16(k + (size_t)S * TK * d * es);
    p = align16(v + (size_t)TK * dv * es);
    stats = p + (size_t)S * L * TK * 4;
    rows = stats + 2 * (size_t)S * L * 4;
    total = rows + (size_t)L * 4;
  }
};

// Partial results: for each (b*H + h, tile, stream*L + row) a record of
// dv + 2 floats — the unnormalized accumulator, then the tile's max and
// sum.
__host__ __device__ inline size_t rec_index(int bh, int tile, int sl, int NS,
                                            int SL, int dv) {
  return (((size_t)bh * NS + tile) * SL + sl) * (dv + 2);
}

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
  bool vec;
};

template <typename T, typename KV, bool PAGED, int LMAX>
__global__ void __launch_bounds__(THREADS)
dattn_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                   const KV* __restrict__ v, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ pos,
                   const int* __restrict__ tables, float* __restrict__ part,
                   const Geom g) {
  constexpr bool INT8 = sizeof(KV) == 1;
  const int S = g.S, H = g.H, d = g.d, dv = g.dv, TK = g.TK;
  const int L = LMAX == 1 ? 1 : g.L;
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
  const Smem lay(S, L, TK, d, dv, sizeof(T));
  float* q_sh = reinterpret_cast<float*>(smem);
  T* k_sh = reinterpret_cast<T*>(smem + lay.k);
  T* v_sh = reinterpret_cast<T*>(smem + lay.v);
  float* p_sh = reinterpret_cast<float*>(smem + lay.p);  // scores, then p
  float* m_sh = reinterpret_cast<float*>(smem + lay.stats);  // tile max
  float* l_sh = m_sh + S * L;                                // tile sum
  int* jl_sh = reinterpret_cast<int*>(smem + lay.rows);      // per-row keys
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // keys of this tile row l sees (<= 0: none)
  auto row_keys = [&](int l) {
    return LMAX == 1 ? jmax : jl_sh[l];
  };

  // 1. this slot's queries, each row's visible count, and the tile: each
  //    run of keys on one page is one contiguous stretch of device memory
  for (int i = tid; i < S * L * d; i += THREADS) {
    const int sl = i / d, e = i % d;
    const int s = sl / L, l = sl % L;
    q_sh[i] = to_f(q[((((size_t)s * g.B + b) * L + l) * H + h) * d + e]);
  }
  if (LMAX > 1 && tid < L) jl_sh[tid] = min(TK, min(pos[b * L + tid] + 1, g.M) - t0);
  for (int j = 0; j < jmax;) {
    const int m = t0 + j;
    const int page = PAGED ? tables[(size_t)b * g.PP + m / g.PS] : b;
    const int off = PAGED ? m % g.PS : m;
    const int run = PAGED ? min(jmax - j, g.PS - off) : jmax;
    for (int s = 0; s < S; ++s) {
      const size_t row = (((size_t)s * g.NP + page) * H + h) * g.PS + off;
      if constexpr (INT8)
        stage(k_sh + ((size_t)s * TK + j) * d,
              reinterpret_cast<const int8_t*>(k) + row * d, ks + row,
              run * d, d, g.vec);
      else
        stage(k_sh + ((size_t)s * TK + j) * d,
              reinterpret_cast<const T*>(k) + row * d, run * d, g.vec);
    }
    const size_t vrow = ((size_t)page * H + h) * g.PS + off;
    if constexpr (INT8)
      stage(v_sh + (size_t)j * dv, reinterpret_cast<const int8_t*>(v) + vrow * dv,
            vs + vrow, run * dv, dv, g.vec);
    else
      stage(v_sh + (size_t)j * dv, reinterpret_cast<const T*>(v) + vrow * dv,
            run * dv, g.vec);
    j += run;
  }
  __syncthreads();

  // 2. scaled scores: one warp per (stream, row, key), lanes over the
  //    head width, KPW keys per warp in flight. Score idx = (s*L + l)*TK
  //    + j; TK is a power of two (tile_keys), so j and the (stream, row)
  //    pair come from a mask and a shift, and only L > 1 divides (by L)
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
      if (idx < SLT && j < row_keys(sl % L)) {
        const T* kr = k_sh + (size_t)((sl / L) * TK + j) * d;
        const float* qr = q_sh + sl * d;
        for (int e = lane; e < d; e += 32) dot[u] = fmaf(qr[e], to_f(kr[e]), dot[u]);
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
          p_sh[idx] = j < row_keys((idx >> tk_shift) % L) ? dot[u] * g.scale
                                                           : NEG_INF;
        }
      }
    }
  }
  __syncthreads();

  // 3. the tile's softmax numerators, max and sum, one warp per (stream,
  //    row); a row that sees no key of this tile is skipped (the combine
  //    never reads its record)
  for (int sl = warp; sl < S * L; sl += WARPS) {
    if (row_keys(sl % L) <= 0) continue;
    const bool has0 = lane < TK, has1 = lane + 32 < TK;
    const float a0 = has0 ? p_sh[sl * TK + lane] : NEG_INF;
    const float a1 = has1 ? p_sh[sl * TK + lane + 32] : NEG_INF;
    const float m = warp_max(fmaxf(a0, a1));
    const float p0 = has0 ? expf(a0 - m) : 0.f;
    const float p1 = has1 ? expf(a1 - m) : 0.f;
    const float l = warp_sum(p0 + p1);
    if (has0) p_sh[sl * TK + lane] = round_to<T>(p0);
    if (has1) p_sh[sl * TK + lane + 32] = round_to<T>(p1);
    if (lane == 0) {
      m_sh[sl] = m;
      l_sh[sl] = l;
    }
  }
  __syncthreads();

  // 4. acc_s = p_s @ V_tile per row for up to two columns per thread, V
  //    read once for all S streams of a row; write the tile's records
  const int NS = g.NS;
  const int SL = S * L;
#pragma unroll
  for (int c = 0; c < MAX_EPT; ++c) {
    const int e = tid + c * THREADS;
    if (e < dv) {
      for (int l = 0; l < L; ++l) {
        const int jl = row_keys(l);
        if (jl <= 0) continue;
        float acc[MAX_S];
#pragma unroll
        for (int s = 0; s < MAX_S; ++s) acc[s] = 0.f;
        for (int j = 0; j < jl; ++j) {
          const float vv = to_f(v_sh[(size_t)j * dv + e]);
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < S) acc[s] = fmaf(p_sh[(s * L + l) * TK + j], vv, acc[s]);
        }
#pragma unroll
        for (int s = 0; s < MAX_S; ++s)
          if (s < S) part[rec_index(bh, tile, s * L + l, NS, SL, dv) + e] = acc[s];
      }
    }
  }
  if (tid < SL && row_keys(tid % L) > 0) {
    float* rec = part + rec_index(bh, tile, tid, NS, SL, dv);
    rec[dv] = m_sh[tid];
    rec[dv + 1] = l_sh[tid];
  }
}

template <typename T, int LMAX>
__global__ void __launch_bounds__(THREADS)
dattn_combine_kernel(const float* __restrict__ part, const int* __restrict__ pos,
                     const float* __restrict__ coeffs, T* __restrict__ out,
                     const Geom g) {
  const int S = g.S, H = g.H, dv = g.dv, TK = g.TK, NS = g.NS;
  const int L = LMAX == 1 ? 1 : g.L;
  const int SL = S * L;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
#pragma unroll
  for (int c = 0; c < MAX_EPT; ++c) {
    const int e = threadIdx.x + c * THREADS;
    if (e < dv) {
      for (int l = 0; l < L; ++l) {
        const int n_vis = min(pos[b * L + l] + 1, g.M);
        const int nt = n_vis > 0 ? (n_vis + TK - 1) / TK : 0;  // visible tiles
        float o = 0.f;
        for (int s = 0; s < S; ++s) {
          const int sl = s * L + l;
          float mx = NEG_INF;
          for (int t = 0; t < nt; ++t)
            mx = fmaxf(mx, part[rec_index(bh, t, sl, NS, SL, dv) + dv]);
          float lsum = 0.f, acc = 0.f;
          for (int t = 0; t < nt; ++t) {
            const float* rec = part + rec_index(bh, t, sl, NS, SL, dv);
            const float w = expf(rec[dv] - mx);
            lsum = fmaf(rec[dv + 1], w, lsum);
            acc = fmaf(rec[e], w, acc);
          }
          o += (acc / fmaxf(lsum, 1e-30f)) * coeffs[s * H + h];
        }
        out[(((size_t)b * L + l) * H + h) * dv + e] = from_f<T>(o);
      }
    }
  }
}

// Keys per tile: a power of two (the split kernel's score indexing
// relies on it), halved until the block's shared memory fits.
int tile_keys(int S, int L, int d, int dv, size_t es) {
  static_assert((MAX_TK & (MAX_TK - 1)) == 0, "MAX_TK must be a power of two");
  int TK = MAX_TK;
  while (TK > 8 && Smem(S, L, TK, d, dv, es).total > MAX_SMEM) TK /= 2;
  return TK;
}

// Pointers of one call.
struct Ptrs {
  const void *q, *k, *v, *ks, *vs, *pos, *tables, *coeffs;
  void *out, *work;
};

template <typename T, typename KV, bool PAGED, int LMAX>
int launch(const Ptrs& a, Geom g, cudaStream_t stream) {
  const size_t bytes = Smem(g.S, g.L, g.TK, g.d, g.dv, sizeof(T)).total;
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // the whole sm_90 budget, asked for once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        dattn_split_kernel<T, KV, PAGED, LMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  // 16-byte vector staging when every K/V row starts 16-byte aligned
  // and a 16-byte load holds whole elements of one row
  constexpr int VEC = 16 / sizeof(KV);
  g.vec = g.d % VEC == 0 && g.dv % VEC == 0 &&
          reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  float* part = static_cast<float*>(a.work);
  dattn_split_kernel<T, KV, PAGED, LMAX><<<dim3(g.B * g.H, g.NS), THREADS, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.pos),
      static_cast<const int*>(a.tables), part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dattn_combine_kernel<T, LMAX><<<g.B * g.H, THREADS, 0, stream>>>(
      part, static_cast<const int*>(a.pos), static_cast<const float*>(a.coeffs),
      static_cast<T*>(a.out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int dispatch(const Ptrs& a, const Geom& g, bool paged, cudaStream_t s) {
  if (g.L == 1)
    return paged ? launch<T, KV, true, 1>(a, g, s) : launch<T, KV, false, 1>(a, g, s);
  return paged ? launch<T, KV, true, MAX_L>(a, g, s)
               : launch<T, KV, false, MAX_L>(a, g, s);
}

bool valid(int S, int B, int L, int H, int M, int d, int dv) {
  return S >= 1 && S <= MAX_S && L >= 1 && L <= MAX_L && d >= 1 &&
         d <= MAX_D && dv >= 1 && dv <= MAX_EPT * THREADS && B >= 1 &&
         H >= 1 && M >= 1;
}

}  // namespace

// Floats of device workspace decode_attention_run needs for these shapes
// (the per-tile partial records), or -1 for shapes it refuses.
extern "C" int decode_attention_workspace(int S, int B, int L, int H, int M,
                                          int d, int dv, int dtype) {
  if (!valid(S, B, L, H, M, d, dv) || (dtype != 0 && dtype != 1)) return -1;
  const int TK = tile_keys(S, L, d, dv, dtype == 0 ? 4 : 2);
  const size_t n = (size_t)B * H * ((M + TK - 1) / TK) * S * L * (dv + 2);
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// dtype: the type of q and out, 0 = float32, 1 = bfloat16. kv_int8: K/V
// are int8 with fp32 scales (else of the dtype, scales ignored). paged:
// K/V are pages of page_size tokens (n_pages of them) reached through
// tables (B, pages_per_slot); else K/V hold n_pages cache rows of M
// tokens (tables ignored). ``work`` holds decode_attention_workspace(...)
// floats. Returns the CUDA error code of the launches.
extern "C" int decode_attention_run(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* tables,
    const void* coeffs, void* out, void* work, int S, int B, int L, int H,
    int M, int d, int dv, int n_pages, int page_size, int pages_per_slot,
    float scale, int dtype, int kv_int8, int paged, void* stream) {
  if (!valid(S, B, L, H, M, d, dv) || n_pages < 1 ||
      (paged && (page_size < 1 || page_size * pages_per_slot != M)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.S = S; g.B = B; g.L = L; g.H = H; g.M = M; g.d = d; g.dv = dv;
  g.NP = n_pages;
  g.PS = paged ? page_size : M;
  g.PP = paged ? pages_per_slot : 1;
  g.TK = tile_keys(S, L, d, dv, dtype == 0 ? 4 : 2);
  g.NS = (M + g.TK - 1) / g.TK;
  g.scale = scale;
  g.vec = false;
  const Ptrs a{q, k, v, k_scale, v_scale, pos, tables, coeffs, out, work};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (kv_int8 ? 1 : 0)) {
    case 0: return dispatch<float, float>(a, g, paged, s);
    case 1: return dispatch<float, int8_t>(a, g, paged, s);
    case 2: return dispatch<__nv_bfloat16, __nv_bfloat16>(a, g, paged, s);
    case 3: return dispatch<__nv_bfloat16, int8_t>(a, g, paged, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
