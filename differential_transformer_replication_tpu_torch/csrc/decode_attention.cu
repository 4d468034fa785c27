// Single-query multi-stream decode attention over the serving slot pool,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel differential_transformer_replication_tpu/ops/
// decode_attention.py:_dattn_fwd_kernel (via decode_attention), float KV.
// Layouts are the JAX package's head-major pool:
//   q (S, B, H, d), K (S, B, H, M, d), V (B, H, M, dv), pos (B,) int32,
//   coeffs (S, H) fp32  ->  out (B, H, dv)
// with q/K/V/out in one storage type T (float or bf16). Row b sees ring
// slot m iff m <= pos[b] (for pos >= M every slot holds a live key).
//
//   out[b, h] = sum_s coeffs[s, h] * softmax_m(q_s . K_s[m] / sqrt(d)) @ V
//
// What bounds it on the H100: the K and V rings. A decode step reads
// every visible key of every stream once (S*d + dv values per position)
// and does ~2*(S*d + S*dv) flops per position, far below the tensor-core
// rate, so the bound is the cache read. The design reads each visible
// (b, h) ring tile ONCE and skips tiles past pos[b] outright, keeps the
// S per-stream softmax statistics in fp32, and applies the combine
// coefficients in-kernel, so no score or probability map ever reaches
// device memory and V is loaded once for all S streams.
//
// Two kernels. The split kernel runs one block per (b, h, tile of TK
// keys) — 64 keys at the recipe's widths, halved on the host until a
// tile fits the shared memory — so a pool of B*H rows spreads over
// B*H*ceil(M/TK) blocks and tiles past pos[b] exit at once. Each tile of
// every stream's K and of V is one contiguous run of device memory (the
// head-major layout): the block copies it into shared memory unchanged
// with coalesced 16-byte loads and stores, a batch in flight per
// thread. Scores come from shared memory (a warp per (stream, key),
// lanes over the head width, four keys per warp in flight; the recipe's
// d = 96, dv = 192 are not powers of two and are looped, never padded),
// then one warp per stream takes the tile's max and sum, and each
// thread accumulates p @ V for up to two output columns and all S
// streams in fp32. The block writes, per stream, the tile's max, sum and
// unnormalized accumulator. The combine kernel (one block per (b, h))
// rescales the visible tiles to their common max, sums them, divides by
// the summed weights and applies the coefficients:
// sum_s c[s,h] * acc_s / l_s. As in the TPU kernel, each stream's
// probabilities are rounded to T before the PV product and the streams
// are combined only at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TK = 64;    // keys per tile (two per lane in the softmax)
constexpr int MAX_S = 8;      // streams
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
  constexpr int BATCH = 8;
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

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Byte offsets of one block's shared memory: q (S*d fp32), the K tile
// (S*TK rows of d, storage type), the V tile (TK*dv, storage type), the
// scores/probabilities (S*TK fp32), and per stream the tile's max and
// sum (2*S fp32). All of it is dynamic, so the opt-in below can ask for
// the whole budget.
struct Smem {
  size_t k, v, p, stats, total;
  __host__ __device__ Smem(int S, int TK, int d, int dv, size_t es) {
    k = align16((size_t)S * d * 4);
    v = align16(k + (size_t)S * TK * d * es);
    p = align16(v + (size_t)TK * dv * es);
    stats = p + (size_t)S * TK * 4;
    total = stats + 2 * (size_t)S * 4;
  }
};

// Partial results: for each (b*H + h, tile, stream) a record of dv + 2
// floats — the unnormalized accumulator, then the tile's max and sum.
__host__ __device__ inline size_t rec_index(int bh, int tile, int s, int NS,
                                            int S, int dv) {
  return (((size_t)bh * NS + tile) * S + s) * (dv + 2);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dattn_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos,
                   float* __restrict__ part, int S, int B, int H, int M,
                   int d, int dv, float scale, int TK, bool vec) {
  const int bh = blockIdx.x;
  const int tile = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t0 = tile * TK;
  // keys 0 .. n_vis-1 are visible; a tile past pos[b] is never loaded
  const int n_vis = min(pos[b] + 1, M);
  if (t0 >= n_vis) return;
  const int jmax = min(TK, n_vis - t0);

  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay(S, TK, d, dv, sizeof(T));
  float* q_sh = reinterpret_cast<float*>(smem);
  T* k_sh = reinterpret_cast<T*>(smem + lay.k);
  T* v_sh = reinterpret_cast<T*>(smem + lay.v);
  float* p_sh = reinterpret_cast<float*>(smem + lay.p);  // scores, then p
  float* m_sh = reinterpret_cast<float*>(smem + lay.stats);  // tile max
  float* l_sh = m_sh + S;                                    // tile sum
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. this row's queries and the tile: each stream's K rows and the V
  //    rows are one contiguous run of device memory each
  for (int i = tid; i < S * d; i += THREADS) {
    const int s = i / d, e = i % d;
    q_sh[i] = to_f(q[((size_t)(s * B + b) * H + h) * d + e]);
  }
  for (int s = 0; s < S; ++s)
    stage(k_sh + (size_t)s * TK * d,
          k + (((size_t)(s * B + b) * H + h) * M + t0) * d, jmax * d, vec);
  stage(v_sh, v + (((size_t)b * H + h) * M + t0) * dv, jmax * dv, vec);
  __syncthreads();

  // 2. scaled scores: one warp per (stream, key), lanes over the head
  //    width, KPW keys per warp in flight
  constexpr int KPW = 4;
  for (int base = warp * KPW; base < S * TK; base += WARPS * KPW) {
    float dot[KPW];
#pragma unroll
    for (int u = 0; u < KPW; ++u) {
      const int idx = base + u;
      const int s = idx / TK;
      const int j = idx - s * TK;
      dot[u] = 0.f;
      if (idx < S * TK && j < jmax) {
        const T* kr = k_sh + (size_t)(s * TK + j) * d;
        const float* qr = q_sh + s * d;
        for (int e = lane; e < d; e += 32) dot[u] = fmaf(qr[e], to_f(kr[e]), dot[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < KPW; ++u) dot[u] = warp_sum(dot[u]);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        const int idx = base + u;
        if (idx < S * TK) {
          const int j = idx - (idx / TK) * TK;
          p_sh[idx] = j < jmax ? dot[u] * scale : NEG_INF;
        }
      }
    }
  }
  __syncthreads();

  // 3. the tile's softmax numerators, max and sum, one warp per stream
  for (int s = warp; s < S; s += WARPS) {
    const bool has0 = lane < TK, has1 = lane + 32 < TK;
    const float a0 = has0 ? p_sh[s * TK + lane] : NEG_INF;
    const float a1 = has1 ? p_sh[s * TK + lane + 32] : NEG_INF;
    const float m = warp_max(fmaxf(a0, a1));
    const float p0 = has0 ? expf(a0 - m) : 0.f;
    const float p1 = has1 ? expf(a1 - m) : 0.f;
    const float l = warp_sum(p0 + p1);
    if (has0) p_sh[s * TK + lane] = round_to<T>(p0);
    if (has1) p_sh[s * TK + lane + 32] = round_to<T>(p1);
    if (lane == 0) {
      m_sh[s] = m;
      l_sh[s] = l;
    }
  }
  __syncthreads();

  // 4. acc_s = p_s @ V_tile for up to two columns per thread, V read
  //    once for all S streams; write the tile's records
  const int NS = gridDim.y;
#pragma unroll
  for (int c = 0; c < MAX_EPT; ++c) {
    const int e = tid + c * THREADS;
    if (e < dv) {
      float acc[MAX_S];
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) acc[s] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        const float vv = to_f(v_sh[(size_t)j * dv + e]);
#pragma unroll
        for (int s = 0; s < MAX_S; ++s)
          if (s < S) acc[s] = fmaf(p_sh[s * TK + j], vv, acc[s]);
      }
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        if (s < S) part[rec_index(bh, tile, s, NS, S, dv) + e] = acc[s];
    }
  }
  if (tid < S) {
    float* rec = part + rec_index(bh, tile, tid, NS, S, dv);
    rec[dv] = m_sh[tid];
    rec[dv + 1] = l_sh[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dattn_combine_kernel(const float* __restrict__ part, const int* __restrict__ pos,
                     const float* __restrict__ coeffs, T* __restrict__ out,
                     int S, int H, int M, int dv, int TK, int NS) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int n_vis = min(pos[b] + 1, M);
  const int nt = n_vis > 0 ? (n_vis + TK - 1) / TK : 0;  // visible tiles
#pragma unroll
  for (int c = 0; c < MAX_EPT; ++c) {
    const int e = threadIdx.x + c * THREADS;
    if (e < dv) {
      float o = 0.f;
      for (int s = 0; s < S; ++s) {
        float mx = NEG_INF;
        for (int t = 0; t < nt; ++t)
          mx = fmaxf(mx, part[rec_index(bh, t, s, NS, S, dv) + dv]);
        float l = 0.f, acc = 0.f;
        for (int t = 0; t < nt; ++t) {
          const float* rec = part + rec_index(bh, t, s, NS, S, dv);
          const float w = expf(rec[dv] - mx);
          l = fmaf(rec[dv + 1], w, l);
          acc = fmaf(rec[e], w, acc);
        }
        o += (acc / fmaxf(l, 1e-30f)) * coeffs[s * H + h];
      }
      out[((size_t)b * H + h) * dv + e] = from_f<T>(o);
    }
  }
}

int tile_keys(int S, int d, int dv, size_t es) {
  int TK = MAX_TK;
  while (TK > 8 && Smem(S, TK, d, dv, es).total > MAX_SMEM) TK /= 2;
  return TK;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           const void* coeffs, void* out, void* work, int S, int B, int H,
           int M, int d, int dv, float scale, cudaStream_t stream) {
  const int TK = tile_keys(S, d, dv, sizeof(T));
  const size_t bytes = Smem(S, TK, d, dv, sizeof(T)).total;
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // the whole sm_90 budget, asked for once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        dattn_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  // 16-byte vector staging when every K/V row starts 16-byte aligned
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = d % VEC == 0 && dv % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int NS = (M + TK - 1) / TK;
  float* part = static_cast<float*>(work);
  dattn_split_kernel<T><<<dim3(B * H, NS), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos), part, S, B, H,
      M, d, dv, scale, TK, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dattn_combine_kernel<T><<<B * H, THREADS, 0, stream>>>(
      part, static_cast<const int*>(pos), static_cast<const float*>(coeffs),
      static_cast<T*>(out), S, H, M, dv, TK, NS);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int S, int B, int H, int M, int d, int dv) {
  return S >= 1 && S <= MAX_S && d >= 1 && d <= MAX_D && dv >= 1 &&
         dv <= MAX_EPT * THREADS && B >= 1 && H >= 1 && M >= 1;
}

}  // namespace

// Floats of device workspace decode_attention_fwd needs for these
// shapes (the per-tile partial records), or -1 for shapes it refuses.
extern "C" int decode_attention_workspace(int S, int B, int H, int M, int d,
                                          int dv, int dtype) {
  if (!valid(S, B, H, M, d, dv) || (dtype != 0 && dtype != 1)) return -1;
  const int TK = tile_keys(S, d, dv, dtype == 0 ? 4 : 2);
  const size_t n = (size_t)B * H * ((M + TK - 1) / TK) * S * (dv + 2);
  return n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// dtype: 0 = float32, 1 = bfloat16. ``work`` holds
// decode_attention_workspace(...) floats. Returns the CUDA error code of
// the launches.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* pos,
                                    const void* coeffs, void* out, void* work,
                                    int S, int B, int H, int M, int d, int dv,
                                    float scale, int dtype, void* stream) {
  if (!valid(S, B, H, M, d, dv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k, v, pos, coeffs, out, work, S, B, H, M, d, dv, scale, s);
    case 1: return launch<__nv_bfloat16>(q, k, v, pos, coeffs, out, work, S, B, H, M, d, dv, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
