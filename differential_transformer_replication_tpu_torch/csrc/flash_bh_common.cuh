// Shared by the head-major attention sources (flash_bh.cu: K2-K4;
// flash_bh_fwd.cu: K1): tile sizes and limits, the dropout counter hash,
// 16-byte staging into shared memory, the tile products (bf16 WMMA or
// fp32 SIMT) and the launch helpers. Each source includes it once, so
// everything here is in an anonymous namespace of that source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "smem_opt_in.cuh"

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int BQ = 32;  // query rows per tile
constexpr int BK = 32;  // keys per tile: one per lane in the row passes
constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;  // rows a warp owns in the row passes
constexpr int MAX_SC = 4;  // streams a block holds in shared memory at once
constexpr int MAX_D = 128;
constexpr int MAX_DV = 256;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the most a block may take
constexpr int SC_LD = BK + 4;       // fp32 [BQ][BK] tiles
constexpr float NEG_INF = -1e30f;   // the JAX package's finite -inf (streams.py)

__host__ __device__ constexpr int round16(int w) { return (w + 15) & ~15; }

// leading dimension of a shared-memory tile of width w: a multiple of 8
// elements for bf16 WMMA operands (+8 breaks bank alignment of rows), of 4
// floats for fp32 tiles and WMMA accumulators
template <typename T> __host__ __device__ int ld_in(int w);
template <> __host__ __device__ int ld_in<bf16>(int w) { return round16(w) + 8; }
template <> __host__ __device__ int ld_in<float>(int w) { return round16(w) + 4; }
__host__ __device__ inline int ld_acc(int w) { return round16(w) + 4; }

// carves 128-byte-aligned buffers out of dynamic shared memory; with a
// null base it only counts bytes (the host's size computation)
struct Carve {
  unsigned char* base;
  size_t off = 0;
  template <typename U> __host__ __device__ U* take(size_t n) {
    off = (off + 127) & ~size_t(127);
    U* p = base ? reinterpret_cast<U*>(base + off) : nullptr;
    off += n * sizeof(U);
    return p;
  }
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// dropout: the JAX package's counter hash (ops/flash.py:_fmix32,
// dropout_keep_ids), uint32 arithmetic wrapping mod 2^32
// ---------------------------------------------------------------------------

struct Drop {
  uint32_t w0, w1m, threshold;  // w1m = w1 * 0x9E3779B1
  float inv_keep;               // float32(1 / (1 - rate))
  int on;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t stream_key(const Drop& dr, int bh, int s) {
  return fmix32(dr.w0 ^ ((uint32_t)bh * 0x9E3779B1u) ^ ((uint32_t)s * 0x27D4EB2Fu));
}

__device__ __forceinline__ bool keep_bit(const Drop& dr, uint32_t key, int row, int col) {
  const uint32_t x = ((uint32_t)row * 0x85EBCA77u) ^ ((uint32_t)col * 0xC2B2AE3Du);
  return fmix32(fmix32(x + key) ^ dr.w1m) >= dr.threshold;
}

// ---------------------------------------------------------------------------
// staging and tile products
// ---------------------------------------------------------------------------

// rows [t0, t0 + rows) of a (T_len, w) row-major slab into dst[rows][ld],
// zero past T_len and in the padding columns [w, round16(w)). Where w
// holds whole 16-byte vectors (every width of the slice), each thread
// starts STAGE_UNROLL 16-byte loads before it stores any, so a tile's
// loads are in flight together; else one element at a time.
constexpr int STAGE_UNROLL = 4;

template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* __restrict__ src,
                                      int T_len, int t0, int rows, int w) {
  constexpr int VEC = 16 / sizeof(T);
  const int wp = round16(w);
  if (w % VEC == 0) {
    const int wv = wp / VEC, n = rows * wv;
    for (int base = threadIdx.x; base < n; base += THREADS * STAGE_UNROLL) {
      uint4 val[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = base + u * THREADS;
        const int r = i / wv, c = (i - r * wv) * VEC, t = t0 + r;
        val[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < n && t < T_len && c < w)
          val[u] = *reinterpret_cast<const uint4*>(src + (size_t)t * w + c);
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < n) {
          const int r = i / wv, c = (i - r * wv) * VEC;
          *reinterpret_cast<uint4*>(dst + r * ld + c) = val[u];
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * wp; i += THREADS) {
    const int r = i / wp, c = i - r * wp;
    const int t = t0 + r;
    dst[r * ld + c] = (t < T_len && c < w) ? src[(size_t)t * w + c] : from_f<T>(0.f);
  }
}

// C[M][N] (fp32, row-major, ldc; shared or global) = (ACC ? C : 0) + A B
// with A (M x K) read as A[m*lda + k] (A_ROW) or A[k*lda + m], and B (K x
// N) read as B[k*ldb + n] (B_ROW) or B[n*ldb + k]. M, N, K are multiples
// of 16. Called by the whole block; a C tile belongs to one warp (bf16) or
// a C element to one thread (fp32), the same one at every call.
template <bool A_ROW, bool B_ROW, bool ACC>
__device__ __forceinline__ void mm(float* C, int ldc, const bf16* A, int lda,
                                   const bf16* B, int ldb, int M, int N, int K) {
  using LA = std::conditional_t<A_ROW, wm::row_major, wm::col_major>;
  using LB = std::conditional_t<B_ROW, wm::row_major, wm::col_major>;
  const int warp = threadIdx.x >> 5;
  const int tn = N / 16, tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += NWARPS) {
    const int i = (t / tn) * 16, j = (t % tn) * 16;
    wm::fragment<wm::accumulator, 16, 16, 16, float> c;
    if (ACC)
      wm::load_matrix_sync(c, C + (size_t)i * ldc + j, ldc, wm::mem_row_major);
    else
      wm::fill_fragment(c, 0.f);
    for (int k = 0; k < K; k += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, LA> a;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, LB> b;
      wm::load_matrix_sync(a, A_ROW ? A + i * lda + k : A + k * lda + i, lda);
      wm::load_matrix_sync(b, B_ROW ? B + k * ldb + j : B + j * ldb + k, ldb);
      wm::mma_sync(c, a, b, c);
    }
    wm::store_matrix_sync(C + (size_t)i * ldc + j, c, ldc, wm::mem_row_major);
  }
}

template <bool A_ROW, bool B_ROW, bool ACC>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A, int lda,
                                   const float* B, int ldb, int M, int N, int K) {
  for (int e = threadIdx.x; e < M * N; e += THREADS) {
    const int m = e / N, n = e - m * N;
    float acc = ACC ? C[(size_t)m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k) {
      const float a = A_ROW ? A[m * lda + k] : A[k * lda + m];
      const float b = B_ROW ? B[k * ldb + n] : B[n * ldb + k];
      acc = fmaf(a, b, acc);
    }
    C[(size_t)m * ldc + n] = acc;
  }
}

bool shapes_ok(int S, int BH, int T_len, int H, int d, int dv) {
  return S >= 1 && BH > 0 && T_len > 0 && H > 0 && BH % H == 0 && d > 0 && d <= MAX_D &&
         dv > 0 && dv <= MAX_DV;
}

Drop make_drop(unsigned w0, unsigned w1, unsigned threshold, float inv_keep, int on) {
  return Drop{w0, w1 * 0x9E3779B1u, threshold, inv_keep, on};
}

// the most streams per pass (<= MAX_SC) whose shared memory fits, and its
// bytes; 0 when not even one stream fits. ``more``: the layout's own
// arguments after (S, sc, d, dv)
template <typename Smem, typename... More>
int streams_per_pass(int S, int d, int dv, size_t* smem, More... more) {
  for (int sc = S < MAX_SC ? S : MAX_SC; sc >= 1; --sc) {
    *smem = Smem(nullptr, S, sc, d, dv, more...).bytes;
    if (*smem <= SMEM_LIMIT) return sc;
  }
  return 0;
}

}  // namespace
