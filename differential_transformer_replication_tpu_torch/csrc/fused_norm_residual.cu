// Fused residual-add + LayerNorm backward for Hopper (sm_90a).
//
// Replaces the TPU kernel differential_transformer_replication_tpu/ops/
// fused_norm_residual.py:_addnorm_bwd_kernel (via _bwd_call). From the
// post-add activation x (M, E), the normalized output's cotangent gn and,
// for the add+ln2 in front of each FFN, the carry's cotangent gx (all in
// one storage type T, float or bf16), and the fp32 scale w (E,):
//   mean = sum(x) / E, c = x - mean, var = sum(c^2) / E,
//   denom = sqrt(var + eps), xhat = c / denom (a division, not rsqrt),
//   dxh = gn * w, m1 = sum(dxh) / E, m2 = sum(dxh * xhat) / E,
//   dx = (dxh - m1 - xhat * m2) / denom (+ gx), rounded to T once;
//   dw = sum over rows of gn * xhat, db = sum over rows of gn, in fp32.
//
// What bounds it on the H100: memory, and close behind it instruction
// throughput. It reads x, gn (and gx) once and writes dx once: at the
// recipe's (16384, 768) in bf16, 4 x 25.17 MB with the carry (30.05 us at
// 3.35 TB/s), 3 x 25.17 MB without (22.54 us); against that, each element
// takes ~20 fp32 operations, two of them quotients by the row's denom. A
// quotient through IEEE division is a subroutine with a range check and a
// branch, which left the kernel bound by instruction throughput in
// development runs; here each row takes one correctly rounded reciprocal
// of denom and each quotient one multiply and two FMAs (``quot`` below).
// The design:
//
// - warp instances (E a multiple of 8, E <= 32 * 8 * MAX_CHUNKS): one warp
//   per row. Lane l owns the same columns on every row, chunks of 8
//   elements at (c * 32 + l) * 8, c < C = ceil(E / 256) (24 elements at E
//   768), loaded as 16-byte vectors (one for bf16, two for fp32), all of a
//   row's loads of x, gn and gx in flight together, the next row's as soon
//   as this row's dx is stored. The four statistics are warp butterflies
//   (__shfl_xor_sync; m1 and m2 in one pass): no barrier on the row path,
//   and every lane ends with the same bits. w sits in shared memory (read
//   as float4), and the lane's dw/db partials (2 x 8C fp32) stay in
//   registers across all its rows. dx leaves as 16-byte stores.
// - a persistent grid: MINB blocks of 8 warps an SM (2 where a lane's raw
//   loads and partials fit in 128 registers, as at E 768 in bf16: 16
//   resident warps, each with a whole row's loads in flight, hide the
//   load latency; a register double buffer of the next row, or the
//   partials in shared memory, were slower in development runs), at most
//   one block per 8 rows; global warp g takes rows g, g + G, g + 2G, ...
//   (G warps in all), so neighbouring warps read neighbouring rows. The
//   grid is a function of M, E, T and the card's SM count alone.
// - a fixed-order finish, no float atomics: after its rows, each block
//   adds its 8 warps' partials in warp order through shared memory (the
//   space w held) and writes one (2E) fp32 row [dw | db]; a second
//   launch, one block of 32 warps per 32 columns, adds those rows in a
//   fixed order (warp v takes rows v, v + 32, ...; the 32 sums then in
//   warp order). Two calls on the same inputs give the same dx, dw and db
//   bit for bit.
// - the block instance (other widths): one block of 8 warps per row, rows
//   b, b + grid, ...; scalar loads, thread t owning columns t, t + 256, ...;
//   block sums by warp butterflies and one shared-memory step in warp
//   order; the thread's dw/db partials accumulate in the block's row of
//   the workspace (each column owned by one thread), which the same
//   finish adds.
//
// The instance is chosen by the wrapper (ops/fused_norm_residual.py:
// add_norm_bwd_instance) and passed in; the launcher refuses, and never
// reroutes, a call that breaks its conditions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

#include "smem_opt_in.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 8;          // elements of a chunk: one 16-byte bf16 load
constexpr int MAX_CHUNKS = 4;   // warp instances: E <= 32 * VEC * MAX_CHUNKS
constexpr int BLOCK_MINB = 2;   // block instance: blocks an SM
constexpr int FINISH_WARPS = 32; // warps of a finish block (32 columns)

// the instance codes shared with ops/fused_norm_residual.py:INSTANCES
enum Instance { BLOCK = 0, WARP = 1 };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// 16-byte words of a chunk of T
template <typename T> __host__ __device__ constexpr int words() { return sizeof(T) * VEC / 16; }

// blocks of the warp instance an SM: 2 where a lane's raw loads of x, gn,
// gx (4 registers a word) and its 2 x 8C partials fit in 96 registers, so
// the whole thread fits in 128
__host__ __device__ constexpr int warp_minb(int tsize, int C) {
  return (tsize * VEC / 16) * 4 * 3 * C + 2 * VEC * C <= 96 ? 2 : 1;
}

template <typename T> struct Chunk { uint4 w[words<T>()]; };

template <typename T>
__device__ __forceinline__ Chunk<T> ld_chunk(const T* p) {
  Chunk<T> c;
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < words<T>(); ++i) c.w[i] = __ldcs(q + i);
  return c;
}

__device__ __forceinline__ void unpack(const Chunk<float>& c, float* f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(c.w[i].x);
    f[4 * i + 1] = __uint_as_float(c.w[i].y);
    f[4 * i + 2] = __uint_as_float(c.w[i].z);
    f[4 * i + 3] = __uint_as_float(c.w[i].w);
  }
}

// bf16 -> fp32 is exact: the 16 bits become the high half
__device__ __forceinline__ void unpack(const Chunk<bf16>& c, float* f) {
  const unsigned u[4] = {c.w[0].x, c.w[0].y, c.w[0].z, c.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void st_chunk(float* p, const float* f) {
  float4* q = reinterpret_cast<float4*>(p);
  __stcs(q, make_float4(f[0], f[1], f[2], f[3]));
  __stcs(q + 1, make_float4(f[4], f[5], f[6], f[7]));
}

__device__ __forceinline__ unsigned bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ void st_chunk(bf16* p, const float* f) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(bf2(f[0], f[1]), bf2(f[2], f[3]), bf2(f[4], f[5]), bf2(f[6], f[7])));
}

// a chunk of w from shared memory
__device__ __forceinline__ void ld_w(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void st_acc(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// butterfly sums: every lane ends with the same bits (each step adds the
// same two values on both lanes of a pair)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

template <typename T, int C, bool HAS_GX>
__device__ __forceinline__ void ld_row(const T* x, const T* gn, const T* gx, size_t base,
                                       int lane, int E, Chunk<T> (&rx)[C], Chunk<T> (&rg)[C],
                                       Chunk<T> (&rgx)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < E) {
      rx[c] = ld_chunk(x + base + col);
      rg[c] = ld_chunk(gn + base + col);
      if (HAS_GX) rgx[c] = ld_chunk(gx + base + col);
    }
  }
}

// n / d from y = 1/d correctly rounded: q = n * y, then one FMA
// correction by the exact remainder n - d * q (the Newton-Markstein step
// that CUDA's IEEE division takes after its reciprocal estimate), which
// rounds the quotient correctly while n, d and the remainder stay clear
// of the exponent range's ends (fused_norm_residual_quot_check holds it
// to IEEE division bit for bit on the card). The row's 2 x 8C quotients
// by one denom then share one reciprocal instead of each taking a
// division's subroutine and its range check.
__device__ __forceinline__ float quot(float n, float d, float y) {
  const float q = n * y;
  return fmaf(fmaf(-d, q, n), y, q);
}

// smem: w (E) while the rows run, then the warps' partials [dw | db]
// (WARPS x 2E), written from the registers that held them over the rows
template <typename T, int C, bool HAS_GX>
__global__ void __launch_bounds__(THREADS, warp_minb(sizeof(T), C))
addnorm_bwd_warp(const T* __restrict__ x, const float* __restrict__ w,
                 const T* __restrict__ gn, const T* __restrict__ gx, T* __restrict__ dx,
                 float* __restrict__ part, int M, int E, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < E; i += THREADS) smem[i] = w[i];
  __syncthreads();

  const float fe = static_cast<float>(E);
  float aw[C][VEC], ab[C][VEC];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < VEC; ++k) aw[c][k] = ab[c][k] = 0.f;

  const int stride = gridDim.x * WARPS;
  int row = blockIdx.x * WARPS + warp;
  Chunk<T> rx[C], rg[C], rgx[C];
  if (row < M) ld_row<T, C, HAS_GX>(x, gn, gx, static_cast<size_t>(row) * E, lane, E, rx, rg, rgx);
  for (; row < M; row += stride) {
    const size_t base = static_cast<size_t>(row) * E;
    float xh[C][VEC];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if ((c * 32 + lane) * VEC < E) {
        unpack(rx[c], xh[c]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) s += xh[c][k];
      }
    }
    const float mean = warp_sum(s) / fe;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if ((c * 32 + lane) * VEC < E) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          xh[c][k] -= mean;
          q += xh[c][k] * xh[c][k];
        }
      }
    }
    const float denom = sqrtf(warp_sum(q) / fe + eps);
    const float y = __frcp_rn(denom);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < E) {
        float g[VEC], wv[VEC];
        unpack(rg[c], g);
        ld_w(smem + col, wv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          xh[c][k] = quot(xh[c][k], denom, y);
          const float d = g[k] * wv[k];
          a += d;
          b += d * xh[c][k];
          aw[c][k] += g[k] * xh[c][k];
          ab[c][k] += g[k];
        }
      }
    }
    warp_sum2(a, b);
    const float m1 = a / fe, m2 = b / fe;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < E) {
        float g[VEC], wv[VEC], r[VEC];
        unpack(rg[c], g);
        ld_w(smem + col, wv);
        if (HAS_GX) unpack(rgx[c], r);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = quot(g[k] * wv[k] - m1 - xh[c][k] * m2, denom, y);
          r[k] = HAS_GX ? v + r[k] : v;
        }
        st_chunk(dx + base + col, r);
      }
    }
    // the next row's loads (the other resident warps hide their latency)
    if (row + stride < M)
      ld_row<T, C, HAS_GX>(x, gn, gx, base + static_cast<size_t>(stride) * E, lane, E, rx, rg,
                           rgx);
  }

  __syncthreads();  // every warp is done with w
  float* slot = smem + static_cast<size_t>(warp) * 2 * E;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < E) {
      st_acc(slot + col, aw[c]);
      st_acc(slot + E + col, ab[c]);
    }
  }
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * E;
  for (int i = threadIdx.x; i < 2 * E; i += THREADS) {
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) t += smem[static_cast<size_t>(v) * 2 * E + i];
    out[i] = t;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// a block's sums of two values, each the warps' sums added in warp
// order; consecutive calls alternate between the two halves of ``red``,
// so each needs one barrier
__device__ __forceinline__ float2 block_sum2(float a, float b, float2 (*red)[WARPS], int& buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sum2(a, b);
  if (lane == 0) red[buf][warp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < WARPS; ++i) {
    t.x += red[buf][i].x;
    t.y += red[buf][i].y;
  }
  buf ^= 1;
  return t;
}

template <typename T, bool HAS_GX>
__global__ void __launch_bounds__(THREADS)
addnorm_bwd_block(const T* __restrict__ x, const float* __restrict__ w,
                  const T* __restrict__ gn, const T* __restrict__ gx, T* __restrict__ dx,
                  float* __restrict__ part, int M, int E, float eps) {
  __shared__ float2 red[2][WARPS];
  int buf = 0;
  const float fe = static_cast<float>(E);
  // this block's [dw | db] row; thread t owns columns t, t + THREADS, ...
  float* acc = part + static_cast<size_t>(blockIdx.x) * 2 * E;
  for (int i = threadIdx.x; i < E; i += THREADS) acc[i] = acc[E + i] = 0.f;
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * E;
    const T* xr = x + base;
    const T* gr = gn + base;
    float s = 0.f;
    for (int i = threadIdx.x; i < E; i += THREADS) s += to_f(xr[i]);
    const float mean = block_sum2(s, 0.f, red, buf).x / fe;
    float q = 0.f;
    for (int i = threadIdx.x; i < E; i += THREADS) {
      const float c = to_f(xr[i]) - mean;
      q += c * c;
    }
    const float denom = sqrtf(block_sum2(q, 0.f, red, buf).x / fe + eps);
    const float y = __frcp_rn(denom);
    float a = 0.f, b = 0.f;
    for (int i = threadIdx.x; i < E; i += THREADS) {
      const float xh = quot(to_f(xr[i]) - mean, denom, y);
      const float d = to_f(gr[i]) * w[i];
      a += d;
      b += d * xh;
    }
    const float2 m = block_sum2(a, b, red, buf);
    const float m1 = m.x / fe, m2 = m.y / fe;
    for (int i = threadIdx.x; i < E; i += THREADS) {
      const float xh = quot(to_f(xr[i]) - mean, denom, y);
      const float g = to_f(gr[i]);
      float v = quot(g * w[i] - m1 - xh * m2, denom, y);
      if (HAS_GX) v += to_f(gx[base + i]);
      dx[base + i] = from_f<T>(v);
      acc[i] += g * xh;
      acc[E + i] += g;
    }
  }
}

// out[i] = sum over the P rows of part[., i] in a fixed order: warp v of
// a block adds rows v, v + FINISH_WARPS, ... of the block's 32 columns,
// then the FINISH_WARPS sums are added in warp order
__global__ void __launch_bounds__(FINISH_WARPS * 32)
addnorm_bwd_finish(const float* __restrict__ part, float* __restrict__ out, int P, int W) {
  __shared__ float sums[FINISH_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (col < W) {
#pragma unroll 4
    for (int r = warp; r < P; r += FINISH_WARPS) a += part[static_cast<size_t>(r) * W + col];
  }
  sums[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && col < W) {
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < FINISH_WARPS; ++v) t += sums[v][lane];
    out[col] = t;
  }
}

// the check of ``quot`` against IEEE division: 64 pairs (a, b) a thread,
// made from a hash of their index and ``seed``: a of either sign and b
// positive, exponents within 2^+-60, significands uniform (mode 0), or a's
// within 2^16 ulps below 2 and b's within 2^16 ulps above 1 (mode 1: where
// a * y is farthest from a / b); adds to *bad the pairs whose quotients
// differ in any bit
__device__ __forceinline__ uint32_t mix(uint32_t v) {
  v ^= v >> 16;
  v *= 0x7feb352du;
  v ^= v >> 15;
  v *= 0x846ca68bu;
  return v ^ (v >> 16);
}

__global__ void quot_check_kernel(unsigned long long* bad, uint32_t seed, int mode) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned int n = 0;
  for (uint32_t i = 0; i < 64; ++i) {
    const uint32_t h1 = mix(tid * 64u + i + seed * 0x9e3779b9u), h2 = mix(h1 ^ 0x5bd1e995u);
    const uint32_t ea = 67 + (h1 >> 25) % 121, eb = 67 + (h2 >> 25) % 121;
    uint32_t ma = h1 & 0x7fffffu, mb = h2 & 0x7fffffu;
    if (mode == 1) {
      ma = 0x7fffffu - (ma & 0xffffu);
      mb &= 0xffffu;
    }
    const float a = __uint_as_float((h1 & 0x80000000u) | (ea << 23) | ma);
    const float b = __uint_as_float((eb << 23) | mb);
    n += __float_as_uint(quot(a, b, __frcp_rn(b))) != __float_as_uint(__fdiv_rn(a, b));
  }
  if (n) atomicAdd(bad, static_cast<unsigned long long>(n));
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

bool warp_ok(int E) { return E % VEC == 0 && E <= 32 * VEC * MAX_CHUNKS; }

// blocks of a call: the rows of the partials the finish adds (0: refused)
int grid_blocks(int M, int E, int dtype, int instance) {
  if (M <= 0 || E <= 0 || (dtype != 0 && dtype != 1)) return 0;
  const int sms = sm_count();
  if (instance == WARP) {
    if (!warp_ok(E)) return 0;
    const int minb = warp_minb(dtype == 1 ? 2 : 4, cdiv(E, 32 * VEC));
    return std::min(cdiv(M, WARPS), minb * sms);
  }
  if (instance == BLOCK) return std::min(M, BLOCK_MINB * sms);
  return 0;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <typename T, int C, bool HAS_GX>
int launch_warp(const void* x, const void* w, const void* gn, const void* gx, void* dx,
                float* part, int blocks, int M, int E, float eps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(WARPS * 2 * E) * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = allow_smem<addnorm_bwd_warp<T, C, HAS_GX>>(smem);
    if (err) return err;
  }
  addnorm_bwd_warp<T, C, HAS_GX><<<blocks, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(gn), static_cast<const T*>(gx), static_cast<T*>(dx), part, M, E,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool HAS_GX>
int launch_warp_c(int C, const void* x, const void* w, const void* gn, const void* gx,
                  void* dx, float* part, int blocks, int M, int E, float eps,
                  cudaStream_t s) {
  switch (C) {
    case 1: return launch_warp<T, 1, HAS_GX>(x, w, gn, gx, dx, part, blocks, M, E, eps, s);
    case 2: return launch_warp<T, 2, HAS_GX>(x, w, gn, gx, dx, part, blocks, M, E, eps, s);
    case 3: return launch_warp<T, 3, HAS_GX>(x, w, gn, gx, dx, part, blocks, M, E, eps, s);
    case 4: return launch_warp<T, 4, HAS_GX>(x, w, gn, gx, dx, part, blocks, M, E, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_rows(int instance, const void* x, const void* w, const void* gn, const void* gx,
                void* dx, float* part, int blocks, int M, int E, float eps, cudaStream_t s) {
  if (instance == WARP) {
    const int C = cdiv(E, 32 * VEC);
    return gx ? launch_warp_c<T, true>(C, x, w, gn, gx, dx, part, blocks, M, E, eps, s)
              : launch_warp_c<T, false>(C, x, w, gn, gx, dx, part, blocks, M, E, eps, s);
  }
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gn);
  const T* gxt = static_cast<const T*>(gx);
  const float* wt = static_cast<const float*>(w);
  if (gx)
    addnorm_bwd_block<T, true><<<blocks, THREADS, 0, s>>>(xt, wt, gt, gxt, static_cast<T*>(dx),
                                                         part, M, E, eps);
  else
    addnorm_bwd_block<T, false><<<blocks, THREADS, 0, s>>>(xt, wt, gt, gxt,
                                                          static_cast<T*>(dx), part, M, E, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// floats of workspace (the blocks' [dw | db] rows) a call takes; -1: the
// shapes, dtype or instance are refused
extern "C" int fused_norm_residual_bwd_workspace(int M, int E, int dtype, int instance) {
  const long long n = static_cast<long long>(grid_blocks(M, E, dtype, instance)) * 2 * E;
  return n <= 0 || n > INT32_MAX ? -1 : static_cast<int>(n);
}

// x, gn, gx (nullptr: no carry cotangent) and dx (M, E) in the storage
// type; w (E,) fp32; dwb (2E,) fp32 = [dw | db]; work as sized above.
// dtype: 0 = float32, 1 = bfloat16; instance: 0 = block, 1 = warp (E a
// multiple of 8 up to 32 * 8 * MAX_CHUNKS, 16-byte aligned rows, else
// refused). Returns the launches' CUDA error code.
extern "C" int fused_norm_residual_bwd(const void* x, const void* w, const void* gn,
                                       const void* gx, void* dx, void* dwb, void* work,
                                       int M, int E, float eps, int dtype, int instance,
                                       void* stream) {
  const int blocks = grid_blocks(M, E, dtype, instance);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (instance == WARP && !aligned16({x, gn, gx, dx}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(work);
  const int err = dtype == 1
                      ? launch_rows<bf16>(instance, x, w, gn, gx, dx, part, blocks, M, E, eps, s)
                      : launch_rows<float>(instance, x, w, gn, gx, dx, part, blocks, M, E, eps, s);
  if (err) return err;
  addnorm_bwd_finish<<<cdiv(2 * E, 32), FINISH_WARPS * 32, 0, s>>>(
      part, static_cast<float*>(dwb), blocks, 2 * E);
  return static_cast<int>(cudaGetLastError());
}

// adds to bad[0] (uint64 on the card) the pairs of ``blocks`` x 256 x 64
// (see quot_check_kernel) where ``quot`` differs from IEEE division.
// Returns the launch's CUDA error code.
extern "C" int fused_norm_residual_quot_check(void* bad, int blocks, unsigned seed, int mode,
                                              void* stream) {
  if (blocks <= 0 || (mode != 0 && mode != 1)) return static_cast<int>(cudaErrorInvalidValue);
  quot_check_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad), seed, mode);
  return static_cast<int>(cudaGetLastError());
}
