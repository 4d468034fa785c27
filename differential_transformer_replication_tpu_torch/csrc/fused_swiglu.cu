// Fused SwiGLU forward for Hopper (sm_90a):
//   out = silu(x @ Wg + bg) * (x @ Wx + bx)
//
// Replaces the TPU kernel differential_transformer_replication_tpu/ops/
// fused_ffn.py:_ffn_fwd_kernel (via _fwd_call). Layouts are the JAX
// package's: x (M, E), Wg/Wx (E, F) row-major (in, out), bg/bx (F,),
// out (M, F), all in one storage type T (float or bf16).
//
// What bounds it on the H100: at decode (M = 8) and at a prefill chunk
// (M = 128) of the recipe (E = 768, F = 3072) the two weight matrices
// (2 * E * F elements, 9.4 MB in bf16) dominate the bytes, and the
// arithmetic (4 * M * E * F) stays far below the tensor-core rate, so
// the bound is the weight read. The design reads each weight element
// once per row tile and never writes the two (M, F) pre-activations:
// one x tile staged in shared memory feeds BOTH products, two fp32
// accumulators per output, and the bias + SiLU + product epilogue runs
// on the accumulators in registers. The products are plain fp32 FMAs on
// values widened from T (exact for bf16), accumulated in fp32 like the
// TPU kernel's preferred_element_type=float32 dot; wgmma/TMA tiles are
// later work.
//
// Epilogue numerics follow the JAX kernel: the biases arrive already in
// T (the wrapper casts them, as fused_ffn.py does) and are widened to
// fp32 before the add; silu(g) = g * sigmoid(g) and the product run in
// fp32; the result is rounded to T once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;       // rows of x per block
constexpr int BN = 32;       // output columns per block (one per lane)
constexpr int BK = 64;       // contraction depth staged per step
constexpr int THREADS = 256; // 8 warps; warp w owns rows 4w .. 4w+3
constexpr int ROWS_PER_THREAD = BM / (THREADS / BN);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
swiglu_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                  const T* __restrict__ bg, const T* __restrict__ wx,
                  const T* __restrict__ bx, T* __restrict__ out,
                  int M, int E, int F) {
  __shared__ float xs[BM][BK + 1];
  __shared__ float gs[BK][BN];
  __shared__ float ts[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % BN;
  const int ty = tid / BN;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float accg[ROWS_PER_THREAD];
  float acct[ROWS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    accg[j] = 0.f;
    acct[j] = 0.f;
  }

  for (int k0 = 0; k0 < E; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      xs[r][c] = (gr < M && gc < E) ? to_f(x[(size_t)gr * E + gc]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      const bool ok = gr < E && gc < F;
      gs[r][c] = ok ? to_f(wg[(size_t)gr * F + gc]) : 0.f;
      ts[r][c] = ok ? to_f(wx[(size_t)gr * F + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float g = gs[k][tx];
      const float t = ts[k][tx];
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        const float a = xs[ty * ROWS_PER_THREAD + j][k];
        accg[j] = fmaf(a, g, accg[j]);
        acct[j] = fmaf(a, t, acct[j]);
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= F) return;
  const float bgv = to_f(bg[col]);
  const float bxv = to_f(bx[col]);
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int row = row0 + ty * ROWS_PER_THREAD + j;
    if (row < M) {
      const float g = accg[j] + bgv;
      const float t = acct[j] + bxv;
      const float sig = 1.f / (1.f + expf(-g));
      out[(size_t)row * F + col] = from_f<T>(g * sig * t);
    }
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* bg, const void* wx,
           const void* bx, void* out, int M, int E, int F,
           cudaStream_t stream) {
  dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  swiglu_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(bg), static_cast<const T*>(wx),
      static_cast<const T*>(bx), static_cast<T*>(out), M, E, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's CUDA error code.
extern "C" int fused_swiglu_fwd(const void* x, const void* wg, const void* bg,
                                const void* wx, const void* bx, void* out,
                                int M, int E, int F, int dtype, void* stream) {
  if (M <= 0 || E <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, wg, bg, wx, bx, out, M, E, F, s);
    case 1: return launch<__nv_bfloat16>(x, wg, bg, wx, bx, out, M, E, F, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
