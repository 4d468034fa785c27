// Fused SwiGLU forward and backward for Hopper (sm_90a):
//   out = silu(x @ Wg + bg) * (x @ Wx + bx)
//
// Replaces the TPU kernels differential_transformer_replication_tpu/ops/
// fused_ffn.py:_ffn_fwd_kernel (via _fwd_call) and _ffn_bwd_kernel (via
// _bwd_call). Layouts are the JAX package's: x (M, E), Wg/Wx (E, F)
// row-major (in, out), bg/bx (F,), out (M, F), all in one storage type T
// (float or bf16).
//
// Three instances, chosen by the wrapper (ops/fused_ffn.py:
// swiglu_instance) and passed in; the launcher does not re-decide:
//
// - mma (bf16, E and F multiples of 8, 16-byte aligned operands; the
//   forward at M > 64 and the backward at every M): tensor-core tiles on
//   Hopper's warpgroup MMA (wgmma) with fp32 accumulators. At the recipe's
//   training shape (M = 16384, E = 768, F = 3072) each product is 77
//   GFLOP against ~35 MB of operands: bound by arithmetic. Two
//   warpgroups own 128 rows of x and N columns of BOTH products (N = 64
//   for g and t: 2 blocks an SM, one block's epilogue under the other's
//   products; N = 128 for the weight grad, whose K loop is long). K-slices
//   of 64 come in by 16-byte cp.async through a 3- or 4-stage ring of
//   128-byte-swizzled tiles in dynamic shared memory, which wgmma reads
//   directly: x K-major, the (E, F) row-major weights (and [dg | dt])
//   MN-major, x^T for the weight grad MN-major. Column tiles run fastest
//   in the grid, so a wave covers every weight column tile (9.4 MB, held
//   in the L2) over a few x row tiles, and x is read once. The epilogue
//   runs on the accumulator fragments in registers: bias, SiLU, product
//   and a bf16x2 store (forward); dg, dt, their bf16 stores and the
//   tile's column sums of the UNROUNDED dg and dt (quad shuffles, then
//   one small shared-memory sum) for the backward.
// - skinny (bf16 as above, the forward at M <= 64: the decode step's
//   rows): the weight read (9.4 MB at the recipe) bounds it, so the
//   operands swap: 16 F-columns of each weight are the A operand (m16 of
//   mma.sync m16n8k16, ldmatrix.trans from the (E, F) rows) and up to 64
//   rows of x the n8 operand. A block of 4 warps owns 16 F-columns of
//   both products for 8, 16, 32 or 64 rows; its warps split E (chunks of
//   32, dealt round robin), each through a private cp.async ring (4
//   stages deep up to 32 rows), so ~200 blocks of ~50 KB keep ~6 MB of
//   weights in flight with no block-wide barrier until the four warps'
//   sums meet (in a fixed order) in shared memory. Past 64 rows the
//   re-read of x by every 16-column block makes the mma tiles faster.
// - simt (fp32, where bf16 or tf32 products would not hold the plain
//   version's 5e-5, and bf16 at other widths): plain fp32 FMAs on values
//   widened from T, below.
//
// Products of bf16 values are exact in fp32 and summed in fp32, like the
// TPU kernel's preferred_element_type=float32 dot; the order of the sums
// is the instance's own, fixed (no atomics: two calls agree bit for bit).
//
// Epilogue numerics follow the JAX kernel: the biases arrive already in
// T (the wrapper casts them, as fused_ffn.py does) and are widened to
// fp32 before the add; silu(g) = g * sigmoid(g) and the product run in
// fp32; the result is rounded to T once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <initializer_list>

#include "mma_ptx.cuh"
#include "smem_opt_in.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 32;       // rows of x per block
constexpr int BN = 32;       // output columns per block (one per lane)
constexpr int BK = 64;       // contraction depth staged per step
constexpr int THREADS = 256; // 8 warps; warp w owns rows 4w .. 4w+3
constexpr int ROWS_PER_THREAD = BM / (THREADS / BN);

// the instance codes shared with ops/fused_ffn.py:INSTANCES
enum Instance { SIMT = 0, MMA = 1, SKINNY = 2 };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// ---------------------------------------------------------------------------
// Backward (kernel G). Replaces the TPU kernel differential_transformer_
// replication_tpu/ops/fused_ffn.py:_ffn_bwd_kernel (via _bwd_call):
//
//   g, t = x @ Wg + bg, x @ Wx + bx          (recomputed per tile, fp32)
//   dg = gh * t * sig(g) (1 + g (1 - sig(g))),  dt = gh * silu(g)
//   dWg = x^T dg, dWx = x^T dt (fp32),  dbg = colsum(dg), dbx = colsum(dt)
//
// dg and dt are stored in the storage type, side by side in one (M, 2F)
// buffer [dg | dt], and the weight grads use those ROUNDED values (what
// the TPU kernel carries into its dot); the bias grads sum the unrounded
// fp32 values. The wrapper finishes dx = [dg | dt] @ [Wg | Wx]^T with one
// matmul outside the kernel, as the JAX code leaves it to XLA.
//
// What bounds it on the H100: at the recipe's training shape (M = 16384,
// E = 768, F = 3072) the two recompute products and the two weight-grad
// products are ~155 GFLOP each, against ~350 MB of operands and results:
// bound by arithmetic. Three launches, no atomics (the grads are run-order
// independent): (1) one block per tile of (M, F) recomputes g and t,
// writes dg/dt and the tile's fp32 column sums of dg/dt; (2) blocks over
// tiles of (E, F) sum x^T dg and x^T dt over the rows (the mma instance
// over a fixed number of row slices, each slice's fp32 partial apart);
// (3) the column sums of (1), and the mma instance's slice partials, are
// added in a fixed order. The simt instance (fp32, other widths): plain
// fp32 FMAs on 4x4 register tiles, below; the mma instance after it.

constexpr int GT = 64;        // tile edge of the backward's outputs
constexpr int GK = 32;        // contraction depth staged per step
constexpr int GTHREADS = 256; // 16 x 16 threads, each a 4x4 register tile

template <typename T>
__global__ void __launch_bounds__(GTHREADS)
swiglu_bwd_act_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                      const T* __restrict__ bg, const T* __restrict__ wx,
                      const T* __restrict__ bx, const T* __restrict__ gh,
                      T* __restrict__ dgt, float* __restrict__ part,
                      int M, int E, int F) {
  __shared__ float xs[GT][GK + 1];
  __shared__ float ws[2][GK][GT];
  __shared__ float red[2][16][GT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * GT, col0 = blockIdx.x * GT;
  float ag[4][4], at[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ag[i][j] = at[i][j] = 0.f;

  for (int k0 = 0; k0 < E; k0 += GK) {
    for (int i = tid; i < GT * GK; i += GTHREADS) {
      const int r = i / GK, c = i % GK, gr = row0 + r, gc = k0 + c;
      xs[r][c] = (gr < M && gc < E) ? to_f(x[(size_t)gr * E + gc]) : 0.f;
    }
    for (int i = tid; i < GK * GT; i += GTHREADS) {
      const int r = i / GT, c = i % GT, gr = k0 + r, gc = col0 + c;
      const bool ok = gr < E && gc < F;
      ws[0][r][c] = ok ? to_f(wg[(size_t)gr * F + gc]) : 0.f;
      ws[1][r][c] = ok ? to_f(wx[(size_t)gr * F + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < GK; ++k) {
      float a[4], g[4], t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[j] = ws[0][k][tx + 16 * j];
        t[j] = ws[1][k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ag[i][j] = fmaf(a[i], g[j], ag[i][j]);
          at[i][j] = fmaf(a[i], t[j], at[i][j]);
        }
    }
    __syncthreads();
  }

  float sg_col[4] = {0.f, 0.f, 0.f, 0.f}, st_col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + tx + 16 * j;
    if (col >= F) continue;
    const float bgv = to_f(bg[col]), bxv = to_f(bx[col]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row >= M) continue;
      const float g = ag[i][j] + bgv;
      const float t = at[i][j] + bxv;
      const float sg = 1.f / (1.f + expf(-g));
      const float h = to_f(gh[(size_t)row * F + col]);
      const float dg = h * t * (sg * (1.f + g * (1.f - sg)));
      const float dt = h * (g * sg);
      dgt[(size_t)row * 2 * F + col] = from_f<T>(dg);
      dgt[(size_t)row * 2 * F + F + col] = from_f<T>(dt);
      sg_col[j] += dg;
      st_col[j] += dt;
    }
  }
  // the tile's column sums, reduced over the 16 thread rows in order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx + 16 * j] = sg_col[j];
    red[1][ty][tx + 16 * j] = st_col[j];
  }
  __syncthreads();
  if (tid < 2 * GT) {
    const int which = tid / GT, c = tid % GT, col = col0 + c;
    float acc = 0.f;
    for (int r = 0; r < 16; ++r) acc += red[which][r][c];
    if (col < F) part[(size_t)blockIdx.y * 2 * F + which * F + col] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(GTHREADS)
swiglu_bwd_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dgt,
                        float* __restrict__ dw, int M, int E, int F) {
  __shared__ float xs[GK][GT + 1];
  __shared__ float ds[2][GK][GT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int e0 = blockIdx.y * GT, f0 = blockIdx.x * GT;
  float ag[4][4], at[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ag[i][j] = at[i][j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += GK) {
    for (int i = tid; i < GK * GT; i += GTHREADS) {
      const int r = i / GT, c = i % GT, m = m0 + r;
      const int e = e0 + c, f = f0 + c;
      xs[r][c] = (m < M && e < E) ? to_f(x[(size_t)m * E + e]) : 0.f;
      const bool ok = m < M && f < F;
      ds[0][r][c] = ok ? to_f(dgt[(size_t)m * 2 * F + f]) : 0.f;
      ds[1][r][c] = ok ? to_f(dgt[(size_t)m * 2 * F + F + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < GK; ++k) {
      float a[4], g[4], t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[j] = ds[0][k][tx + 16 * j];
        t[j] = ds[1][k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ag[i][j] = fmaf(a[i], g[j], ag[i][j]);
          at[i][j] = fmaf(a[i], t[j], at[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = e0 + ty + 16 * i;
    if (e >= E) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f >= F) continue;
      dw[(size_t)e * F + f] = ag[i][j];
      dw[(size_t)E * F + (size_t)e * F + f] = at[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// The mma instance on Hopper's warpgroup MMA (wgmma): C_p = A B_p for
// p = 0, 1 over one 128 x N tile of each product (N = 64 for g and t, 2
// blocks an SM, so one block's epilogue runs under the other's products;
// N = 128 for the weight grad, whose K loop is long). Two warpgroups each
// own 64 rows and both products (N / 2 fp32 accumulators a product a
// thread); K-slices of 64 land by 16-byte cp.async in a ring of
// 128-byte-swizzled tiles that the tensor cores read straight from shared
// memory: A K-major (x rows) or MN-major (x^T for dW), the (K, N)
// row-major B_p MN-major (the instruction's transpose flag). A swizzled
// row is 128 bytes: 16-byte chunk ch of row r sits at ((ch ^ r % 8) * 16);
// an MN-major atom is 64 elements by 64 K-rows (8 KB).

constexpr int WG_TM = 128;    // rows of A per block: two warpgroups of 64
constexpr int WG_TK = 64;     // K a stage holds
constexpr int WG_THREADS = 256;
constexpr int WG_A_BYTES = WG_TM * WG_TK * 2;  // 16 KB

template <int N>
struct WgCfg {
  static constexpr int B_BYTES = WG_TK * N * 2;       // a product
  static constexpr int STAGE = WG_A_BYTES + 2 * B_BYTES;
  static constexpr int NS = N == 128 ? 4 : 3;         // ring stages
  static constexpr int MINB = N == 128 ? 1 : 2;       // blocks an SM
  static constexpr int SMEM = NS * STAGE + 1024;      // + the 1024-byte alignment
  static constexpr int GLD = N + 8;                   // the backward's staged gh rows
  static constexpr int RED_OFF = WG_TM * GLD * 2;     // the column sums, after them
  static_assert(RED_OFF + 8 * 2 * N * 4 <= NS * STAGE, "epilogue scratch");
};
constexpr int ACT_N = 64;            // the g, t tiles' columns of each product
constexpr int WGRAD_N = 128;         // the weight grad's
constexpr int SMS = 132;             // SMs of the H100 SXM: the weight grad's wave
// row slices of the weight grad, at most: more fill the last wave better
// but add (slices - 1) x 2 E F fp32 partials to write and read back; at
// the recipe (M 16384, E 768, F 3072) 4 beat 8 by ~1.5% of the backward
// and 2 and 1 lost 4% and 14% (train/attention_bench.py --parts ffn on
// an H100 80GB HBM3 at 700 W)
constexpr int MAX_SLICES = 4;
constexpr int MIN_SLICE_ROWS = 512;  // and each of at least this many rows

// the operands of one product pair: A (rows x K) row-major, or with AT
// its transpose stored (K x rows) row-major; B_0, B_1 (K x cols), row
// stride ldb. rows, cols and K bound the reads (zeros past them).
struct MmaOps {
  const bf16* a;
  const bf16* b0;
  const bf16* b1;
  int lda, ldb, rows, cols, K;
};

// a shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo in bytes
// (MN-major: lbo between 64-element atoms along M or N, sbo between 8-row
// groups along K; K-major: sbo between 8-row groups, lbo unused)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// cp.async's writes (generic proxy) made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int NA>
__device__ __forceinline__ void wg_hold(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N fp32, the warpgroup's fragments) += A (64 x 16) B (16 x N)
template <int TRANS_A>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A));
}

template <int TRANS_A>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33,"
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A));
}

template <int N, int TRANS_A>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64)
    wgmma_n64<TRANS_A>(d, da, db);
  else
    wgmma_n128<TRANS_A>(d, da, db);
}

// stage K-slice [k0, k0 + 64) of the tile at (r0, c0): A as [row][64 k]
// (K-major) or [64-row atom][64 k][64 rows] (AT: MN-major), B_p as
// [p][64-column atom][64 k][64 columns]
template <int N, bool AT>
__device__ __forceinline__ void wg_load_stage(unsigned char* st, const MmaOps& o, int r0,
                                              int c0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < WG_A_BYTES / 16 / WG_THREADS; ++i) {
    const int c = tid + i * WG_THREADS, ch = c & 7;
    if constexpr (!AT) {
      const int r = c >> 3;
      const bool ok = r0 + r < o.rows && k0 + ch * 8 < o.K;
      cp_async16(st + r * 128 + ((ch ^ (r & 7)) << 4),
                 ok ? o.a + (size_t)(r0 + r) * o.lda + k0 + ch * 8 : o.a, ok);
    } else {
      const int j = c >> 9, kr = (c >> 3) & 63, r = j * 64 + ch * 8;
      const bool ok = k0 + kr < o.K && r0 + r < o.rows;
      cp_async16(st + j * 8192 + kr * 128 + ((ch ^ (kr & 7)) << 4),
                 ok ? o.a + (size_t)(k0 + kr) * o.lda + r0 + r : o.a, ok);
    }
  }
#pragma unroll
  for (int i = 0; i < 2 * WgCfg<N>::B_BYTES / 16 / WG_THREADS; ++i) {
    const int c = tid + i * WG_THREADS, p = c / (8 * N), cc = c % (8 * N);
    const int j = cc >> 9, kr = (cc >> 3) & 63, ch = cc & 7, n = j * 64 + ch * 8;
    const bool ok = k0 + kr < o.K && c0 + n < o.cols;
    const bf16* b = p ? o.b1 : o.b0;
    cp_async16(st + WG_A_BYTES + p * WgCfg<N>::B_BYTES + j * 8192 + kr * 128 +
                   ((ch ^ (kr & 7)) << 4),
               ok ? b + (size_t)(k0 + kr) * o.ldb + c0 + n : b, ok);
  }
}

// acc_g / acc_t: the warpgroup's 64 x N fragments of C_0 / C_1 over
// K-steps [kt0, kt1); warpgroup w holds rows 64 w .. 64 w + 63 of the tile
template <int N, bool AT>
__device__ __forceinline__ void wg_mainloop(float (&acc_g)[N / 2], float (&acc_t)[N / 2],
                                            unsigned char* smem, const MmaOps& o, int r0,
                                            int c0, int kt0, int kt1) {
  using C = WgCfg<N>;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc_g[i] = acc_t[i] = 0.f;
  const int n = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < C::NS - 2; ++s) {
    if (s < n) wg_load_stage<N, AT>(smem + s * C::STAGE, o, r0, c0, (kt0 + s) * WG_TK);
    cp_commit();
  }
  const uint32_t base = smem_addr(smem);
  for (int i = 0; i < n; ++i) {
    cp_wait<C::NS - 3>();
    fence_proxy_async();
    __syncthreads();  // step i is in; every warpgroup is done with step i - 2's slot
    const int nxt = i + C::NS - 2;
    if (nxt < n)
      wg_load_stage<N, AT>(smem + (nxt % C::NS) * C::STAGE, o, r0, c0, (kt0 + nxt) * WG_TK);
    cp_commit();
    const uint32_t st = base + (i % C::NS) * C::STAGE;
    wg_hold(acc_g);
    wg_hold(acc_t);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WG_TK / 16; ++kk) {
      const uint64_t da = AT ? gmma_desc(st + wg * 8192 + kk * 2048, 8192, 1024)
                             : gmma_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint32_t sb = st + WG_A_BYTES + kk * 2048;
      wgmma_tile<N, AT ? 1 : 0>(acc_g, da, gmma_desc(sb, 8192, 1024));
      wgmma_tile<N, AT ? 1 : 0>(acc_t, da, gmma_desc(sb + C::B_BYTES, 8192, 1024));
    }
    wg_commit();
    wg_wait<1>();  // step i - 1's products are done
    wg_hold(acc_g);
    wg_hold(acc_t);
  }
  wg_wait<0>();
  wg_hold(acc_g);
  wg_hold(acc_t);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}
// g = x Wg + bg, t = x Wx + bx on the tile at (row tile blockIdx.y,
// column tile blockIdx.x; column tiles run fastest, so a wave covers
// every weight column tile, held in the L2, over a few x row tiles), then
// the forward's out (M, F) = silu(g) t or the backward's dgt (M, 2F) =
// [dg | dt] and part[row tile] (2F) = the tile's column sums of the
// unrounded dg and dt, all from the accumulator fragments in registers
template <bool BWD>
__global__ void __launch_bounds__(WG_THREADS, WgCfg<ACT_N>::MINB)
swiglu_act_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                 const bf16* __restrict__ bg, const bf16* __restrict__ wx,
                 const bf16* __restrict__ bx, const bf16* __restrict__ gh,
                 bf16* __restrict__ out, float* __restrict__ part, int M, int E, int F) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  using C = WgCfg<ACT_N>;
  const int c0 = blockIdx.x * ACT_N, r0 = blockIdx.y * WG_TM;
  const MmaOps o{x, wg, wx, E, F, M, F, E};
  float acc_g[ACT_N / 2], acc_t[ACT_N / 2];
  wg_mainloop<ACT_N, false>(acc_g, acc_t, smem, o, r0, c0, 0, cdiv(E, WG_TK));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = r0 + (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);  // row of h = 0
  const int q2 = (lane & 3) * 2;
  const bf16* ghs = reinterpret_cast<const bf16*>(smem);       // BWD: [TM][GLD]
  float* red = reinterpret_cast<float*>(smem + C::RED_OFF);    // BWD: [warp][p][ACT_N]
  if constexpr (BWD) {
    // the tile's rows of gh into the drained ring by 16-byte copies
    __syncthreads();
    for (int c = threadIdx.x; c < WG_TM * ACT_N / 8; c += WG_THREADS) {
      const int r = c / (ACT_N / 8), cc = (c % (ACT_N / 8)) * 8;
      const bool ok = r0 + r < M && c0 + cc < F;
      cp_async16(smem + (r * C::GLD + cc) * 2, ok ? gh + (size_t)(r0 + r) * F + c0 + cc : gh,
                 ok);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < ACT_N / 8; ++j) {
    const int col = c0 + j * 8 + q2;  // even; F % 8 == 0, so col + 1 < F too
    float sg0 = 0.f, sg1 = 0.f, st0 = 0.f, st1 = 0.f;  // BWD: column sums of dg, dt
    if (col < F) {
      const float2 bgv = ld_bf16x2(bg + col), bxv = ld_bf16x2(bx + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw + 8 * h;
        if (row >= M) continue;
        const float g0 = acc_g[4 * j + 2 * h] + bgv.x, g1 = acc_g[4 * j + 2 * h + 1] + bgv.y;
        const float t0 = acc_t[4 * j + 2 * h] + bxv.x, t1 = acc_t[4 * j + 2 * h + 1] + bxv.y;
        const float s0 = 1.f / (1.f + expf(-g0)), s1 = 1.f / (1.f + expf(-g1));
        if constexpr (!BWD) {
          *reinterpret_cast<unsigned*>(out + (size_t)row * F + col) =
              pack_bf16(g0 * s0 * t0, g1 * s1 * t1);
        } else {
          const float2 hv = ld_bf16x2(ghs + (row - r0) * C::GLD + col - c0);
          const float dg0 = hv.x * t0 * (s0 * (1.f + g0 * (1.f - s0)));
          const float dg1 = hv.y * t1 * (s1 * (1.f + g1 * (1.f - s1)));
          const float dt0 = hv.x * (g0 * s0), dt1 = hv.y * (g1 * s1);
          bf16* d = out + (size_t)row * 2 * F + col;
          *reinterpret_cast<unsigned*>(d) = pack_bf16(dg0, dg1);
          *reinterpret_cast<unsigned*>(d + F) = pack_bf16(dt0, dt1);
          sg0 += dg0;
          sg1 += dg1;
          st0 += dt0;
          st1 += dt1;
        }
      }
    }
    if constexpr (BWD) {
      // over the warp's 8 row groups (lanes 4 apart)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        sg0 += __shfl_xor_sync(0xffffffffu, sg0, m);
        sg1 += __shfl_xor_sync(0xffffffffu, sg1, m);
        st0 += __shfl_xor_sync(0xffffffffu, st0, m);
        st1 += __shfl_xor_sync(0xffffffffu, st1, m);
      }
      if (lane < 4) {
        float* rg = red + warp * 2 * ACT_N + j * 8 + q2;
        rg[0] = sg0;
        rg[1] = sg1;
        rg[ACT_N] = st0;
        rg[ACT_N + 1] = st1;
      }
    }
  }
  if constexpr (BWD) {
    __syncthreads();  // the eight warps' sums, added in warp order
    for (int i = threadIdx.x; i < 2 * ACT_N; i += WG_THREADS) {
      const int p = i / ACT_N, c = i - p * ACT_N, col = c0 + c;
      if (col >= F) continue;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WG_THREADS / 32; ++w) t += red[(w * 2 + p) * ACT_N + c];
      part[(size_t)blockIdx.y * 2 * F + p * F + col] = t;
    }
  }
}

// dW partials: [x^T dg, x^T dt] over row slice blockIdx.z of M for the
// (E, F) tile at (blockIdx.y, blockIdx.x); slice 0 into dw (2, E, F),
// slice s > 0 into wpart[s - 1] (2, E, F), all fp32
__global__ void __launch_bounds__(WG_THREADS, WgCfg<WGRAD_N>::MINB)
swiglu_wgrad_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ dgt,
                   float* __restrict__ dw, float* __restrict__ wpart, int M, int E, int F,
                   int slices) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int c0 = blockIdx.x * WGRAD_N, r0 = blockIdx.y * WG_TM, s = blockIdx.z;
  const int steps = cdiv(M, WG_TK);
  const int kt0 = (int)((long long)steps * s / slices);
  const int kt1 = (int)((long long)steps * (s + 1) / slices);
  const MmaOps o{x, dgt, dgt + F, E, 2 * F, E, F, M};
  float acc_g[WGRAD_N / 2], acc_t[WGRAD_N / 2];
  wg_mainloop<WGRAD_N, true>(acc_g, acc_t, smem, o, r0, c0, kt0, kt1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ew = r0 + (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int q2 = (lane & 3) * 2;
  float* dst = s == 0 ? dw : wpart + (size_t)(s - 1) * 2 * E * F;
#pragma unroll
  for (int j = 0; j < WGRAD_N / 8; ++j) {
    const int col = c0 + j * 8 + q2;
    if (col >= F) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = ew + 8 * h;
      if (e >= E) continue;
      *reinterpret_cast<float2*>(dst + (size_t)e * F + col) =
          make_float2(acc_g[4 * j + 2 * h], acc_g[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(dst + (size_t)E * F + (size_t)e * F + col) =
          make_float2(acc_t[4 * j + 2 * h], acc_t[4 * j + 2 * h + 1]);
    }
  }
}

// both backwards' last launch: db[c] = the row tiles' column sums
// part[r][c] added in row-tile order (c < width = 2F), and dw += the
// slices' partials in slice order (n4 float4s each; none for one slice)
__global__ void swiglu_bwd_finish_kernel(const float* __restrict__ part,
                                         float* __restrict__ db, int tiles, int width,
                                         float4* __restrict__ dw,
                                         const float4* __restrict__ wpart, int slices,
                                         int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < width) {
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < tiles; ++r) acc += part[(size_t)r * width + i];
    db[i] = acc;
  } else if (i - width < n4) {
    const int j = i - width;
    float4 a = dw[j];
    for (int s = 1; s < slices; ++s) {
      const float4 b = wpart[(size_t)(s - 1) * n4 + j];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    dw[j] = a;
  }
}

// row slices of the weight grad: the count (1 .. MAX_SLICES, each of at
// least MIN_SLICE_ROWS rows) whose blocks fill the last of their
// waves on SMS SMs best, one block an SM (the smaller on a tie). A
// function of the shapes alone, so two calls sum in the same order.
int wgrad_slices(int M, int E, int F) {
  const int tiles = cdiv(E, WG_TM) * cdiv(F, WGRAD_N);
  const int per_sm = WgCfg<WGRAD_N>::MINB;
  const int most = std::max(1, std::min(MAX_SLICES, M / MIN_SLICE_ROWS));
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= most; ++s) {
    const int blocks = tiles * s;
    const double fill = (double)blocks / ((double)cdiv(blocks, SMS * per_sm) * SMS * per_sm);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

// ---------------------------------------------------------------------------
// The skinny instance (the forward at M <= 64): C_p^T = Wp^T x^T with the
// weights as the m16 operand, for 16 F-columns and 8 * NT rows a block.

constexpr int SK_WARPS = 4;
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_F = 16;       // F-columns of each product per block
constexpr int SK_K = 32;       // E per chunk
constexpr int SK_LD = SK_K + 8;  // chunk row stride: [e][Wg 16 | Wx 16], [m][e 32]

template <int NT>
struct SkLayout {
  // each warp's cp.async ring depth: deeper where the x chunk is small
  static constexpr int STAGES = NT <= 4 ? 4 : 3;
  static constexpr int W_ELEMS = SK_K * SK_LD;
  static constexpr int STAGE = W_ELEMS + 8 * NT * SK_LD;  // bf16 elements
  static constexpr int RING_BYTES = SK_WARPS * STAGES * STAGE * 2;
  static constexpr int RED_BYTES = SK_WARPS * 2 * NT * 128 * 4;  // the warps' sums, after
  static constexpr int SMEM = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
};

template <int NT>
__global__ void __launch_bounds__(SK_THREADS)
swiglu_fwd_skinny_mma(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                      const bf16* __restrict__ bg, const bf16* __restrict__ wx,
                      const bf16* __restrict__ bx, bf16* __restrict__ out, int M, int E,
                      int F) {
  using Lay = SkLayout<NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * SK_F, m0 = blockIdx.y * 8 * NT;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + warp * Lay::STAGES * Lay::STAGE;
  const int nch = cdiv(E, SK_K);
  const int mine = warp < nch ? (nch - 1 - warp) / SK_WARPS + 1 : 0;  // chunks warp, warp + 4, ..
  auto load = [&](int i) {
    bf16* ws = ring + (i % Lay::STAGES) * Lay::STAGE;
    bf16* xs = ws + Lay::W_ELEMS;
    const int e0 = (warp + i * SK_WARPS) * SK_K;
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // 32 e-rows x (Wg, Wx) x two 8-column halves
      const int idx = lane + 32 * r, row = idx >> 2, q = idx & 3, f = f0 + (q & 1) * 8;
      const bf16* src = (q >> 1) ? wx : wg;
      const bool ok = e0 + row < E && f < F;
      cp_async16(ws + row * SK_LD + q * 8, ok ? src + (size_t)(e0 + row) * F + f : src, ok);
    }
#pragma unroll
    for (int r = 0; r < NT; ++r) {  // 8 NT rows of x x 4 chunks of 8
      const int idx = lane + 32 * r, row = idx >> 2, q = idx & 3;
      const bool ok = m0 + row < M && e0 + q * 8 < E;
      cp_async16(xs + row * SK_LD + q * 8, ok ? x + (size_t)(m0 + row) * E + e0 + q * 8 : x, ok);
    }
  };
  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[p][n][0] = acc[p][n][1] = acc[p][n][2] = acc[p][n][3] = 0.f;
#pragma unroll
  for (int s = 0; s < Lay::STAGES - 1; ++s) {
    if (s < mine) load(s);
    cp_commit();
  }
  // A = W^T from the [e][f] chunk, transposed (lane >> 4: the e half,
  // lane >> 3 & 1: the f half); B = x^T from the [m][e] chunk
  const int a_off = ((lane & 7) + (lane >> 4) * 8) * SK_LD + ((lane >> 3) & 1) * 8;
  const int b_off = (NT == 1 ? (lane & 7) : (lane & 7) + (lane >> 4) * 8) * SK_LD +
                    ((lane >> 3) & 1) * 8;
  for (int i = 0; i < mine; ++i) {
    cp_wait<Lay::STAGES - 2>();
    __syncwarp();  // chunk i has landed for every lane; slot i - 1 is free
    if (i + Lay::STAGES - 1 < mine) load(i + Lay::STAGES - 1);
    cp_commit();
    const bf16* ws = ring + (i % Lay::STAGES) * Lay::STAGE;
    const bf16* xs = ws + Lay::W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < SK_K; kk += 16) {
      unsigned ag[4], at[4];
      ldsm4t(ag, ws + a_off + kk * SK_LD);
      ldsm4t(at, ws + a_off + kk * SK_LD + SK_F);
      if constexpr (NT == 1) {
        unsigned b[2];
        ldsm2(b, xs + b_off + kk);
        mma16816(acc[0][0], ag, b[0], b[1]);
        mma16816(acc[1][0], at, b[0], b[1]);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned b[4];
          ldsm4(b, xs + b_off + np * 16 * SK_LD + kk);
          mma16816(acc[0][2 * np], ag, b[0], b[1]);
          mma16816(acc[1][2 * np], at, b[0], b[1]);
          mma16816(acc[0][2 * np + 1], ag, b[2], b[3]);
          mma16816(acc[1][2 * np + 1], at, b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // every ring is drained: the sums take its place
  // the four warps' sums, added in warp order, then the epilogue: element
  // (F-column g8 (+8), row 2 (lane % 4) (+1)) of each 16 x 8 fragment
  float* red = reinterpret_cast<float*>(smem_raw);  // [w][p][n][c][lane]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(((warp * 2 + p) * NT + n) * 4 + c) * 32 + lane] = acc[p][n][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NT * 128; idx += SK_THREADS) {
    const int n = idx >> 7, c = (idx >> 5) & 3, ln = idx & 31;
    const int f = f0 + (ln >> 2) + (c >> 1) * 8, m = m0 + n * 8 + (ln & 3) * 2 + (c & 1);
    if (f >= F || m >= M) continue;
    float g = 0.f, t = 0.f;
#pragma unroll
    for (int w = 0; w < SK_WARPS; ++w) {
      g += red[(((w * 2) * NT + n) * 4 + c) * 32 + ln];
      t += red[(((w * 2 + 1) * NT + n) * 4 + c) * 32 + ln];
    }
    g += to_f(bg[f]);
    t += to_f(bx[f]);
    const float sg = 1.f / (1.f + expf(-g));
    out[(size_t)m * F + f] = from_f<bf16>(g * sg * t);
  }
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

// the tensor-core instances' conditions (the wrapper's instance rule
// holds them; a call that breaks them is refused, never rerouted)
bool tc_ok(int dtype, int E, int F, std::initializer_list<const void*> ptrs) {
  return dtype == 1 && E % 8 == 0 && F % 8 == 0 && aligned16(ptrs);
}

template <int NT>
int launch_skinny(const bf16* x, const bf16* wg, const bf16* bg, const bf16* wx,
                  const bf16* bx, bf16* out, int M, int E, int F, cudaStream_t stream) {
  const int rc = allow_smem<swiglu_fwd_skinny_mma<NT>>(SkLayout<NT>::SMEM);
  if (rc != 0) return rc;
  swiglu_fwd_skinny_mma<NT><<<dim3(cdiv(F, SK_F), cdiv(M, 8 * NT)), SK_THREADS,
                              SkLayout<NT>::SMEM, stream>>>(x, wg, bg, wx, bx, out, M, E, F);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd_tc(int instance, const bf16* x, const bf16* wg, const bf16* bg,
                  const bf16* wx, const bf16* bx, bf16* out, int M, int E, int F,
                  cudaStream_t stream) {
  if (instance == SKINNY) {
    // 8 NT rows a block: the fewest 8-row groups that hold M, at most 8
    if (M <= 8) return launch_skinny<1>(x, wg, bg, wx, bx, out, M, E, F, stream);
    if (M <= 16) return launch_skinny<2>(x, wg, bg, wx, bx, out, M, E, F, stream);
    if (M <= 32) return launch_skinny<4>(x, wg, bg, wx, bx, out, M, E, F, stream);
    return launch_skinny<8>(x, wg, bg, wx, bx, out, M, E, F, stream);
  }
  constexpr int smem = WgCfg<ACT_N>::SMEM;
  const int rc = allow_smem<swiglu_act_wgmma<false>>(smem);
  if (rc != 0) return rc;
  swiglu_act_wgmma<false><<<dim3(cdiv(F, ACT_N), cdiv(M, WG_TM)), WG_THREADS, smem, stream>>>(
      x, wg, bg, wx, bx, nullptr, out, nullptr, M, E, F);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_mma(const bf16* x, const bf16* wg, const bf16* bg, const bf16* wx,
                   const bf16* bx, const bf16* gh, bf16* dgt, float* dw, float* db,
                   float* work, int M, int E, int F, cudaStream_t stream) {
  const int tiles = cdiv(M, WG_TM), slices = wgrad_slices(M, E, F);
  float* part = work;
  float* wpart = work + (size_t)tiles * 2 * F;
  constexpr int act_smem = WgCfg<ACT_N>::SMEM, wgrad_smem = WgCfg<WGRAD_N>::SMEM;
  int rc = allow_smem<swiglu_act_wgmma<true>>(act_smem);
  if (rc == 0) rc = allow_smem<swiglu_wgrad_wgmma>(wgrad_smem);
  if (rc != 0) return rc;
  swiglu_act_wgmma<true><<<dim3(cdiv(F, ACT_N), tiles), WG_THREADS, act_smem, stream>>>(
      x, wg, bg, wx, bx, gh, dgt, part, M, E, F);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  swiglu_wgrad_wgmma<<<dim3(cdiv(F, WGRAD_N), cdiv(E, WG_TM), slices), WG_THREADS, wgrad_smem,
                       stream>>>(x, dgt, dw, wpart, M, E, F, slices);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int n4 = slices > 1 ? E * F / 2 : 0;  // 2 E F floats as float4s
  swiglu_bwd_finish_kernel<<<cdiv(2 * F + n4, 256), 256, 0, stream>>>(
      part, db, tiles, 2 * F, reinterpret_cast<float4*>(dw),
      reinterpret_cast<const float4*>(wpart), slices, n4);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const void* x, const void* wg, const void* bg, const void* wx,
                const void* bx, void* out, int M, int E, int F, cudaStream_t stream) {
  dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  swiglu_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(bg), static_cast<const T*>(wx),
      static_cast<const T*>(bx), static_cast<T*>(out), M, E, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_simt(const void* x, const void* wg, const void* bg, const void* wx,
                    const void* bx, const void* gh, void* dgt, float* dw,
                    float* db, float* part, int M, int E, int F,
                    cudaStream_t stream) {
  const int tiles = (M + GT - 1) / GT;
  swiglu_bwd_act_kernel<T><<<dim3((F + GT - 1) / GT, tiles), GTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(bg), static_cast<const T*>(wx),
      static_cast<const T*>(bx), static_cast<const T*>(gh),
      static_cast<T*>(dgt), part, M, E, F);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  swiglu_bwd_wgrad_kernel<T><<<dim3((F + GT - 1) / GT, (E + GT - 1) / GT), GTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dgt), dw, M, E, F);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  swiglu_bwd_finish_kernel<<<cdiv(2 * F, 256), 256, 0, stream>>>(part, db, tiles, 2 * F,
                                                                 nullptr, nullptr, 1, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of fp32 workspace fused_swiglu_bwd needs for (M, E, F) and the
// instance (-1: refused). simt: the column sums of each 64-row tile; mma:
// those of each 128-row tile, then the weight grad's partials of every
// row slice past the first.
extern "C" int fused_swiglu_bwd_workspace(int M, int E, int F, int instance) {
  if (M <= 0 || E <= 0 || F <= 0) return -1;
  long long n;
  if (instance == SIMT)
    n = (long long)cdiv(M, GT) * 2 * F;
  else if (instance == MMA)
    n = (long long)cdiv(M, WG_TM) * 2 * F + (long long)(wgrad_slices(M, E, F) - 1) * 2 * E * F;
  else
    return -1;
  return n > INT_MAX ? -1 : static_cast<int>(n);
}

// x (M, E), wg/wx (E, F), bg/bx (F,), gh (M, F) in the storage type;
// dgt (M, 2F) = [dg | dt] in the storage type; dw (2, E, F) = [dWg, dWx]
// and db (2F,) = [dbg | dbx] in fp32; work as sized above. dtype: 0 =
// float32, 1 = bfloat16; instance: 0 = simt, 1 = mma (bf16, E and F
// multiples of 8, 16-byte aligned operands, else refused). Returns the
// launches' CUDA error code.
extern "C" int fused_swiglu_bwd(const void* x, const void* wg, const void* bg,
                                const void* wx, const void* bx, const void* gh,
                                void* dgt, void* dw, void* db, void* work,
                                int M, int E, int F, int dtype, int instance,
                                void* stream) {
  if (M <= 0 || E <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(dw);
  float* b = static_cast<float*>(db);
  float* p = static_cast<float*>(work);
  if (instance == MMA) {
    if (!tc_ok(dtype, E, F, {x, wg, bg, wx, bx, gh, dgt, dw, work}))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bwd_mma(static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                          static_cast<const bf16*>(bg), static_cast<const bf16*>(wx),
                          static_cast<const bf16*>(bx), static_cast<const bf16*>(gh),
                          static_cast<bf16*>(dgt), w, b, p, M, E, F, s);
  }
  if (instance != SIMT) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch_bwd_simt<float>(x, wg, bg, wx, bx, gh, dgt, w, b, p, M, E, F, s);
    case 1: return launch_bwd_simt<bf16>(x, wg, bg, wx, bx, gh, dgt, w, b, p, M, E, F, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype: 0 = float32, 1 = bfloat16; instance: 0 = simt, 1 = mma, 2 =
// skinny (the last two: bf16, E and F multiples of 8, 16-byte aligned
// operands, else refused). Returns the launch's CUDA error code.
extern "C" int fused_swiglu_fwd(const void* x, const void* wg, const void* bg,
                                const void* wx, const void* bx, void* out,
                                int M, int E, int F, int dtype, int instance,
                                void* stream) {
  if (M <= 0 || E <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == MMA || instance == SKINNY) {
    if (!tc_ok(dtype, E, F, {x, wg, bg, wx, bx, out}))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_fwd_tc(instance, static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                         static_cast<const bf16*>(bg), static_cast<const bf16*>(wx),
                         static_cast<const bf16*>(bx), static_cast<bf16*>(out), M, E, F, s);
  }
  if (instance != SIMT) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch_simt<float>(x, wg, bg, wx, bx, out, M, E, F, s);
    case 1: return launch_simt<bf16>(x, wg, bg, wx, bx, out, M, E, F, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
