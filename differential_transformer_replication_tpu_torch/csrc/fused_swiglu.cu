// Fused SwiGLU forward and backward for Hopper (sm_90a):
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
// TPU kernel's preferred_element_type=float32 dot. At training shapes
// (M >= 512, bf16) the products run on tensor cores instead (the WMMA
// path below), where the arithmetic, not the weight read, bounds the
// kernel; wgmma/TMA tiles are later work.
//
// The backward (kernel G, below the forward) replaces _ffn_bwd_kernel
// (via _bwd_call); see its own note.
//
// Epilogue numerics follow the JAX kernel: the biases arrive already in
// T (the wrapper casts them, as fused_ffn.py does) and are widened to
// fp32 before the add; silu(g) = g * sigmoid(g) and the product run in
// fp32; the result is rounded to T once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// The tensor-core path (bf16). For bf16 operands whose E and F are
// multiples of 64 (the recipe: 768, 3072), the training-shape products
// run on WMMA 16x16x16 bf16 fragments with fp32 accumulators instead of
// SIMT FMAs: a block of 8 warps owns a 64x64 output tile, each warp a
// 16x32 slice of it for both products; 64x32 / 32x64 operand tiles are
// staged in shared memory with 16-byte loads (rows past M read as zero);
// the accumulators leave through shared memory into the same fp32
// epilogues as the SIMT kernels. Products of bf16 values are exact in
// fp32 and summed in fp32, like the SIMT path, in another order. No
// asynchronous copies or multi-stage pipeline yet.

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int WT = 64;          // output tile edge
constexpr int WK = 32;          // contraction depth staged per step
constexpr int WPAD = 8;         // bf16 row padding: ldm stays a multiple of 8
constexpr int WTHREADS = 256;   // 8 warps: rows 16 * (w / 2), cols 32 * (w % 2)
constexpr int ACC_LD = WT + 4;  // fp32 epilogue row stride
constexpr int WMMA_FWD_MIN_M = 512;  // below it (decode, prefill chunks) the
                                     // SIMT forward keeps every SM busier

using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragAc = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// rows [row0, row0 + rows) x cols [col0, col0 + cols) of a row-major bf16
// array (ld elements per row, nrows rows) into shared memory (row stride
// sld), 8 elements per 16-byte load; rows past nrows are zero
__device__ __forceinline__ void stage_bf16(bf16* s, int sld, const bf16* g,
                                           int ld, int row0, int nrows,
                                           int col0, int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += WTHREADS) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * ld + col0 + c);
    *reinterpret_cast<uint4*>(s + r * sld + c) = v;
  }
}

// shared memory of the (M, F)-tile kernels: the staging tiles, later
// reused for the two fp32 accumulator tiles and the column-sum scratch
constexpr int ACT_STAGE_BYTES =
    (WT * (WK + WPAD) + 2 * WK * (WT + WPAD)) * (int)sizeof(bf16);
constexpr int ACT_EPI_BYTES = (2 * WT * ACC_LD + 2 * 4 * WT) * (int)sizeof(float);
constexpr int ACT_SMEM = ACT_STAGE_BYTES > ACT_EPI_BYTES ? ACT_STAGE_BYTES : ACT_EPI_BYTES;

// g = x @ Wg and t = x @ Wx (no bias) for the 64x64 tile at (row0, col0),
// left in acc[0] / acc[1] (fp32, [WT][ACC_LD]) in shared memory
__device__ __forceinline__ void gt_tile_wmma(unsigned char* raw, const bf16* x,
                                             const bf16* wg, const bf16* wx,
                                             int M, int E, int F, int row0,
                                             int col0) {
  bf16* xs = reinterpret_cast<bf16*>(raw);   // [WT][WK + WPAD]
  bf16* gs = xs + WT * (WK + WPAD);          // [WK][WT + WPAD]
  bf16* ts = gs + WK * (WT + WPAD);          // [WK][WT + WPAD]
  const int warp = threadIdx.x >> 5, wr = (warp >> 1) * 16, wc = (warp & 1) * 32;
  FragC cg[2], ct[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wm::fill_fragment(cg[j], 0.f);
    wm::fill_fragment(ct[j], 0.f);
  }
  for (int k0 = 0; k0 < E; k0 += WK) {
    __syncthreads();
    stage_bf16(xs, WK + WPAD, x, E, row0, M, k0, WT, WK);
    stage_bf16(gs, WT + WPAD, wg, F, k0, E, col0, WK, WT);
    stage_bf16(ts, WT + WPAD, wx, F, k0, E, col0, WK, WT);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      FragA a;
      wm::load_matrix_sync(a, xs + wr * (WK + WPAD) + kk, WK + WPAD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB b;
        wm::load_matrix_sync(b, gs + kk * (WT + WPAD) + wc + 16 * j, WT + WPAD);
        wm::mma_sync(cg[j], a, b, cg[j]);
        wm::load_matrix_sync(b, ts + kk * (WT + WPAD) + wc + 16 * j, WT + WPAD);
        wm::mma_sync(ct[j], a, b, ct[j]);
      }
    }
  }
  __syncthreads();  // the staging tiles are dead: the accumulators take over
  float* acc = reinterpret_cast<float*>(raw);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wm::store_matrix_sync(acc + wr * ACC_LD + wc + 16 * j, cg[j], ACC_LD, wm::mem_row_major);
    wm::store_matrix_sync(acc + WT * ACC_LD + wr * ACC_LD + wc + 16 * j, ct[j],
                          ACC_LD, wm::mem_row_major);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(WTHREADS)
swiglu_fwd_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                       const bf16* __restrict__ bg, const bf16* __restrict__ wx,
                       const bf16* __restrict__ bx, bf16* __restrict__ out,
                       int M, int E, int F) {
  __shared__ __align__(128) unsigned char raw[ACT_SMEM];
  const int row0 = blockIdx.y * WT, col0 = blockIdx.x * WT;
  gt_tile_wmma(raw, x, wg, wx, M, E, F, row0, col0);
  const float* acc = reinterpret_cast<const float*>(raw);
  const int c = threadIdx.x % WT, col = col0 + c;
  const float bgv = to_f(bg[col]), bxv = to_f(bx[col]);
  for (int r = threadIdx.x / WT; r < WT && row0 + r < M; r += WTHREADS / WT) {
    const float g = acc[r * ACC_LD + c] + bgv;
    const float t = acc[WT * ACC_LD + r * ACC_LD + c] + bxv;
    const float sig = 1.f / (1.f + expf(-g));
    out[(size_t)(row0 + r) * F + col] = from_f<bf16>(g * sig * t);
  }
}

__global__ void __launch_bounds__(WTHREADS)
swiglu_bwd_act_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                           const bf16* __restrict__ bg, const bf16* __restrict__ wx,
                           const bf16* __restrict__ bx, const bf16* __restrict__ gh,
                           bf16* __restrict__ dgt, float* __restrict__ part,
                           int M, int E, int F) {
  __shared__ __align__(128) unsigned char raw[ACT_SMEM];
  const int row0 = blockIdx.y * WT, col0 = blockIdx.x * WT;
  gt_tile_wmma(raw, x, wg, wx, M, E, F, row0, col0);
  const float* acc = reinterpret_cast<const float*>(raw);
  float* red = reinterpret_cast<float*>(raw) + 2 * WT * ACC_LD;  // [2][4][WT]
  const int c = threadIdx.x % WT, grp = threadIdx.x / WT, col = col0 + c;
  const float bgv = to_f(bg[col]), bxv = to_f(bx[col]);
  float sum_g = 0.f, sum_t = 0.f;
  for (int r = grp; r < WT && row0 + r < M; r += WTHREADS / WT) {
    const int row = row0 + r;
    const float g = acc[r * ACC_LD + c] + bgv;
    const float t = acc[WT * ACC_LD + r * ACC_LD + c] + bxv;
    const float sg = 1.f / (1.f + expf(-g));
    const float h = to_f(gh[(size_t)row * F + col]);
    const float dg = h * t * (sg * (1.f + g * (1.f - sg)));
    const float dt = h * (g * sg);
    dgt[(size_t)row * 2 * F + col] = from_f<bf16>(dg);
    dgt[(size_t)row * 2 * F + F + col] = from_f<bf16>(dt);
    sum_g += dg;
    sum_t += dt;
  }
  red[grp * WT + c] = sum_g;
  red[4 * WT + grp * WT + c] = sum_t;
  __syncthreads();
  if (threadIdx.x < 2 * WT) {
    const int which = threadIdx.x / WT, cc = threadIdx.x % WT;
    float total = 0.f;
    for (int g = 0; g < 4; ++g) total += red[which * 4 * WT + g * WT + cc];
    part[(size_t)blockIdx.y * 2 * F + which * F + col0 + cc] = total;
  }
}

// dW (2, E, F) fp32: [x^T dg, x^T dt] for the 64x64 tile at (e0, f0),
// summed over all M rows in steps of WK
__global__ void __launch_bounds__(WTHREADS)
swiglu_bwd_wgrad_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dgt,
                             float* __restrict__ dw, int M, int E, int F) {
  __shared__ __align__(128) bf16 xs[WK * (WT + WPAD)];      // [m][e]
  __shared__ __align__(128) bf16 ds[2 * WK * (WT + WPAD)];  // [2][m][f]
  const int e0 = blockIdx.y * WT, f0 = blockIdx.x * WT;
  const int warp = threadIdx.x >> 5, er = (warp >> 1) * 16, fc = (warp & 1) * 32;
  FragC cg[2], ct[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wm::fill_fragment(cg[j], 0.f);
    wm::fill_fragment(ct[j], 0.f);
  }
  for (int m0 = 0; m0 < M; m0 += WK) {
    __syncthreads();
    stage_bf16(xs, WT + WPAD, x, E, m0, M, e0, WK, WT);
    stage_bf16(ds, WT + WPAD, dgt, 2 * F, m0, M, f0, WK, WT);
    stage_bf16(ds + WK * (WT + WPAD), WT + WPAD, dgt, 2 * F, m0, M, F + f0, WK, WT);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      FragAc a;  // x^T: element (e, m) at xs[m][e], a column-major view
      wm::load_matrix_sync(a, xs + kk * (WT + WPAD) + er, WT + WPAD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB b;
        wm::load_matrix_sync(b, ds + kk * (WT + WPAD) + fc + 16 * j, WT + WPAD);
        wm::mma_sync(cg[j], a, b, cg[j]);
        wm::load_matrix_sync(b, ds + WK * (WT + WPAD) + kk * (WT + WPAD) + fc + 16 * j,
                             WT + WPAD);
        wm::mma_sync(ct[j], a, b, ct[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* at = dw + (size_t)(e0 + er) * F + f0 + fc + 16 * j;
    wm::store_matrix_sync(at, cg[j], F, wm::mem_row_major);
    wm::store_matrix_sync(at + (size_t)E * F, ct[j], F, wm::mem_row_major);
  }
}

// whether the bf16 tensor-core path takes these operands
bool wmma_ok(int E, int F, std::initializer_list<const void*> ptrs) {
  if (E % WT != 0 || F % WT != 0) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

template <typename T>
int launch(const void* x, const void* wg, const void* bg, const void* wx,
           const void* bx, void* out, int M, int E, int F,
           cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (M >= WMMA_FWD_MIN_M && wmma_ok(E, F, {x, wg, wx, out})) {
      swiglu_fwd_wmma_kernel<<<dim3(F / WT, (M + WT - 1) / WT), WTHREADS, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
          static_cast<const bf16*>(bg), static_cast<const bf16*>(wx),
          static_cast<const bf16*>(bx), static_cast<bf16*>(out), M, E, F);
      return static_cast<int>(cudaGetLastError());
    }
  }
  dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  swiglu_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(bg), static_cast<const T*>(wx),
      static_cast<const T*>(bx), static_cast<T*>(out), M, E, F);
  return static_cast<int>(cudaGetLastError());
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
// products are ~155 GFLOP each, against ~200 MB of operands: bound by
// arithmetic. Three launches, no atomics (the grads are run-order
// independent): (1) one block per 64x64 tile of (M, F) recomputes g and t
// from staged x/W tiles, writes dg/dt and the tile's fp32 column sums of
// dg/dt; (2) one block per 64x64 tile of (E, F) sums x^T dg and x^T dt
// over all M rows from staged tiles; (3) the column sums of (1) are
// added in row-tile order. In bf16 at the recipe's shapes (1) and (2)
// run on tensor cores (the WMMA path above); fp32 and other shapes run
// plain fp32 FMAs on 4x4 register tiles.

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

// db[c] = sum over row tiles r, in order, of part[r][c], c < 2F
__global__ void swiglu_bwd_bias_kernel(const float* __restrict__ part,
                                       float* __restrict__ db, int tiles,
                                       int width) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float acc = 0.f;
  for (int r = 0; r < tiles; ++r) acc += part[(size_t)r * width + c];
  db[c] = acc;
}

template <typename T>
int launch_bwd(const void* x, const void* wg, const void* bg, const void* wx,
               const void* bx, const void* gh, void* dgt, float* dw,
               float* db, float* part, int M, int E, int F,
               cudaStream_t stream) {
  const int tiles = (M + GT - 1) / GT;
  if constexpr (std::is_same_v<T, bf16>) {
    if (wmma_ok(E, F, {x, wg, wx, gh, dgt, dw})) {
      swiglu_bwd_act_wmma_kernel<<<dim3(F / WT, tiles), WTHREADS, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
          static_cast<const bf16*>(bg), static_cast<const bf16*>(wx),
          static_cast<const bf16*>(bx), static_cast<const bf16*>(gh),
          static_cast<bf16*>(dgt), part, M, E, F);
      int rc = static_cast<int>(cudaGetLastError());
      if (rc != 0) return rc;
      swiglu_bwd_wgrad_wmma_kernel<<<dim3(F / WT, E / WT), WTHREADS, 0, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(dgt), dw, M, E, F);
      rc = static_cast<int>(cudaGetLastError());
      if (rc != 0) return rc;
      swiglu_bwd_bias_kernel<<<(2 * F + 255) / 256, 256, 0, stream>>>(part, db, tiles, 2 * F);
      return static_cast<int>(cudaGetLastError());
    }
  }
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
  swiglu_bwd_bias_kernel<<<(2 * F + 255) / 256, 256, 0, stream>>>(part, db, tiles, 2 * F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of fp32 workspace fused_swiglu_bwd needs for (M, F).
extern "C" int fused_swiglu_bwd_workspace(int M, int F) {
  if (M <= 0 || F <= 0) return -1;
  return ((M + GT - 1) / GT) * 2 * F;
}

// x (M, E), wg/wx (E, F), bg/bx (F,), gh (M, F) in the storage type;
// dgt (M, 2F) = [dg | dt] in the storage type; dw (2, E, F) = [dWg, dWx]
// and db (2F,) = [dbg | dbx] in fp32; work as sized above. dtype: 0 =
// float32, 1 = bfloat16. Returns the launches' CUDA error code.
extern "C" int fused_swiglu_bwd(const void* x, const void* wg, const void* bg,
                                const void* wx, const void* bx, const void* gh,
                                void* dgt, void* dw, void* db, void* work,
                                int M, int E, int F, int dtype, void* stream) {
  if (M <= 0 || E <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(dw);
  float* b = static_cast<float*>(db);
  float* p = static_cast<float*>(work);
  switch (dtype) {
    case 0: return launch_bwd<float>(x, wg, bg, wx, bx, gh, dgt, w, b, p, M, E, F, s);
    case 1: return launch_bwd<__nv_bfloat16>(x, wg, bg, wx, bx, gh, dgt, w, b, p, M, E, F, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
