// Shared by the head-major bf16 tensor-core kernels (flash_bh_fwd.cu: K1;
// flash_bh_bwd_dq.cu: K2; flash_bh_bwd_dkv.cu: K3): 16-byte cp.async tile
// copies, the two tile products and the launch buckets, over the
// mma.sync, ldmatrix and cp.async wrappers of mma_ptx.cuh (which also
// sets out the fragment layout). Include it after flash_bh_common.cuh
// (the dropout hash, bf16, round16, SMEM_LIMIT); each source includes
// both itself, so the library hash (ops/_kernels.py) covers them. A block
// is MT threads, 4 warps; warp w owns rows 16w .. 16w + 15 of a TILE-row
// operand.

#pragma once

#include "mma_ptx.cuh"

namespace {

constexpr int TILE = 64;     // rows per block: q rows (K1, K2) or keys (K3)
constexpr int KC = 32;       // columns per step: keys (K1, K2) or q rows (K3)
constexpr int MT = 128;      // 4 warps; warp w owns tile rows 16w .. 16w+15
constexpr int SKT = KC / 8;  // 8-column score fragments across a step

// named barrier 1 over n threads (a multiple of 32): for warp groups that
// run their own loops with the same number of barriers
__device__ __forceinline__ void bar_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(n) : "memory");
}

// rows [t0, t0 + rows) of a (T_len, w) row-major slab into a bf16 tile of
// row stride sld; rows past T_len are zeros, columns past w are never
// written (zeroed once at the kernel's start). VEC: 16-byte cp.async
// copies (w a multiple of 8, the slab 16-byte aligned); else 2-byte loads.
// Issued by MT threads, tid = 0 .. MT - 1 (load_rows: the block's).
template <bool VEC>
__device__ __forceinline__ void load_rows_by(int tid, bf16* dst, int sld,
                                             const bf16* __restrict__ src, int T_len, int t0,
                                             int rows, int w) {
  if (VEC) {
    // chunk i = tid + k MT is (row r, 16-byte chunk cc); stepping i by MT
    // adds (dr, dc) with a carry, so no division per chunk
    const int chunks = w >> 3, dr = MT / chunks, dc = MT - dr * chunks;
    int r = tid / chunks, cc = tid - r * chunks;
    for (int i = tid; i < rows * chunks; i += MT) {
      const int c = cc << 3, t = t0 + r;
      const bool ok = t < T_len;
      cp_async16(dst + r * sld + c, src + (size_t)(ok ? t : 0) * w + c, ok);
      r += dr;
      cc += dc;
      if (cc >= chunks) {
        cc -= chunks;
        ++r;
      }
    }
  } else {
    for (int i = tid; i < rows * w; i += MT) {
      const int r = i / w, c = i - r * w;
      const int t = t0 + r;
      dst[r * sld + c] = t < T_len ? src[(size_t)t * w + c] : __float2bfloat16_rn(0.f);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load_rows(bf16* dst, int sld, const bf16* __restrict__ src,
                                          int T_len, int t0, int rows, int w) {
  load_rows_by<VEC>(threadIdx.x, dst, sld, src, T_len, t0, rows, w);
}

__device__ __forceinline__ void zero_smem_by(int tid, void* p, size_t bytes) {
  int4* q = static_cast<int4*>(p);
  for (size_t i = tid; i < bytes / 16; i += MT) q[i] = make_int4(0, 0, 0, 0);
}
__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  zero_smem_by(threadIdx.x, p, bytes);
}

// zeros into n contiguous bf16 elements of device memory (the rows of a
// block that sees no visible pair), 16 bytes a store where VEC (n and the
// start a multiple of 8 elements)
template <bool VEC>
__device__ __forceinline__ void zero_rows_by(int tid, bf16* dst, size_t n) {
  if (VEC) {
    uint4* p = reinterpret_cast<uint4*>(dst);
    for (size_t i = tid; i < n / 8; i += MT) p[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (size_t i = tid; i < n; i += MT) dst[i] = __float2bfloat16_rn(0.f);
  }
}
template <bool VEC>
__device__ __forceinline__ void zero_rows(bf16* dst, size_t n) {
  zero_rows_by<VEC>(threadIdx.x, dst, n);
}

// s (16 rows x KC columns, fp32 fragments) = A B^T over depth kd (a
// multiple of 16): A the warp's 16 rows (a tile of stride lda from its
// first row), B the KC rows of a tile of stride ldb, both stored
// [row][depth]. Depth step k's fragments sit in (a0, b0), k + 16's in (a1,
// b1): the next step's ldmatrix is in flight while this step's mma run.
__device__ __forceinline__ void tile_abt(float (&s)[SKT][4], const bf16* A, int lda,
                                         const bf16* B, int ldb, int kd) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < SKT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  const bf16* a_row = A + (lane & 15) * lda + (lane >> 4) * 8;
  const bf16* b_row = B + ((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 8;
  unsigned a0[4], a1[4], b0[SKT / 2][4], b1[SKT / 2][4];
  auto load = [&](unsigned (&a)[4], unsigned (&b)[SKT / 2][4], int k) {
    ldsm4(a, a_row + k);
#pragma unroll
    for (int np = 0; np < SKT / 2; ++np) ldsm4(b[np], b_row + np * 16 * ldb + k);
  };
  auto mma = [&](const unsigned (&a)[4], const unsigned (&b)[SKT / 2][4]) {
#pragma unroll
    for (int np = 0; np < SKT / 2; ++np) {
      mma16816(s[2 * np], a, b[np][0], b[np][1]);
      mma16816(s[2 * np + 1], a, b[np][2], b[np][3]);
    }
  };
  load(a0, b0, 0);
  for (int k = 0; k < kd; k += 32) {
    if (k + 16 < kd) load(a1, b1, k + 16);
    mma(a0, b0);
    if (k + 16 >= kd) break;
    if (k + 32 < kd) load(a0, b0, k + 32);
    mma(a1, b1);
  }
}

// acc (16 x 8N fp32 fragments, N of them live: n < nlive) += P (16 x KC,
// bf16 A fragments pa[kk] for columns 16kk..16kk+15) times the KC x 8N
// tile B of stride ldb stored [P column][acc column] (read transposed)
template <int N>
__device__ __forceinline__ void tile_pb(float (&acc)[N][4], const unsigned (&pa)[KC / 16][4],
                                        const bf16* B, int ldb, int nlive) {
  const int lane = threadIdx.x & 31;
  const bf16* b_row = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      if (2 * np < nlive) {
        unsigned bb[4];
        ldsm4t(bb, b_row + kk * 16 * ldb + np * 16);
        mma16816(acc[2 * np], pa[kk], bb[0], bb[1]);
        mma16816(acc[2 * np + 1], pa[kk], bb[2], bb[3]);
      }
    }
  }
}

// the C fragments of s (16 x KC) as A fragments of the next product
__device__ __forceinline__ void to_a(unsigned (&pa)[KC / 16][4], const float (&s)[SKT][4]) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// one row's pair of adjacent columns (c, c + 1) of a bf16 output
template <bool VEC>
__device__ __forceinline__ void store2(bf16* dst, int c, int w, float x0, float x1) {
  if (VEC) {
    if (c < w) *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < w) dst[0] = __float2bfloat16_rn(x0);
    if (c + 1 < w) dst[1] = __float2bfloat16_rn(x1);
  }
}

// the keep bit of keep_bit() with the row and column factors precomputed:
// x = row * 0x85EBCA77 ^ col * 0xC2B2AE3D
__device__ __forceinline__ bool keep_x(const Drop& dr, uint32_t key, uint32_t x) {
  return fmix32(fmix32(x + key) ^ dr.w1m) >= dr.threshold;
}

// --- launch helpers ---------------------------------------------------------

int pad16(int x) { return (x + 15) & ~15; }
// fragment counts of an instance, by bucket: one instance per bucket, the
// fragments past the head's width skipped at run time
int v_bucket(int dv) {  // 8-column fragments of a dv-wide accumulator
  const int n = pad16(dv) / 8;
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 24 ? 24 : 32;
}
int d_bucket(int d) {  // 8-column fragments of a d-wide accumulator or operand
  const int n = pad16(d) / 8;
  return n <= 8 ? 8 : n <= 12 ? 12 : 16;
}

}  // namespace
