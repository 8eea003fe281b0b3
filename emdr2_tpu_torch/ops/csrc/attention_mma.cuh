// Register-resident attention tiles for the flash kernels (bf16, head dim
// 64): the products on the tensor cores with their results in registers,
// tiles brought in by cp.async, an online softmax that never leaves
// registers. Two families of products share the softmax:
// mma.sync.m16n8k16 fed by ldmatrix (one warp at a time: the cross-attention
// forward, whose warps walk different keys) and wgmma.m64n64k16 (four warps
// at a time, operands read straight from shared memory: the walks of
// attention_flash.cuh).
//
// A warp owns M "atoms" of 16 query rows and NT "n-tiles" of 8 keys. Its
// scores S[M][NT][4] come out of Q.K^T in the accumulator layout of the
// product (lane = 4*g + t: elements 0, 1 are row g, keys 2t and 2t+1
// of the n-tile; elements 2, 3 the same keys of row g + 8), and that layout
// is, pair of n-tiles by pair, the A operand of P.V: p is packed to bf16 in
// place and multiplied without touching shared memory. The output
// accumulator O[M][8][4] stays in registers across the whole key walk and
// is rescaled there.
//
// Shared-memory tiles for ldmatrix are [rows, LDT] bf16 with 144-byte rows,
// so the eight row addresses of one ldmatrix fall in eight different
// 16-byte columns of the banks (no conflict, no swizzle); the tiles wgmma
// reads are described with the warpgroup products below. cp.async copies 16
// bytes a thread; rows past a limit are zero-filled by a copy of size 0.
//
// The online softmax works per step (the keys a warp holds at once): it
// rounds p against the running max after that step, where the TPU kernel
// rounds against the max after the whole key chunk. Dropout, l and lse
// keep the TPU kernel's rule: l sums undropped p, the keep mask of
// hashing.cuh zeroes p in the value term only, at the key's place in its
// logical chunk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hashing.cuh"

namespace amma {

constexpr int HD = 64;                  // head dim (BERT-base, T5-base)
constexpr int LDT = HD + 8;             // bf16 tile row stride (elements)
constexpr int DT = HD / 8;              // n-tiles of the output accumulator

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 bytes of zeros when !valid (src is not
// read then, but must still be an address inside the tensor).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) x 64 columns of a row-major matrix -> dst [ROWS, LDT],
// by `nthreads` threads (this one is `tid`); `src` points at column 0 of the
// head in row 0, `ld` is the row stride in elements (a multiple of 8), rows
// at or past `limit` arrive as zeros.
template <int ROWS>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long ld, int r0,
                                                int limit, int tid,
                                                int nthreads) {
  for (int i = tid; i < ROWS * (HD / 8); i += nthreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * LDT + c, src + (size_t)(ok ? r0 + r : 0) * ld + c,
               ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c[16, 8] += a[16, 16] . b[16, 8] (bf16 in, fp32 out).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// exp(x) for x <= 0 by the special-function unit alone: results below the
// normal range flush to zero (p that small adds nothing), which spares the
// range fix-up that the non-flushing form wraps around every call.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S[m][n] = Q[16m + (0..15), :] . K[8n + (0..7), :]^T for one warp: Qs the
// warp's first query row, Ks the first of its 8*NT keys, both [*, LDT].
template <int M, int NT>
__device__ __forceinline__ void scores(float (&S)[M][NT][4],
                                       const __nv_bfloat16* Qs,
                                       const __nv_bfloat16* Ks, int lane) {
  static_assert(NT % 2 == 0, "keys come in pairs of n-tiles");
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) S[m][n][e] = 0.0f;
    }
  }
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      ldsm_x4(a[m], Qs + (16 * m + a_row) * LDT + kk * 16 + a_col);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bk[4];
      ldsm_x4(bk, Ks + (16 * np + b_row) * LDT + kk * 16 + b_col);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        mma_bf16(S[m][2 * np], a[m], bk[0], bk[1]);
        mma_bf16(S[m][2 * np + 1], a[m], bk[2], bk[3]);
      }
    }
  }
}

// One online-softmax step on the warp's scores, in place: S becomes p (fp32,
// dropped entries zeroed), mrow / lrow / O are brought to the new running
// max. lrow is this lane's share of the row sum: add the four lanes of a
// quad at the end. `bias_s` holds the bias of the warp's 8*NT keys, `kin0`
// is the first key's place in its chunk of C keys (keys at or past C are no
// keys: their bias counts as -inf, so p = 0), `j` the chunk, `qrow0` the
// warp's first query row. No branch: the compiler may weave the step into
// the products around it.
template <int M, int NT, bool DROP>
__device__ __forceinline__ void softmax_step(
    float (&S)[M][NT][4], float (&O)[M][DT][4], float (&mrow)[M][2],
    float (&lrow)[M][2], const float* bias_s, int kin0, int C, float scale,
    const Dropout& drop, uint32_t bh, uint32_t j, int qrow0, int lane) {
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + t2;
    const float b0 = kin0 + col < C ? bias_s[col] : -INFINITY;
    const float b1 = kin0 + col + 1 < C ? bias_s[col + 1] : -INFINITY;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      S[m][n][0] = fmaf(S[m][n][0], scale, b0);
      S[m][n][1] = fmaf(S[m][n][1], scale, b1);
      S[m][n][2] = fmaf(S[m][n][2], scale, b0);
      S[m][n][3] = fmaf(S[m][n][3], scale, b1);
    }
  }
  const uint32_t base = drop.seed + bh * 0x27D4EB2Fu + j * 0x165667B1u;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx = fmaxf(mx, fmaxf(S[m][n][2 * hf], S[m][n][2 * hf + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(mrow[m][hf], mx);
      const float corr = exp_fast(mrow[m][hf] - m_new);
      mrow[m][hf] = m_new;
      // the row's term of the mask hash; see dropout_keep in hashing.cuh
      const uint32_t rterm =
          (uint32_t)(qrow0 + 16 * m + 8 * hf + g) * 0x9E3779B1u ^ base;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp_fast(S[m][n][2 * hf + e] - m_new);
          sum += p;
          if (DROP) {
            const uint32_t col = (uint32_t)(kin0 + 8 * n + t2 + e);
            p = murmur_fin(rterm ^ (col * 0x85EBCA77u)) < drop.threshold
                    ? 0.0f : p;
          }
          S[m][n][2 * hf + e] = p;
        }
      }
      lrow[m][hf] = lrow[m][hf] * corr + sum;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        O[m][n][2 * hf] *= corr;
        O[m][n][2 * hf + 1] *= corr;
      }
    }
  }
}

// O[m] += bf16(P[m]) . V for one warp: P the probabilities in the score
// layout, Vs the first of the warp's 8*NT keys' value rows, [*, LDT].
template <int M, int NT>
__device__ __forceinline__ void accumulate_pv(float (&O)[M][DT][4],
                                              const float (&P)[M][NT][4],
                                              const __nv_bfloat16* Vs,
                                              int lane) {
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    uint32_t a[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      a[m][0] = pack_bf16(P[m][2 * ks][0], P[m][2 * ks][1]);
      a[m][1] = pack_bf16(P[m][2 * ks][2], P[m][2 * ks][3]);
      a[m][2] = pack_bf16(P[m][2 * ks + 1][0], P[m][2 * ks + 1][1]);
      a[m][3] = pack_bf16(P[m][2 * ks + 1][2], P[m][2 * ks + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, Vs + (16 * ks + b_row) * LDT + dp * 16 + b_col);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        mma_bf16(O[m][2 * dp], a[m], bv[0], bv[1]);
        mma_bf16(O[m][2 * dp + 1], a[m], bv[2], bv[3]);
      }
    }
  }
}

// The bf16 A operands of a product whose left factor is P (a warp's 16 rows
// in the score layout): A[ks] covers keys 16*ks .. 16*ks + 15.
template <int NT>
__device__ __forceinline__ void pack_scores(uint32_t (&A)[NT / 2][4],
                                            const float (&P)[1][NT][4]) {
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    A[ks][0] = pack_bf16(P[0][2 * ks][0], P[0][2 * ks][1]);
    A[ks][1] = pack_bf16(P[0][2 * ks][2], P[0][2 * ks][3]);
    A[ks][2] = pack_bf16(P[0][2 * ks + 1][0], P[0][2 * ks + 1][1]);
    A[ks][3] = pack_bf16(P[0][2 * ks + 1][2], P[0][2 * ks + 1][3]);
  }
}

template <int M>
__device__ __forceinline__ void init_state(float (&O)[M][DT][4],
                                           float (&mrow)[M][2],
                                           float (&lrow)[M][2]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mrow[m][0] = mrow[m][1] = -1e30f;
    lrow[m][0] = lrow[m][1] = 0.0f;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) O[m][n][e] = 0.0f;
    }
  }
}

// The row sum of a quad's four lanes (every lane gets it).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// ---- warpgroup products (wgmma): a 64-row tile by four warps ----
//
// Tiles that wgmma reads from shared memory are [rows, 64] bf16 with
// 128-byte rows under the 128-byte swizzle (the 16-byte column c of row r
// lives at column c ^ (r % 8)), 1024-byte aligned. The accumulator of
// m64n64 is float[1][8][4] per thread in the layout of the mma scores above
// (warp w of the group owns rows 16w .. 16w + 15), so softmax_step,
// pack_scores and the quad reductions serve both.

constexpr int WG_TILE = 64 * HD;        // elements of a [64, 64] tile

// Element offset of (row r, 16-byte column c) in a swizzled tile.
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * HD + ((c ^ (r & 7)) << 3);
}

// load_rows_async into a swizzled tile.
template <int ROWS>
__device__ __forceinline__ void load_rows_async_swizzled(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long ld, int r0,
    int limit, int tid, int nthreads) {
  for (int i = tid; i < ROWS * (HD / 8); i += nthreads) {
    const int r = i >> 3;
    const int c = i & 7;
    const bool ok = r0 + r < limit;
    cp_async16(dst + swizzled(r, c),
               src + (size_t)(ok ? r0 + r : 0) * ld + c * 8, ok);
  }
}

// Matrix descriptor of a swizzled tile (or of a part of it that starts
// `byte_offset` into it): 8-row groups 1024 bytes apart, 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(const __nv_bfloat16* tile,
                                               int byte_offset) {
  uint64_t d = (uint64_t)(((smem_u32(tile) + byte_offset) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;               // leading offset: unused at 128 bytes
  d |= (uint64_t)(1024 >> 4) << 32;     // stride to the next 8-row group
  d |= (uint64_t)1 << 62;               // 128-byte swizzle
  return d;
}

// Shared memory written by cp.async or plain stores, made visible to wgmma.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The 32 accumulator registers of an m64n64 product, as read-write asm
// operands.
#define AMMA_ACC(d) \
  "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]), \
  "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]), \
  "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]), \
  "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]), \
  "+f"(d[0][4][0]), "+f"(d[0][4][1]), "+f"(d[0][4][2]), "+f"(d[0][4][3]), \
  "+f"(d[0][5][0]), "+f"(d[0][5][1]), "+f"(d[0][5][2]), "+f"(d[0][5][3]), \
  "+f"(d[0][6][0]), "+f"(d[0][6][1]), "+f"(d[0][6][2]), "+f"(d[0][6][3]), \
  "+f"(d[0][7][0]), "+f"(d[0][7][1]), "+f"(d[0][7][2]), "+f"(d[0][7][3])

// Wait until at most N committed groups of products are in flight; `c` and
// `d` are the accumulators that the finished ones wrote, named here so that
// nothing reads them before the wait.
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&c)[1][8][4],
                                           float (&d)[1][8][4]) {
  asm volatile("wgmma.wait_group.sync.aligned %64;\n"
               : AMMA_ACC(c), AMMA_ACC(d)
               : "n"(N)
               : "memory");
}

// d[64, 64] (+)= A[64, 16] . B[64, 16]^T: A and B 16 of the 64 columns of a
// swizzled tile (descriptors); scale_d = 0 starts the sum anew.
__device__ __forceinline__ void wgmma_ss(float (&d)[1][8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : AMMA_ACC(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64, 64] += A[64, 16] . B[16, 64]: A from registers (a warp's 16 rows in
// the mma A layout), B 16 rows of a swizzled tile, read transposed.
__device__ __forceinline__ void wgmma_rs(float (&d)[1][8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : AMMA_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef AMMA_ACC

}  // namespace amma
