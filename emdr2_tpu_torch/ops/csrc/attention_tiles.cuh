// Tile helpers shared by the backward kernels of flash cross-attention and
// of the general per-head attention (bf16, head dim 64, four warps of 16
// rows, WMMA 16x16x16 bf16 -> fp32 on the tensor cores, scores staged through
// shared memory).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace attn {

using namespace nvcuda;

constexpr int HD = 64;                  // head dim (BERT-base, T5-base)
constexpr int TR = 64;                  // rows per tile (queries or keys)
constexpr int WARPS = TR / 16;          // 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int LDT = HD + 8;             // bf16 tile row stride (elements)
constexpr int LDS = TR + 4;             // fp32 [16, 64] warp tile row stride
constexpr int LDP = TR + 8;             // bf16 [16, 64] warp tile row stride
constexpr int TILE_BYTES = TR * LDT * 2;
constexpr int S_BYTES = 16 * LDS * 4;   // one fp32 warp tile
constexpr int P_BYTES = 16 * LDP * 2;   // one bf16 warp tile

static_assert(LDS >= HD, "an fp32 warp tile stages a [16, HD] product");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Rows [r0, min(r0+64, limit)) x columns [c0, c0+HD) of a row-major matrix
// with row stride `ld` (elements) -> smem [64, LDT], zero-filled past
// `limit`. 16-byte loads, 8 threads per 128-byte row; needs ld and c0
// multiples of 8 and a 16-byte aligned base.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int ld,
                                          int c0, int r0, int limit) {
  for (int i = threadIdx.x; i < TR * (HD / 8); i += THREADS) {
    const int r = i / (HD / 8);
    const int c = (i % (HD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c0 + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = v;
  }
}

// Out[16, 64] = A[16, HD] . B[64, HD]^T for one warp: A is the warp's 16
// rows of a tile, B a whole tile, both [rows, LDT] in smem; fp32 result
// stored row-major with stride LDS.
__device__ __forceinline__ void product_abt(const __nv_bfloat16* A,
                                            const __nv_bfloat16* B,
                                            float* out) {
#pragma unroll
  for (int n = 0; n < TR / 16; ++n) {
    FragC s;
    wmma::fill_fragment(s, 0.0f);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      FragA a;
      FragBc b;
      wmma::load_matrix_sync(a, A + k * 16, LDT);
      wmma::load_matrix_sync(b, B + n * 16 * LDT + k * 16, LDT);
      wmma::mma_sync(s, a, b, s);
    }
    wmma::store_matrix_sync(out + n * 16, s, LDS, wmma::mem_row_major);
  }
}

// acc[f] += P[16, 64] . B[64, HD] for one warp: P bf16 row-major with stride
// LDP, B a [64, LDT] tile (rows = the contracted axis).
__device__ __forceinline__ void accumulate_pb(FragC (&acc)[HD / 16],
                                              const __nv_bfloat16* P,
                                              const __nv_bfloat16* B) {
#pragma unroll
  for (int kk = 0; kk < TR; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, P + kk, LDP);
#pragma unroll
    for (int f = 0; f < HD / 16; ++f) {
      FragBr b;
      wmma::load_matrix_sync(b, B + kk * LDT + f * 16, LDT);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  }
}

// Stage the warp's [16, HD] accumulator into its fp32 tile `S` (stride LDS).
__device__ __forceinline__ void stage_acc(float* S,
                                          const FragC (&acc)[HD / 16]) {
#pragma unroll
  for (int f = 0; f < HD / 16; ++f) {
    wmma::store_matrix_sync(S + f * 16, acc[f], LDS, wmma::mem_row_major);
  }
}

}  // namespace attn
