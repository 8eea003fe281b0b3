// Padding-masked flash self-attention on the fused QKV slab (bf16), Hopper.
//
// Replaces: emdr2_tpu/ops/fid_attention.py:_self_fwd_kernel (the forward
// of flash_self_attention). Computes, for each row b and head h,
//   out[b, :, h] = softmax(q k^T * hd^-0.5 + kv_bias[b]) v
// reading q, k and v straight from the [B, L, 3H] slab at column offsets
// h*hd, H + h*hd and 2H + h*hd: no split or head transpose in memory.
//
// Rounding follows the TPU kernel: scores in fp32 as s*scale + bias (bias is
// 0 / -1e9, never -inf); p = exp(s - rowmax); l = sum(p) in fp32 over the
// unrounded p; p is rounded to bf16 BEFORE the P.V product, which
// accumulates in fp32; the division by l (guarded l > 0) comes after the
// product; the result is cast to bf16.
//
// What bounds it on the H100: at L=512 (FiD encoder, B*K=400 rows) the
// 4*L^2*hd FLOP per row and head make it compute bound; at L=64 (query
// tower) it is launch and memory bound.
//
// Design: one block per (query tile of 64 rows, head, row); four warps of
// 16 query rows each. Both products run on the tensor cores through WMMA
// (bf16 x bf16 -> fp32, 16x16x16). The key axis is walked in tiles of 64 in
// two passes: pass 1 finds the exact row max, pass 2 recomputes the scores,
// forms p against that final max (so p rounds exactly where the TPU kernel
// rounds it, which an online softmax would not), sums l and accumulates
// P.V. The extra Q.K^T pass costs 1.5x the score FLOPs but keeps shared
// memory at ~53 KB per block (several blocks per SM) instead of holding an
// [64, L] fp32 score slab. Later work: wgmma + TMA, and a single pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HD = 64;                  // head dim (BERT-base, T5-base)
constexpr int QT = 64;                  // query rows per block
constexpr int KT = 64;                  // keys per tile
constexpr int WARPS = QT / 16;          // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int LDT = HD + 8;             // bf16 tile row stride (elements)
constexpr int LDS = KT + 4;             // fp32 score tile row stride
constexpr int LDP = KT + 8;             // bf16 prob tile row stride
constexpr int TILE_BYTES = 64 * LDT * 2;
constexpr int S_BYTES = 16 * LDS * 4;   // per warp
constexpr int P_BYTES = 16 * LDP * 2;   // per warp
constexpr int SMEM_BYTES = 3 * TILE_BYTES + WARPS * (S_BYTES + P_BYTES);

static_assert(QT == 64 && KT == 64, "tile loader assumes 64-row tiles");
static_assert(LDS >= HD, "the output staging reuses the score tile");

// Rows [r0, r0+64) x columns [c0, c0+HD) of one slab row block -> smem,
// zero-filled past L. 16-byte loads, 8 threads per 128-byte row.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* slab, int H3,
                                          int c0, int r0, int L) {
  for (int i = threadIdx.x; i < 64 * (HD / 8); i += THREADS) {
    const int r = i / (HD / 8);
    const int c = (i % (HD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) {
      v = *reinterpret_cast<const uint4*>(slab + (size_t)(r0 + r) * H3 + c0 + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = v;
  }
}

// Sw[16, KT] = Qw[16, HD] . Ks[KT, HD]^T (raw, unscaled) for one warp.
__device__ __forceinline__ void score_tile(const __nv_bfloat16* Qw,
                                           const __nv_bfloat16* Ks, float* Sw) {
#pragma unroll
  for (int n = 0; n < KT / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
    wmma::fill_fragment(s, 0.0f);
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qw + k * 16, LDT);
      wmma::load_matrix_sync(b, Ks + n * 16 * LDT + k * 16, LDT);
      wmma::mma_sync(s, a, b, s);
    }
    wmma::store_matrix_sync(Sw + n * 16, s, LDS, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_self_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                            const float* __restrict__ kv_bias,
                            __nv_bfloat16* __restrict__ out,
                            int L, int nh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + 64 * LDT;
  __nv_bfloat16* Vs = Ks + 64 * LDT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(smem + 3 * TILE_BYTES) + warp * 16 * LDS;
  __nv_bfloat16* Pw = reinterpret_cast<__nv_bfloat16*>(
      smem + 3 * TILE_BYTES + WARPS * S_BYTES) + warp * 16 * LDP;
  const __nv_bfloat16* Qw = Qs + warp * 16 * LDT;

  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * HD;
  const int H3 = 3 * H;
  const __nv_bfloat16* slab = qkv + (size_t)b * L * H3;
  const float* bias = kv_bias + (size_t)b * L;

  // each query row of the warp is owned by a lane pair; the pair splits
  // the tile's columns even/odd
  const int row = lane >> 1;
  const int half = lane & 1;
  const int n_kt = (L + KT - 1) / KT;

  load_tile(Qs, slab, H3, h * HD, q0, L);

  // ---- pass 1: exact row max over every real key ----
  float m = -INFINITY;
  for (int t = 0; t < n_kt; ++t) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    load_tile(Ks, slab, H3, H + h * HD, t * KT, L);
    __syncthreads();
    score_tile(Qw, Ks, Sw);
    __syncwarp();
    for (int j = 0; j < KT / 2; ++j) {
      const int c = half + 2 * j;
      const int key = t * KT + c;
      if (key < L) m = fmaxf(m, Sw[row * LDS + c] * scale + bias[key]);
    }
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // ---- pass 2: p = exp(s - m), l = sum p, acc = bf16(p) . v ----
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[HD / 16];
#pragma unroll
  for (int f = 0; f < HD / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
  float l = 0.0f;
  for (int t = 0; t < n_kt; ++t) {
    __syncthreads();
    load_tile(Ks, slab, H3, H + h * HD, t * KT, L);
    load_tile(Vs, slab, H3, 2 * H + h * HD, t * KT, L);
    __syncthreads();
    score_tile(Qw, Ks, Sw);
    __syncwarp();
    for (int j = 0; j < KT / 2; ++j) {
      const int c = half + 2 * j;
      const int key = t * KT + c;
      float p = 0.0f;  // keys past L do not exist: no weight, no sum
      if (key < L) p = expf(Sw[row * LDS + c] * scale + bias[key] - m);
      l += p;
      Pw[row * LDP + c] = __float2bfloat16(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Pw + kk, LDP);
#pragma unroll
      for (int f = 0; f < HD / 16; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kk * LDT + f * 16, LDT);
        wmma::mma_sync(acc[f], pa, vb, acc[f]);
      }
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  // stage the [16, HD] fp32 product through the warp's score tile
  __syncwarp();
#pragma unroll
  for (int f = 0; f < HD / 16; ++f) {
    wmma::store_matrix_sync(Sw + f * 16, acc[f], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  const int qrow = q0 + warp * 16 + row;
  if (qrow < L) {
    const float safe = l > 0.0f ? l : 1.0f;
    __nv_bfloat16* dst = out + ((size_t)b * L + qrow) * H + h * HD;
    for (int j = 0; j < HD / 2; ++j) {
      const int c = half + 2 * j;
      dst[c] = __float2bfloat16(Sw[row * LDS + c] / safe);
    }
  }
}

}  // namespace

// qkv [B, L, 3*nh*hd] bf16, kv_bias [B, L] fp32, out [B, L, nh*hd] bf16, all
// contiguous and 16-byte aligned. Returns a cudaError_t (0 = launched).
extern "C" int emdr2_flash_self_attention_bf16(const void* qkv,
                                               const void* kv_bias, void* out,
                                               int B, int L, int nh, int hd,
                                               void* stream) {
  if (hd != HD || B <= 0 || L <= 0 || nh <= 0 || B > 65535 || nh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_self_attention_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + QT - 1) / QT, nh, B);
  const float scale = 1.0f / sqrtf((float)HD);
  flash_self_attention_kernel<<<grid, THREADS, SMEM_BYTES,
                                (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(kv_bias),
      static_cast<__nv_bfloat16*>(out), L, nh, scale);
  return (int)cudaGetLastError();
}
