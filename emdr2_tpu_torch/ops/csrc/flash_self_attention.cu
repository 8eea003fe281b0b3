// Padding-masked flash self-attention on the fused QKV slab (bf16), Hopper:
// forward with in-kernel dropout, and its backward.
//
// Replaces: emdr2_tpu/ops/fid_attention.py:_self_fwd_kernel (forward) and
// :_self_bwd_kernel (backward) of flash_self_attention. For each row b and
// head h,
//   out[b, :, h] = dropout(softmax(q k^T * hd^-0.5 + kv_bias[b])) v
// reading q, k and v straight from the [B, L, 3H] slab at column offsets
// h*hd, H + h*hd and 2H + h*hd, and the backward writes dq, dk and dv into
// the same column slices of a [B, L, 3H] dqkv slab: no split or head
// transpose in memory, in either direction.
//
// Rounding follows the TPU kernel: scores in fp32 as s*scale + bias (bias is
// 0 / -1e9, never -inf); p = exp(s - rowmax); l = sum(p) in fp32 over the
// unrounded, undropped p; dropped p are zeroed (hashing.cuh, keep mask with
// bh = b*nh + h, j = 0, col = the global key index) and p is rounded to bf16
// BEFORE the P.V product, which accumulates in fp32; the division by
// l*(1-rate) (guarded > 0) comes after the product. The forward also writes
// the row statistics (rowmax, 1/l) [B, nh, 2, L] fp32 for the backward: an
// lse = rowmax + log(l) would lose log(l) in fp32 when a fully padded row
// has rowmax ~ -1e9, and the TPU backward, which recomputes both, does not.
//
// Backward (TPU formula): P = exp(s - rowmax) / l; delta = rowsum(do*out);
// dP = do v^T, zeroed where dropped and scaled by 1/(1-rate);
// dS = P (dP - delta); dq = dS k * scale; dk = dS^T q * scale;
// dv = P_d^T do with P_d the dropped, rescaled P. dS and P_d are rounded to
// bf16 for the tensor-core products (the TPU multiplies them in fp32).
//
// What bounds it on the H100: at L=512 (FiD encoder, B*K=400 rows) the
// 4*L^2*hd FLOP per row and head (forward; ~2.5x that backward) make it
// compute bound; at L=64 (query tower) it is launch and memory bound.
//
// Design: every kernel runs four warps of 16 rows over 64-row tiles, both
// products on the tensor cores through WMMA (bf16 x bf16 -> fp32, 16x16x16).
// Forward: one block per (query tile, head, row); the key axis is walked in
// two passes: pass 1 finds the exact row max, pass 2 recomputes the scores,
// forms p against that final max (so p rounds exactly where the TPU kernel
// rounds it, which an online softmax would not), sums l and accumulates P.V.
// The extra Q.K^T pass costs 1.5x the score FLOPs but keeps shared memory at
// ~53 KB per block. Backward: two kernels, neither with atomics, so the
// gradients are deterministic: one block per (query tile, head, row) walks
// the keys for dq (and writes delta), then one block per (key tile, head,
// row) walks the queries for dk and dv; both recompute P from the saved
// row statistics. Later work: wgmma + TMA, a single forward pass, a fused
// backward.

#include <math.h>

#include "attention_tiles.cuh"
#include "hashing.cuh"

namespace {

using namespace attn;

constexpr int FWD_SMEM = 3 * TILE_BYTES + WARPS * (S_BYTES + P_BYTES);
constexpr int DQ_SMEM = 4 * TILE_BYTES + WARPS * (2 * S_BYTES + P_BYTES);
constexpr int DKV_SMEM = 4 * TILE_BYTES + WARPS * (2 * S_BYTES + 2 * P_BYTES)
                         + 3 * TR * 4;

__global__ void __launch_bounds__(THREADS)
self_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                const float* __restrict__ kv_bias,
                __nv_bfloat16* __restrict__ out, float* __restrict__ stats,
                int L, int nh, float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + TR * LDT;
  __nv_bfloat16* Vs = Ks + TR * LDT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Sw = reinterpret_cast<float*>(smem + 3 * TILE_BYTES) + warp * 16 * LDS;
  __nv_bfloat16* Pw = reinterpret_cast<__nv_bfloat16*>(
      smem + 3 * TILE_BYTES + WARPS * S_BYTES) + warp * 16 * LDP;
  const __nv_bfloat16* Qw = Qs + warp * 16 * LDT;

  const int q0 = blockIdx.x * TR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * HD;
  const int H3 = 3 * H;
  const __nv_bfloat16* slab = qkv + (size_t)b * L * H3;
  const float* bias = kv_bias + (size_t)b * L;
  const uint32_t bh = (uint32_t)(b * nh + h);

  // each query row of the warp is owned by a lane pair; the pair splits
  // the tile's columns even/odd
  const int row = lane >> 1;
  const int half = lane & 1;
  const int qrow = q0 + warp * 16 + row;
  const int n_kt = (L + TR - 1) / TR;

  load_tile(Qs, slab, H3, h * HD, q0, L);

  // ---- pass 1: exact row max over every real key ----
  float m = -INFINITY;
  for (int t = 0; t < n_kt; ++t) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    load_tile(Ks, slab, H3, H + h * HD, t * TR, L);
    __syncthreads();
    product_abt(Qw, Ks, Sw);
    __syncwarp();
    for (int j = 0; j < TR / 2; ++j) {
      const int c = half + 2 * j;
      const int key = t * TR + c;
      if (key < L) m = fmaxf(m, Sw[row * LDS + c] * scale + bias[key]);
    }
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // ---- pass 2: p = exp(s - m), l = sum p, acc = bf16(dropout(p)) . v ----
  FragC acc[HD / 16];
#pragma unroll
  for (int f = 0; f < HD / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
  float l = 0.0f;
  for (int t = 0; t < n_kt; ++t) {
    __syncthreads();
    load_tile(Ks, slab, H3, H + h * HD, t * TR, L);
    load_tile(Vs, slab, H3, 2 * H + h * HD, t * TR, L);
    __syncthreads();
    product_abt(Qw, Ks, Sw);
    __syncwarp();
    for (int j = 0; j < TR / 2; ++j) {
      const int c = half + 2 * j;
      const int key = t * TR + c;
      float p = 0.0f;  // keys past L do not exist: no weight, no sum
      if (key < L) p = expf(Sw[row * LDS + c] * scale + bias[key] - m);
      l += p;
      if (drop.on && p != 0.0f &&
          !dropout_keep(drop.seed, bh, 0u, (uint32_t)qrow, (uint32_t)key,
                        drop.threshold)) {
        p = 0.0f;
      }
      Pw[row * LDP + c] = __float2bfloat16(p);
    }
    __syncwarp();
    accumulate_pb(acc, Pw, Vs);
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  // stage the [16, HD] fp32 product through the warp's score tile
  __syncwarp();
  stage_acc(Sw, acc);
  __syncwarp();
  if (qrow < L) {
    const float l_eff = l * drop.keep_frac;
    const float safe = l_eff > 0.0f ? l_eff : 1.0f;
    __nv_bfloat16* dst = out + ((size_t)b * L + qrow) * H + h * HD;
    for (int j = 0; j < HD / 2; ++j) {
      const int c = half + 2 * j;
      dst[c] = __float2bfloat16(Sw[row * LDS + c] / safe);
    }
    if (half == 0 && stats != nullptr) {
      stats[(size_t)bh * 2 * L + qrow] = m;
      stats[((size_t)bh * 2 + 1) * L + qrow] = 1.0f / (l > 0.0f ? l : 1.0f);
    }
  }
}

// dq for one (query tile, head, row); also writes delta = rowsum(do * out).
__global__ void __launch_bounds__(THREADS)
self_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const float* __restrict__ kv_bias,
                   const __nv_bfloat16* __restrict__ out,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ stats, float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dqkv, int L, int nh,
                   float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + TR * LDT;
  __nv_bfloat16* Ks = dOs + TR * LDT;
  __nv_bfloat16* Vs = Ks + TR * LDT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* wbase = smem + 4 * TILE_BYTES + warp * (2 * S_BYTES + P_BYTES);
  float* Sw = reinterpret_cast<float*>(wbase);
  float* dPw = reinterpret_cast<float*>(wbase + S_BYTES);
  __nv_bfloat16* dSw = reinterpret_cast<__nv_bfloat16*>(wbase + 2 * S_BYTES);

  const int q0 = blockIdx.x * TR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * HD;
  const int H3 = 3 * H;
  const __nv_bfloat16* slab = qkv + (size_t)b * L * H3;
  const float* bias = kv_bias + (size_t)b * L;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int row = lane >> 1;
  const int half = lane & 1;
  const int qrow = q0 + warp * 16 + row;
  const int n_kt = (L + TR - 1) / TR;

  load_tile(Qs, slab, H3, h * HD, q0, L);
  load_tile(dOs, dout + (size_t)b * L * H, H, h * HD, q0, L);

  float dlt = 0.0f;
  float row_m = 0.0f, row_il = 0.0f;
  if (qrow < L) {
    const __nv_bfloat16* o = out + ((size_t)b * L + qrow) * H + h * HD;
    const __nv_bfloat16* g = dout + ((size_t)b * L + qrow) * H + h * HD;
    for (int j = 0; j < HD / 2; ++j) {
      const int c = half + 2 * j;
      dlt += __bfloat162float(g[c]) * __bfloat162float(o[c]);
    }
    row_m = stats[(size_t)bh * 2 * L + qrow];
    row_il = stats[((size_t)bh * 2 + 1) * L + qrow];
  }
  dlt += __shfl_xor_sync(0xffffffffu, dlt, 1);
  if (qrow < L && half == 0) delta[(size_t)bh * L + qrow] = dlt;

  FragC acc[HD / 16];
#pragma unroll
  for (int f = 0; f < HD / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
  for (int t = 0; t < n_kt; ++t) {
    __syncthreads();
    load_tile(Ks, slab, H3, H + h * HD, t * TR, L);
    load_tile(Vs, slab, H3, 2 * H + h * HD, t * TR, L);
    __syncthreads();
    product_abt(Qs + warp * 16 * LDT, Ks, Sw);     // S = q k^T
    product_abt(dOs + warp * 16 * LDT, Vs, dPw);   // dP = do v^T
    __syncwarp();
    for (int j = 0; j < TR / 2; ++j) {
      const int c = half + 2 * j;
      const int key = t * TR + c;
      float ds = 0.0f;
      if (key < L && qrow < L) {
        const float P =
            expf(Sw[row * LDS + c] * scale + bias[key] - row_m) * row_il;
        float dp = dPw[row * LDS + c];
        if (drop.on) {
          dp = dropout_keep(drop.seed, bh, 0u, (uint32_t)qrow, (uint32_t)key,
                            drop.threshold) ? dp * drop.inv_keep : 0.0f;
        }
        ds = P * (dp - dlt);
      }
      dSw[row * LDP + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate_pb(acc, dSw, Ks);                    // dq += dS k
  }
  __syncwarp();
  stage_acc(Sw, acc);
  __syncwarp();
  if (qrow < L) {
    __nv_bfloat16* dst = dqkv + ((size_t)b * L + qrow) * H3 + h * HD;
    for (int j = 0; j < HD / 2; ++j) {
      const int c = half + 2 * j;
      dst[c] = __float2bfloat16(Sw[row * LDS + c] * scale);
    }
  }
}

// dk and dv for one (key tile, head, row), walking the query tiles.
__global__ void __launch_bounds__(THREADS)
self_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const float* __restrict__ kv_bias,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ stats,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dqkv, int L, int nh,
                    float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + TR * LDT;
  __nv_bfloat16* Qs = Vs + TR * LDT;
  __nv_bfloat16* dOs = Qs + TR * LDT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* wbase = smem + 4 * TILE_BYTES
                         + warp * (2 * S_BYTES + 2 * P_BYTES);
  float* Sw = reinterpret_cast<float*>(wbase);
  float* dPw = reinterpret_cast<float*>(wbase + S_BYTES);
  __nv_bfloat16* Pw = reinterpret_cast<__nv_bfloat16*>(wbase + 2 * S_BYTES);
  __nv_bfloat16* dSw = Pw + 16 * LDP;
  float* m_s = reinterpret_cast<float*>(
      smem + 4 * TILE_BYTES + WARPS * (2 * S_BYTES + 2 * P_BYTES));
  float* il_s = m_s + TR;
  float* delta_s = il_s + TR;

  const int k0 = blockIdx.x * TR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * HD;
  const int H3 = 3 * H;
  const __nv_bfloat16* slab = qkv + (size_t)b * L * H3;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int row = lane >> 1;
  const int half = lane & 1;
  const int key = k0 + warp * 16 + row;
  const float kbias = key < L ? kv_bias[(size_t)b * L + key] : 0.0f;
  const int n_qt = (L + TR - 1) / TR;

  load_tile(Ks, slab, H3, H + h * HD, k0, L);
  load_tile(Vs, slab, H3, 2 * H + h * HD, k0, L);

  FragC dk[HD / 16], dv[HD / 16];
#pragma unroll
  for (int f = 0; f < HD / 16; ++f) {
    wmma::fill_fragment(dk[f], 0.0f);
    wmma::fill_fragment(dv[f], 0.0f);
  }
  for (int t = 0; t < n_qt; ++t) {
    __syncthreads();
    load_tile(Qs, slab, H3, h * HD, t * TR, L);
    load_tile(dOs, dout + (size_t)b * L * H, H, h * HD, t * TR, L);
    for (int i = threadIdx.x; i < TR; i += THREADS) {
      const int q = t * TR + i;
      m_s[i] = q < L ? stats[(size_t)bh * 2 * L + q] : 0.0f;
      il_s[i] = q < L ? stats[((size_t)bh * 2 + 1) * L + q] : 0.0f;
      delta_s[i] = q < L ? delta[(size_t)bh * L + q] : 0.0f;
    }
    __syncthreads();
    product_abt(Ks + warp * 16 * LDT, Qs, Sw);     // S^T = k q^T
    product_abt(Vs + warp * 16 * LDT, dOs, dPw);   // dP^T = v do^T
    __syncwarp();
    for (int j = 0; j < TR / 2; ++j) {
      const int c = half + 2 * j;
      const int q = t * TR + c;
      float pd = 0.0f, ds = 0.0f;
      if (q < L && key < L) {
        const float P =
            expf(Sw[row * LDS + c] * scale + kbias - m_s[c]) * il_s[c];
        float dp = dPw[row * LDS + c];
        pd = P;
        if (drop.on) {
          const bool keep = dropout_keep(drop.seed, bh, 0u, (uint32_t)q,
                                         (uint32_t)key, drop.threshold);
          dp = keep ? dp * drop.inv_keep : 0.0f;
          pd = keep ? P * drop.inv_keep : 0.0f;
        }
        ds = P * (dp - delta_s[c]);
      }
      Pw[row * LDP + c] = __float2bfloat16(pd);
      dSw[row * LDP + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate_pb(dv, Pw, dOs);                     // dv += P_d^T do
    accumulate_pb(dk, dSw, Qs);                     // dk += dS^T q
  }
  // stage_acc is warp-collective: every lane takes part, the writes are
  // guarded per row
  __nv_bfloat16* dst = dqkv + ((size_t)b * L + key) * H3 + h * HD;
  __syncwarp();
  stage_acc(Sw, dk);
  __syncwarp();
  if (key < L) {
    for (int j = 0; j < HD / 2; ++j) {
      const int c = half + 2 * j;
      dst[H + c] = __float2bfloat16(Sw[row * LDS + c] * scale);
    }
  }
  __syncwarp();
  stage_acc(Sw, dv);
  __syncwarp();
  if (key < L) {
    for (int j = 0; j < HD / 2; ++j) {
      const int c = half + 2 * j;
      dst[2 * H + c] = __float2bfloat16(Sw[row * LDS + c]);
    }
  }
}

bool bad_shape(int B, int L, int nh, int hd) {
  return hd != HD || B <= 0 || L <= 0 || nh <= 0 || B > 65535 || nh > 65535;
}

}  // namespace

// qkv [B, L, 3*nh*hd] bf16, kv_bias [B, L] fp32, out [B, L, nh*hd] bf16,
// stats [B, nh, 2, L] fp32 (rowmax, 1/l; or null), all contiguous and
// 16-byte aligned.
// Dropout is on when `drop_on` != 0: `threshold` = min(int(rate*2^32),
// 2^32-1), keep_frac = 1 - rate. Returns a cudaError_t (0 = launched).
extern "C" int emdr2_flash_self_attention_bf16(
    const void* qkv, const void* kv_bias, void* out, void* stats, int B, int L,
    int nh, int hd, unsigned int seed, unsigned int threshold, int drop_on,
    float keep_frac, float inv_keep, void* stream) {
  if (bad_shape(B, L, nh, hd)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      self_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + TR - 1) / TR, nh, B);
  const float scale = 1.0f / sqrtf((float)HD);
  self_fwd_kernel<<<grid, THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(kv_bias), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(stats), L, nh, scale,
      make_dropout(seed, threshold, drop_on, keep_frac, inv_keep));
  return (int)cudaGetLastError();
}

// Backward: qkv, kv_bias as the forward; out [B, L, H] and dout [B, L, H]
// bf16; stats [B, nh, 2, L] fp32 from the forward; delta [B, nh, L] fp32
// scratch; dqkv [B, L, 3H] bf16 (every element written). Two launches on
// `stream`, in order. Returns a cudaError_t (0 = launched).
extern "C" int emdr2_flash_self_attention_bwd_bf16(
    const void* qkv, const void* kv_bias, const void* out, const void* dout,
    const void* stats, void* delta, void* dqkv, int B, int L, int nh, int hd,
    unsigned int seed, unsigned int threshold, int drop_on, float keep_frac,
    float inv_keep, void* stream) {
  if (bad_shape(B, L, nh, hd)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      self_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(self_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + TR - 1) / TR, nh, B);
  const float scale = 1.0f / sqrtf((float)HD);
  const Dropout drop = make_dropout(seed, threshold, drop_on, keep_frac,
                                    inv_keep);
  cudaStream_t s = (cudaStream_t)stream;
  self_bwd_dq_kernel<<<grid, THREADS, DQ_SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(kv_bias),
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(stats), static_cast<float*>(delta),
      static_cast<__nv_bfloat16*>(dqkv), L, nh, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  self_bwd_dkv_kernel<<<grid, THREADS, DKV_SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(kv_bias),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dqkv), L, nh, scale, drop);
  return (int)cudaGetLastError();
}
