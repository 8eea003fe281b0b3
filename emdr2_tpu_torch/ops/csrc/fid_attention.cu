// General per-head flash attention (bf16) with a key-side bias, an online
// softmax over key chunks and in-kernel dropout, Hopper: forward and backward.
//
// Replaces: emdr2_tpu/ops/fid_attention.py:_fwd_kernel (launched by
// _fid_forward) and :_bwd_kernel (launched by _fid_bwd) of
// fid_cross_attention: the route self-attention takes when the sequence is
// longer than the key chunk. For each row b and head h,
//   out[b, :, h] = dropout(softmax(q k^T * hd^-0.5 + kv_bias[b])) v
// with q [B, Lq, nh, hd] and k, v [B, Lk, nh, hd]. The three inputs are
// read through their batch and row strides, so they may be views of one
// fused [B, L, 3H] projection slab: nothing is copied or transposed.
//
// What the TPU kernel computes: it walks the keys in chunks of `key_chunk`
// with an online softmax: per chunk j, m_new = max(m, chunk max), p =
// exp(s - m_new) rounded to bf16 before the fp32-accumulated P.V, l =
// l*exp(m - m_new) + sum(p) over undropped p, acc = acc*exp(m - m_new) +
// P.V; out = acc / (l*(1-rate)) (guarded > 0), lse = m + log(l) (l guarded
// > 0). Dropout zeroes p in the value term only, with the keep mask of
// hashing.cuh at bh = b*nh + h, j = the chunk, col = the key within the
// chunk, row = the query: the chunk's coordinates, whatever tile walks it.
//
// What bounds it on the H100: operations. At the reader encoder's shape
// (400 rows of 512 tokens, 12 heads) it is 4*Lq*Lk*hd FLOP per row and head
// (322 GFLOP) and one exp per score (1.26 G, a third of a millisecond of the
// special-function units alone) for 0.6 GB of reads and 0.3 GB of writes.
//
// Forward design: the shared forward walk of attention_flash.cuh (wgmma on
// swizzled tiles, a cp.async ring, the online softmax in registers; p
// rounds against the running max after each 64-key tile, not after the
// whole chunk as on the TPU: within bf16 rounding of the plain version),
// saving lse. Tiles never straddle a chunk: a chunk that is no multiple of
// 64 keys ends in a short tile whose missing keys count as bias -inf, so
// every shape takes this one kernel.
//
// Backward (the TPU kernel's formula, from the forward's saved lse):
// delta = rowsum(do * out) in fp32; per key, P = exp(s*scale + bias - lse);
// dP = do v^T, zeroed where dropped and scaled by 1/(1-rate);
// dS = P (dP - delta); dq = dS k * scale; dk = dS^T q * scale;
// dv = P_d^T do with P_d the dropped, rescaled P. A fully padded row has
// lse = its (equal) scores, so P = 1 on every key there, as on the TPU. dS
// and P_d are rounded to bf16 for the tensor-core products (the TPU
// multiplies them in fp32). At the reader encoder's shape it is five
// products of 2*Lq*Lk*hd FLOP per row and head: bound by operations.
//
// Backward design (WMMA tiles of attention_tiles.cuh, scores staged through
// shared memory): two kernels, neither with atomics or partial sums, so the
// gradients repeat bit for bit. One block per (query tile, head, row) walks
// every key tile for dq and writes delta; then one block per (key tile of a
// chunk, head, row) walks the query tiles for dk and dv. Both recompute P
// from lse, and both take the mask's (chunk, column in chunk) from the key's
// place in its logical chunk. A chunk that is no multiple of 64 keys ends in
// a ragged tile. q, k and v are read through their strides like the
// forward's; do, out and the three gradients are contiguous [B, L, nh, hd].

#include <math.h>

#include "attention_flash.cuh"
#include "attention_tiles.cuh"
#include "hashing.cuh"

namespace {

using namespace attn;

constexpr int DQ_SMEM = 4 * TILE_BYTES + WARPS * (2 * S_BYTES + P_BYTES);
constexpr int DKV_SMEM = 4 * TILE_BYTES + WARPS * (2 * S_BYTES + 2 * P_BYTES)
                         + 2 * TR * 4;

// dq for one (query tile, head, row); also writes delta = rowsum(do * out).
__global__ void __launch_bounds__(THREADS)
fid_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ kv_bias,
                  const float* __restrict__ lse,
                  const __nv_bfloat16* __restrict__ out,
                  const __nv_bfloat16* __restrict__ dout,
                  float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                  long long q_bs, int q_rs, long long k_bs, int k_rs,
                  long long v_bs, int v_rs, int Lq, int Lk, int nh, int C,
                  float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + TR * LDT;
  __nv_bfloat16* Ks = dOs + TR * LDT;
  __nv_bfloat16* Vs = Ks + TR * LDT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* wbase = smem + 4 * TILE_BYTES
                         + warp * (2 * S_BYTES + P_BYTES);
  float* Sw = reinterpret_cast<float*>(wbase);
  float* dPw = reinterpret_cast<float*>(wbase + S_BYTES);
  __nv_bfloat16* dSw = reinterpret_cast<__nv_bfloat16*>(wbase + 2 * S_BYTES);

  const int q0 = blockIdx.x * TR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * HD;
  const __nv_bfloat16* kb = k + (size_t)b * k_bs;
  const __nv_bfloat16* vb = v + (size_t)b * v_bs;
  const float* bias = kv_bias + (size_t)b * Lk;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int row = lane >> 1;
  const int half = lane & 1;
  const int qrow = q0 + warp * 16 + row;
  const int n_chunks = Lk / C;
  const int n_ct = (C + TR - 1) / TR;

  load_tile(Qs, q + (size_t)b * q_bs, q_rs, h * HD, q0, Lq);
  load_tile(dOs, dout + (size_t)b * Lq * H, H, h * HD, q0, Lq);

  float dlt = 0.0f;
  float row_lse = 0.0f;
  if (qrow < Lq) {
    const __nv_bfloat16* o = out + ((size_t)b * Lq + qrow) * H + h * HD;
    const __nv_bfloat16* g = dout + ((size_t)b * Lq + qrow) * H + h * HD;
    for (int jj = 0; jj < HD / 2; ++jj) {
      const int c = half + 2 * jj;
      dlt += __bfloat162float(g[c]) * __bfloat162float(o[c]);
    }
    row_lse = lse[(size_t)bh * Lq + qrow];
  }
  dlt += __shfl_xor_sync(0xffffffffu, dlt, 1);
  if (qrow < Lq && half == 0) delta[(size_t)bh * Lq + qrow] = dlt;

  FragC acc[HD / 16];
#pragma unroll
  for (int f = 0; f < HD / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
  for (int j = 0; j < n_chunks; ++j) {
    const int c0 = j * C;
    for (int t = 0; t < n_ct; ++t) {
      __syncthreads();
      load_tile(Ks, kb, k_rs, h * HD, c0 + t * TR, c0 + C);
      load_tile(Vs, vb, v_rs, h * HD, c0 + t * TR, c0 + C);
      __syncthreads();
      product_abt(Qs + warp * 16 * LDT, Ks, Sw);     // S = q k^T
      product_abt(dOs + warp * 16 * LDT, Vs, dPw);   // dP = do v^T
      __syncwarp();
      for (int jj = 0; jj < TR / 2; ++jj) {
        const int c = half + 2 * jj;
        const int kin = t * TR + c;
        float ds = 0.0f;
        if (kin < C && qrow < Lq) {
          const float P =
              expf(Sw[row * LDS + c] * scale + bias[c0 + kin] - row_lse);
          float dp = dPw[row * LDS + c];
          if (drop.on) {
            dp = dropout_keep(drop.seed, bh, (uint32_t)j, (uint32_t)qrow,
                              (uint32_t)kin, drop.threshold)
                     ? dp * drop.inv_keep : 0.0f;
          }
          ds = P * (dp - dlt);
        }
        dSw[row * LDP + c] = __float2bfloat16(ds);
      }
      __syncwarp();
      accumulate_pb(acc, dSw, Ks);                    // dq += dS k
    }
  }
  __syncwarp();
  stage_acc(Sw, acc);
  __syncwarp();
  if (qrow < Lq) {
    __nv_bfloat16* dst = dq + ((size_t)b * Lq + qrow) * H + h * HD;
    for (int jj = 0; jj < HD / 2; ++jj) {
      const int c = half + 2 * jj;
      dst[c] = __float2bfloat16(Sw[row * LDS + c] * scale);
    }
  }
}

// dk and dv for one (key tile of a chunk, head, row), walking the query
// tiles.
__global__ void __launch_bounds__(THREADS)
fid_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ kv_bias,
                   const float* __restrict__ lse,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, long long q_bs, int q_rs,
                   long long k_bs, int k_rs, long long v_bs, int v_rs, int Lq,
                   int Lk, int nh, int C, float scale, Dropout drop) {
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
  float* lse_s = reinterpret_cast<float*>(
      smem + 4 * TILE_BYTES + WARPS * (2 * S_BYTES + 2 * P_BYTES));
  float* delta_s = lse_s + TR;

  const int n_ct = (C + TR - 1) / TR;
  const int j = blockIdx.x / n_ct;                  // the key chunk
  const int c0 = j * C;
  const int t0 = (blockIdx.x % n_ct) * TR;          // tile start in the chunk
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * HD;
  const __nv_bfloat16* qb = q + (size_t)b * q_bs;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int row = lane >> 1;
  const int half = lane & 1;
  const int kin = t0 + warp * 16 + row;             // key within the chunk
  const int key = c0 + kin;
  const bool real = kin < C;
  const float kbias = real ? kv_bias[(size_t)b * Lk + key] : 0.0f;
  const int n_qt = (Lq + TR - 1) / TR;

  load_tile(Ks, k + (size_t)b * k_bs, k_rs, h * HD, c0 + t0, c0 + C);
  load_tile(Vs, v + (size_t)b * v_bs, v_rs, h * HD, c0 + t0, c0 + C);

  FragC dk_acc[HD / 16], dv_acc[HD / 16];
#pragma unroll
  for (int f = 0; f < HD / 16; ++f) {
    wmma::fill_fragment(dk_acc[f], 0.0f);
    wmma::fill_fragment(dv_acc[f], 0.0f);
  }
  for (int t = 0; t < n_qt; ++t) {
    __syncthreads();
    load_tile(Qs, qb, q_rs, h * HD, t * TR, Lq);
    load_tile(dOs, dout + (size_t)b * Lq * H, H, h * HD, t * TR, Lq);
    for (int i = threadIdx.x; i < TR; i += THREADS) {
      const int qi = t * TR + i;
      lse_s[i] = qi < Lq ? lse[(size_t)bh * Lq + qi] : 0.0f;
      delta_s[i] = qi < Lq ? delta[(size_t)bh * Lq + qi] : 0.0f;
    }
    __syncthreads();
    product_abt(Ks + warp * 16 * LDT, Qs, Sw);     // S^T = k q^T
    product_abt(Vs + warp * 16 * LDT, dOs, dPw);   // dP^T = v do^T
    __syncwarp();
    for (int jj = 0; jj < TR / 2; ++jj) {
      const int c = half + 2 * jj;
      const int qi = t * TR + c;
      float pd = 0.0f, ds = 0.0f;
      if (qi < Lq && real) {
        const float P = expf(Sw[row * LDS + c] * scale + kbias - lse_s[c]);
        float dp = dPw[row * LDS + c];
        pd = P;
        if (drop.on) {
          const bool keep = dropout_keep(drop.seed, bh, (uint32_t)j,
                                         (uint32_t)qi, (uint32_t)kin,
                                         drop.threshold);
          dp = keep ? dp * drop.inv_keep : 0.0f;
          pd = keep ? P * drop.inv_keep : 0.0f;
        }
        ds = P * (dp - delta_s[c]);
      }
      Pw[row * LDP + c] = __float2bfloat16(pd);
      dSw[row * LDP + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate_pb(dv_acc, Pw, dOs);                 // dv += P_d^T do
    accumulate_pb(dk_acc, dSw, Qs);                 // dk += dS^T q
  }
  // stage_acc is warp-collective: every lane takes part, the writes are
  // guarded per row
  const size_t dst = ((size_t)b * Lk + key) * H + h * HD;
  __syncwarp();
  stage_acc(Sw, dk_acc);
  __syncwarp();
  if (real) {
    for (int jj = 0; jj < HD / 2; ++jj) {
      const int c = half + 2 * jj;
      dk[dst + c] = __float2bfloat16(Sw[row * LDS + c] * scale);
    }
  }
  __syncwarp();
  stage_acc(Sw, dv_acc);
  __syncwarp();
  if (real) {
    for (int jj = 0; jj < HD / 2; ++jj) {
      const int c = half + 2 * jj;
      dv[dst + c] = __float2bfloat16(Sw[row * LDS + c]);
    }
  }
}

bool bad_call(long long q_bs, int q_rs, long long k_bs, int k_rs,
              long long v_bs, int v_rs, int B, int Lq, int Lk, int nh, int hd,
              int key_chunk) {
  return aflash::bad_shape(B, Lq, Lk, nh, hd, key_chunk) ||
         aflash::bad_rows(aflash::head_rows(nullptr, q_bs, q_rs)) ||
         aflash::bad_rows(aflash::head_rows(nullptr, k_bs, k_rs)) ||
         aflash::bad_rows(aflash::head_rows(nullptr, v_bs, v_rs));
}

}  // namespace

// q [B, Lq, nh, hd], k, v [B, Lk, nh, hd] bf16, each given by its base
// pointer (16-byte aligned), batch stride and row stride in elements
// (multiples of 8; heads and the head dim contiguous); kv_bias [B, Lk] fp32;
// out [B, Lq, nh, hd] bf16 and lse [B, nh, Lq] fp32, contiguous. Lk is a
// multiple of key_chunk. Dropout as in the other attention kernels.
// Returns a cudaError_t (0 = launched).
extern "C" int emdr2_fid_attention_bf16(
    const void* q, const void* k, const void* v, const void* kv_bias,
    void* out, void* lse, long long q_bs, int q_rs, long long k_bs, int k_rs,
    long long v_bs, int v_rs, int B, int Lq, int Lk, int nh, int hd,
    int key_chunk, unsigned int seed, unsigned int threshold, int drop_on,
    float keep_frac, float inv_keep, void* stream) {
  if (bad_call(q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, B, Lq, Lk, nh, hd,
               key_chunk)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)aflash::launch_forward(
      aflash::head_rows(q, q_bs, q_rs), aflash::head_rows(k, k_bs, k_rs),
      aflash::head_rows(v, v_bs, v_rs), kv_bias, out,
      aflash::Lse{static_cast<float*>(lse)}, B, Lq, Lk, nh, key_chunk,
      make_dropout(seed, threshold, drop_on, keep_frac, inv_keep), stream);
}

// Backward: q, k, v (pointer and strides), kv_bias and the dropout arguments
// as the forward; lse [B, nh, Lq] fp32 from the forward; out and dout
// [B, Lq, nh, hd] bf16; delta [B, nh, Lq] fp32 scratch; dq [B, Lq, nh, hd]
// and dk, dv [B, Lk, nh, hd] bf16 (every element written); all contiguous
// and 16-byte aligned. Two launches on `stream`, in order. Returns a
// cudaError_t (0 = launched).
extern "C" int emdr2_fid_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* kv_bias,
    const void* lse, const void* out, const void* dout, void* delta, void* dq,
    void* dk, void* dv, long long q_bs, int q_rs, long long k_bs, int k_rs,
    long long v_bs, int v_rs, int B, int Lq, int Lk, int nh, int hd,
    int key_chunk, unsigned int seed, unsigned int threshold, int drop_on,
    float keep_frac, float inv_keep, void* stream) {
  if (bad_call(q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, B, Lq, Lk, nh, hd,
               key_chunk)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fid_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fid_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)HD);
  const Dropout drop = make_dropout(seed, threshold, drop_on, keep_frac,
                                    inv_keep);
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* dop = static_cast<const __nv_bfloat16*>(dout);
  const dim3 q_grid((Lq + TR - 1) / TR, nh, B);
  fid_bwd_dq_kernel<<<q_grid, THREADS, DQ_SMEM, s>>>(
      qp, kp, vp, static_cast<const float*>(kv_bias),
      static_cast<const float*>(lse), static_cast<const __nv_bfloat16*>(out),
      dop, static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dq), q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, Lq, Lk, nh, key_chunk, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 k_grid((Lk / key_chunk) * ((key_chunk + TR - 1) / TR), nh, B);
  fid_bwd_dkv_kernel<<<k_grid, THREADS, DKV_SMEM, s>>>(
      qp, kp, vp, static_cast<const float*>(kv_bias),
      static_cast<const float*>(lse), dop, static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, Lq, Lk, nh, key_chunk, scale, drop);
  return (int)cudaGetLastError();
}
