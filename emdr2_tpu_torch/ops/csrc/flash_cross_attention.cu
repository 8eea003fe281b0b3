// FiD flash cross-attention on the query and fused key/value slabs (bf16),
// Hopper: forward with in-kernel dropout, and its backward.
//
// Replaces: emdr2_tpu/ops/fid_attention.py:_xslab_fwd_kernel (forward) and
// :_xslab_bwd_kernel (backward) of flash_cross_attention. For each row b and
// head h, the Lq decoder queries q [B, Lq, H] attend over the Lk encoder
// keys of kv [B, Lk, 2H] (features [k | v], heads at column h*hd and
// H + h*hd) with the key-side bias kv_bias [B, Lk]:
//   out[b, :, h] = dropout(softmax(q k^T * hd^-0.5 + bias)) v
// and the backward writes dq [B, Lq, H] and the combined dkv [B, Lk, 2H]
// in the projection's own layout (the TPU emits dkv transposed).
//
// Rounding follows the TPU kernel, which walks the keys in chunks of
// `key_chunk` with an online softmax: per chunk j, m_new = max(m, chunk
// max), p = exp(s - m_new) rounded to bf16 before the fp32-accumulated P.V,
// l = l*exp(m - m_new) + sum(p) over undropped p, acc = acc*exp(m - m_new)
// + P.V; out = acc / (l*(1-rate)), lse = m + log(l). Dropout zeroes p in
// the value term only, with the keep mask of hashing.cuh at bh = b*nh + h,
// j = the chunk, col = the key within the chunk, row = the query: the
// chunk's coordinates, whatever tile size walks it.
//
// Backward (TPU formula): P = exp(s - lse); delta = rowsum(do * out);
// dP = do v^T, dropped and rescaled; dS = P (dP - delta); dk = dS^T q *
// scale and dv = P_d^T do per key, with no reduction; dq = sum over the
// chunks of dS k * scale. dS and P_d are rounded to bf16 for the products.
//
// What bounds it on the H100: memory. At the reader shape (8 rows, 32
// queries, 25,600 keys) the forward reads 629 MB of kv for ~5 GFLOP and the
// backward reads it again and writes 629 MB of dkv; at the teacher shape
// (400 rows of 512 keys) the same holds per row.
//
// Design: WMMA (bf16 -> fp32), four warps of 16 rows, 64-row tiles; at most
// 64 queries (the decoder length is 32). Forward: one block per (head, row)
// walks the chunks in order; within a chunk, two passes over its 64-key
// tiles (the chunk max, then p, l and P.V), so p rounds against the same
// running max as on the TPU; the running accumulator lives in shared
// memory and is rescaled once per chunk. At the reader shape that is only
// 96 blocks on 132 SMs, each streaming 6.5 MB: a key split with an lse
// combine (flash decoding) is the known remedy, left for later work since
// it changes where p rounds. Backward: one block per (chunk, head, row)
// writes its keys' dk and dv and an fp32 dq partial for the chunk; a second
// kernel sums the partials in chunk order. No atomics: deterministic.

#include <math.h>

#include "attention_tiles.cuh"
#include "hashing.cuh"

namespace {

using namespace attn;

constexpr int FWD_SMEM = 3 * TILE_BYTES + WARPS * (2 * S_BYTES + P_BYTES);
constexpr int BWD_SMEM = 4 * TILE_BYTES + WARPS * (2 * S_BYTES)
                         + 2 * TILE_BYTES + 2 * TR * 4;

__global__ void __launch_bounds__(THREADS)
cross_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kv,
                 const float* __restrict__ kv_bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int Lq, int Lk, int nh, int C, float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + TR * LDT;
  __nv_bfloat16* Vs = Ks + TR * LDT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* wbase = smem + 3 * TILE_BYTES
                         + warp * (2 * S_BYTES + P_BYTES);
  float* Sw = reinterpret_cast<float*>(wbase);
  float* Aw = reinterpret_cast<float*>(wbase + S_BYTES);   // running acc
  __nv_bfloat16* Pw = reinterpret_cast<__nv_bfloat16*>(wbase + 2 * S_BYTES);
  const __nv_bfloat16* Qw = Qs + warp * 16 * LDT;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int H = nh * HD;
  const __nv_bfloat16* kvb = kv + (size_t)b * Lk * 2 * H;
  const float* bias = kv_bias + (size_t)b * Lk;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int row = lane >> 1;
  const int half = lane & 1;
  const int qrow = warp * 16 + row;
  const int n_chunks = Lk / C;
  const int n_ct = (C + TR - 1) / TR;

  load_tile(Qs, q + (size_t)b * Lq * H, H, h * HD, 0, Lq);
  for (int jj = 0; jj < HD / 2; ++jj) Aw[row * LDS + half + 2 * jj] = 0.0f;

  float m = -1e30f;
  float l = 0.0f;
  for (int j = 0; j < n_chunks; ++j) {
    const int c0 = j * C;
    // ---- pass 1: the chunk's row max ----
    float mc = -INFINITY;
    for (int t = 0; t < n_ct; ++t) {
      __syncthreads();
      load_tile(Ks, kvb, 2 * H, h * HD, c0 + t * TR, c0 + C);
      __syncthreads();
      product_abt(Qw, Ks, Sw);
      __syncwarp();
      for (int jj = 0; jj < TR / 2; ++jj) {
        const int c = half + 2 * jj;
        const int kin = t * TR + c;
        if (kin < C) {
          mc = fmaxf(mc, Sw[row * LDS + c] * scale + bias[c0 + kin]);
        }
      }
      __syncwarp();
    }
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    const float m_new = fmaxf(m, mc);
    const float corr = expf(m - m_new);

    // ---- pass 2: p against the running max, l, P.V of the chunk ----
    FragC acc[HD / 16];
#pragma unroll
    for (int f = 0; f < HD / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);
    float lc = 0.0f;
    for (int t = 0; t < n_ct; ++t) {
      __syncthreads();
      load_tile(Ks, kvb, 2 * H, h * HD, c0 + t * TR, c0 + C);
      load_tile(Vs, kvb, 2 * H, H + h * HD, c0 + t * TR, c0 + C);
      __syncthreads();
      product_abt(Qw, Ks, Sw);
      __syncwarp();
      for (int jj = 0; jj < TR / 2; ++jj) {
        const int c = half + 2 * jj;
        const int kin = t * TR + c;
        float p = 0.0f;
        if (kin < C) {
          p = expf(Sw[row * LDS + c] * scale + bias[c0 + kin] - m_new);
        }
        lc += p;
        if (drop.on && p != 0.0f &&
            !dropout_keep(drop.seed, bh, (uint32_t)j, (uint32_t)qrow,
                          (uint32_t)kin, drop.threshold)) {
          p = 0.0f;
        }
        Pw[row * LDP + c] = __float2bfloat16(p);
      }
      __syncwarp();
      accumulate_pb(acc, Pw, Vs);
    }
    lc += __shfl_xor_sync(0xffffffffu, lc, 1);
    l = l * corr + lc;
    __syncwarp();
    stage_acc(Sw, acc);
    __syncwarp();
    for (int jj = 0; jj < HD / 2; ++jj) {
      const int c = half + 2 * jj;
      Aw[row * LDS + c] = Aw[row * LDS + c] * corr + Sw[row * LDS + c];
    }
    __syncwarp();
    m = m_new;
  }

  if (qrow < Lq) {
    const float l_eff = l * drop.keep_frac;
    const float safe = l_eff > 0.0f ? l_eff : 1.0f;
    __nv_bfloat16* dst = out + ((size_t)b * Lq + qrow) * H + h * HD;
    for (int jj = 0; jj < HD / 2; ++jj) {
      const int c = half + 2 * jj;
      dst[c] = __float2bfloat16(Aw[row * LDS + c] / safe);
    }
    if (half == 0) {
      lse[((size_t)b * Lq + qrow) * nh + h] = m + logf(l > 0.0f ? l : 1.0f);
    }
  }
}

// One (chunk, head, row): dk, dv of the chunk's keys and its dq partial.
__global__ void __launch_bounds__(THREADS)
cross_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kv,
                 const float* __restrict__ kv_bias,
                 const float* __restrict__ lse,
                 const __nv_bfloat16* __restrict__ out,
                 const __nv_bfloat16* __restrict__ dout,
                 float* __restrict__ dq_part, __nv_bfloat16* __restrict__ dkv,
                 int Lq, int Lk, int nh, int C, float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + TR * LDT;
  __nv_bfloat16* Ks = dOs + TR * LDT;
  __nv_bfloat16* Vs = Ks + TR * LDT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* wbase = smem + 4 * TILE_BYTES + warp * (2 * S_BYTES);
  float* Sw = reinterpret_cast<float*>(wbase);
  float* dPw = reinterpret_cast<float*>(wbase + S_BYTES);
  // [64 keys, LDP] bf16 each, shared: warp w writes rows [16w, 16w + 16)
  __nv_bfloat16* PdT = reinterpret_cast<__nv_bfloat16*>(
      smem + 4 * TILE_BYTES + WARPS * (2 * S_BYTES));
  __nv_bfloat16* dST = PdT + TR * LDP;
  float* lse_s = reinterpret_cast<float*>(dST + TR * LDP);
  float* delta_s = lse_s + TR;

  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * HD;
  const int n_chunks = Lk / C;
  const int c0 = j * C;
  const __nv_bfloat16* kvb = kv + (size_t)b * Lk * 2 * H;
  const float* bias = kv_bias + (size_t)b * Lk;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int row = lane >> 1;
  const int half = lane & 1;
  const int n_ct = (C + TR - 1) / TR;

  load_tile(Qs, q + (size_t)b * Lq * H, H, h * HD, 0, Lq);
  load_tile(dOs, dout + (size_t)b * Lq * H, H, h * HD, 0, Lq);
  {
    // delta and lse of the 64 query rows: two threads per row
    const int r = threadIdx.x >> 1;
    const int hf = threadIdx.x & 1;
    float dlt = 0.0f;
    if (r < Lq) {
      const __nv_bfloat16* o = out + ((size_t)b * Lq + r) * H + h * HD;
      const __nv_bfloat16* g = dout + ((size_t)b * Lq + r) * H + h * HD;
      for (int jj = 0; jj < HD / 2; ++jj) {
        const int c = hf + 2 * jj;
        dlt += __bfloat162float(g[c]) * __bfloat162float(o[c]);
      }
    }
    dlt += __shfl_xor_sync(0xffffffffu, dlt, 1);
    if (hf == 0) {
      delta_s[r] = r < Lq ? dlt : 0.0f;
      lse_s[r] = r < Lq ? lse[((size_t)b * Lq + r) * nh + h] : 0.0f;
    }
  }

  FragC dq[HD / 16];
#pragma unroll
  for (int f = 0; f < HD / 16; ++f) wmma::fill_fragment(dq[f], 0.0f);
  for (int t = 0; t < n_ct; ++t) {
    const int kin = t * TR + warp * 16 + row;     // this lane pair's key
    const int key = c0 + kin;
    __syncthreads();
    load_tile(Ks, kvb, 2 * H, h * HD, c0 + t * TR, c0 + C);
    load_tile(Vs, kvb, 2 * H, H + h * HD, c0 + t * TR, c0 + C);
    __syncthreads();
    product_abt(Ks + warp * 16 * LDT, Qs, Sw);    // S^T = k q^T
    product_abt(Vs + warp * 16 * LDT, dOs, dPw);  // dP^T = v do^T
    __syncwarp();
    const float kbias = kin < C ? bias[key] : 0.0f;
    for (int jj = 0; jj < TR / 2; ++jj) {
      const int c = half + 2 * jj;                  // query row
      float pd = 0.0f, ds = 0.0f;
      if (c < Lq && kin < C) {
        const float P = expf(Sw[row * LDS + c] * scale + kbias - lse_s[c]);
        float dp = dPw[row * LDS + c];
        pd = P;
        if (drop.on) {
          const bool keep = dropout_keep(drop.seed, bh, (uint32_t)j,
                                         (uint32_t)c, (uint32_t)kin,
                                         drop.threshold);
          dp = keep ? dp * drop.inv_keep : 0.0f;
          pd = keep ? P * drop.inv_keep : 0.0f;
        }
        ds = P * (dp - delta_s[c]);
      }
      PdT[(warp * 16 + row) * LDP + c] = __float2bfloat16(pd);
      dST[(warp * 16 + row) * LDP + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    {
      // dk = dS^T q * scale and dv = P_d^T do for this warp's 16 keys
      FragC dk[HD / 16], dv[HD / 16];
#pragma unroll
      for (int f = 0; f < HD / 16; ++f) {
        wmma::fill_fragment(dk[f], 0.0f);
        wmma::fill_fragment(dv[f], 0.0f);
      }
      accumulate_pb(dk, dST + warp * 16 * LDP, Qs);
      accumulate_pb(dv, PdT + warp * 16 * LDP, dOs);
      __nv_bfloat16* dst = dkv + ((size_t)b * Lk + key) * 2 * H + h * HD;
      stage_acc(Sw, dk);
      __syncwarp();
      if (kin < C) {
        for (int jj = 0; jj < HD / 2; ++jj) {
          const int c = half + 2 * jj;
          dst[c] = __float2bfloat16(Sw[row * LDS + c] * scale);
        }
      }
      __syncwarp();
      stage_acc(Sw, dv);
      __syncwarp();
      if (kin < C) {
        for (int jj = 0; jj < HD / 2; ++jj) {
          const int c = half + 2 * jj;
          dst[H + c] = __float2bfloat16(Sw[row * LDS + c]);
        }
      }
    }
    __syncthreads();  // every warp's dS^T rows are in place
    // dq rows [16w, 16w + 16) += dS[q, keys] . k[keys, :]; dS read
    // column-major out of dS^T
#pragma unroll
    for (int kk = 0; kk < TR; kk += 16) {
      FragAc a;
      wmma::load_matrix_sync(a, dST + kk * LDP + warp * 16, LDP);
#pragma unroll
      for (int f = 0; f < HD / 16; ++f) {
        FragBr bk;
        wmma::load_matrix_sync(bk, Ks + kk * LDT + f * 16, LDT);
        wmma::mma_sync(dq[f], a, bk, dq[f]);
      }
    }
  }
  __syncwarp();
  stage_acc(Sw, dq);
  __syncwarp();
  const int qr = warp * 16 + row;
  if (qr < Lq) {
    float* dst = dq_part + (((size_t)b * n_chunks + j) * Lq + qr) * H + h * HD;
    for (int jj = 0; jj < HD / 2; ++jj) {
      const int c = half + 2 * jj;
      dst[c] = Sw[row * LDS + c] * scale;
    }
  }
}

// dq[b, q, :] = sum over chunks, in chunk order, of the fp32 partials.
__global__ void cross_dq_reduce_kernel(const float* __restrict__ dq_part,
                                       __nv_bfloat16* __restrict__ dq, int B,
                                       int n_chunks, int LqH) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * LqH) return;
  const size_t b = i / LqH;
  const size_t r = i % LqH;
  const float* src = dq_part + b * n_chunks * LqH + r;
  float s = 0.0f;
  for (int j = 0; j < n_chunks; ++j) s += src[(size_t)j * LqH];
  dq[i] = __float2bfloat16(s);
}

bool bad_shape(int B, int Lq, int Lk, int nh, int hd, int C) {
  return hd != HD || B <= 0 || Lq <= 0 || Lq > TR || Lk <= 0 || nh <= 0 ||
         C <= 0 || Lk % C != 0 || B > 65535 || nh > 65535;
}

}  // namespace

// q [B, Lq, nh*hd] bf16, kv [B, Lk, 2*nh*hd] bf16, kv_bias [B, Lk] fp32,
// out [B, Lq, nh*hd] bf16, lse [B, Lq, nh] fp32; contiguous, 16-byte
// aligned; Lq <= 64, Lk a multiple of key_chunk. Dropout as in
// flash_self_attention.cu. Returns a cudaError_t (0 = launched).
extern "C" int emdr2_flash_cross_attention_bf16(
    const void* q, const void* kv, const void* kv_bias, void* out, void* lse,
    int B, int Lq, int Lk, int nh, int hd, int key_chunk, unsigned int seed,
    unsigned int threshold, int drop_on, float keep_frac, float inv_keep,
    void* stream) {
  if (bad_shape(B, Lq, Lk, nh, hd, key_chunk)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      cross_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.0f / sqrtf((float)HD);
  cross_fwd_kernel<<<dim3(nh, B), THREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv),
      static_cast<const float*>(kv_bias), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Lq, Lk, nh, key_chunk, scale,
      make_dropout(seed, threshold, drop_on, keep_frac, inv_keep));
  return (int)cudaGetLastError();
}

// Backward: inputs as the forward plus lse, out and dout [B, Lq, H];
// dq_part [B, Lk/key_chunk, Lq, H] fp32 scratch; dq [B, Lq, H] bf16 and
// dkv [B, Lk, 2H] bf16 (every element written). Two launches on `stream`,
// in order. Returns a cudaError_t (0 = launched).
extern "C" int emdr2_flash_cross_attention_bwd_bf16(
    const void* q, const void* kv, const void* kv_bias, const void* lse,
    const void* out, const void* dout, void* dq_part, void* dq, void* dkv,
    int B, int Lq, int Lk, int nh, int hd, int key_chunk, unsigned int seed,
    unsigned int threshold, int drop_on, float keep_frac, float inv_keep,
    void* stream) {
  if (bad_shape(B, Lq, Lk, nh, hd, key_chunk)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      cross_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = Lk / key_chunk;
  if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf((float)HD);
  cudaStream_t s = (cudaStream_t)stream;
  cross_bwd_kernel<<<dim3(n_chunks, nh, B), THREADS, BWD_SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv),
      static_cast<const float*>(kv_bias), static_cast<const float*>(lse),
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(dq_part),
      static_cast<__nv_bfloat16*>(dkv), Lq, Lk, nh, key_chunk, scale,
      make_dropout(seed, threshold, drop_on, keep_frac, inv_keep));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int LqH = Lq * nh * HD;
  const size_t n = (size_t)B * LqH;
  const int threads = 256;
  cross_dq_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                           0, s>>>(static_cast<const float*>(dq_part),
                                   static_cast<__nv_bfloat16*>(dq), B,
                                   n_chunks, LqH);
  return (int)cudaGetLastError();
}
