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
// What the TPU kernel computes: it walks the keys in chunks of `key_chunk`
// with an online softmax: per chunk j, m_new = max(m, chunk max), p =
// exp(s - m_new) rounded to bf16 before the fp32-accumulated P.V, l =
// l*exp(m - m_new) + sum(p) over undropped p, acc = acc*exp(m - m_new) +
// P.V; out = acc / (l*(1-rate)), lse = m + log(l). Dropout zeroes p in the
// value term only, with the keep mask of hashing.cuh at bh = b*nh + h, j =
// the chunk, col = the key within the chunk, row = the query: the chunk's
// coordinates, whatever tile walks it.
//
// Backward (TPU formula): P = exp(s - lse); delta = rowsum(do * out);
// dP = do v^T, dropped and rescaled; dS = P (dP - delta); dk = dS^T q *
// scale and dv = P_d^T do per key, with no reduction; dq = sum over the
// chunks of dS k * scale. dS and P_d are rounded to bf16 for the products.
//
// What bounds it on the H100: memory. At the reader shape (8 rows, 32
// queries, 25,600 keys) the forward reads 629 MB of kv for ~5 GFLOP and the
// backward reads it again and writes 629 MB of dkv; at the teacher shape
// (400 rows of 512 keys) the same holds per row. So the forward's design is
// about keeping the memory system busy: enough blocks, loads always in
// flight, every key and value read once.
//
// Forward design (attention_mma.cuh: mma.sync m16n8k16, ldmatrix, cp.async):
// - Grid (split, head, row). The wrapper deals the chunks to splits in runs
//   of whole chunks, so that the reader shape has several blocks a
//   multiprocessor (96 (head, row) pairs alone leave 36 of 132 idle); the
//   teacher shape has 4,800 pairs and one split. A block with more than one
//   split writes an fp32 partial (m, l, acc) and a second small kernel
//   combines the partials in split order: M = max m_i, l = sum l_i exp(m_i
//   - M), acc likewise. No atomics: repeats are bit-identical.
// - Inside a block the four warps split the keys, not the queries: of each
//   64-key step a warp owns 16 keys and all the queries (ceil(Lq / 16)
//   atoms of 16 rows: no product is spent on rows past Lq rounded up to 16).
//   A warp has its own ring of FWD_STAGES slots fed by cp.async and its own
//   running (m, l, acc) in registers, so the key walk needs no block
//   barrier: a warp waits for its own copies only. At the end the four
//   warps' states are merged through shared memory in warp order.
// - One pass: a step's scores stay in the mma accumulators, give the max,
//   become p, are packed to bf16 there and feed P.V as its A operand.
// - Where p rounds: against the running max of the warp's own keys after
//   each 16-key step, not after the whole chunk as on the TPU; the result
//   stays within bf16 rounding of the plain version (about 2e-3 of the
//   largest output at the reader shape). A chunk that is no multiple of 64
//   keys ends in a short step; a warp whose 16 keys lie past the chunk's
//   end skips the step. A fully padded split has m about -1e9 and p = 1 on
//   every key; m starts at -1e30, never -inf, so exp(m_i - M) is 0 or 1
//   there and never NaN.
//
// Backward design: WMMA tiles of attention_tiles.cuh (four warps of 16
// rows, 64-row tiles). One block per (chunk, head, row) writes its keys' dk
// and dv and an fp32 dq partial for the chunk; a second kernel sums the
// partials in chunk order. No atomics: deterministic. It reads the
// forward's lse, whichever way the forward was split.

#include <math.h>

#include "attention_mma.cuh"
#include "attention_tiles.cuh"
#include "hashing.cuh"

namespace {

using namespace attn;

constexpr int BWD_SMEM = 4 * TILE_BYTES + WARPS * (2 * S_BYTES)
                         + 2 * TILE_BYTES + 2 * TR * 4;

// ---- forward: attention_mma.cuh tiles, keys split over warps and blocks ----

constexpr int FWD_STAGES = 2;                   // slots of each warp's ring
constexpr int FWD_WARPS = 4;
constexpr int FWD_THREADS = FWD_WARPS * 32;
constexpr int FWD_KW = 16;                      // keys a warp holds at once
constexpr int FWD_NT = FWD_KW / 8;
constexpr int FWD_KT = FWD_WARPS * FWD_KW;      // keys the block holds at once
// one ring slot of a warp: its keys, their values, their bias
constexpr int FWD_SLOT = 2 * FWD_KW * amma::LDT * 2 + FWD_KW * 4;
constexpr int FWD_LDO = amma::HD + 8;           // fp32 row stride of the merge

static_assert(FWD_STAGES >= 2, "the ring overlaps one load with one product");

// Shared memory of the forward for M atoms of 16 queries: the larger of the
// walk's (Q and the four rings) and the merge's (m, l and O of four warps).
constexpr int fwd_smem(int M) {
  const int walk = M * 16 * amma::LDT * 2 + FWD_WARPS * FWD_STAGES * FWD_SLOT;
  const int merge = FWD_WARPS * M * 16 * (2 + FWD_LDO) * 4;
  return walk > merge ? walk : merge;
}

// One (split, head, row): the split's chunks [j0, j1), every warp walking
// its own quarter of each 64-key step with its own ring and its own online
// softmax; the four warps' (m, l, O) are merged in warp order at the end.
// With one split the block writes out and lse; otherwise its fp32 partial.
template <int M, bool DROP>
__global__ void __launch_bounds__(FWD_THREADS)
cross_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kv,
                 const float* __restrict__ kv_bias,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int Lq, int Lk, int nh, int C, int chunks_per_split,
                 float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  unsigned char* ring = smem + M * 16 * amma::LDT * 2
                        + warp * FWD_STAGES * FWD_SLOT;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int H = nh * amma::HD;
  const __nv_bfloat16* kb = kv + (size_t)b * Lk * 2 * H + h * amma::HD;
  const __nv_bfloat16* vb = kb + H;
  const float* bias = kv_bias + (size_t)b * Lk;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int n_chunks = Lk / C;
  const int j0 = split * chunks_per_split;
  const int j1 = min(n_chunks, j0 + chunks_per_split);
  const int n_ct = (C + FWD_KT - 1) / FWD_KT;   // steps of a chunk
  const int n_steps = (j1 - j0) * n_ct;

  // the next step to load: chunk pj, step pt of it; a warp whose 16 keys
  // lie past the chunk's end loads nothing and later skips the step
  int pj = j0, pt = 0;
  auto prefetch = [&](int slot) {
    if (pj < j1) {
      const int kin0 = pt * FWD_KT + warp * FWD_KW;
      if (kin0 < C) {
        __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(
            ring + slot * FWD_SLOT);
        __nv_bfloat16* Vs = Ks + FWD_KW * amma::LDT;
        float* Bs = reinterpret_cast<float*>(Vs + FWD_KW * amma::LDT);
        const int r0 = pj * C + kin0;
        const int limit = (pj + 1) * C;
        amma::load_rows_async<FWD_KW>(Ks, kb, 2 * H, r0, limit, lane, 32);
        amma::load_rows_async<FWD_KW>(Vs, vb, 2 * H, r0, limit, lane, 32);
        if (lane < FWD_KW) {
          const bool ok = r0 + lane < limit;
          amma::cp_async4(Bs + lane, bias + (ok ? r0 + lane : 0), ok);
        }
      }
      if (++pt == n_ct) {
        pt = 0;
        ++pj;
      }
    }
    amma::cp_async_commit();     // an empty group keeps the count in step
  };

  amma::load_rows_async<M * 16>(Qs, q + (size_t)b * Lq * H + h * amma::HD, H,
                                0, Lq, tid, FWD_THREADS);
  amma::cp_async_commit();
#pragma unroll
  for (int s = 0; s < FWD_STAGES - 1; ++s) prefetch(s);
  amma::cp_async_wait<FWD_STAGES - 1>();           // Q has landed
  __syncthreads();                                // ... every warp's part

  float O[M][amma::DT][4], mrow[M][2], lrow[M][2];
  amma::init_state<M>(O, mrow, lrow);

  int cj = j0, ct = 0;                            // the step in hand
  for (int i = 0; i < n_steps; ++i) {
    amma::cp_async_wait<FWD_STAGES - 2>();         // step i has landed
    __syncwarp();                                 // ... for every lane,
    prefetch((i + FWD_STAGES - 1) % FWD_STAGES);    // and step i-1 is free
    const int kin0 = ct * FWD_KT + warp * FWD_KW;
    if (kin0 < C) {
      const unsigned char* slot = ring + (i % FWD_STAGES) * FWD_SLOT;
      const __nv_bfloat16* Ks = reinterpret_cast<const __nv_bfloat16*>(slot);
      const __nv_bfloat16* Vs = Ks + FWD_KW * amma::LDT;
      const float* Bs =
          reinterpret_cast<const float*>(Vs + FWD_KW * amma::LDT);
      float S[M][FWD_NT][4];
      amma::scores<M, FWD_NT>(S, Qs, Ks, lane);
      amma::softmax_step<M, FWD_NT, DROP>(S, O, mrow, lrow, Bs, kin0, C,
                                          scale, drop, bh, (uint32_t)cj, 0,
                                          lane);
      amma::accumulate_pv<M, FWD_NT>(O, S, Vs, lane);
    }
    if (++ct == n_ct) {
      ct = 0;
      ++cj;
    }
  }
  amma::cp_async_wait<0>();
  __syncthreads();              // the walk's shared memory is free

  // merge the four warps, in warp order: m = max, l and O rescaled to it
  constexpr int R = M * 16;
  float* m_s = reinterpret_cast<float*>(smem);           // [4, R]
  float* l_s = m_s + FWD_WARPS * R;                      // [4, R]
  float* O_s = l_s + FWD_WARPS * R;                      // [4, R, FWD_LDO]
  {
    const int g = lane >> 2;
    const int t2 = (lane & 3) * 2;
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float l = amma::quad_sum(lrow[m][hf]);
        const int r = 16 * m + 8 * hf + g;
        if ((lane & 3) == 0) {
          m_s[warp * R + r] = mrow[m][hf];
          l_s[warp * R + r] = l;
        }
#pragma unroll
        for (int n = 0; n < amma::DT; ++n) {
          *reinterpret_cast<float2*>(O_s + (warp * R + r) * FWD_LDO + 8 * n
                                     + t2) =
              make_float2(O[m][n][2 * hf], O[m][n][2 * hf + 1]);
        }
      }
    }
  }
  __syncthreads();
  const bool last = gridDim.x == 1;
  for (int i = tid; i < Lq * amma::HD; i += FWD_THREADS) {
    const int r = i / amma::HD;
    const int c = i % amma::HD;
    float mb = m_s[r];
#pragma unroll
    for (int w = 1; w < FWD_WARPS; ++w) mb = fmaxf(mb, m_s[w * R + r]);
    float l = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < FWD_WARPS; ++w) {
      const float e = expf(m_s[w * R + r] - mb);
      l += l_s[w * R + r] * e;
      acc += O_s[(w * R + r) * FWD_LDO + c] * e;
    }
    if (last) {
      const float l_eff = l * drop.keep_frac;
      out[((size_t)b * Lq + r) * H + h * amma::HD + c] =
          __float2bfloat16(acc / (l_eff > 0.0f ? l_eff : 1.0f));
      if (c == 0) {
        lse[((size_t)b * Lq + r) * nh + h] = mb + logf(l > 0.0f ? l : 1.0f);
      }
    } else {
      const size_t row = (((size_t)split * B + b) * nh + h) * Lq + r;
      part_acc[row * amma::HD + c] = acc;
      if (c == 0) {
        part_ml[row * 2] = mb;
        part_ml[row * 2 + 1] = l;
      }
    }
  }
}

// out and lse from the splits' partials (m, l, acc), in split order:
// M = max m_i, l = sum l_i exp(m_i - M), acc likewise. One thread per
// output element; partial rows are [split, B, nh, Lq].
__global__ void cross_combine_kernel(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml,
                                     __nv_bfloat16* __restrict__ out,
                                     float* __restrict__ lse, int n_splits,
                                     int B, int Lq, int nh, float keep_frac) {
  const size_t n_rows = (size_t)B * nh * Lq;
  const size_t row = (size_t)blockIdx.x * (blockDim.x / amma::HD)
                     + threadIdx.x / amma::HD;
  const int c = threadIdx.x % amma::HD;
  if (row >= n_rows) return;
  float mb = -INFINITY;
  for (int i = 0; i < n_splits; ++i) {
    mb = fmaxf(mb, part_ml[(i * n_rows + row) * 2]);
  }
  float l = 0.0f, acc = 0.0f;
  for (int i = 0; i < n_splits; ++i) {
    const size_t pr = i * n_rows + row;
    const float e = expf(part_ml[pr * 2] - mb);     // m_i >= -1e30: no NaN
    l += part_ml[pr * 2 + 1] * e;
    acc += part_acc[pr * amma::HD + c] * e;
  }
  const int qi = (int)(row % Lq);
  const int h = (int)((row / Lq) % nh);
  const size_t b = row / ((size_t)Lq * nh);
  const float l_eff = l * keep_frac;
  out[((b * Lq + qi) * nh + h) * amma::HD + c] =
      __float2bfloat16(acc / (l_eff > 0.0f ? l_eff : 1.0f));
  if (c == 0) {
    lse[(b * Lq + qi) * nh + h] = mb + logf(l > 0.0f ? l : 1.0f);
  }
}

template <int M>
cudaError_t launch_cross_fwd(dim3 grid, cudaStream_t stream,
                             const __nv_bfloat16* q, const __nv_bfloat16* kv,
                             const float* kv_bias, __nv_bfloat16* out,
                             float* lse, float* part_acc, float* part_ml,
                             int Lq, int Lk, int nh, int C,
                             int chunks_per_split, float scale,
                             Dropout drop) {
  const auto kernel = drop.on ? cross_fwd_kernel<M, true>
                              : cross_fwd_kernel<M, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem(M));
  if (err != cudaSuccess) return err;
  kernel<<<grid, FWD_THREADS, fwd_smem(M), stream>>>(
      q, kv, kv_bias, out, lse, part_acc, part_ml, Lq, Lk, nh, C,
      chunks_per_split, scale, drop);
  return cudaGetLastError();
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
// aligned; Lq <= 64, Lk a multiple of key_chunk. The chunks are dealt to
// n_splits blocks per (head, row) in runs of ceil(chunks / n_splits), none
// empty; with more than one split, part_acc [n_splits, B, nh, Lq, hd] and
// part_ml [n_splits, B, nh, Lq, 2] are fp32 scratch and a second launch on
// `stream` combines them. Dropout as in flash_self_attention.cu. Returns a
// cudaError_t (0 = launched).
extern "C" int emdr2_flash_cross_attention_bf16(
    const void* q, const void* kv, const void* kv_bias, void* out, void* lse,
    void* part_acc, void* part_ml, int B, int Lq, int Lk, int nh, int hd,
    int key_chunk, int n_splits, unsigned int seed, unsigned int threshold,
    int drop_on, float keep_frac, float inv_keep, void* stream) {
  if (bad_shape(B, Lq, Lk, nh, hd, key_chunk) || n_splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunks = Lk / key_chunk;
  const int per_split = (n_chunks + n_splits - 1) / n_splits;
  if ((n_splits - 1) * per_split >= n_chunks ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const float scale = 1.0f / sqrtf((float)HD);
  const Dropout drop = make_dropout(seed, threshold, drop_on, keep_frac,
                                    inv_keep);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(n_splits, nh, B);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kvp = static_cast<const __nv_bfloat16*>(kv);
  const float* bp = static_cast<const float*>(kv_bias);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  float* lp = static_cast<float*>(lse);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaError_t err;
  switch ((Lq + 15) / 16) {           // 16-query atoms a warp carries
    case 1:
      err = launch_cross_fwd<1>(grid, s, qp, kvp, bp, op, lp, pa, pm, Lq, Lk,
                                nh, key_chunk, per_split, scale, drop);
      break;
    case 2:
      err = launch_cross_fwd<2>(grid, s, qp, kvp, bp, op, lp, pa, pm, Lq, Lk,
                                nh, key_chunk, per_split, scale, drop);
      break;
    case 3:
      err = launch_cross_fwd<3>(grid, s, qp, kvp, bp, op, lp, pa, pm, Lq, Lk,
                                nh, key_chunk, per_split, scale, drop);
      break;
    default:
      err = launch_cross_fwd<4>(grid, s, qp, kvp, bp, op, lp, pa, pm, Lq, Lk,
                                nh, key_chunk, per_split, scale, drop);
  }
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  const int rows_per_block = 4;
  const size_t n_rows = (size_t)B * nh * Lq;
  cross_combine_kernel<<<(unsigned)((n_rows + rows_per_block - 1)
                                    / rows_per_block),
                         rows_per_block * amma::HD, 0, s>>>(
      pa, pm, op, lp, n_splits, B, Lq, nh, drop.keep_frac);
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
