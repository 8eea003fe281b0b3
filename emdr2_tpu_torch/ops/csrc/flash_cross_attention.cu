// FiD flash cross-attention on the query and fused key/value slabs (bf16),
// Hopper: forward with in-kernel dropout, and its backward.
//
// Replaces: emdr2_tpu/ops/fid_attention.py:_xslab_fwd_kernel (forward) and
// :_xslab_bwd_kernel (backward) of flash_cross_attention. For each row b and
// head h, the Lq decoder queries q [B, Lq, H] attend over the Lk encoder
// keys of kv [B, Lk, 2H] (features [k | v], heads at column h*hd and
// H + h*hd) with the key-side bias kv_bias [B, Lk]:
//   out[b, :, h] = dropout(softmax(q k^T * scale + bias)) v
// (scale is the caller's: hd^-0.5 for standard attention, 1 for T5's)
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
// Backward design (the same family; bound by bytes too: it reads the kv
// slab once more and writes a dkv slab of the same size, for about 2.5x the
// forward's ~5 GFLOP, a tenth of the read's time at the tensor-core rate):
// - Grid (run, head, row), the chunks dealt to runs as the forward deals
//   them to splits. A first small kernel computes delta = rowsum(do * out)
//   once per (row, query, head); a block loads Q, dO, lse and delta of its
//   (head, row) once.
// - The four warps split the keys: of each 64-key step a warp owns 16 keys
//   (the M side of every product) and all the queries (the N side, Lq
//   rounded up to 16, at least 32: no product is spent on 64 padded rows).
//   A warp's keys, values and bias come through its own ring of BWD_STAGES
//   slots fed by cp.async, so the key walk needs no block barrier and two
//   steps are in flight while one computes. At 32 queries a block takes
//   65,536 B of shared memory; no register cap is set (a cap for a third
//   block made the walk spill), and chip_smoke.py prints the registers and
//   the residency the build came to.
// - S^T = k q^T and dP^T = v do^T come out of mma.sync in accumulators; P,
//   the keep bit, P_d and dS are formed there and packed to bf16 in place as
//   the A operands of dv = P_d^T do and dk = dS^T q (the queries
//   contracted, do and q read by ldmatrix.trans). dq += dS k takes dS
//   transposed by movmatrix, 8x8 by 8x8, into a warp's fp32 dq accumulator
//   that lives across its whole run. No score tile goes through shared
//   memory.
// - dk and dv of the warp's 16 keys are staged as bf16 in the ring slot the
//   warp has just read (its keys and values are spent by then) and written
//   as whole 128-byte rows by 16-byte stores.
// - At the end the four warps' dq are summed in warp order; with one run
//   the block writes dq, otherwise an fp32 partial per run, and a last small
//   kernel sums the partials in run order. No atomics: repeats are
//   bit-identical. It reads the forward's lse, whichever way the forward was
//   split; s = S*scale + bias stays fp32 before the lse is subtracted, so a
//   fully padded row (s = lse = about -1e9) keeps P = exp(0) = 1.

#include <math.h>

#include "attention_mma.cuh"
#include "hashing.cuh"

namespace {

constexpr int MAX_QUERIES = 64;                 // decoder positions a row

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

// ---- backward: keys split over blocks and warps, scores in registers ----

constexpr int BWD_STAGES = 3;                   // slots of each warp's ring
constexpr int BWD_WARPS = 4;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int BWD_KW = 16;                      // keys a warp holds at once
constexpr int BWD_KT = BWD_WARPS * BWD_KW;      // keys the block holds at once
// one ring slot of a warp: its keys, their values, their bias
constexpr int BWD_SLOT = 2 * BWD_KW * amma::LDT * 2 + BWD_KW * 4;
constexpr int BWD_LDQ = amma::HD + 8;           // fp32 row stride of the merge

// Atoms of 16 queries a warp carries at least: 16 queries or fewer run the
// 32-query kernel (their padded queries get P = 0; no decoder of the model
// is that short, and the one-atom instance spilled a register).
constexpr int BWD_MIN_ATOMS = 2;

static_assert(BWD_STAGES >= 2, "the ring overlaps one load with one step");

// Shared memory of the backward for M atoms of 16 queries: the larger of
// the walk's (Q, dO, lse, delta and the four rings) and the merge's (the
// four warps' dq).
constexpr int bwd_smem(int M) {
  const int walk = 2 * M * 16 * amma::LDT * 2 + 2 * M * 16 * 4
                   + BWD_WARPS * BWD_STAGES * BWD_SLOT;
  const int merge = BWD_WARPS * M * 16 * BWD_LDQ * 4;
  return walk > merge ? walk : merge;
}

// The transpose of an 8x8 bf16 matrix held by a warp in the mma fragment
// layout (lane 4g + t: row g, columns 2t and 2t + 1), in the same layout.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t a) {
  uint32_t d;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// O[m] += A[m] . B over one 16-deep step of the contraction: A[m] the bf16
// A operands of 16 rows (mma layout), Bs the first of B's 16 rows and of its
// 8 * ND columns, in shared memory with row stride LDT and the contracted
// axis along its rows.
template <int M, int ND>
__device__ __forceinline__ void mma_rows(float (&O)[M][ND][4],
                                         const uint32_t (&A)[M][4],
                                         const __nv_bfloat16* Bs, int lane) {
  static_assert(ND % 2 == 0, "columns come in pairs of n-tiles");
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < ND / 2; ++dp) {
    uint32_t bv[4];
    amma::ldsm_x4_trans(bv, Bs + b_row * amma::LDT + dp * 16 + b_col);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      amma::mma_bf16(O[m][2 * dp], A[m], bv[0], bv[1]);
      amma::mma_bf16(O[m][2 * dp + 1], A[m], bv[2], bv[3]);
    }
  }
}

// d[16, HD / 2] = A^T . B for the warp's 16 keys and half the head dim:
// A[m] the packed A operands of queries 16m .. 16m + 15 (the score
// layout), Bs the queries' rows of q or do at the half's first column.
template <int M>
__device__ __forceinline__ void key_rows(float (&d)[1][amma::DT / 2][4],
                                         const uint32_t (&A)[M][4],
                                         const __nv_bfloat16* Bs, int lane) {
#pragma unroll
  for (int n = 0; n < amma::DT / 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[0][n][e] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const uint32_t a[1][4] = {{A[m][0], A[m][1], A[m][2], A[m][3]}};
    mma_rows<1, amma::DT / 2>(d, a, Bs + 16 * m * amma::LDT, lane);
  }
}

// One step of the backward on a warp's 16 keys and 8 * NT queries from
// query c0 on, in registers. S holds the scores k.q^T of the keys (rows)
// against the queries (columns), dP holds v.do^T; P = exp(S*scale + bias -
// lse) and
//   Ads = bf16(P (dP_d - delta)),  Apd = bf16(P_d),
// with dP_d and P_d dropped by the keep mask at (query, the key's place in
// its chunk j) and rescaled, packed as the A operands of dk and dv. Keys at
// or past C are no keys (bias -inf: P = 0); queries past Lq have lse = +inf
// (P = 0). lse_s and delta_s start at query c0.
template <int NT, bool DROP>
__device__ __forceinline__ void grads_step(
    float (&S)[1][NT][4], float (&dP)[1][NT][4], uint32_t (&Ads)[NT / 2][4],
    uint32_t (&Apd)[NT / 2][4], const float* bias_s, const float* lse_s,
    const float* delta_s, int c0, int kin0, int C, float scale,
    const Dropout& drop, uint32_t bh, uint32_t j, int lane) {
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  // the (bh, chunk) term of the mask hash; see dropout_keep in hashing.cuh
  const uint32_t base = drop.seed + bh * 0x27D4EB2Fu + j * 0x165667B1u;
  float kb[2];                                    // the two keys' bias
  uint32_t kterm[2];                              // ... and hash terms
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kin = kin0 + g + 8 * hf;
    kb[hf] = kin < C ? bias_s[g + 8 * hf] : -INFINITY;
    kterm[hf] = (uint32_t)kin * 0x85EBCA77u ^ base;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + 8 * n + t2);
    const float2 dl2 = *reinterpret_cast<const float2*>(delta_s + 8 * n + t2);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = fmaf(S[0][n][2 * hf + e], scale, kb[hf]);
        const float p = amma::exp_fast(s - (e ? lse2.y : lse2.x));
        float dp = dP[0][n][2 * hf + e];
        float pd = p;
        if (DROP) {
          const uint32_t c = (uint32_t)(c0 + 8 * n + t2 + e);   // the query
          const bool keep =
              murmur_fin(c * 0x9E3779B1u ^ kterm[hf]) >= drop.threshold;
          dp = keep ? dp * drop.inv_keep : 0.0f;
          pd = keep ? p * drop.inv_keep : 0.0f;
        }
        S[0][n][2 * hf + e] = p * (dp - (e ? dl2.y : dl2.x));
        dP[0][n][2 * hf + e] = pd;
      }
    }
  }
  amma::pack_scores<NT>(Ads, S);
  amma::pack_scores<NT>(Apd, dP);
}

// The scores pass of a step over MG atoms of 16 queries from atom m0 on:
// S^T = k q^T and dP^T = v do^T of the warp's 16 keys (Ks, Vs) against those
// queries, one 16-deep slice of the head dim at a time, then grads_step;
// the packed A operands of dk and dv go to Ads[m0 ..] and Apd[m0 ..]. The
// slices are a loop, not unrolled: the fragments in flight are then one
// slice's, not four's, which leaves the registers to dq.
template <int MG, int M, bool DROP>
__device__ __forceinline__ void scores_pass(
    uint32_t (&Ads)[M][4], uint32_t (&Apd)[M][4], int m0,
    const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
    const __nv_bfloat16* Qs, const __nv_bfloat16* dOs, const float* bias_s,
    const float* lse_s, const float* delta_s, int kin0, int C, float scale,
    const Dropout& drop, uint32_t bh, uint32_t j, int lane) {
  constexpr int NT = 2 * MG;                      // n-tiles of 8 queries
  const int c0 = 16 * m0;
  float S[1][NT][4], dP[1][NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) S[0][n][e] = dP[0][n][e] = 0.0f;
  }
  const int a = (lane & 15) * amma::LDT + (lane >> 4) * 8;
  const int b = (c0 + (lane & 7) + ((lane >> 4) << 3)) * amma::LDT
                + ((lane >> 3) & 1) * 8;
#pragma unroll 1
  for (int kk = 0; kk < amma::HD / 16; ++kk) {
    uint32_t ak[4], av[4];
    amma::ldsm_x4(ak, Ks + a + kk * 16);
    amma::ldsm_x4(av, Vs + a + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bq[4], bo[4];
      amma::ldsm_x4(bq, Qs + 16 * np * amma::LDT + b + kk * 16);
      amma::ldsm_x4(bo, dOs + 16 * np * amma::LDT + b + kk * 16);
      amma::mma_bf16(S[0][2 * np], ak, bq[0], bq[1]);
      amma::mma_bf16(S[0][2 * np + 1], ak, bq[2], bq[3]);
      amma::mma_bf16(dP[0][2 * np], av, bo[0], bo[1]);
      amma::mma_bf16(dP[0][2 * np + 1], av, bo[2], bo[3]);
    }
  }
  uint32_t pa[MG][4], pb[MG][4];
  grads_step<NT, DROP>(S, dP, pa, pb, bias_s, lse_s + c0, delta_s + c0, c0,
                       kin0, C, scale, drop, bh, j, lane);
#pragma unroll
  for (int m = 0; m < MG; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      Ads[m0 + m][e] = pa[m][e];
      Apd[m0 + m][e] = pb[m][e];
    }
  }
}

// The warp's [16, HD / 2] fp32 accumulator times `mul`, as bf16 into the
// rows of `dst` (shared memory, row stride LDT, at the half's first column).
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const float (&d)[1][amma::DT / 2][4],
                                           float mul, int lane) {
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < amma::DT / 2; ++n) {
    *reinterpret_cast<uint32_t*>(dst + g * amma::LDT + 8 * n + t2) =
        amma::pack_bf16(d[0][n][0] * mul, d[0][n][1] * mul);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * amma::LDT + 8 * n + t2) =
        amma::pack_bf16(d[0][n][2] * mul, d[0][n][3] * mul);
  }
}

// Rows [r0, min(r0 + 16, limit)) of a row-major matrix with row stride `ld`
// (elements; `dst` at column 0 of the head in row 0) from `src` [16, LDT]:
// whole 128-byte rows, 16 bytes a lane and a store.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ld,
                                           const __nv_bfloat16* src, int r0,
                                           int limit, int lane) {
#pragma unroll
  for (int k = 0; k < BWD_KW * (amma::HD / 8) / 32; ++k) {
    const int i = lane + 32 * k;
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    if (r0 + r < limit) {
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * ld + c) =
          *reinterpret_cast<const uint4*>(src + r * amma::LDT + c);
    }
  }
}

// delta[row] = sum over the head dim of dout * out in fp32, for each of the
// n_rows rows (row, query, head) of 64 elements; eight lanes a row.
__global__ void cross_delta_kernel(const __nv_bfloat16* __restrict__ out,
                                   const __nv_bfloat16* __restrict__ dout,
                                   float* __restrict__ delta, int n_rows) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t row = t >> 3;
  const int c = (int)(t & 7) * 8;
  float s = 0.0f;
  if (row < (size_t)n_rows) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + row * amma::HD + c);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * amma::HD + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 a = __bfloat1622float2(o2[k]);
      const float2 b = __bfloat1622float2(g2[k]);
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if ((t & 7) == 0 && row < (size_t)n_rows) delta[row] = s;
}

// One (run, head, row): the run's chunks [j0, j1), every warp walking its
// own quarter of each 64-key step with its own ring; dk and dv of every key
// written as the walk passes it, dq summed over the run in each warp's
// registers and over the warps in warp order at the end. With one run the
// block writes dq, otherwise its fp32 partial.
template <int M, bool DROP>
__global__ void __launch_bounds__(BWD_THREADS)
cross_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ kv,
                 const float* __restrict__ kv_bias,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const __nv_bfloat16* __restrict__ dout,
                 float* __restrict__ dq_part, __nv_bfloat16* __restrict__ dq,
                 __nv_bfloat16* __restrict__ dkv, int Lq, int Lk, int nh,
                 int C, int chunks_per_run, float scale, Dropout drop) {
  constexpr int R = M * 16;                       // query rows held
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + R * amma::LDT;
  float* lse_s = reinterpret_cast<float*>(dOs + R * amma::LDT);
  float* delta_s = lse_s + R;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  unsigned char* ring = reinterpret_cast<unsigned char*>(delta_s + R)
                        + warp * BWD_STAGES * BWD_SLOT;

  const int run = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int H = nh * amma::HD;
  const size_t kv_row0 = (size_t)b * Lk * 2 * H + h * amma::HD;
  const __nv_bfloat16* kb = kv + kv_row0;
  const __nv_bfloat16* vb = kb + H;
  __nv_bfloat16* dkb = dkv + kv_row0;
  __nv_bfloat16* dvb = dkb + H;
  const float* bias = kv_bias + (size_t)b * Lk;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int n_chunks = Lk / C;
  const int j0 = run * chunks_per_run;
  const int j1 = min(n_chunks, j0 + chunks_per_run);
  const int n_ct = (C + BWD_KT - 1) / BWD_KT;   // steps of a chunk
  const int n_steps = (j1 - j0) * n_ct;

  // the next step to load: chunk pj, step pt of it; a warp whose 16 keys
  // lie past the chunk's end loads nothing and later skips the step
  int pj = j0, pt = 0;
  auto prefetch = [&](int slot) {
    if (pj < j1) {
      const int kin0 = pt * BWD_KT + warp * BWD_KW;
      if (kin0 < C) {
        __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(
            ring + slot * BWD_SLOT);
        __nv_bfloat16* Vs = Ks + BWD_KW * amma::LDT;
        float* Bs = reinterpret_cast<float*>(Vs + BWD_KW * amma::LDT);
        const int r0 = pj * C + kin0;
        const int limit = (pj + 1) * C;
        amma::load_rows_async<BWD_KW>(Ks, kb, 2 * H, r0, limit, lane, 32);
        amma::load_rows_async<BWD_KW>(Vs, vb, 2 * H, r0, limit, lane, 32);
        if (lane < BWD_KW) {
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

  const size_t q0 = (size_t)b * Lq * H + h * amma::HD;
  amma::load_rows_async<R>(Qs, q + q0, H, 0, Lq, tid, BWD_THREADS);
  amma::load_rows_async<R>(dOs, dout + q0, H, 0, Lq, tid, BWD_THREADS);
  amma::cp_async_commit();
  for (int r = tid; r < R; r += BWD_THREADS) {
    const size_t stat = ((size_t)b * Lq + r) * nh + h;
    lse_s[r] = r < Lq ? lse[stat] : INFINITY;      // no query: P = 0
    delta_s[r] = r < Lq ? delta[stat] : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s) prefetch(s);
  amma::cp_async_wait<BWD_STAGES - 1>();           // Q and dO have landed
  __syncthreads();                                // ... every warp's part

  float dQ[M][amma::DT][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int n = 0; n < amma::DT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dQ[m][n][e] = 0.0f;
    }
  }

  int cj = j0, ct = 0;                            // the step in hand
  for (int i = 0; i < n_steps; ++i) {
    amma::cp_async_wait<BWD_STAGES - 2>();         // step i has landed
    __syncwarp();                                 // ... for every lane,
    prefetch((i + BWD_STAGES - 1) % BWD_STAGES);    // and step i-1 is free
    const int kin0 = ct * BWD_KT + warp * BWD_KW;
    if (kin0 < C) {
      unsigned char* slot = ring + (i % BWD_STAGES) * BWD_SLOT;
      __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(slot);
      __nv_bfloat16* Vs = Ks + BWD_KW * amma::LDT;
      const float* Bs = reinterpret_cast<const float*>(Vs + BWD_KW * amma::LDT);
      // S^T = k q^T and dP^T = v do^T: up to 32 queries in one pass; past
      // that, where dq takes 96-128 registers, 16 a pass
      uint32_t Ads[M][4], Apd[M][4];
      constexpr int MG = M > 2 ? 1 : M;
#pragma unroll
      for (int m0 = 0; m0 < M; m0 += MG) {
        scores_pass<MG, M, DROP>(Ads, Apd, m0, Ks, Vs, Qs, dOs, Bs, lse_s,
                                 delta_s, kin0, C, scale, drop, bh,
                                 (uint32_t)cj, lane);
      }
      __syncwarp();                                // the values are spent
      float d[1][amma::DT / 2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {       // dv = P_d^T do
        key_rows<M>(d, Apd, dOs + half * amma::HD / 2, lane);
        stage_rows(Vs + half * amma::HD / 2, d, 1.0f, lane);
      }
      // dq += dS k: the A operand of query atom m is dS^T's 8x8 blocks
      // (keys 0-7 | 8-15) x (queries 16m .. +7 | 16m + 8 .. +15), transposed
      uint32_t Aq[M][4];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        Aq[m][0] = transpose8x8(Ads[m][0]);
        Aq[m][1] = transpose8x8(Ads[m][2]);
        Aq[m][2] = transpose8x8(Ads[m][1]);
        Aq[m][3] = transpose8x8(Ads[m][3]);
      }
      mma_rows<M, amma::DT>(dQ, Aq, Ks, lane);
      __syncwarp();                                // the keys are spent
#pragma unroll
      for (int half = 0; half < 2; ++half) {       // dk = dS^T q * scale
        key_rows<M>(d, Ads, Qs + half * amma::HD / 2, lane);
        stage_rows(Ks + half * amma::HD / 2, d, scale, lane);
      }
      __syncwarp();
      const int r0 = cj * C + kin0;
      const int limit = (cj + 1) * C;
      store_rows(dkb, 2 * H, Ks, r0, limit, lane);
      store_rows(dvb, 2 * H, Vs, r0, limit, lane);
    }
    if (++ct == n_ct) {
      ct = 0;
      ++cj;
    }
  }
  amma::cp_async_wait<0>();
  __syncthreads();              // the walk's shared memory is free

  // merge the four warps' dq, in warp order
  float* dq_s = reinterpret_cast<float*>(smem);          // [4, R, BWD_LDQ]
  {
    const int g = lane >> 2;
    const int t2 = (lane & 3) * 2;
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * m + 8 * hf + g;
#pragma unroll
        for (int n = 0; n < amma::DT; ++n) {
          *reinterpret_cast<float2*>(dq_s + (warp * R + r) * BWD_LDQ + 8 * n
                                     + t2) =
              make_float2(dQ[m][n][2 * hf], dQ[m][n][2 * hf + 1]);
        }
      }
    }
  }
  __syncthreads();
  const bool last = gridDim.x == 1;
  for (int i = tid; i < Lq * amma::HD; i += BWD_THREADS) {
    const int r = i / amma::HD;
    const int c = i % amma::HD;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) acc += dq_s[(w * R + r) * BWD_LDQ + c];
    acc *= scale;
    const size_t o = ((size_t)b * Lq + r) * H + h * amma::HD + c;
    if (last) {
      dq[o] = __float2bfloat16(acc);
    } else {
      dq_part[(size_t)run * B * Lq * H + o] = acc;
    }
  }
}

// dq[i] = sum over the runs, in run order, of the fp32 partials
// dq_part [n_runs, n].
__global__ void cross_dq_reduce_kernel(const float* __restrict__ dq_part,
                                       __nv_bfloat16* __restrict__ dq,
                                       int n_runs, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int r = 0; r < n_runs; ++r) s += dq_part[(size_t)r * n + i];
  dq[i] = __float2bfloat16(s);
}

template <int M>
cudaError_t launch_cross_bwd(dim3 grid, cudaStream_t stream,
                             const __nv_bfloat16* q, const __nv_bfloat16* kv,
                             const float* kv_bias, const float* lse,
                             const float* delta, const __nv_bfloat16* dout,
                             float* dq_part, __nv_bfloat16* dq,
                             __nv_bfloat16* dkv, int Lq, int Lk, int nh,
                             int C, int chunks_per_run, float scale,
                             Dropout drop) {
  const auto kernel = drop.on ? cross_bwd_kernel<M, true>
                              : cross_bwd_kernel<M, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem(M));
  if (err != cudaSuccess) return err;
  kernel<<<grid, BWD_THREADS, bwd_smem(M), stream>>>(
      q, kv, kv_bias, lse, delta, dout, dq_part, dq, dkv, Lq, Lk, nh, C,
      chunks_per_run, scale, drop);
  return cudaGetLastError();
}

// Blocks of the M-atom backward kernel a multiprocessor of the current
// device holds at once, with dropout off and on.
template <int M>
cudaError_t bwd_residency(int* off, int* on) {
  const auto k0 = cross_bwd_kernel<M, false>;
  const auto k1 = cross_bwd_kernel<M, true>;
  cudaError_t err = cudaFuncSetAttribute(
      k0, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem(M));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd_smem(M));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(off, k0, BWD_THREADS,
                                                        bwd_smem(M));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(on, k1, BWD_THREADS,
                                                        bwd_smem(M));
  }
  return err;
}

bool bad_shape(int B, int Lq, int Lk, int nh, int hd, int C) {
  return hd != amma::HD || B <= 0 || Lq <= 0 || Lq > MAX_QUERIES || Lk <= 0
         || nh <= 0 || C <= 0 || Lk % C != 0 || B > 65535 || nh > 65535;
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
    int drop_on, float keep_frac, float inv_keep, float scale, void* stream) {
  if (bad_shape(B, Lq, Lk, nh, hd, key_chunk) || n_splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunks = Lk / key_chunk;
  const int per_split = (n_chunks + n_splits - 1) / n_splits;
  if ((n_splits - 1) * per_split >= n_chunks ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
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

// Backward: inputs as the forward plus lse [B, Lq, nh] fp32 and out, dout
// [B, Lq, H] bf16; delta [B, Lq, nh] fp32 scratch. The chunks are dealt to
// n_runs blocks per (head, row) in runs of ceil(chunks / n_runs), none
// empty; with more than one run dq_part [n_runs, B, Lq, H] is fp32 scratch.
// Writes dq [B, Lq, H] and dkv [B, Lk, 2H] bf16, every element. Launches on
// `stream`, in order: delta, the walk, and with more than one run the sum of
// the dq partials. Returns a cudaError_t (0 = launched).
extern "C" int emdr2_flash_cross_attention_bwd_bf16(
    const void* q, const void* kv, const void* kv_bias, const void* lse,
    const void* out, const void* dout, void* delta, void* dq_part, void* dq,
    void* dkv, int B, int Lq, int Lk, int nh, int hd, int key_chunk,
    int n_runs, unsigned int seed, unsigned int threshold, int drop_on,
    float keep_frac, float inv_keep, float scale, void* stream) {
  if (bad_shape(B, Lq, Lk, nh, hd, key_chunk) || n_runs < 1 ||
      n_runs > 65535 || delta == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunks = Lk / key_chunk;
  const int per_run = (n_chunks + n_runs - 1) / n_runs;
  if ((n_runs - 1) * per_run >= n_chunks ||
      (n_runs > 1 && dq_part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Dropout drop = make_dropout(seed, threshold, drop_on, keep_frac,
                                    inv_keep);
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kvp = static_cast<const __nv_bfloat16*>(kv);
  const float* bp = static_cast<const float*>(kv_bias);
  const float* lp = static_cast<const float*>(lse);
  const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(dout);
  float* dp = static_cast<float*>(delta);
  float* pp = static_cast<float*>(dq_part);
  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(dq);
  __nv_bfloat16* dkvp = static_cast<__nv_bfloat16*>(dkv);

  const int n_rows = B * Lq * nh;
  const int threads = 256;
  cross_delta_kernel<<<(unsigned)(((size_t)n_rows * 8 + threads - 1)
                                  / threads),
                       threads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out), gp, dp, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(n_runs, nh, B);
  const int atoms = (Lq + 15) / 16;              // 16-query atoms a warp
  switch (atoms < BWD_MIN_ATOMS ? BWD_MIN_ATOMS : atoms) {   // carries
    case 2:
      err = launch_cross_bwd<2>(grid, s, qp, kvp, bp, lp, dp, gp, pp, dqp,
                                dkvp, Lq, Lk, nh, key_chunk, per_run, scale,
                                drop);
      break;
    case 3:
      err = launch_cross_bwd<3>(grid, s, qp, kvp, bp, lp, dp, gp, pp, dqp,
                                dkvp, Lq, Lk, nh, key_chunk, per_run, scale,
                                drop);
      break;
    default:
      err = launch_cross_bwd<4>(grid, s, qp, kvp, bp, lp, dp, gp, pp, dqp,
                                dkvp, Lq, Lk, nh, key_chunk, per_run, scale,
                                drop);
  }
  if (err != cudaSuccess || n_runs == 1) return (int)err;
  const size_t n = (size_t)B * Lq * nh * amma::HD;
  cross_dq_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                           0, s>>>(pp, dqp, n_runs, n);
  return (int)cudaGetLastError();
}

// The backward walk's layout, for reports: out[0] = slots of a warp's ring,
// out[1] = threads a block; then for M = 2..4 atoms of 16 queries, out[1 +
// M] = dynamic shared memory of a block in bytes, out[5 + M] and out[9 + M]
// = blocks of that kernel (dropout off, on) a multiprocessor of the current
// device holds at once, by the runtime's occupancy query (out[2], out[6]
// and out[10] are not written: there is no one-atom kernel). Returns a
// cudaError_t (0 = all read).
extern "C" int emdr2_flash_cross_attention_bwd_layout(int* out) {
  out[0] = BWD_STAGES;
  out[1] = BWD_THREADS;
  for (int m = BWD_MIN_ATOMS; m <= 4; ++m) out[1 + m] = bwd_smem(m);
  cudaError_t err = bwd_residency<2>(out + 7, out + 11);
  if (err == cudaSuccess) err = bwd_residency<3>(out + 8, out + 12);
  if (err == cudaSuccess) err = bwd_residency<4>(out + 9, out + 13);
  return (int)err;
}
