// The flash attention walks on register-resident tiles (attention_mma.cuh,
// wgmma m64n64k16), shared by the self-attention slab kernels
// (flash_self_attention.cu) and the general per-head kernels
// (fid_attention.cu): one forward body and one backward pair, instantiated
// per saved softmax statistic.
//
// Every tensor of heads is read and written through its strides
// (HeadRows), so q, k and v may be column slices of one fused projection
// slab and the gradients may land in the column slices of another. The keys
// are walked in logical chunks of C keys (the unit of the dropout mask's
// coordinates: chunk j, column within the chunk), each in 64-key tiles that
// never straddle a chunk: a chunk that is no multiple of 64 ends in a short
// tile whose missing keys count as bias -inf. Self-attention on a slab is
// the one-chunk case, C = Lk.
//
// Forward: one block per (128-query tile, head, row), two warpgroups of 64
// queries. Q and the 64-key tiles of K and V sit in shared memory as
// [64, 64] tiles under the 128-byte swizzle (a head's row is exactly one
// swizzle row); K, V and the bias arrive through a ring of FWD_STAGES slots
// filled by cp.async, the next tile in flight while this one is multiplied.
// Per tile: S = Q.K^T by four wgmma with both operands in shared memory and
// the result in registers; the online softmax on those registers (p rounds
// against the running max after each 64-key tile); p packed to bf16 in
// place as the register A operand of four wgmma for P.V (V read
// transposed). The output accumulator lives in registers for the whole
// walk. FWD_MINB sets the register budget (128, two blocks a
// multiprocessor).
//
// Backward: two kernels, neither with atomics or partial sums, so the
// gradients repeat bit for bit. Both rebuild P from the saved statistic.
//   dq: one block (one warpgroup) per (64-query tile, head, row), q and do
//   resident, k, v and the bias through a cp.async ring. Per key tile
//   S = q k^T and dP = do v^T land in registers; P, the mask and
//   dS = P (dP - delta) are computed there; dS packed to bf16 in place is
//   the A operand of dq += dS k. It also writes delta = rowsum(do * out).
//   dk, dv: one block per (64-key tile of a chunk, head, row), k and v
//   resident, q, do and the per-query (statistic, delta) through the ring.
//   The key tile is the M rows: S^T = k q^T and dP^T = v do^T in registers,
//   the per-query values are per column of the accumulator; P_d^T and dS^T
//   packed in place are the A operands of dv += P_d^T do and dk += dS^T q.
// Results are staged as bf16 over the block's own resident tiles and
// written 16 bytes a lane.
//
// Relative-position bias (RelBias, a compile-time variant; NoRel builds the
// walks without it): a per-head fp32 vector over the key-query offsets,
// bias[h, j - i + Lq - 1], added to the scaled score of query i and key j
// (j counted over all keys, not within a chunk). Each block copies its
// head's vector into shared memory, padded with zeros on both sides so that
// the rows and keys past the tensors index it too (their scores are masked
// or never written). The dq kernel also sums dS along each diagonal: per
// key tile each warp stages its [16, 64] dS in shared memory, each lane
// sums whole diagonals of it (79 of them, rows of stride REL_STAGE so a
// diagonal's reads fall in distinct banks across the lanes) and adds each
// sum to the block's shared-memory row of offsets (one atomic add a
// diagonal and warp: the warps' diagonals overlap); the row is the block's
// partial [B * query tiles, nh, Lq + Lk - 1], which the caller sums over
// rows and tiles.

#pragma once

#include <math.h>

#include "attention_mma.cuh"
#include "hashing.cuh"

namespace aflash {

using amma::HD;
using amma::WG_TILE;
typedef __nv_bfloat16 bf16;

// A [B, L, nh, 64] bf16 tensor seen through its batch and row strides (in
// elements, multiples of 8; heads and the head dim contiguous; 16-byte
// aligned).
struct HeadRows {
  bf16* p;
  long long bs;
  int rs;
  __device__ __forceinline__ bf16* head(int b, int h) const {
    return p + (size_t)b * bs + h * HD;
  }
};

inline HeadRows head_rows(const void* p, long long bs, int rs) {
  HeadRows r;
  r.p = static_cast<bf16*>(const_cast<void*>(p));
  r.bs = bs;
  r.rs = rs;
  return r;
}

inline bool bad_rows(const HeadRows& r) {
  return r.bs < 0 || r.rs <= 0 || r.bs % 8 || r.rs % 8;
}

inline bool bad_shape(int B, int Lq, int Lk, int nh, int hd, int C) {
  return hd != HD || B <= 0 || Lq <= 0 || Lk <= 0 || nh <= 0 || B > 65535 ||
         nh > 65535 || C <= 0 || Lk % C;
}

// ---- the softmax statistic a forward saves per (batch*head, query) ----
//
// The backward rebuilds P = prob(s, first, second) from it, where first and
// second are the values row_first and (where the statistic has two, kTwo)
// row_second hold for the query.

// (rowmax, 1/l) [B*nh, 2, Lq] fp32: exact on a fully padded row, whose
// rowmax is about -1e9 (an lse would lose log l there). A null base saves
// nothing (inference).
struct RowMaxInv {
  float* base;
  static constexpr bool kTwo = true;
  __device__ __forceinline__ const float* row_first(uint32_t bh,
                                                    int Lq) const {
    return base + (size_t)bh * 2 * Lq;
  }
  __device__ __forceinline__ const float* row_second(uint32_t bh,
                                                     int Lq) const {
    return base + ((size_t)bh * 2 + 1) * Lq;
  }
  __device__ __forceinline__ void save(uint32_t bh, int Lq, int row, float m,
                                       float l) const {
    if (base == nullptr) return;
    base[(size_t)bh * 2 * Lq + row] = m;
    base[((size_t)bh * 2 + 1) * Lq + row] = 1.0f / (l > 0.0f ? l : 1.0f);
  }
  static __device__ __forceinline__ float prob(float s, float m, float il) {
    return amma::exp_fast(s - m) * il;
  }
};

// lse = m + log l [B*nh, Lq] fp32 (l guarded > 0): a fully padded row has
// lse = its (equal) scores, so P = 1 on every key there.
struct Lse {
  float* base;
  static constexpr bool kTwo = false;
  __device__ __forceinline__ const float* row_first(uint32_t bh,
                                                    int Lq) const {
    return base + (size_t)bh * Lq;
  }
  __device__ __forceinline__ void save(uint32_t bh, int Lq, int row, float m,
                                       float l) const {
    base[(size_t)bh * Lq + row] = m + logf(l > 0.0f ? l : 1.0f);
  }
  static __device__ __forceinline__ float prob(float s, float lse, float) {
    return amma::exp_fast(s - lse);
  }
};

// Half `hf` of a warp's [16, 64] fp32 accumulator (this lane's row g + 8*hf
// of the 16), times `mul`, staged as bf16 in row `r` of a swizzled tile.
__device__ __forceinline__ void stage_half(bf16* tile, int r,
                                           const float (&acc)[1][amma::DT][4],
                                           int hf, float mul, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < amma::DT; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(tile + amma::swizzled(r, n) + 2 * t) =
        __floats2bfloat162_rn(acc[0][n][2 * hf] * mul,
                              acc[0][n][2 * hf + 1] * mul);
  }
}

// The warp's 16 staged rows -> rows [row0, row0 + 16) of `dst` (row stride
// `rs`), 16 bytes a lane; rows at or past `limit` are not written.
__device__ __forceinline__ void write_rows(bf16* dst, int rs, int row0,
                                           int limit, const bf16* tile,
                                           int warp_row0, int lane) {
  for (int i = lane; i < 16 * (HD / 8); i += 32) {
    const int r = i >> 3;
    const int c = i & 7;
    if (row0 + r < limit) {
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * rs + c * 8) =
          *reinterpret_cast<const uint4*>(tile
                                          + amma::swizzled(warp_row0 + r, c));
    }
  }
}

// floor(i / d) for 0 <= i, 1 <= d, i * d < 2^32 by one multiply, with
// recip = div_recip(d): the walks turn a tile's index into (chunk, tile of
// the chunk) with it, which costs fewer registers across the walk than two
// more counters and less work a tile than a division.
__device__ __forceinline__ uint32_t div_recip(int d) {
  return d > 1 ? 0xFFFFFFFFu / (uint32_t)d + 1u : 0u;   // ceil(2^32 / d)
}

__device__ __forceinline__ int div_by(int i, int d, uint32_t recip) {
  return d > 1 ? (int)__umulhi((uint32_t)i, recip) : i;
}

// The dynamic shared memory, aligned to the swizzled tiles' 1024 bytes.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (amma::smem_u32(raw) & 1023)) & 1023);
}

// ---- the relative-position bias of a walk ----

// No bias: the walks as they were.
struct NoRel {
  static constexpr bool kOn = false;
  const float* bias;
  float* dbias;
};

// bias [nh, Lq + Lk - 1] fp32, the offset j - i at column j - i + Lq - 1;
// dbias [B * ceil(Lq / 64), nh, Lq + Lk - 1] fp32, the dq kernel's
// partials (backward only).
struct RelBias {
  static constexpr bool kOn = true;
  const float* bias;
  float* dbias;
};

// zeros each side of a shared-memory row of offsets: rows up to 127 past
// Lq and keys up to 63 past Lk still index inside it
constexpr int REL_PAD = 128;
// the row stride (floats) of a warp's staged [16, 64] dS: writes of a quad
// two-way at most, a diagonal's reads across the lanes in distinct banks
constexpr int REL_STAGE = 72;
constexpr int REL_STAGE_BYTES = 16 * REL_STAGE * 4;   // a warp's

// Bytes of one shared-memory row of offsets, padded.
__host__ __device__ inline int rel_row_bytes(int Lq, int Lk) {
  return ((Lq + Lk - 1 + 2 * REL_PAD + 3) / 4) * 16;
}

// Copies the head's offsets into `at` (padded with zeros) with `nthreads`
// threads; returns the row's offset 0 - (Lq - 1): row[j - i + Lq - 1].
__device__ __forceinline__ float* load_rel_row(unsigned char* at,
                                               const float* src, int width,
                                               int tid, int nthreads) {
  float* r = reinterpret_cast<float*>(at);
  for (int i = tid; i < width + 2 * REL_PAD; i += nthreads) {
    const int o = i - REL_PAD;
    r[i] = (o >= 0 && o < width) ? __ldg(src + o) : 0.0f;
  }
  return r + REL_PAD;
}

// Zeroes a padded shared-memory row of offsets (the dq kernel's sums);
// returns it as load_rel_row does.
__device__ __forceinline__ float* zero_rel_row(unsigned char* at, int width,
                                               int tid, int nthreads) {
  float* r = reinterpret_cast<float*>(at);
  for (int i = tid; i < width + 2 * REL_PAD; i += nthreads) r[i] = 0.0f;
  return r + REL_PAD;
}

// ------------------------------------------------------------- forward

constexpr int FWD_GROUPS = 2;   // warpgroups (64 queries each) a block
constexpr int FWD_STAGES = 3;   // key/value tiles in the shared-memory ring
constexpr int FWD_MINB = 2;     // blocks a multiprocessor the registers allow
constexpr int KT = 64;                              // rows per tile
constexpr int NT = KT / 8;
constexpr int FWD_ROWS = FWD_GROUPS * 64;            // queries per block
constexpr int FWD_THREADS = FWD_GROUPS * 128;
// one ring slot: two swizzled tiles and up to 1 KB of fp32 per-row values
// (the keys' bias; the queries' statistic and delta), which keeps the next
// slot's tiles on their 1024-byte alignment
constexpr int SLOT = 2 * WG_TILE * 2 + 1024;
// the queries, the ring, and room to align the whole to 1024 bytes
constexpr int FWD_SMEM = FWD_ROWS * HD * 2 + FWD_STAGES * SLOT + 1024;

static_assert(FWD_STAGES >= 2, "the ring overlaps one load with one product");
static_assert(3 * KT * 4 <= 1024,
              "the per-row values share the slot's last KB");

// The ring of STAGES slots through which a walk over the keys receives tile
// after tile of (keys, values, the keys' bias) by cp.async from THREADS
// threads: the forward's and the dq kernel's. The tile loaded next is tile
// pt of chunk pj.
template <int STAGES, int THREADS>
struct KeyRing {
  unsigned char* slots;
  const bf16* kb;               // the head's keys and values, row 0
  const bf16* vb;
  const float* bias;            // the row's key-side bias
  int k_rs, v_rs, C, n_chunks, n_ct;
  int pj, pt;

  __device__ __forceinline__ bf16* keys(int i) const {
    return reinterpret_cast<bf16*>(slots + (i % STAGES) * SLOT);
  }
  __device__ __forceinline__ bf16* values(int i) const {
    return keys(i) + WG_TILE;
  }
  __device__ __forceinline__ float* key_bias(int i) const {
    return reinterpret_cast<float*>(keys(i) + 2 * WG_TILE);
  }
  // Load the next tile into slot `i`, if one is left, and commit a group
  // either way (an empty group keeps the count in step).
  __device__ __forceinline__ void prefetch(int i, int tid) {
    if (pj < n_chunks) {
      const int r0 = pj * C + pt * KT;
      const int limit = (pj + 1) * C;
      amma::load_rows_async_swizzled<KT>(keys(i), kb, k_rs, r0, limit, tid,
                                         THREADS);
      amma::load_rows_async_swizzled<KT>(values(i), vb, v_rs, r0, limit, tid,
                                         THREADS);
      for (int c = tid; c < KT; c += THREADS) {
        const bool ok = r0 + c < limit;
        amma::cp_async4(key_bias(i) + c, bias + (ok ? r0 + c : 0), ok);
      }
      if (++pt == n_ct) {
        pt = 0;
        ++pj;
      }
    }
    amma::cp_async_commit();
  }
};

// out [B, Lq, nh, hd] contiguous; `stat` saves the row's statistic; `rel`
// the relative-position bias, if any.
template <bool DROP, class Stat, class Rel>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MINB)
flash_fwd_kernel(HeadRows q, HeadRows k, HeadRows v,
                 const float* __restrict__ kv_bias, bf16* __restrict__ out,
                 Stat stat, int Lq, int Lk, int nh, int C, float scale,
                 Dropout drop, Rel rel) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x;
  const int group = tid / 128;                      // the warpgroup
  const int warp = (tid % 128) / 32;                // within it
  const int lane = tid % 32;

  const int q0 = blockIdx.x * FWD_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* qb = q.head(b, h);
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int n_chunks = Lk / C;
  const int n_ct = (C + KT - 1) / KT;               // tiles of a chunk
  const int n_tiles = n_chunks * n_ct;
  const uint32_t ct_recip = div_recip(n_ct);
  KeyRing<FWD_STAGES, FWD_THREADS> ring{
      smem + FWD_ROWS * HD * 2, k.head(b, h), v.head(b, h),
      kv_bias + (size_t)b * Lk, k.rs, v.rs, C, n_chunks, n_ct, 0, 0};

  // a warpgroup's 64 queries are one swizzled tile of their own
#pragma unroll
  for (int g = 0; g < FWD_GROUPS; ++g) {
    amma::load_rows_async_swizzled<64>(Qs + g * WG_TILE, qb, q.rs,
                                       q0 + g * 64, Lq, tid, FWD_THREADS);
  }
#pragma unroll
  for (int s = 0; s < FWD_STAGES - 1; ++s) {
    ring.prefetch(s, tid);                          // Q is in group 0
  }

  float O[1][amma::DT][4], mrow[1][2], lrow[1][2];
  amma::init_state<1>(O, mrow, lrow);
  bf16* Qg = Qs + group * WG_TILE;
  const int qrow0 = q0 + group * 64 + warp * 16;
  const float* rel_s = nullptr;     // rel_s[j - i + Lq - 1]
  if constexpr (Rel::kOn) {
    rel_s = load_rel_row(smem + FWD_ROWS * HD * 2 + FWD_STAGES * SLOT,
                         rel.bias + (size_t)h * (Lq + Lk - 1), Lq + Lk - 1,
                         tid, FWD_THREADS) + (Lq - 1);
  }

  float S[1][NT][4] = {};       // the products take it as a read-write operand
  uint32_t P[NT / 2][4];
  for (int i = 0; i < n_tiles; ++i) {
    amma::cp_async_wait<FWD_STAGES - 2>();           // tile i has landed
    amma::fence_async_proxy();                      // ... where wgmma reads,
    __syncthreads();                                // for every thread,
    ring.prefetch(i + FWD_STAGES - 1, tid);          // and tile i-1 is free
    amma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {          // 32 bytes a k-step
      amma::wgmma_ss(S, amma::wgmma_desc(Qg, kk * 32),
                     amma::wgmma_desc(ring.keys(i), kk * 32), kk > 0);
    }
    amma::wgmma_commit();
    amma::wgmma_wait<0>(S, O);
    const int cj = div_by(i, n_ct, ct_recip);       // tile ct of chunk cj
    const int ct = i - cj * n_ct;
    if constexpr (Rel::kOn) {
      // s * scale + the offset's bias here; the step adds the key bias
      const int key0 = cj * C + ct * KT + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int off = key0 + 8 * n + e - (qrow0 + 8 * hf + (lane >> 2));
            S[0][n][2 * hf + e] = fmaf(S[0][n][2 * hf + e], scale,
                                       rel_s[off]);
          }
        }
      }
    }
    amma::softmax_step<1, NT, DROP>(S, O, mrow, lrow, ring.key_bias(i),
                                    ct * KT, C, Rel::kOn ? 1.0f : scale, drop,
                                    bh, (uint32_t)cj, qrow0, lane);
    amma::pack_scores<NT>(P, S);
    amma::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks) {           // 16 keys = 2048 bytes
      amma::wgmma_rs(O, P[ks], amma::wgmma_desc(ring.values(i), ks * 2048));
    }
    // waited for here: left in flight into the next tile, the assembler
    // serializes the products (and the time is the same)
    amma::wgmma_commit();
    amma::wgmma_wait<0>(S, O);
  }
  amma::cp_async_wait<0>();

  // out = O / (l * (1 - rate)): staged as bf16 over the warp's own query
  // rows (every product that read them is done), then written 16 bytes a
  // lane
  __syncwarp();
  const int g = lane >> 2;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float l = amma::quad_sum(lrow[0][hf]);
    const float l_eff = l * drop.keep_frac;
    const float inv = 1.0f / (l_eff > 0.0f ? l_eff : 1.0f);
    stage_half(Qg, warp * 16 + 8 * hf + g, O, hf, inv, lane);
    const int row = qrow0 + 8 * hf + g;
    if ((lane & 3) == 0 && row < Lq) stat.save(bh, Lq, row, mrow[0][hf], l);
  }
  __syncwarp();
  write_rows(out + (size_t)b * Lq * nh * HD + h * HD, nh * HD, qrow0, Lq, Qg,
             warp * 16, lane);
}

// The scores' scale of standard attention, hd^-0.5.
inline float default_scale() { return 1.0f / sqrtf((float)HD); }

// The most dynamic shared memory a block may ask for on the H100.
constexpr int MAX_SMEM = 227 * 1024;

// Launches the forward on `stream`; returns the launch's cudaError_t.
// Scores are s * scale (+ the relative-position bias of `rel`) + the key
// bias.
template <class Stat, class Rel = NoRel>
inline cudaError_t launch_forward(HeadRows q, HeadRows k, HeadRows v,
                                  const void* kv_bias, void* out, Stat stat,
                                  int B, int Lq, int Lk, int nh, int C,
                                  Dropout drop, void* stream,
                                  float scale = default_scale(),
                                  Rel rel = Rel{}) {
  const auto kernel = drop.on ? flash_fwd_kernel<true, Stat, Rel>
                              : flash_fwd_kernel<false, Stat, Rel>;
  const int smem = FWD_SMEM + (Rel::kOn ? rel_row_bytes(Lq, Lk) : 0);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + FWD_ROWS - 1) / FWD_ROWS, nh, B);
  kernel<<<grid, FWD_THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, static_cast<const float*>(kv_bias), static_cast<bf16*>(out),
      stat, Lq, Lk, nh, C, scale, drop, rel);
  return cudaGetLastError();
}

// ------------------------------------------------------------ backward

constexpr int BWD_THREADS = 128;  // one warpgroup: 64 queries (dq), 64 keys
constexpr int BWD_STAGES = 3;     // tiles in the shared-memory ring
constexpr int DQ_MINB = 3;        // blocks a multiprocessor: 170 registers
constexpr int DKV_MINB = 2;       // ... 255 registers
// the two resident tiles, the ring, and room to align the whole
constexpr int BWD_SMEM = 2 * WG_TILE * 2 + BWD_STAGES * SLOT + 1024;

// The mask's constant of (batch*head, chunk): see dropout_keep in hashing.cuh.
__device__ __forceinline__ uint32_t mask_base(const Dropout& drop, uint32_t bh,
                                              uint32_t j) {
  return drop.seed + bh * 0x27D4EB2Fu + j * 0x165667B1u;
}

// dq for one (64-query tile, head, row); also writes delta = rowsum(do *
// out) [B*nh, Lq]. out and dout are [B, Lq, nh, hd] contiguous.
template <bool DROP, class Stat, class Rel>
__global__ void __launch_bounds__(BWD_THREADS, DQ_MINB)
flash_bwd_dq_kernel(HeadRows q, HeadRows k, HeadRows v,
                    const float* __restrict__ kv_bias, Stat stat,
                    const bf16* __restrict__ out,
                    const bf16* __restrict__ dout, float* __restrict__ delta,
                    HeadRows dq, int Lq, int Lk, int nh, int C, float scale,
                    Dropout drop, Rel rel) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + WG_TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int q0 = blockIdx.x * KT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * HD;
  const bf16* ob = out + (size_t)b * Lq * H + h * HD;
  const bf16* dob = dout + (size_t)b * Lq * H + h * HD;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const int n_chunks = Lk / C;
  const int n_ct = (C + KT - 1) / KT;
  const int n_tiles = n_chunks * n_ct;
  const uint32_t ct_recip = div_recip(n_ct);
  KeyRing<BWD_STAGES, BWD_THREADS> ring{
      smem + 2 * WG_TILE * 2, k.head(b, h), v.head(b, h),
      kv_bias + (size_t)b * Lk, k.rs, v.rs, C, n_chunks, n_ct, 0, 0};

  amma::load_rows_async_swizzled<KT>(Qs, q.head(b, h), q.rs, q0, Lq, tid,
                                     BWD_THREADS);
  amma::load_rows_async_swizzled<KT>(dOs, dob, H, q0, Lq, tid, BWD_THREADS);
#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s) ring.prefetch(s, tid);
  // the offsets' bias and the block's sums of dS along the diagonals,
  // both indexed [j - i + Lq - 1]
  const int width = Lq + Lk - 1;
  const float* rel_s = nullptr;
  float* drel_s = nullptr;
  float* stage_s = nullptr;         // this warp's [16, REL_STAGE] dS
  if constexpr (Rel::kOn) {
    unsigned char* at = smem + 2 * WG_TILE * 2 + BWD_STAGES * SLOT;
    rel_s = load_rel_row(at, rel.bias + (size_t)h * width, width, tid,
                         BWD_THREADS) + (Lq - 1);
    drel_s = zero_rel_row(at + rel_row_bytes(Lq, Lk), width, tid,
                          BWD_THREADS) + (Lq - 1);
    stage_s = reinterpret_cast<float*>(at + 2 * rel_row_bytes(Lq, Lk)
                                       + warp * REL_STAGE_BYTES);
  }

  // this lane's two query rows: the statistic, and delta from the lane's 16
  // of the row's 64 columns, summed over the quad
  const int qrow0 = q0 + warp * 16;
  float first[2], second[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = qrow0 + 8 * hf + g;
    const bool ok = row < Lq;
    float d = 0.0f;
    first[hf] = 0.0f;
    second[hf] = 0.0f;
    if (ok) {
      const uint4* o4 =
          reinterpret_cast<const uint4*>(ob + (size_t)row * H + t * 16);
      const uint4* g4 =
          reinterpret_cast<const uint4*>(dob + (size_t)row * H + t * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 ov = __ldg(o4 + i);
        const uint4 gv = __ldg(g4 + i);
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 =
            reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 gf = __bfloat1622float2(g2[e]);
          d = fmaf(gf.x, of.x, d);
          d = fmaf(gf.y, of.y, d);
        }
      }
      first[hf] = stat.row_first(bh, Lq)[row];
      if constexpr (Stat::kTwo) second[hf] = stat.row_second(bh, Lq)[row];
    }
    d = amma::quad_sum(d);
    dl[hf] = d;
    if (ok && t == 0) delta[(size_t)bh * Lq + row] = d;
  }

  float S[1][NT][4] = {}, dP[1][NT][4] = {}, acc[1][amma::DT][4] = {};
  uint32_t A[NT / 2][4];
  for (int i = 0; i < n_tiles; ++i) {
    amma::cp_async_wait<BWD_STAGES - 2>();
    amma::fence_async_proxy();
    __syncthreads();
    ring.prefetch(i + BWD_STAGES - 1, tid);
    amma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {          // S = q k^T
      amma::wgmma_ss(S, amma::wgmma_desc(Qs, kk * 32),
                     amma::wgmma_desc(ring.keys(i), kk * 32), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {          // dP = do v^T
      amma::wgmma_ss(dP, amma::wgmma_desc(dOs, kk * 32),
                     amma::wgmma_desc(ring.values(i), kk * 32), kk > 0);
    }
    amma::wgmma_commit();
    amma::wgmma_wait<0>(S, dP);

    // dS = P (dP - delta), in place of S
    const float* bias_s = ring.key_bias(i);
    const int cj = div_by(i, n_ct, ct_recip);       // tile ct of chunk cj
    const int ct = i - cj * n_ct;
    const int kin0 = ct * KT;
    const uint32_t base = mask_base(drop, bh, (uint32_t)cj);
    const uint32_t rterm[2] = {
        (uint32_t)(qrow0 + g) * 0x9E3779B1u ^ base,
        (uint32_t)(qrow0 + 8 + g) * 0x9E3779B1u ^ base};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t;
      const float kbias[2] = {
          kin0 + col < C ? bias_s[col] : -INFINITY,
          kin0 + col + 1 < C ? bias_s[col + 1] : -INFINITY};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = fmaf(S[0][n][2 * hf + e], scale, kbias[e]);
          const int off = cj * C + kin0 + col + e - (qrow0 + 8 * hf + g);
          if constexpr (Rel::kOn) s += rel_s[off];
          const float p = Stat::prob(s, first[hf], second[hf]);
          float dp = dP[0][n][2 * hf + e];
          if (DROP) {
            const uint32_t kin = (uint32_t)(kin0 + col + e);
            dp = murmur_fin(rterm[hf] ^ (kin * 0x85EBCA77u)) < drop.threshold
                     ? 0.0f : dp * drop.inv_keep;
          }
          const float ds = p * (dp - dl[hf]);
          S[0][n][2 * hf + e] = ds;
          if constexpr (Rel::kOn) {
            stage_s[(8 * hf + g) * REL_STAGE + col + e] = ds;
          }
        }
      }
    }
    if constexpr (Rel::kOn) {
      // the sums along the tile's diagonals: lane l takes the offsets
      // o = l - 15, l + 17, l + 49 (key column minus row, -15 .. 63)
      __syncwarp();
      float* dst = drel_s + (cj * C + kin0 - qrow0);
      for (int o = lane - 15; o < KT; o += 32) {
        const int r0 = o < 0 ? -o : 0;
        const int r1 = o > KT - 16 ? KT - 1 - o : 15;
        float sum = 0.0f;
        for (int r = r0; r <= r1; ++r) sum += stage_s[r * (REL_STAGE + 1) + o];
        asm volatile("red.shared.add.f32 [%0], %1;\n"
                     :: "r"(amma::smem_u32(dst + o)), "f"(sum) : "memory");
      }
      __syncwarp();
    }
    amma::pack_scores<NT>(A, S);
    amma::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks) {           // dq += dS k
      amma::wgmma_rs(acc, A[ks], amma::wgmma_desc(ring.keys(i), ks * 2048));
    }
    amma::wgmma_commit();
    amma::wgmma_wait<0>(acc, S);
  }
  amma::cp_async_wait<0>();

  // dq * scale staged over the warp's own query rows (every product of the
  // block is done)
  __syncthreads();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    stage_half(Qs, warp * 16 + 8 * hf + g, acc, hf, scale, lane);
  }
  __syncwarp();
  write_rows(dq.head(b, h), dq.rs, qrow0, Lq, Qs, warp * 16, lane);
  if constexpr (Rel::kOn) {                         // the block's partial
    float* dst = rel.dbias
                 + ((size_t)(b * gridDim.x + blockIdx.x) * nh + h) * width;
    for (int o = tid; o < width; o += BWD_THREADS) {
      dst[o] = drel_s[o - (Lq - 1)];
    }
  }
}

// dk and dv for one (64-key tile of a chunk, head, row), walking the query
// tiles; delta from the dq kernel.
template <bool DROP, class Stat, class Rel>
__global__ void __launch_bounds__(BWD_THREADS, DKV_MINB)
flash_bwd_dkv_kernel(HeadRows q, HeadRows k, HeadRows v,
                     const float* __restrict__ kv_bias, Stat stat,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ delta, HeadRows dk, HeadRows dv,
                     int Lq, int Lk, int nh, int C, float scale,
                     Dropout drop, Rel rel) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + WG_TILE;
  unsigned char* ring = smem + 2 * WG_TILE * 2;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int n_ct = (C + KT - 1) / KT;
  const int j = blockIdx.x / n_ct;                  // the key chunk
  const int c0 = j * C;
  const int t0 = (blockIdx.x % n_ct) * KT;          // tile start in the chunk
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = nh * HD;
  const bf16* qb = q.head(b, h);
  const int q_rs = q.rs;
  const bf16* dob = dout + (size_t)b * Lq * H + h * HD;
  const uint32_t bh = (uint32_t)(b * nh + h);
  const float* first_row = stat.row_first(bh, Lq);
  const float* delta_row = delta + (size_t)bh * Lq;
  const int n_qt = (Lq + KT - 1) / KT;

  auto slot_q = [&](int i) {
    return reinterpret_cast<bf16*>(ring + (i % BWD_STAGES) * SLOT);
  };
  auto slot_do = [&](int i) { return slot_q(i) + WG_TILE; };
  // the queries' (first, second, delta), KT floats each
  auto slot_rows = [&](int i) {
    return reinterpret_cast<float*>(slot_q(i) + 2 * WG_TILE);
  };
  auto prefetch = [&](int i) {
    if (i < n_qt) {
      const int r0 = i * KT;
      amma::load_rows_async_swizzled<KT>(slot_q(i), qb, q_rs, r0, Lq, tid,
                                         BWD_THREADS);
      amma::load_rows_async_swizzled<KT>(slot_do(i), dob, H, r0, Lq, tid,
                                         BWD_THREADS);
      float* rows = slot_rows(i);
      for (int c = tid; c < KT; c += BWD_THREADS) {
        const bool ok = r0 + c < Lq;
        const int src = ok ? r0 + c : 0;
        amma::cp_async4(rows + c, first_row + src, ok);
        if constexpr (Stat::kTwo) {
          amma::cp_async4(rows + KT + c, stat.row_second(bh, Lq) + src, ok);
        }
        amma::cp_async4(rows + 2 * KT + c, delta_row + src, ok);
      }
    }
    amma::cp_async_commit();
  };

  amma::load_rows_async_swizzled<KT>(Ks, k.head(b, h), k.rs, c0 + t0, c0 + C,
                                     tid, BWD_THREADS);
  amma::load_rows_async_swizzled<KT>(Vs, v.head(b, h), v.rs, c0 + t0, c0 + C,
                                     tid, BWD_THREADS);
#pragma unroll
  for (int s = 0; s < BWD_STAGES - 1; ++s) prefetch(s);
  const float* rel_s = nullptr;     // rel_s[j - i + Lq - 1]
  if constexpr (Rel::kOn) {
    rel_s = load_rel_row(ring + BWD_STAGES * SLOT,
                         rel.bias + (size_t)h * (Lq + Lk - 1), Lq + Lk - 1,
                         tid, BWD_THREADS) + (Lq - 1);
  }

  // this lane's two keys: place in the chunk, bias, the mask's key term
  const int kin0 = t0 + warp * 16;
  const uint32_t base = mask_base(drop, bh, (uint32_t)j);
  float kbias[2];
  uint32_t kterm[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kin = kin0 + 8 * hf + g;
    kbias[hf] = kin < C ? kv_bias[(size_t)b * Lk + c0 + kin] : -INFINITY;
    kterm[hf] = (uint32_t)kin * 0x85EBCA77u ^ base;
  }

  float ST[1][NT][4] = {}, dPT[1][NT][4] = {};
  float dk_acc[1][amma::DT][4] = {}, dv_acc[1][amma::DT][4] = {};
  uint32_t Apd[NT / 2][4], Ads[NT / 2][4];
  for (int i = 0; i < n_qt; ++i) {
    amma::cp_async_wait<BWD_STAGES - 2>();
    amma::fence_async_proxy();
    __syncthreads();
    prefetch(i + BWD_STAGES - 1);
    amma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {          // S^T = k q^T
      amma::wgmma_ss(ST, amma::wgmma_desc(Ks, kk * 32),
                     amma::wgmma_desc(slot_q(i), kk * 32), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {          // dP^T = v do^T
      amma::wgmma_ss(dPT, amma::wgmma_desc(Vs, kk * 32),
                     amma::wgmma_desc(slot_do(i), kk * 32), kk > 0);
    }
    amma::wgmma_commit();
    amma::wgmma_wait<0>(ST, dPT);

    // P_d^T in place of S^T, dS^T in place of dP^T; the queries' values
    // are per column
    const float* rows = slot_rows(i);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 f2 = *reinterpret_cast<const float2*>(rows + col);
      const float2 s2 =
          Stat::kTwo ? *reinterpret_cast<const float2*>(rows + KT + col)
                     : make_float2(0.0f, 0.0f);
      const float2 d2 = *reinterpret_cast<const float2*>(rows + 2 * KT + col);
      const float qfirst[2] = {f2.x, f2.y};
      const float qsecond[2] = {s2.x, s2.y};
      const float qdelta[2] = {d2.x, d2.y};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = fmaf(ST[0][n][2 * hf + e], scale, kbias[hf]);
          if constexpr (Rel::kOn) {
            s += rel_s[c0 + kin0 + 8 * hf + g - (i * KT + col + e)];
          }
          const float p = Stat::prob(s, qfirst[e], qsecond[e]);
          float dp = dPT[0][n][2 * hf + e];
          float pd = p;
          if (DROP) {
            const uint32_t qi = (uint32_t)(i * KT + col + e);
            const bool keep = murmur_fin(kterm[hf] ^ (qi * 0x9E3779B1u))
                              >= drop.threshold;
            dp = keep ? dp * drop.inv_keep : 0.0f;
            pd = keep ? p * drop.inv_keep : 0.0f;
          }
          ST[0][n][2 * hf + e] = pd;
          dPT[0][n][2 * hf + e] = p * (dp - qdelta[e]);
        }
      }
    }
    amma::pack_scores<NT>(Apd, ST);
    amma::pack_scores<NT>(Ads, dPT);
    amma::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks) {           // dv += P_d^T do
      amma::wgmma_rs(dv_acc, Apd[ks], amma::wgmma_desc(slot_do(i), ks * 2048));
    }
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks) {           // dk += dS^T q
      amma::wgmma_rs(dk_acc, Ads[ks], amma::wgmma_desc(slot_q(i), ks * 2048));
    }
    amma::wgmma_commit();
    amma::wgmma_wait<0>(dv_acc, dk_acc);
  }
  amma::cp_async_wait<0>();

  // dk * scale and dv staged over the warp's own key rows (every product
  // of the block is done)
  __syncthreads();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    stage_half(Ks, warp * 16 + 8 * hf + g, dk_acc, hf, scale, lane);
    stage_half(Vs, warp * 16 + 8 * hf + g, dv_acc, hf, 1.0f, lane);
  }
  __syncwarp();
  write_rows(dk.head(b, h), dk.rs, c0 + kin0, c0 + C, Ks, warp * 16, lane);
  write_rows(dv.head(b, h), dv.rs, c0 + kin0, c0 + C, Vs, warp * 16, lane);
}

// Launches both backward kernels on `stream`, in order; returns the first
// failing launch's cudaError_t (0 = both launched). `stat` is the forward's
// saved statistic, `delta` [B*nh, Lq] fp32 scratch; every element of dq
// [.., Lq, ..] and dk, dv [.., Lk, ..] is written, and with a RelBias every
// element of its partials dbias.
template <class Stat, class Rel = NoRel>
inline cudaError_t launch_backward(HeadRows q, HeadRows k, HeadRows v,
                                   const void* kv_bias, Stat stat,
                                   const void* out, const void* dout,
                                   void* delta, HeadRows dq, HeadRows dk,
                                   HeadRows dv, int B, int Lq, int Lk, int nh,
                                   int C, Dropout drop, void* stream,
                                   float scale = default_scale(),
                                   Rel rel = Rel{}) {
  const auto dq_kernel = drop.on ? flash_bwd_dq_kernel<true, Stat, Rel>
                                 : flash_bwd_dq_kernel<false, Stat, Rel>;
  const auto dkv_kernel = drop.on ? flash_bwd_dkv_kernel<true, Stat, Rel>
                                  : flash_bwd_dkv_kernel<false, Stat, Rel>;
  const int row = Rel::kOn ? rel_row_bytes(Lq, Lk) : 0;
  // the bias, the sums and the warps' staged dS
  const int dq_smem = BWD_SMEM + (Rel::kOn ? 2 * row + 4 * REL_STAGE_BYTES
                                           : 0);
  const int dkv_smem = BWD_SMEM + row;
  if (dq_smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const float* bias = static_cast<const float*>(kv_bias);
  const bf16* dop = static_cast<const bf16*>(dout);
  const dim3 q_grid((Lq + KT - 1) / KT, nh, B);
  dq_kernel<<<q_grid, BWD_THREADS, dq_smem, s>>>(
      q, k, v, bias, stat, static_cast<const bf16*>(out), dop,
      static_cast<float*>(delta), dq, Lq, Lk, nh, C, scale, drop, rel);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 k_grid((Lk / C) * ((C + KT - 1) / KT), nh, B);
  dkv_kernel<<<k_grid, BWD_THREADS, dkv_smem, s>>>(
      q, k, v, bias, stat, dop, static_cast<const float*>(delta), dk, dv, Lq,
      Lk, nh, C, scale, drop, rel);
  return cudaGetLastError();
}

}  // namespace aflash
