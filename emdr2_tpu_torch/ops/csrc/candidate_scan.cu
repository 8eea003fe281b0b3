// MIPS candidate scan over the resident evidence index, Hopper.
//
// Replaces: emdr2_tpu/ops/mips.py:_mips_candidates_kernel (launched by
// _candidate_scan). Scores every query against every index row and keeps,
// per group of G consecutive rows, the best row and the runner-up, so the
// [nq, N] score matrix never reaches device memory:
//   vals[q, r*(N/G) + g], idx[q, r*(N/G) + g]   for rank r in {0, 1}.
// Order is value descending, then lowest row first (jnp.argmax, and the
// knock-out of the winner before the second pass). Rows >= n_valid score
// NEG_INF = -3e38. bf16 x bf16 accumulates in fp32; int8 x int8 accumulates
// exactly in int32 and is cast to fp32, which is lossless because
// |dot| <= 768 * 127^2 < 2^24. Group and query scales of the int8 index are
// applied outside, to the winners only.
//
// Two kernels, picked by the wrapper (ops/mips.py:candidate_scan) by the
// number of queries:
//
// 1. The CUDA-core scan (candidate_scan_kernel), for serving batches. At
//    nq = 8 it is memory bound, one pass over the index (2.0 GB bf16 or
//    1.0 GB int8 at 1,310,720 x 768). One block per (group, query tile of 8
//    or 32); one thread per group row (blockDim = G). The query tile sits
//    in shared memory; the group's rows stream through shared memory in
//    128-byte column chunks with coalesced 16-byte loads, and each thread
//    accumulates its row's dot with every query of the tile in registers
//    (fmaf, or __dp4a for int8). The per-group top-2 is a block reduction
//    (warp shuffles, then one value per warp). At nq = 512 its scalar dot
//    products bound it.
//
// 2. The tensor-core scan (candidate_scan_mma_kernel), for query batches at
//    and above the crossover (retrieval evaluation sends thousands). There
//    the products bound the scan: 2 nq N d operations against one read of
//    the index. One block per (query tile of QT = 64 or 128, group of 128
//    rows), on a one-dimensional grid (blockIdx.x = tile + tiles * group:
//    any number of groups, where grid.y would stop at 65,535, 8.4M rows)
//    that walks query tiles fastest, so the blocks that read one group run
//    together and the group comes from device memory once and from L2 for
//    the other tiles. The block's [QT + 128, 128 bytes] k-chunks
//    of queries and rows stream through a three-stage cp.async ring; eight
//    warps each hold a [32 queries, 128 / WN rows] tile of scores in
//    registers, products by mma.sync (bf16 m16n8k16 into fp32, int8
//    m16n8k32 into int32, exact like __dp4a), operands by ldmatrix. Both
//    products take 32 bytes of each row a step, so one byte layout and one
//    ldmatrix addressing serve both types. The top-2 of each query over
//    the group comes straight from the accumulators: each thread's 2 x NT
//    columns, then the four threads of a quad by shuffles, then the WN
//    warps that share a query through shared memory (the ring's, reused).
//    Later work: wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr float NEG_INF = -3.0e38f;
constexpr int CHUNK = 128;            // bytes of each row staged per step
constexpr int RSTRIDE = CHUNK + 16;   // padded smem row stride (bytes)

template <int QT>
__device__ __forceinline__ void dot_chunk(const uint4* r, const uint8_t* qs,
                                          int qstride, float (&acc)[QT],
                                          const __nv_bfloat16*) {
#pragma unroll
  for (int p = 0; p < CHUNK / 16; ++p) {
    const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&r[p]);
    float2 rf[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) rf[e] = __bfloat1622float2(rv[e]);
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const uint4 qv = *reinterpret_cast<const uint4*>(qs + q * qstride + p * 16);
      const __nv_bfloat162* qb = reinterpret_cast<const __nv_bfloat162*>(&qv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 qf = __bfloat1622float2(qb[e]);
        acc[q] = fmaf(rf[e].x, qf.x, acc[q]);
        acc[q] = fmaf(rf[e].y, qf.y, acc[q]);
      }
    }
  }
}

template <int QT>
__device__ __forceinline__ void dot_chunk(const uint4* r, const uint8_t* qs,
                                          int qstride, int (&acc)[QT],
                                          const int8_t*) {
#pragma unroll
  for (int p = 0; p < CHUNK / 16; ++p) {
    const uint4 rv = r[p];
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const uint4 qv = *reinterpret_cast<const uint4*>(qs + q * qstride + p * 16);
      acc[q] = __dp4a((int)rv.x, (int)qv.x, acc[q]);
      acc[q] = __dp4a((int)rv.y, (int)qv.y, acc[q]);
      acc[q] = __dp4a((int)rv.z, (int)qv.z, acc[q]);
      acc[q] = __dp4a((int)rv.w, (int)qv.w, acc[q]);
    }
  }
}

// (v, i) beats (ov, oi): larger value, then lower row
__device__ __forceinline__ bool better(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

template <typename T, typename Acc, int QT>
__global__ void candidate_scan_kernel(const T* __restrict__ queries,
                                      const T* __restrict__ index,
                                      float* __restrict__ vals,
                                      int* __restrict__ idx, int nq, int N,
                                      int d, int n_valid, int cands) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = blockDim.x;
  const int NW = G / 32;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int g = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int qbytes = d * (int)sizeof(T);  // one query row, bytes

  uint8_t* qs = smem;                                  // [QT][qbytes]
  uint8_t* rs = qs + QT * qbytes;                      // [G][RSTRIDE]
  float* red_v = reinterpret_cast<float*>(rs + G * RSTRIDE);  // [QT][NW]
  int* red_i = reinterpret_cast<int*>(red_v + QT * NW);       // [QT][NW]
  int* win = red_i + QT * NW;                                  // [QT]

  // query tile -> smem (zero rows past nq)
  const uint8_t* qsrc = reinterpret_cast<const uint8_t*>(queries);
  for (int i = t; i < QT * (qbytes / 16); i += G) {
    const int q = i / (qbytes / 16);
    const int off = (i % (qbytes / 16)) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + q < nq) {
      v = *reinterpret_cast<const uint4*>(qsrc + (size_t)(q0 + q) * qbytes + off);
    }
    *reinterpret_cast<uint4*>(qs + q * qbytes + off) = v;
  }

  Acc acc[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) acc[q] = 0;

  const uint8_t* gsrc = reinterpret_cast<const uint8_t*>(index) +
                        (size_t)g * G * qbytes;
  for (int c0 = 0; c0 < qbytes; c0 += CHUNK) {
    __syncthreads();  // previous chunk consumed (and the query tile stored)
    for (int i = t; i < G * (CHUNK / 16); i += G) {
      const int r = i / (CHUNK / 16);
      const int off = (i % (CHUNK / 16)) * 16;
      *reinterpret_cast<uint4*>(rs + r * RSTRIDE + off) =
          *reinterpret_cast<const uint4*>(gsrc + (size_t)r * qbytes + c0 + off);
    }
    __syncthreads();
    dot_chunk<QT>(reinterpret_cast<const uint4*>(rs + t * RSTRIDE), qs + c0,
                  qbytes, acc, static_cast<const T*>(nullptr));
  }

  const int row = g * G + t;
  float s[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) s[q] = row < n_valid ? (float)acc[q] : NEG_INF;

  const int n_groups = N / G;
  const int n_cols = cands * n_groups;
  for (int rank = 0; rank < cands; ++rank) {
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      float v = s[q];
      int i = t;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
      }
      if (lane == 0) {
        red_v[q * NW + warp] = v;
        red_i[q * NW + warp] = i;
      }
    }
    __syncthreads();
    if (t < QT) {
      float v = red_v[t * NW];
      int i = red_i[t * NW];
      for (int w = 1; w < NW; ++w) {
        if (better(red_v[t * NW + w], red_i[t * NW + w], v, i)) {
          v = red_v[t * NW + w];
          i = red_i[t * NW + w];
        }
      }
      win[t] = i;
      if (q0 + t < nq) {
        const size_t o = (size_t)(q0 + t) * n_cols + (size_t)rank * n_groups + g;
        vals[o] = v;
        idx[o] = g * G + i;
      }
    }
    __syncthreads();
    // knock the winner out (NEG_INF, like the reference) for the next rank
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      if (win[q] == t) s[q] = NEG_INF;
    }
  }
}

template <typename T, typename Acc, int QT>
int launch(const void* queries, const void* index, void* vals, void* idx,
           int nq, int N, int d, int n_valid, int group, int cands,
           cudaStream_t stream) {
  const int qbytes = d * (int)sizeof(T);
  const int NW = group / 32;
  const size_t smem = (size_t)QT * qbytes + (size_t)group * RSTRIDE +
                      (size_t)QT * NW * 8 + QT * 4;
  auto kernel = candidate_scan_kernel<T, Acc, QT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / group, (nq + QT - 1) / QT);
  kernel<<<grid, group, smem, stream>>>(
      static_cast<const T*>(queries), static_cast<const T*>(index),
      static_cast<float*>(vals), static_cast<int*>(idx), nq, N, d, n_valid,
      cands);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core scan.

constexpr int MMA_G = 128;                 // rows a group (the block's N tile)
constexpr int MMA_THREADS = 256;           // eight warps
constexpr int MMA_KB = 128;                // bytes of each row a ring stage
constexpr int MMA_LD = MMA_KB + 16;        // smem row stride: 144 bytes puts
                                           // ldmatrix's eight rows in eight
                                           // different bank quads
constexpr int MMA_STAGES = 3;

constexpr size_t mma_smem_bytes(int qt) {
  return (size_t)MMA_STAGES * (qt + MMA_G) * MMA_LD;
}

// c[16, 8] += a[16, 32 bytes] . b[32 bytes, 8]: bf16 into fp32, or int8
// into int32. The fragments are the same registers of the same bytes.
__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  amma::mma_bf16(c, a, b0, b1);
}

__device__ __forceinline__ void mma_step(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const uint8_t* p) {
  amma::ldsm_x4(r, reinterpret_cast<const __nv_bfloat16*>(p));
}

// A top-2 under `better`, rows distinct: (v1, i1) ahead of (v2, i2).
struct Top2 {
  float v1, v2;
  int i1, i2;
};

__device__ __forceinline__ void top2_insert(Top2& t, float v, int i) {
  if (better(v, i, t.v1, t.i1)) {
    t.v2 = t.v1;
    t.i2 = t.i1;
    t.v1 = v;
    t.i1 = i;
  } else if (better(v, i, t.v2, t.i2)) {
    t.v2 = v;
    t.i2 = i;
  }
}

// the top-2 of the union of two top-2s over disjoint rows
__device__ __forceinline__ Top2 top2_merge(const Top2& a, const Top2& b) {
  Top2 r;
  if (better(b.v1, b.i1, a.v1, a.i1)) {
    r.v1 = b.v1;
    r.i1 = b.i1;
    const bool ab = better(a.v1, a.i1, b.v2, b.i2);
    r.v2 = ab ? a.v1 : b.v2;
    r.i2 = ab ? a.i1 : b.i2;
  } else {
    r.v1 = a.v1;
    r.i1 = a.i1;
    const bool ba = better(b.v1, b.i1, a.v2, a.i2);
    r.v2 = ba ? b.v1 : a.v2;
    r.i2 = ba ? b.i1 : a.i2;
  }
  return r;
}

__device__ __forceinline__ Top2 top2_shfl_xor(const Top2& t, int off) {
  Top2 o;
  o.v1 = __shfl_xor_sync(0xffffffffu, t.v1, off);
  o.v2 = __shfl_xor_sync(0xffffffffu, t.v2, off);
  o.i1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
  o.i2 = __shfl_xor_sync(0xffffffffu, t.i2, off);
  return o;
}

// One stage of the ring: the query tile's k-chunk kc (rows [0, QT), zeros
// past nq) and the group's (rows [QT, QT + 128)), 16 bytes a cp.async.
template <int QT>
__device__ __forceinline__ void mma_load_stage(uint8_t* dst, const uint8_t* q,
                                               const uint8_t* x, int q0,
                                               int nq, int rb, int kc) {
  constexpr int SEGS = MMA_KB / 16;
  for (int i = threadIdx.x; i < (QT + MMA_G) * SEGS; i += MMA_THREADS) {
    const int r = i / SEGS;
    const int c = (i % SEGS) * 16;
    const uint8_t* src;
    bool ok = true;
    if (r < QT) {
      ok = q0 + r < nq;
      src = q + (size_t)(ok ? q0 + r : 0) * rb;
    } else {
      src = x + (size_t)(r - QT) * rb;
    }
    amma::cp_async16(dst + r * MMA_LD + c, src + (size_t)kc * MMA_KB + c, ok);
  }
}

template <typename Acc, int QT>
__global__ void __launch_bounds__(MMA_THREADS, 2)
    candidate_scan_mma_kernel(const uint8_t* __restrict__ queries,
                              const uint8_t* __restrict__ index,
                              float* __restrict__ vals, int* __restrict__ idx,
                              int nq, int N, int rb, int n_valid, int cands) {
  constexpr int WM = QT / 32;              // warps along the queries
  constexpr int WN = 8 / WM;               // warps along the group's rows
  constexpr int NT = MMA_G / WN / 8;       // n-tiles of 8 rows a warp
  constexpr int STAGE = (QT + MMA_G) * MMA_LD;
  static_assert(WM * WN == 8 && NT % 2 == 0, "warp layout");
  extern __shared__ __align__(128) uint8_t smem[];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int n_tiles = (nq + QT - 1) / QT;
  const int q0 = (int)(blockIdx.x % n_tiles) * QT;
  const int g = (int)(blockIdx.x / n_tiles);
  const uint8_t* x = index + (size_t)g * MMA_G * rb;

  Acc acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
    }
  }

  const int nk = rb / MMA_KB;
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < nk) mma_load_stage<QT>(smem + s * STAGE, queries, x, q0, nq, rb, s);
    amma::cp_async_commit();
  }

  // ldmatrix lanes: A rows of a 16-row atom, B rows of a pair of n-tiles
  const int a_row = lane & 15;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kc = 0; kc < nk; ++kc) {
    amma::cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // chunk kc landed; the stage refilled below is free
    const int nxt = kc + MMA_STAGES - 1;
    if (nxt < nk) {
      mma_load_stage<QT>(smem + (nxt % MMA_STAGES) * STAGE, queries, x, q0,
                         nq, rb, nxt);
    }
    amma::cp_async_commit();
    const uint8_t* st = smem + (kc % MMA_STAGES) * STAGE;
    const uint8_t* qs = st + (wm * 32) * MMA_LD;
    const uint8_t* xs = st + (QT + wn * NT * 8) * MMA_LD;
#pragma unroll
    for (int kk = 0; kk < MMA_KB / 32; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        ldsm(a[m], qs + (16 * m + a_row) * MMA_LD + kk * 32 + a_col);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm(b, xs + (16 * np + b_row) * MMA_LD + kk * 32 + b_col);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_step(acc[m][2 * np], a[m], b[0], b[1]);
          mma_step(acc[m][2 * np + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
  amma::cp_async_wait<0>();
  __syncthreads();  // the ring is free: its bytes hold the warps' top-2s

  // red[q][wn]: the top-2 of query q over warp column wn's rows
  Top2* red = reinterpret_cast<Top2*>(smem);
  const int gq = lane >> 2;
  const int t2 = (lane & 3) * 2;
  const int col0 = wn * NT * 8;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Top2 t = {-INFINITY, -INFINITY, 0x7fffffff, 0x7fffffff};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * n + t2 + e;
          const float v = g * MMA_G + col < n_valid
                              ? (float)acc[m][n][2 * h + e]
                              : NEG_INF;
          top2_insert(t, v, col);
        }
      }
      t = top2_merge(t, top2_shfl_xor(t, 1));
      t = top2_merge(t, top2_shfl_xor(t, 2));
      if ((lane & 3) == 0) red[(wm * 32 + 16 * m + 8 * h + gq) * WN + wn] = t;
    }
  }
  __syncthreads();

  const int n_groups = N / MMA_G;
  const int n_cols = cands * n_groups;
  for (int q = threadIdx.x; q < QT; q += MMA_THREADS) {
    if (q0 + q >= nq) break;
    Top2 t = red[q * WN];
#pragma unroll
    for (int w = 1; w < WN; ++w) t = top2_merge(t, red[q * WN + w]);
    // the runner-up is the best row once the winner scores NEG_INF (the
    // reference's knock-out): with only NEG_INF rows left, that may be the
    // winner itself
    if (!better(t.v2, t.i2, NEG_INF, t.i1)) {
      t.v2 = NEG_INF;
      t.i2 = t.i1;
    }
    const size_t o = (size_t)(q0 + q) * n_cols + g;
    vals[o] = t.v1;
    idx[o] = g * MMA_G + t.i1;
    if (cands == 2) {
      vals[o + n_groups] = t.v2;
      idx[o + n_groups] = g * MMA_G + t.i2;
    }
  }
}

template <typename Acc, int QT>
int launch_mma(const void* queries, const void* index, void* vals, void* idx,
               int nq, int N, int rb, int n_valid, int cands,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(QT);
  auto kernel = candidate_scan_mma_kernel<Acc, QT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((nq + QT - 1) / QT) * (N / MMA_G);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, MMA_THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(queries), static_cast<const uint8_t*>(index),
      static_cast<float*>(vals), static_cast<int*>(idx), nq, N, rb, n_valid,
      cands);
  return (int)cudaGetLastError();
}

template <typename Acc>
int dispatch_mma(const void* queries, const void* index, void* vals,
                 void* idx, int nq, int N, int d, int esize, int n_valid,
                 int group, int cands, cudaStream_t stream) {
  const int rb = d * esize;
  if (nq <= 0 || N <= 0 || group != MMA_G || N % MMA_G || rb % MMA_KB ||
      cands < 1 || cands > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (nq <= 64) {
    return launch_mma<Acc, 64>(queries, index, vals, idx, nq, N, rb, n_valid,
                               cands, stream);
  }
  return launch_mma<Acc, 128>(queries, index, vals, idx, nq, N, rb, n_valid,
                              cands, stream);
}

bool bad_args(int nq, int N, int d, int esize, int group, int cands) {
  return nq <= 0 || N <= 0 || group < 32 || group > 256 || group % 32 ||
         N % group || (d * esize) % CHUNK || cands < 1 || cands > 2 ||
         (nq + 7) / 8 > 65535;
}

}  // namespace

// queries [nq, d], index [N, d] (both bf16, or both int8), contiguous,
// 16-byte aligned; vals fp32 / idx int32 [nq, cands * N / group].
// Returns a cudaError_t (0 = launched).
extern "C" int emdr2_candidate_scan_bf16(const void* queries, const void* index,
                                         void* vals, void* idx, int nq, int N,
                                         int d, int n_valid, int group,
                                         int cands, void* stream) {
  if (bad_args(nq, N, d, 2, group, cands)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nq <= 8) {
    return launch<__nv_bfloat16, float, 8>(queries, index, vals, idx, nq, N,
                                           d, n_valid, group, cands, s);
  }
  return launch<__nv_bfloat16, float, 32>(queries, index, vals, idx, nq, N, d,
                                          n_valid, group, cands, s);
}

extern "C" int emdr2_candidate_scan_i8(const void* queries, const void* index,
                                       void* vals, void* idx, int nq, int N,
                                       int d, int n_valid, int group,
                                       int cands, void* stream) {
  if (bad_args(nq, N, d, 1, group, cands)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nq <= 8) {
    return launch<int8_t, int, 8>(queries, index, vals, idx, nq, N, d,
                                  n_valid, group, cands, s);
  }
  return launch<int8_t, int, 32>(queries, index, vals, idx, nq, N, d, n_valid,
                                 group, cands, s);
}

// The tensor-core scan: the same arguments and outputs, group 128 only.
extern "C" int emdr2_candidate_scan_mma_bf16(const void* queries,
                                             const void* index, void* vals,
                                             void* idx, int nq, int N, int d,
                                             int n_valid, int group,
                                             int cands, void* stream) {
  return dispatch_mma<float>(queries, index, vals, idx, nq, N, d, 2, n_valid,
                             group, cands, (cudaStream_t)stream);
}

extern "C" int emdr2_candidate_scan_mma_i8(const void* queries,
                                           const void* index, void* vals,
                                           void* idx, int nq, int N, int d,
                                           int n_valid, int group, int cands,
                                           void* stream) {
  return dispatch_mma<int>(queries, index, vals, idx, nq, N, d, 1, n_valid,
                           group, cands, (cudaStream_t)stream);
}
