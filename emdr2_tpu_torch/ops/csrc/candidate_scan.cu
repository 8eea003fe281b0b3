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
// Two kernels, picked by the wrapper (ops/mips.py:scan_route) by the group,
// the row width, and the number of queries for each type:
//
// 1. The CUDA-core scan (candidate_scan_kernel), for any group of 32-256
//    rows. At nq = 8 it is memory bound, one pass over the index (2.0 GB
//    bf16 or 1.0 GB int8 at 1,310,720 x 768). One block per (group, query
//    tile of 8 or 32); one thread per group row (blockDim = G). The query
//    tile sits in shared memory; the group's rows stream through shared
//    memory in 128-byte column chunks with coalesced 16-byte loads, and each
//    thread accumulates its row's dot with every query of the tile in
//    registers (fmaf, or __dp4a for int8). The per-group top-2 is a block
//    reduction (warp shuffles, then one value per warp). At nq = 512 its
//    scalar dot products bound it.
//
// 2. The tensor-core scan (candidate_scan_tc_kernel), groups of 128 rows.
//    From a few hundred queries the products bound it (2 nq N d operations
//    against one read of N d bytes); below, the read of the index. Between
//    them sit the bytes each block stages from L2 into shared memory for
//    its products: a block that stages both a query tile and a group for
//    every (query tile, group) pair spends most of its time on those
//    loads. So:
//    - A persistent block keeps its query tile (64 queries; 128 for int8
//      above 128 queries) resident in shared memory and walks a contiguous
//      run of groups; blocks with other query tiles walk the same runs at
//      the same time, so each group comes from device memory once and from
//      L2 for the others. The (query tile, run) items are cut so that the
//      rounds of them over the resident blocks waste the least.
//      (Clusters that share each stage by TMA multicast measured slower
//      than single blocks on the H100, PERF.md section 6.)
//    - Products by wgmma (bf16 m64n128k16 into fp32, int8 m64n128k32 into
//      int32, both operands K-major in swizzled shared memory): a
//      warpgroup's accumulators hold 64 queries x the group's 128 rows,
//      each thread 2 queries x 32 rows, so the per-group top-2 is 32
//      inserts a query and two quad shuffles, with no shared memory.
//    - One producer thread fills a ring of 128-row x 128-byte stages by
//      TMA (tensor maps with the 128-byte swizzle wgmma reads, mbarriers
//      counting the bytes); two consumer warpgroups take the groups in
//      turn, the turn handed over by named barriers as soon as a
//      warpgroup has issued its group's products, so one warpgroup's
//      branch-free top-2 runs under the other's products.
//    - No atomics: each (query, group) is written by one thread, and two
//      launches are bit-equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tma.cuh"

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

// A top-2 under `better`, rows distinct: (v1, i1) ahead of (v2, i2).
struct Top2 {
  float v1, v2;
  int i1, i2;
};

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

constexpr int TC_G = 128;                 // rows a group: the products' N
constexpr int TC_CONSUMERS = 2;           // warpgroups that take groups in turn
constexpr int TC_THREADS = 128 * (TC_CONSUMERS + 1);   // + the producer's
constexpr int TC_PRODUCER_REGS = 40;      // registers a thread after the
constexpr int TC_CONSUMER_REGS = 232;     // split (setmaxnreg)
constexpr int TC_KB = 128;                // bytes of a row a tile holds
constexpr int TC_STAGE = TC_G * TC_KB;    // bytes of a ring stage
constexpr int TC_MAX_STAGES = 16;
constexpr int TC_SMEM_LIMIT = 232448;     // dynamic shared memory of a block

// Shared memory of a block: the resident query tile, `stages` ring stages,
// their full and empty mbarriers and the query tile's two, and the slack
// that aligns the tiles to 1024 bytes.
constexpr int tc_smem_bytes(int qt, int rb, int stages) {
  return qt * rb + stages * TC_STAGE + (2 * stages + 2) * 8 + 1024;
}

// The ring stages that fit beside the resident query tile.
constexpr int tc_stages(int qt, int rb) {
  return std::min(TC_MAX_STAGES,
                  (TC_SMEM_LIMIT - tc_smem_bytes(qt, rb, 0)) / (TC_STAGE + 16));
}

// Matrix descriptor of a K-major tile in shared memory under the 128-byte
// swizzle (128-byte rows, 8-row groups 1024 bytes apart), starting at `p`
// (a k-step of 32 bytes into a row advances p by 32).
__device__ __forceinline__ uint64_t tc_desc(const void* p) {
  uint64_t d = (uint64_t)((tma::smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;                       // leading offset: unused
  d |= (uint64_t)(1024 >> 4) << 32;             // stride offset
  d |= (uint64_t)1 << 62;                       // 128-byte swizzle
  return d;
}

#define TC_ACC(c, d)                                                        \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),   \
  c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),       \
  c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),     \
  c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),     \
  c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]),     \
  c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),     \
  c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),     \
  c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),     \
  c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])

#define TC_REGS                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 queries, 128 rows] (+)= A[64, 32 bytes] . B[128, 32 bytes]^T, both
// K-major in shared memory (descriptors); scale_d = 0 starts the sum anew.
// bf16 into fp32, or int8 into int32 (exact, like mma.sync and __dp4a).
__device__ __forceinline__ void tc_mma(float (&d)[64], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TC_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : TC_ACC("+f", d)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tc_mma(int (&d)[64], uint64_t da, uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " TC_REGS
      ", %64, %65, p;\n"
      "}\n"
      : TC_ACC("+r", d)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef TC_REGS
#undef TC_ACC

// Pin the accumulators around the asynchronous products: the compiler may
// not move a read or a copy of them across these points.
__device__ __forceinline__ void tc_fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void tc_fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void tc_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void tc_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void tc_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 hand the products' turn between the two consumer
// warpgroups (barrier 0 is __syncthreads').
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * TC_CONSUMERS)
               : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(128 * TC_CONSUMERS)
               : "memory");
}

// The items of the walk: query tile qt by slice of the groups; block b
// takes items b, b + blocks, ... Each item's groups are [g0, g1), empty when
// there are more slices than groups.
struct TcItem {
  int qt, g0, g1;
};

__device__ __forceinline__ TcItem tc_item(int it, int tiles, int slices,
                                          int n_groups) {
  const int slice = it / tiles;
  return {it % tiles, (int)((long long)slice * n_groups / slices),
          (int)((long long)(slice + 1) * n_groups / slices)};
}

// The top-2 of one query row over the 32 columns a thread holds (its lane
// adds t2), taken in increasing column order, so a strict > keeps the lower
// column on ties; selects, not branches. Columns at or past `live` score
// NEG_INF (MASKED: the group holds rows past n_valid).
template <bool MASKED, typename Acc>
__device__ __forceinline__ Top2 tc_row_top2(const Acc (&d)[64], int h,
                                            int live) {
  float v1 = -INFINITY, v2 = -INFINITY;
  int i1 = 0, i2 = 0;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + e;
      float v = (float)d[4 * n + 2 * h + e];
      if (MASKED) v = col < live ? v : NEG_INF;
      const bool p1 = v > v1;
      const bool p2 = v > v2;
      v2 = p1 ? v1 : (p2 ? v : v2);
      i2 = p1 ? i1 : (p2 ? col : i2);
      v1 = p1 ? v : v1;
      i1 = p1 ? col : i1;
    }
  }
  return {v1, v2, i1, i2};
}

// A position in the ring's sequence of stages: the stage index c, its slot
// and the parity of its slot's phase, moved forward without a division.
struct RingPos {
  int c, slot, phase;
  __device__ __forceinline__ void advance(int k, int stages) {
    c += k;
    slot += k;
    while (slot >= stages) {
      slot -= stages;
      phase ^= 1;
    }
  }
};

// One block: a producer warpgroup (one thread of it) that fills the ring by
// TMA, with its registers given to the two consumer warpgroups, which take
// the item's groups in turn (even, odd), each running the products of all
// its group's stages against the resident query tile and then, while the
// other warpgroup's products run, the group's top-2.
template <typename T, typename Acc, int MA>
__global__ void __launch_bounds__(TC_THREADS, 1)
    candidate_scan_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap xmap,
                             float* __restrict__ vals, int* __restrict__ idx,
                             int nq, int n_groups, int rb, int n_valid,
                             int cands, int tiles, int slices, int stages) {
  constexpr int QT = 64 * MA;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* qs = smem;                      // [rb / 128][QT][128], swizzled
  uint8_t* ring = qs + QT * rb;            // [stages][128][128], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * TC_STAGE);
  uint64_t* empty = full + stages;
  uint64_t* qfull = empty + stages;        // the query tile landed
  uint64_t* qfree = qfull + 1;             // ... and is no longer read

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int items = tiles * slices;
  const int kc_n = rb / TC_KB;             // ring stages a group

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tma::mbar_init(full + s, 1);
      tma::mbar_init(empty + s, 1);
    }
    tma::mbar_init(qfull, 1);
    tma::mbar_init(qfree, TC_CONSUMERS);
    tma::fence_mbar_init();
  }
  __syncthreads();

  if (warp / 4 == TC_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        TC_PRODUCER_REGS));
    if (warp == 4 * TC_CONSUMERS && lane == 0) {
      RingPos p = {0, 0, 0};
      int loaded = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const TcItem w = tc_item(it, tiles, slices, n_groups);
        if (w.g1 <= w.g0) continue;
        if (loaded > 0) tma::mbar_wait(qfree, (loaded - 1) & 1);
        tma::mbar_expect(qfull, QT * rb);
        for (int kq = 0; kq < rb / TC_KB; ++kq) {
          tma::tma_load_2d(qs + kq * QT * TC_KB, &qmap, kq * TC_KB, w.qt * QT,
                           qfull);
        }
        ++loaded;
        for (int g = w.g0; g < w.g1; ++g) {
          for (int kc = 0; kc < kc_n; ++kc, p.advance(1, stages)) {
            tma::mbar_wait(empty + p.slot, p.phase ^ 1);
            tma::mbar_expect(full + p.slot, TC_STAGE);
            tma::tma_load_2d(ring + p.slot * TC_STAGE, &xmap, kc * TC_KB,
                             g * TC_G, full + p.slot);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        TC_CONSUMER_REGS));
    const int wg = warp / 4;               // consumer warpgroup 0 or 1
    const bool signals = threadIdx.x % 128 == 0;
    const int n_cols = cands * n_groups;
    const int t2 = (lane & 3) * 2;
    Acc acc[MA][64];
    int n = 0, loaded = 0;
    RingPos p = {0, 0, 0};
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const TcItem w = tc_item(it, tiles, slices, n_groups);
      if (w.g1 <= w.g0) continue;
      tma::mbar_wait(qfull, loaded & 1);
      ++loaded;
      for (int j = wg; w.g0 + j < w.g1; j += 2) {
        p.advance(n + j * kc_n - p.c, stages);   // this group's first stage
        if (j > 0) turn_wait(1 + wg);
        int held = 0;                        // the slot read last
        for (int kc = 0; kc < kc_n; ++kc, p.advance(1, stages)) {
          tma::mbar_wait(full + p.slot, p.phase);
          const uint8_t* st = ring + p.slot * TC_STAGE;
#pragma unroll
          for (int m = 0; m < MA; ++m) tc_fence_regs(acc[m]);
          tc_wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < TC_KB / 32; ++ks) {
            // k-step ks of stage kc is bytes [32 ks, 32 ks + 32) of query
            // chunk kc
            const uint64_t db = tc_desc(st + ks * 32);
            const uint8_t* qa = qs + kc * QT * TC_KB + ks * 32;
#pragma unroll
            for (int m = 0; m < MA; ++m) {
              tc_mma(acc[m], tc_desc(qa + m * 64 * TC_KB), db,
                     kc > 0 || ks > 0 ? 1 : 0);
            }
          }
          tc_commit();
#pragma unroll
          for (int m = 0; m < MA; ++m) tc_fence_regs(acc[m]);
          if (kc > 0) {
            tc_wait<1>();                   // the stage before has been read
            if (signals) tma::mbar_arrive(empty + held);
          }
          held = p.slot;
        }
        // the other warpgroup's products start while these finish and
        // while this one takes the top-2
        if (w.g0 + j + 1 < w.g1) turn_pass(2 - wg);
        tc_wait<0>();
#pragma unroll
        for (int m = 0; m < MA; ++m) tc_fence_regs(acc[m]);
        if (signals) tma::mbar_arrive(empty + held);

        const int g = w.g0 + j;
        const int row0 = g * TC_G;
        const bool whole = row0 + TC_G <= n_valid;
        const int live = n_valid - row0 - t2;   // columns of this lane
#pragma unroll
        for (int m = 0; m < MA; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            Top2 t = whole ? tc_row_top2<false>(acc[m], h, live)
                           : tc_row_top2<true>(acc[m], h, live);
            t.i1 += t2;
            t.i2 += t2;
            t = top2_merge(t, top2_shfl_xor(t, 1));
            t = top2_merge(t, top2_shfl_xor(t, 2));
            // the runner-up is the best row once the winner scores NEG_INF
            // (the reference's knock-out): with only NEG_INF rows left,
            // that may be the winner itself
            if (!better(t.v2, t.i2, NEG_INF, t.i1)) {
              t.v2 = NEG_INF;
              t.i2 = t.i1;
            }
            const int q = w.qt * QT + 64 * m + 16 * (warp % 4) + 8 * h +
                          (lane >> 2);
            if ((lane & 3) == 0 && q < nq) {
              const size_t o = (size_t)q * n_cols + g;
              vals[o] = t.v1;
              idx[o] = row0 + t.i1;
              if (cands == 2) {
                vals[o + n_groups] = t.v2;
                idx[o + n_groups] = row0 + t.i2;
              }
            }
          }
        }
      }
      n += (w.g1 - w.g0) * kc_n;
      if (signals) tma::mbar_arrive(qfree);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled load_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                       cudaEnableDefault, &found) !=
      cudaSuccess) {
    return nullptr;
  }
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                              cudaEnableDefault, &found) != cudaSuccess) {
    return nullptr;
  }
#endif
  return found == cudaDriverEntryPointSuccess ? (EncodeTiled)fn : nullptr;
}

// A [rows, rb] byte matrix, row-major, cut into boxes of box_rows rows by
// 128 bytes under the 128-byte swizzle; rows past the end arrive as zeros.
bool make_map(CUtensorMap* map, const void* base, int rows, int rb,
              int box_rows) {
  static const EncodeTiled encode = load_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)rb, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)rb};
  const cuuint32_t box[2] = {(cuuint32_t)TC_KB, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How many slices of the groups each query tile is cut into: the items
// (query tile, slice) are dealt to the resident blocks in rounds, so the
// walk takes rounds / slices of the groups' time; the fewest slices within
// 1% of the least such time (each slice a block walks costs it a reload of
// its query tile).
int slices_per_tile(int tiles, int n_groups, int blocks) {
  const int most = std::max(1, std::min(n_groups, 8 * blocks));
  auto cost = [&](int k) {
    return (double)((tiles * k + blocks - 1) / blocks) / k;
  };
  double best = cost(1);
  for (int k = 2; k <= most; ++k) best = std::min(best, cost(k));
  int k = 1;
  while (cost(k) > 1.01 * best) ++k;
  return k;
}

template <typename T, typename Acc, int MA>
int launch_tc(const void* queries, const void* index, void* vals, void* idx,
              int nq, int N, int rb, int n_valid, int cands,
              cudaStream_t stream) {
  constexpr int QT = 64 * MA;
  auto kernel = candidate_scan_tc_kernel<T, Acc, MA>;
  const int stages = tc_stages(QT, rb);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = tc_smem_bytes(QT, rb, stages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        TC_THREADS, smem);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;

  CUtensorMap qmap, xmap;
  if (!make_map(&qmap, queries, nq, rb, QT) ||
      !make_map(&xmap, index, N, rb, TC_G)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_groups = N / TC_G;
  const int tiles = (nq + QT - 1) / QT;
  const int slices = slices_per_tile(tiles, n_groups, per_sm * sms);
  const int blocks = std::min(per_sm * sms, tiles * slices);
  kernel<<<blocks, TC_THREADS, smem, stream>>>(
      qmap, xmap, static_cast<float*>(vals), static_cast<int*>(idx), nq,
      n_groups, rb, n_valid, cands, tiles, slices, stages);
  return (int)cudaGetLastError();
}

// 64 queries a block; int8 above 128 queries takes 128, which halves the
// bytes a product needs from L2 (bf16's 128 resident queries would leave a
// ring of two stages).
template <typename T, typename Acc>
int dispatch_tc(const void* queries, const void* index, void* vals, void* idx,
                int nq, int N, int d, int n_valid, int group, int cands,
                cudaStream_t stream) {
  const int rb = d * (int)sizeof(T);
  if (nq <= 0 || N <= 0 || group != TC_G || N % TC_G || rb % TC_KB ||
      cands < 1 || cands > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (sizeof(T) == 1) {
    if (nq > 128 && tc_stages(128, rb) >= 2) {
      return launch_tc<T, Acc, 2>(queries, index, vals, idx, nq, N, rb,
                                  n_valid, cands, stream);
    }
  }
  return launch_tc<T, Acc, 1>(queries, index, vals, idx, nq, N, rb, n_valid,
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
extern "C" int emdr2_candidate_scan_tc_bf16(const void* queries,
                                            const void* index, void* vals,
                                            void* idx, int nq, int N, int d,
                                            int n_valid, int group, int cands,
                                            void* stream) {
  return dispatch_tc<__nv_bfloat16, float>(queries, index, vals, idx, nq, N,
                                           d, n_valid, group, cands,
                                           (cudaStream_t)stream);
}

extern "C" int emdr2_candidate_scan_tc_i8(const void* queries,
                                          const void* index, void* vals,
                                          void* idx, int nq, int N, int d,
                                          int n_valid, int group, int cands,
                                          void* stream) {
  return dispatch_tc<int8_t, int>(queries, index, vals, idx, nq, N, d,
                                  n_valid, group, cands,
                                  (cudaStream_t)stream);
}

// What the compiler made of each kernel, KERNEL_INFO ints a kernel into
// `out` (at most `cap` kernels): type (0 bf16, 1 int8), route (0 CUDA-core,
// 1 tensor-core), queries a block, registers a thread, static shared bytes,
// local (spilled) bytes a thread, the dynamic shared bytes it launches with
// at d = 768, the ring's stages there (0: none). Returns the number of
// kernels, or minus a cudaError_t.
namespace {

constexpr int KERNEL_INFO = 8;

struct KernelRow {
  const void* fn;
  int type, route, tile, smem, stages;
};

template <typename T, typename Acc, int QT>
KernelRow core_row() {
  const int qbytes = 768 * (int)sizeof(T);
  return {(const void*)candidate_scan_kernel<T, Acc, QT>, sizeof(T) == 1, 0,
          QT, QT * qbytes + TC_G * RSTRIDE + QT * (TC_G / 32) * 8 + QT * 4,
          0};
}

template <typename T, typename Acc, int MA>
KernelRow tc_row() {
  const int rb = 768 * (int)sizeof(T);
  const int stages = tc_stages(64 * MA, rb);
  return {(const void*)candidate_scan_tc_kernel<T, Acc, MA>, sizeof(T) == 1,
          1, 64 * MA, tc_smem_bytes(64 * MA, rb, stages), stages};
}

}  // namespace

extern "C" int emdr2_candidate_scan_kernels(int* out, int cap) {
  const KernelRow rows[] = {
      core_row<__nv_bfloat16, float, 8>(),
      core_row<__nv_bfloat16, float, 32>(),
      core_row<int8_t, int, 8>(),
      core_row<int8_t, int, 32>(),
      tc_row<__nv_bfloat16, float, 1>(),
      tc_row<int8_t, int, 1>(),
      tc_row<int8_t, int, 2>(),
  };
  const int n = (int)(sizeof(rows) / sizeof(rows[0]));
  for (int i = 0; i < n && i < cap; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, rows[i].fn);
    if (err != cudaSuccess) return -(int)err;
    int* o = out + i * KERNEL_INFO;
    o[0] = rows[i].type;
    o[1] = rows[i].route;
    o[2] = rows[i].tile;
    o[3] = a.numRegs;
    o[4] = (int)a.sharedSizeBytes;
    o[5] = (int)a.localSizeBytes;
    o[6] = rows[i].smem;
    o[7] = rows[i].stages;
  }
  return n;
}
