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
// exactly in int32 (__dp4a) and is cast to fp32, which is lossless because
// |dot| <= 768 * 127^2 < 2^24. Group and query scales of the int8 index are
// applied outside, to the winners only.
//
// What bounds it on the H100: at serving batch (nq = 8) it is memory bound,
// one pass over the index (2.0 GB bf16 or 1.0 GB int8 at 1,310,720 x 768);
// at nq = 512 the CUDA-core dot products bound it.
//
// Design: one block per (group, query tile); one thread per group row
// (blockDim = G). The query tile sits in shared memory; the group's rows
// stream through shared memory in 128-byte column chunks with coalesced
// 16-byte loads, so each index byte is read once per query tile, and each
// thread accumulates its row's dot with every query of the tile in
// registers. The per-group top-2 is a block reduction (warp shuffles, then
// one value per warp). Later work: tensor-core scoring and several groups
// per block to amortize the reductions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
