// Hidden dropout and its residual add in one pass, Hopper.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's
// PackedDropout (emdr2_tpu/models/layers.py) with the residual add around
// it. In eager PyTorch the same rule (ops/hashing.py:packed_dropout) is
// some twenty separate passes over int32 hash tensors a site, plus a saved
// one-byte mask; this kernel is the one pass that the work needs.
//
//   out = [r +] (keep ? bf16(y * scale) : 0)
//   keep = murmur_fin(seed ^ (i0+row_offset)*P0 ^ (i1+head_offset)*P1
//                     ^ i2*P2 ^ i3*P3) >= threshold
// over a contiguous tensor of rank 1 to 4 (coordinates of the axes it has;
// an offset belongs to axis 0 and axis 1 whatever the rank), in wrapping
// uint32 arithmetic, with P the MIX_PRIMES of hashing.py and threshold =
// round(rate * 2^32). scale is 2^32 / (2^32 - threshold) rounded to the
// tensor's dtype by the caller, exactly as packed_dropout rounds it, and
// every product and sum is rounded to the dtype where the plain path
// rounds it (the product, then the sum; never fused): the output is the
// plain path's bits. The backward of the dropout is the same pass over the
// incoming gradient without a residual (dy = keep ? bf16(g * scale) : 0;
// the residual's gradient is g itself), so nothing of a site is saved but
// its scalars: the mask is hashed again from the coordinates.
//
// What bounds it on the H100: bytes. 6 bytes an element forward with a
// residual in bf16 (read y and r, write out), 4 without and 4 backward,
// against ~15 integer operations of hashing. At [400, 512, 768] with a
// residual that is 944 MB, 0.282 ms at 3.35 TB/s.
//
// Design: one kernel; each thread takes one 16-byte vector's worth of the
// flat tensor (8 bf16 or 4 fp32 values), y's and r's loads issued before
// any hashing. The vector's first element gives its row term (seed ^ the
// lead axes' terms) from one division of its flat index; each element
// then adds only col * P_last and the finaliser. A vector that runs into
// the next row (a ragged last axis) takes a second loop that makes that
// row's term when it gets there: kept out of the common loop, whose
// per-element test cost 12-16% where the hashing's integer work is close
// to the bytes' time (no residual, the backward). The loads and the store
// are one 16-byte access each when the pointers sit on 16 bytes; the
// tensor's last partial vector, and every vector of a tensor off 16
// bytes, goes element by element under a mask. Flat indices are 64-bit;
// each axis is below 2^31. Timed on an H100 (700 W): two vectors a
// thread, 128 or 512 threads a block, evict-first loads or stores were no
// faster (0-5% slower); at [400, 512, 768] the kernel takes 0.321 ms with
// the residual (88% of the bound; torch.add(y, r), the same bytes, takes
// 0.308) and 0.214-0.217 without (87%).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hashing.cuh"

namespace {

constexpr int THREADS = 256;

constexpr uint32_t PRIMES[4] = {0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du,
                                0x27D4EB2Fu};

// The hashing rule of one tensor. The lead axes (all but the last) sit in
// three slots, right-aligned: slot 2 is axis rank-2, slot 1 axis rank-3,
// slot 0 axis rank-4; an absent axis has extent 1 and mul = add = 0.
// A term is c * mul + add, which is (c + offset) * P in uint32.
struct Plan {
  uint64_t n_elem;
  uint32_t n;            // the last axis
  uint32_t e1, e2;       // extents of slots 1 and 2
  uint32_t mul[3], add[3];
  uint32_t col_mul, col_add;
  uint32_t seed, threshold;
  float scale;
  bool aligned;          // y, r and out on 16 bytes: vector accesses
};

__device__ __forceinline__ uint64_t div64(uint64_t x, uint32_t d) {
  return (x >> 32) ? x / d : (uint64_t)((uint32_t)x / d);
}

// seed ^ the lead axes' terms of flat row `row`
__device__ __forceinline__ uint32_t row_term(const Plan& p, uint64_t row) {
  const uint64_t t = div64(row, p.e2);
  const uint32_t c2 = (uint32_t)(row - t * p.e2);
  const uint64_t c0 = div64(t, p.e1);
  const uint32_t c1 = (uint32_t)(t - c0 * p.e1);
  return p.seed ^ ((uint32_t)c0 * p.mul[0] + p.add[0])
         ^ (c1 * p.mul[1] + p.add[1]) ^ (c2 * p.mul[2] + p.add[2]);
}

__device__ __forceinline__ bool keep_bit(const Plan& p, uint32_t row_h,
                                         uint32_t col) {
  return murmur_fin(row_h ^ (col * p.col_mul + p.col_add)) >= p.threshold;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_float(float x) { return x; }

// [r +] (keep ? T(y * scale) : 0), each step rounded to T
template <typename T, bool RESID>
__device__ __forceinline__ T drop_one(T y, T r, bool keep, float scale) {
  const float d = keep ? to_float(from_float<T>(__fmul_rn(to_float(y), scale)))
                       : 0.0f;
  return from_float<T>(RESID ? __fadd_rn(to_float(r), d) : d);
}

// The elements [v * VEC, v * VEC + VEC) of the flat tensor, v this
// thread's index; those past the end are neither read nor written.
template <typename T, bool RESID>
__global__ void __launch_bounds__(THREADS)
    dropout_add_kernel(const T* __restrict__ y, const T* __restrict__ r,
                       T* __restrict__ out, Plan p) {
  constexpr int VEC = 16 / sizeof(T);
  const uint64_t e =
      ((uint64_t)blockIdx.x * THREADS + threadIdx.x) * (uint64_t)VEC;
  if (e >= p.n_elem) return;
  const bool whole = p.aligned && e + VEC <= p.n_elem;
  const uint64_t left = p.n_elem - e;
  const int valid = left < (uint64_t)VEC ? (int)left : VEC;
  uint4 yv = make_uint4(0u, 0u, 0u, 0u), rv = yv, ov;
  T* ys = reinterpret_cast<T*>(&yv);
  T* rs = reinterpret_cast<T*>(&rv);
  T* os = reinterpret_cast<T*>(&ov);
  if (whole) {
    yv = reinterpret_cast<const uint4*>(y + e)[0];
    if (RESID) rv = reinterpret_cast<const uint4*>(r + e)[0];
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (j < valid) {
        ys[j] = y[e + j];
        if (RESID) rs[j] = r[e + j];
      }
    }
  }
  uint64_t row = div64(e, p.n);
  uint32_t col = (uint32_t)(e - row * p.n);
  uint32_t row_h = row_term(p, row);
  if (col + VEC <= p.n) {           // the vector lies in one row
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      os[j] = drop_one<T, RESID>(ys[j], rs[j], keep_bit(p, row_h, col + j),
                                 p.scale);
  } else {                          // it runs into the next row
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (col == p.n) {
        col = 0u;
        row_h = row_term(p, ++row);
      }
      os[j] = drop_one<T, RESID>(ys[j], rs[j], keep_bit(p, row_h, col),
                                 p.scale);
      ++col;
    }
  }
  if (whole) {
    reinterpret_cast<uint4*>(out + e)[0] = ov;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < valid) out[e + j] = os[j];
  }
}

// The plan of a tensor of `rank` axes: lead extents e1, e2 (right-aligned
// slots), last axis n; offsets on axis 0 and axis 1.
Plan make_plan(long long n_elem, int rank, int e1, int e2, int n,
               unsigned row_offset, unsigned head_offset, unsigned seed,
               unsigned threshold, float scale) {
  Plan p;
  p.n_elem = (uint64_t)n_elem;
  p.n = (uint32_t)n;
  p.e1 = (uint32_t)e1;
  p.e2 = (uint32_t)e2;
  const uint32_t offsets[4] = {row_offset, head_offset, 0u, 0u};
  for (int s = 0; s < 3; ++s) {
    const int axis = rank - 4 + s;
    p.mul[s] = axis >= 0 ? PRIMES[axis] : 0u;
    p.add[s] = axis >= 0 ? offsets[axis] * PRIMES[axis] : 0u;
  }
  p.col_mul = PRIMES[rank - 1];
  p.col_add = offsets[rank - 1] * PRIMES[rank - 1];
  p.seed = seed;
  p.threshold = threshold;
  p.scale = scale;
  return p;
}

template <typename T>
int launch(const void* y, const void* r, void* out, long long n_elem,
           int rank, int e1, int e2, int n, unsigned row_offset,
           unsigned head_offset, unsigned seed, unsigned threshold,
           float scale, cudaStream_t stream) {
  if (n_elem <= 0 || rank < 1 || rank > 4 || n < 1 || e1 < 1 || e2 < 1 ||
      n_elem % n != 0 || threshold == 0u)
    return (int)cudaErrorInvalidValue;
  Plan p = make_plan(n_elem, rank, e1, e2, n, row_offset, head_offset,
                     seed, threshold, scale);
  p.aligned = ((uintptr_t)y | (uintptr_t)out | (uintptr_t)(r ? r : out)) %
                  16 == 0;
  constexpr int VEC = 16 / sizeof(T);
  const uint64_t blocks =
      ((uint64_t)n_elem + (uint64_t)VEC * THREADS - 1) / (VEC * THREADS);
  if (blocks > 0x7FFFFFFFull) return (int)cudaErrorInvalidValue;
  const T* yt = static_cast<const T*>(y);
  const T* rt = static_cast<const T*>(r);
  T* ot = static_cast<T*>(out);
  if (r)
    dropout_add_kernel<T, true><<<(unsigned)blocks, THREADS, 0, stream>>>(
        yt, rt, ot, p);
  else
    dropout_add_kernel<T, false><<<(unsigned)blocks, THREADS, 0, stream>>>(
        yt, rt, ot, p);
  return (int)cudaGetLastError();
}

}  // namespace

// y, r (null: no residual), out: contiguous, n_elem elements of `rank`
// axes; e1, e2 the extents of axes rank-3 and rank-2 (1 where absent), n
// the last axis; offsets, seed and threshold as uint32; scale rounded to
// the dtype. Returns the launch's cudaError_t.
extern "C" int emdr2_dropout_add_bf16(const void* y, const void* r, void* out,
                                      long long n_elem, int rank, int e1,
                                      int e2, int n, unsigned row_offset,
                                      unsigned head_offset, unsigned seed,
                                      unsigned threshold, float scale,
                                      void* stream) {
  return launch<__nv_bfloat16>(y, r, out, n_elem, rank, e1, e2, n,
                               row_offset, head_offset, seed, threshold,
                               scale, (cudaStream_t)stream);
}

extern "C" int emdr2_dropout_add_f32(const void* y, const void* r, void* out,
                                     long long n_elem, int rank, int e1,
                                     int e2, int n, unsigned row_offset,
                                     unsigned head_offset, unsigned seed,
                                     unsigned threshold, float scale,
                                     void* stream) {
  return launch<float>(y, r, out, n_elem, rank, e1, e2, n, row_offset,
                       head_offset, seed, threshold, scale,
                       (cudaStream_t)stream);
}
