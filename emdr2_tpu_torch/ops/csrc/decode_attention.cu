// Decode cross-attention over int8-stored K/V with per-row scales, Hopper.
//
// Replaces: emdr2_tpu/ops/decode_attention.py:_int8_kernel, launched by
// decode_cross_attention_int8. For each example b and head h, the R query
// rows of a decode step (R = beams x new tokens, 1..8 a launch) attend over
// the Lk encoder keys stored as int8 rows k8, v8 [B, nh, Lk, hd] with fp32
// row scales kscale, vscale [B, nh, Lk] and the key-side bias [B, Lk]:
//   s = (q . k8^T) * (hd^-0.5 * kscale) + bias
//   out = sum_k softmax(s)_k * vscale_k * v8_k      (0 where l == 0)
// Dequantization acts on the scores and on the probabilities, never on the
// slab.
//
// What bounds it on the H100: bytes. A launch reads the whole slab once
// (2 * B*nh*Lk*hd bytes of int8, 2 * B*nh*Lk*4 of scales) for 4*R*hd FLOP
// per key; with R <= 8 the tensor cores buy nothing (and q is bf16, so
// __dp4a does not apply): int8 is converted in registers and multiplied in
// fp32.
//
// Design: the TPU grid (B*nh programs, each walking the key chunks in
// order) would give 96 blocks for 132 SMs; here the keys are split over
// blocks from the start. One block per (split of SPLIT keys, head, example):
//   1. scores, one thread per key and four keys a thread: a key's 64-byte
//      row is read with four 16-byte loads, dotted with the R query rows
//      held in shared memory as fp32 (each query value read serves the
//      thread's four keys), scaled and biased; the scores go to shared
//      memory;
//   2. the block's max m and sum l of p = exp(s - m) per query row, and
//      p * vscale back into shared memory (fp32: the TPU kernel rounds this
//      product to bf16, so the two differ by that rounding);
//   3. p.v, eight threads per key row (8-byte loads of int8), sixteen key
//      rows in flight a pass, fp32 accumulators in registers reduced over
//      the block through shuffles and shared memory;
// and writes the partial (acc[R, hd], m, l) in fp32. A second small kernel
// per (head, example) combines the splits in split order: global max,
// rescale, sum, divide. No atomics: the result repeats bit for bit.
// Padded keys carry k8 = v8 = 0, scale 1 and bias -1e9 and get weight
// exp(-1e9 - m) = 0; keys past Lk in the last split are skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr int SPLIT = 512;          // keys per block
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KPT = SPLIT / THREADS;  // keys per thread in the score pass
constexpr int MAX_R = 8;
constexpr int PART = HD + 2;        // acc[hd], m, l per (split, row)

__device__ __forceinline__ void unpack4(uint32_t w, float (&f)[4]) {
  f[0] = (float)(int8_t)(w & 0xffu);
  f[1] = (float)(int8_t)((w >> 8) & 0xffu);
  f[2] = (float)(int8_t)((w >> 16) & 0xffu);
  f[3] = (float)(int8_t)(w >> 24);
}

template <int R>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ k8,
                    const float* __restrict__ kscale,
                    const int8_t* __restrict__ v8,
                    const float* __restrict__ vscale,
                    const float* __restrict__ kv_bias,
                    float* __restrict__ part, int R_total, int r0, int nh,
                    int Lk, int n_splits, float scale) {
  __shared__ __align__(16) float Qs[R][HD];
  __shared__ float Ss[R][SPLIT];            // scores, then p * vscale
  __shared__ float red[WARPS][R];
  __shared__ __align__(16) float Acc[WARPS][R][HD];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const size_t bh = (size_t)b * nh + h;
  const int k0 = split * SPLIT;
  const int n_keys = min(SPLIT, Lk - k0);

  for (int i = t; i < R * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    Qs[r][d] = __bfloat162float(
        q[(((size_t)b * R_total + r0 + r) * nh + h) * HD + d]);
  }
  __syncthreads();

  // ---- 1. scores: one thread per key, KPT keys a thread; the query
  // values read from shared memory serve all of a thread's keys ----
  float dot[KPT][R];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) dot[i][r] = 0.0f;
#pragma unroll 1
  for (int c = 0; c < HD / 16; ++c) {
    uint4 w[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kk = t + i * THREADS;
      w[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kk < n_keys) {
        w[i] = reinterpret_cast<const uint4*>(
            k8 + (bh * Lk + k0 + kk) * HD)[c];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float kf[KPT][4];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const uint32_t word = j == 0 ? w[i].x : j == 1 ? w[i].y
                              : j == 2 ? w[i].z : w[i].w;
        unpack4(word, kf[i]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[r][c * 16 + j * 4]);
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          dot[i][r] = fmaf(kf[i][0], qv.x, dot[i][r]);
          dot[i][r] = fmaf(kf[i][1], qv.y, dot[i][r]);
          dot[i][r] = fmaf(kf[i][2], qv.z, dot[i][r]);
          dot[i][r] = fmaf(kf[i][3], qv.w, dot[i][r]);
        }
      }
    }
  }
  float mloc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mloc[r] = -INFINITY;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int kk = t + i * THREADS;
    float ks = 0.0f, bias = -INFINITY;      // keys past Lk: no weight
    if (kk < n_keys) {
      ks = kscale[bh * Lk + k0 + kk] * scale;
      bias = kv_bias[(size_t)b * Lk + k0 + kk];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s = dot[i][r] * ks + bias;
      mloc[r] = fmaxf(mloc[r], s);
      Ss[r][kk] = s;
    }
  }

  // ---- 2. block max, p, block sum, p * vscale ----
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float m = mloc[r];
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[warp][r] = m;
  }
  __syncthreads();
  float mrow[R], lloc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float m = red[0][r];
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w][r]);
    mrow[r] = m;
    lloc[r] = 0.0f;
  }
  __syncthreads();                          // red is reused for the sums
  for (int kk = t; kk < n_keys; kk += THREADS) {
    const float vs = vscale[bh * Lk + k0 + kk];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = expf(Ss[r][kk] - mrow[r]);   // own element: no sync
      lloc[r] += p;
      Ss[r][kk] = p * vs;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float l = lloc[r];
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) red[warp][r] = l;
  }
  __syncthreads();                          // Ss and red complete

  // ---- 3. p.v: 8 threads a key row (8 bytes each), 16 rows a pass ----
  const int c8 = t % 8;                     // columns [8*c8, 8*c8 + 8)
  const int kg = t / 8;
  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.0f;
#pragma unroll 4
  for (int kk = kg; kk < n_keys; kk += THREADS / 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        v8 + (bh * Lk + k0 + kk) * HD + c8 * 8);
    float lo[4], hi[4];
    unpack4(w.x, lo);
    unpack4(w.y, hi);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = Ss[r][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[r][i] = fmaf(p, lo[i], acc[r][i]);
        acc[r][4 + i] = fmaf(p, hi[i], acc[r][4 + i]);
      }
    }
  }
  // the four key groups of a warp (lanes differing in bits 3 and 4)
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float a = acc[r][i];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      acc[r][i] = a;
    }
  if (lane < 8) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) Acc[warp][r][lane * 8 + i] = acc[r][i];
  }
  __syncthreads();
  float* dst = part + ((bh * n_splits + split) * R) * PART;
  for (int i = t; i < R * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float a = Acc[0][r][d];
    for (int w = 1; w < WARPS; ++w) a += Acc[w][r][d];
    dst[r * PART + d] = a;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (t == r) {                           // mrow is the same in every thread
      float l = red[0][r];
      for (int w = 1; w < WARPS; ++w) l += red[w][r];
      dst[r * PART + HD] = mrow[r];
      dst[r * PART + HD + 1] = l;
    }
  }
}

// One block per (head, example), one thread per (row, column): the splits'
// partials combined in split order.
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      __nv_bfloat16* __restrict__ out,
                                      int R_total, int r0, int R, int nh,
                                      int n_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r = threadIdx.x / HD;
  const int d = threadIdx.x % HD;
  const size_t bh = (size_t)b * nh + h;
  const float* src = part + (bh * n_splits * R + r) * PART;
  const size_t step = (size_t)R * PART;
  float m = -INFINITY;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, src[s * step + HD]);
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(src[s * step + HD] - m);
    l = fmaf(src[s * step + HD + 1], w, l);
    acc = fmaf(src[s * step + d], w, acc);
  }
  out[(((size_t)b * R_total + r0 + r) * nh + h) * HD + d] =
      __float2bfloat16(l > 0.0f ? acc / l : 0.0f);
}

template <int R>
cudaError_t launch_split(const void* q, const void* k8, const void* kscale,
                         const void* v8, const void* vscale,
                         const void* kv_bias, void* part, int B, int R_total,
                         int r0, int nh, int Lk, int n_splits,
                         cudaStream_t stream) {
  const dim3 grid(n_splits, nh, B);
  decode_split_kernel<R><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(kscale), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vscale), static_cast<const float*>(kv_bias),
      static_cast<float*>(part), R_total, r0, nh, Lk, n_splits,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace

// q [B, R_total, nh, hd] bf16; k8, v8 [B, nh, Lk, hd] int8; kscale, vscale
// [B, nh, Lk] fp32; kv_bias [B, Lk] fp32; part [B, nh, n_splits, R, hd + 2]
// fp32 scratch; out [B, R_total, nh, hd] bf16, of which rows [r0, r0 + R)
// are written. All contiguous and 16-byte aligned; n_splits =
// ceil(Lk / 512); 1 <= R <= 8. Two launches on `stream`, in order. Returns
// a cudaError_t (0 = launched).
extern "C" int emdr2_decode_attention_int8(
    const void* q, const void* k8, const void* kscale, const void* v8,
    const void* vscale, const void* kv_bias, void* part, void* out, int B,
    int R_total, int r0, int R, int nh, int hd, int Lk, int n_splits,
    void* stream) {
  if (hd != HD || B <= 0 || nh <= 0 || Lk <= 0 || R < 1 || R > MAX_R ||
      r0 < 0 || r0 + R > R_total || B > 65535 || nh > 65535 ||
      n_splits != (Lk + SPLIT - 1) / SPLIT) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define EMDR2_SPLIT_CASE(N)                                                \
  case N:                                                                  \
    err = launch_split<N>(q, k8, kscale, v8, vscale, kv_bias, part, B,     \
                          R_total, r0, nh, Lk, n_splits, s);               \
    break;
  switch (R) {
    EMDR2_SPLIT_CASE(1)
    EMDR2_SPLIT_CASE(2)
    EMDR2_SPLIT_CASE(3)
    EMDR2_SPLIT_CASE(4)
    EMDR2_SPLIT_CASE(5)
    EMDR2_SPLIT_CASE(6)
    EMDR2_SPLIT_CASE(7)
    EMDR2_SPLIT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EMDR2_SPLIT_CASE
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<dim3(nh, B), R * HD, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out),
      R_total, r0, R, nh, n_splits);
  return (int)cudaGetLastError();
}
