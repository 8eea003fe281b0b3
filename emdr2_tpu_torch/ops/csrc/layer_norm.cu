// LayerNorm over the last axis, forward and backward, Hopper.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's LayerNorm
// (emdr2_tpu/models/layers.py, fp32 statistics over bf16 activations) into
// the passes around it. In eager PyTorch the same formula
// (ops/layer_norm.py:layer_norm_reference) is about ten passes over fp32
// copies of the rows forward and twice as many backward, and autograd
// keeps three fp32 copies a norm; these kernels are the one pass each way
// that the work needs, and keep only x.
//
//   y = bf16((x - mean) * rstd * w + b),  rstd = rsqrt(var + eps)
//   mean = sum(x) / H, var = sum((x - mean)^2) / H   (two passes, in fp32)
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),  g = dy * w,
//   xhat = (x - mean) * rstd;   dw = sum_rows dy * xhat,  db = sum_rows dy
// over rows of H elements, x, y, dy and dx bf16 or fp32 (one dtype), w, b,
// dw and db fp32 [H]. Statistics and gradients are fp32; every product and
// sum is rounded where the formula rounds it (no fused multiply-adds), and
// y and dx once, to x's dtype. The backward recomputes mean and rstd from
// the row it loads anyway (the same code, so the same bits as the
// forward's): nothing but x is saved.
//
// What bounds it on the H100: bytes. Forward 4 bytes an element in bf16
// (x in, y out), backward 6 (x and dy in, dx out), against ~10 and ~20
// flops; at [400, 512, 768] that is 629 MB forward, 0.188 ms at 3.35 TB/s,
// and 944 MB backward, 0.282 ms (0.283 with the partials).
//
// Design: a thread holds K chunks of 8 consecutive elements of a row in
// registers (one 16-byte access each in bf16, two in fp32), so a row is
// read once and written once. Up to H = 1,024 a warp walks a row (at 768
// each lane holds three chunks) and a block of 8 warps walks 8 rows at a
// time; beyond, the block's 256 threads walk one row, summing the warps'
// shares in shared memory. The sums within a row are lane shuffles
// (butterflies: every lane holds the same bits). The grid is a fixed
// number of blocks a multiprocessor, which walk the rows in turn, so the
// weight and bias are staged in shared memory once a block. In the
// backward, dw and db build up in each thread's registers over the rows
// its warp walks, in row order; the block sums its warps' in shared
// memory in warp order and writes one fp32 partial a block ([2, G, H],
// G = the grid), and a second kernel sums the partials over G in index
// order: no atomics, so a step repeats bit for bit. Timed on an H100
// (700 W), ten calls queued: at [400, 512, 768] bf16 the forward takes
// 0.253 ms (74% of its bound), the backward 0.357 ms (79%), against
// F.layer_norm's 0.418 and 0.656 and the formula's 4.21 and 8.44; 56 and
// 128 registers at 768, no spills (the backward's instances of 4 chunks a
// thread, H of 776 to 1,024 and above 6,144, spill 172-324 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_MAX_H = 1024;   // a warp a row up to here (4 chunks a lane)
constexpr int MAX_H = 8192;        // a block a row: 256 threads x 4 chunks
constexpr int STATIC_SMEM = 48 * 1024;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// Who walks a row: a warp (8 rows a block at a time) or the whole block.
template <bool WARP_ROW>
struct Walk {
  static constexpr int GROUP = WARP_ROW ? 32 : THREADS;   // threads a row
  static constexpr int ROWS = WARP_ROW ? WARPS : 1;       // rows a block
  __device__ static int thread() {
    return WARP_ROW ? (int)(threadIdx.x & 31) : (int)threadIdx.x;
  }
  __device__ static int slot() { return WARP_ROW ? (int)(threadIdx.x >> 5) : 0; }
  // the row's sum, the same bits in every thread of the row; `red` holds
  // WARPS floats of shared memory (the block walk's warps' shares)
  __device__ static float sum(float v, float* red) {
    v = warp_sum(v);
    if (WARP_ROW) return v;
    __syncthreads();                     // red is free again
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, red[w]);
    return s;
  }
};

// Chunk c of thread t is the row's elements [8i, 8i + 8), i = t + c * GROUP,
// where i < n8 = H / 8.
template <int K, bool WARP_ROW, typename T>
__device__ __forceinline__ void load_row(const T* row, int t, int n8,
                                         float (&v)[K][8]) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int i = t + c * Walk<WARP_ROW>::GROUP;
    if (i < n8) load8(row + 8 * i, v[c]);
  }
}

// Centres v (the row's chunks) on the row's mean in place and returns
// rstd: the mean, then the mean of the squared deviations, as the formula.
template <int K, bool WARP_ROW>
__device__ __forceinline__ float centre(float (&v)[K][8], int t, int n8,
                                        float inv_h, float eps, float* red) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (t + c * Walk<WARP_ROW>::GROUP < n8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s = __fadd_rn(s, v[c][j]);
    }
  }
  const float mean = __fmul_rn(Walk<WARP_ROW>::sum(s, red), inv_h);
  float q = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (t + c * Walk<WARP_ROW>::GROUP < n8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[c][j] = __fsub_rn(v[c][j], mean);
        q = __fadd_rn(q, __fmul_rn(v[c][j], v[c][j]));
      }
    }
  }
  const float var = __fmul_rn(Walk<WARP_ROW>::sum(q, red), inv_h);
  return rsqrtf(__fadd_rn(var, eps));
}

// Shared memory: w [H], b [H], the warps' shares [WARPS].
template <typename T, int K, bool WARP_ROW>
__global__ void __launch_bounds__(THREADS, 4)
    layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, T* __restrict__ y,
                          int rows, int h, float eps) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* sb = sw + h;
  float* red = sb + h;
  for (int i = threadIdx.x; i < h; i += THREADS) {
    sw[i] = w[i];
    sb[i] = b[i];
  }
  __syncthreads();
  using W = Walk<WARP_ROW>;
  const int t = W::thread(), n8 = h / 8;
  const float inv_h = 1.0f / (float)h;
  for (int row = blockIdx.x * W::ROWS + W::slot(); row < rows;
       row += gridDim.x * W::ROWS) {
    const size_t base = (size_t)row * h;
    float v[K][8];
    load_row<K, WARP_ROW>(x + base, t, n8, v);
    const float rstd = centre<K, WARP_ROW>(v, t, n8, inv_h, eps, red);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int i = t + c * W::GROUP;
      if (i < n8) {
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[c][j], rstd), sw[8 * i + j]),
                           sb[8 * i + j]);
        store8(y + base + 8 * i, o);
      }
    }
  }
}

// Shared memory: w [H], the warps' shares [WARPS], and in the warp walk
// the warps' dw or db [WARPS][H]. partial: [2][gridDim.x][H] (dw's, db's).
template <typename T, int K, bool WARP_ROW>
__global__ void __launch_bounds__(THREADS, 2)
    layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ w, T* __restrict__ dx,
                          float* __restrict__ partial, int rows, int h,
                          float eps) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* red = sw + h;
  for (int i = threadIdx.x; i < h; i += THREADS) sw[i] = w[i];
  __syncthreads();
  using W = Walk<WARP_ROW>;
  const int t = W::thread(), n8 = h / 8;
  const float inv_h = 1.0f / (float)h;
  float dw[K][8], db[K][8];
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dw[c][j] = db[c][j] = 0.0f;
  }
  for (int row = blockIdx.x * W::ROWS + W::slot(); row < rows;
       row += gridDim.x * W::ROWS) {
    const size_t base = (size_t)row * h;
    float v[K][8], g[K][8];
    load_row<K, WARP_ROW>(x + base, t, n8, v);
    load_row<K, WARP_ROW>(dy + base, t, n8, g);
    const float rstd = centre<K, WARP_ROW>(v, t, n8, inv_h, eps, red);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int i = t + c * W::GROUP;
      if (i < n8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xhat = __fmul_rn(v[c][j], rstd);
          v[c][j] = xhat;
          dw[c][j] = __fadd_rn(dw[c][j], __fmul_rn(g[c][j], xhat));
          db[c][j] = __fadd_rn(db[c][j], g[c][j]);
          g[c][j] = __fmul_rn(g[c][j], sw[8 * i + j]);
          s1 = __fadd_rn(s1, g[c][j]);
          s2 = __fadd_rn(s2, __fmul_rn(g[c][j], xhat));
        }
      }
    }
    const float m1 = __fmul_rn(W::sum(s1, red), inv_h);
    const float m2 = __fmul_rn(W::sum(s2, red), inv_h);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int i = t + c * W::GROUP;
      if (i < n8) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          g[c][j] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(g[c][j], m1),
                                              __fmul_rn(v[c][j], m2)));
        store8(dx + base + 8 * i, g[c]);
      }
    }
  }
  float* pw = partial + (size_t)blockIdx.x * h;
  float* pb = partial + ((size_t)gridDim.x + blockIdx.x) * h;
  if (!WARP_ROW) {                 // a thread owns its columns in the block
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int i = t + c * W::GROUP;
      if (i < n8) {
        store8(pw + 8 * i, dw[c]);
        store8(pb + 8 * i, db[c]);
      }
    }
    return;
  }
  // every warp holds every column: sum the warps' in warp order
  float* acc = red + WARPS;
  for (int q = 0; q < 2; ++q) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const int i = t + c * W::GROUP;
      if (i < n8) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[W::slot() * h + 8 * i + j] = q ? db[c][j] : dw[c][j];
      }
    }
    __syncthreads();
    float* out = q ? pb : pw;
    for (int i = threadIdx.x; i < h; i += THREADS) {
      float s = acc[i];
#pragma unroll
      for (int k = 1; k < WARPS; ++k) s = __fadd_rn(s, acc[k * h + i]);
      out[i] = s;
    }
  }
}

// dw and db: the partials [2][groups][H] summed over groups in index order.
__global__ void __launch_bounds__(THREADS)
    layer_norm_bwd_sum_kernel(const float* __restrict__ partial,
                              float* __restrict__ dw, float* __restrict__ db,
                              int groups, int h) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= 2 * h) return;
  const int q = i / h, col = i - q * h;
  const float* p = partial + (size_t)q * groups * h + col;
  float s = p[0];
#pragma unroll 8
  for (int g = 1; g < groups; ++g) s = __fadd_rn(s, p[(size_t)g * h]);
  (q ? db : dw)[col] = s;
}

bool bad_shape(int rows, int h, int grid) {
  return rows <= 0 || h <= 0 || h % 8 != 0 || h > MAX_H || grid <= 0;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= STATIC_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int K, bool WARP_ROW>
int launch_fwd(const T* x, const float* w, const float* b, T* y, int rows,
               int h, float eps, int grid, cudaStream_t stream) {
  auto kernel = layer_norm_fwd_kernel<T, K, WARP_ROW>;
  const size_t smem = (2 * (size_t)h + WARPS) * sizeof(float);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(x, w, b, y, rows, h, eps);
  return (int)cudaGetLastError();
}

template <typename T, int K, bool WARP_ROW>
int launch_bwd(const T* x, const T* dy, const float* w, T* dx, float* partial,
               float* dw, float* db, int rows, int h, float eps, int groups,
               cudaStream_t stream) {
  auto kernel = layer_norm_bwd_kernel<T, K, WARP_ROW>;
  const size_t smem =
      ((size_t)h + WARPS + (WARP_ROW ? (size_t)WARPS * h : 0)) * sizeof(float);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<groups, THREADS, smem, stream>>>(x, dy, w, dx, partial, rows, h,
                                            eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  layer_norm_bwd_sum_kernel<<<(2 * h + THREADS - 1) / THREADS, THREADS, 0,
                              stream>>>(partial, dw, db, groups, h);
  return (int)cudaGetLastError();
}

// Returns CALL(K, WARP_ROW) for the instance that takes rows of h: the
// walk, and the chunks of 8 a thread holds (1 to 4).
#define LN_DISPATCH(h, CALL)                                      \
  if ((h) <= WARP_MAX_H) {                                        \
    switch (((h) / 8 + 31) / 32) {                                \
      case 1: return CALL(1, true);                               \
      case 2: return CALL(2, true);                               \
      case 3: return CALL(3, true);                               \
      case 4: return CALL(4, true);                               \
    }                                                             \
  } else {                                                        \
    switch (((h) / 8 + THREADS - 1) / THREADS) {                  \
      case 1: return CALL(1, false);                              \
      case 2: return CALL(2, false);                              \
      case 3: return CALL(3, false);                              \
      case 4: return CALL(4, false);                              \
    }                                                             \
  }                                                               \
  return (int)cudaErrorInvalidValue

template <typename T>
int forward(const void* x, const void* w, const void* b, void* y, int rows,
            int h, float eps, int grid, void* stream) {
  if (bad_shape(rows, h, grid)) return (int)cudaErrorInvalidValue;
#define LN_FWD(K, WARP_ROW)                                                  \
  launch_fwd<T, K, WARP_ROW>(static_cast<const T*>(x),                       \
                             static_cast<const float*>(w),                   \
                             static_cast<const float*>(b), static_cast<T*>(y), \
                             rows, h, eps, grid, (cudaStream_t)stream)
  LN_DISPATCH(h, LN_FWD);
#undef LN_FWD
}

template <typename T>
int backward(const void* x, const void* dy, const void* w, void* dx,
             void* partial, void* dw, void* db, int rows, int h, float eps,
             int groups, void* stream) {
  if (bad_shape(rows, h, groups)) return (int)cudaErrorInvalidValue;
#define LN_BWD(K, WARP_ROW)                                                  \
  launch_bwd<T, K, WARP_ROW>(                                                \
      static_cast<const T*>(x), static_cast<const T*>(dy),                   \
      static_cast<const float*>(w), static_cast<T*>(dx),                     \
      static_cast<float*>(partial), static_cast<float*>(dw),                 \
      static_cast<float*>(db), rows, h, eps, groups, (cudaStream_t)stream)
  LN_DISPATCH(h, LN_BWD);
#undef LN_BWD
}

#undef LN_DISPATCH

}  // namespace

// x, y: contiguous [rows, h] on 16 bytes; w, b: fp32 [h]; h a multiple of
// 8 up to 8,192; grid: the blocks that walk the rows. Returns the launch's
// cudaError_t.
extern "C" int emdr2_layer_norm_bf16(const void* x, const void* w,
                                     const void* b, void* y, int rows, int h,
                                     float eps, int grid, void* stream) {
  return forward<__nv_bfloat16>(x, w, b, y, rows, h, eps, grid, stream);
}

extern "C" int emdr2_layer_norm_f32(const void* x, const void* w,
                                    const void* b, void* y, int rows, int h,
                                    float eps, int grid, void* stream) {
  return forward<float>(x, w, b, y, rows, h, eps, grid, stream);
}

// x, dy, dx: contiguous [rows, h] on 16 bytes; w: fp32 [h]; partial: fp32
// [2, groups, h] scratch; dw, db: fp32 [h]; groups: the blocks that walk
// the rows (the row kernel's grid). Two launches: the rows, then the sum of
// the partials. Returns the first failed launch's cudaError_t.
extern "C" int emdr2_layer_norm_bwd_bf16(const void* x, const void* dy,
                                         const void* w, void* dx,
                                         void* partial, void* dw, void* db,
                                         int rows, int h, float eps,
                                         int groups, void* stream) {
  return backward<__nv_bfloat16>(x, dy, w, dx, partial, dw, db, rows, h, eps,
                                 groups, stream);
}

extern "C" int emdr2_layer_norm_bwd_f32(const void* x, const void* dy,
                                        const void* w, void* dx,
                                        void* partial, void* dw, void* db,
                                        int rows, int h, float eps,
                                        int groups, void* stream) {
  return backward<float>(x, dy, w, dx, partial, dw, db, rows, h, eps, groups,
                         stream);
}
