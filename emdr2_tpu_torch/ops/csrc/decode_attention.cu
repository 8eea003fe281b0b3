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
// fp32. Those 2*R*hd multiply-adds a key, and two operations a converted
// byte, are not free either: from about three query rows on the arithmetic,
// not the read, sets the time, so the loads must run under it.
//
// Design: the TPU grid (B*nh programs, each walking the key chunks in
// order) would give 96 blocks for 132 SMs; here the keys of a (head,
// example) are dealt to blocks in runs of whole stages, and a block walks
// its run through a ring of STAGES shared-memory slots of STAGE_KEYS keys.
//   - A stage's K rows and its V rows are each one contiguous run of the
//     slab: one thread asks for both with two bulk asynchronous copies
//     (cp.async.bulk, completion counted in bytes on the slot's mbarrier),
//     STAGES - 1 stages ahead of the one being computed, so V arrives while
//     the scores are formed and the next stage while this one is summed.
//     No thread spends a register or an operation on the slab's
//     addresses. The stage's scales and bias (12 bytes a key, at any
//     alignment) go through registers: read at the top of the stage before,
//     stored into the slot at its end.
//   - Each warp owns a quarter of every stage and runs its own online
//     softmax over its keys, so nothing but the slot hand-over
//     (__syncthreads once a stage) couples the warps.
//       scores: four lanes a key row, 16 bytes each (a warp reads 512
//       contiguous bytes of shared memory: no bank conflict), against the
//       lane's 16 columns of the R query rows held in registers, column by
//       column so that each converted value feeds R independent
//       multiply-adds; two shuffles sum the four lanes. Lane c of the four
//       takes rows c and c + 4: scale, bias, the running max, p =
//       exp(s - m), and p * vscale into the warp's own [R, keys + 8] fp32
//       tile (the + 8 spreads the rows over the banks). fp32 throughout:
//       the TPU kernel rounds p * vscale to bf16, so the two differ by
//       that rounding.
//       p.v: eight lanes a key row, 8 bytes each (256 contiguous bytes a
//       warp), fp32 accumulators [R, 8] a lane for the whole walk, rescaled
//       when the warp's max moves.
//   - At the end of its run a block merges its four warps' (acc, m, l) in
//     warp order and writes one fp32 partial; a second small kernel per
//     (head, example) combines the blocks' partials in block order: global
//     max, rescale, sum, divide. No atomics: the result repeats bit for bit.
// int8 becomes fp32 without the conversion unit: a byte permute into the
// mantissa of 2^23 and one subtraction (unpack4), exact.
// Padded keys carry k8 = v8 = 0, scale 1 and bias -1e9 and get weight
// exp(-1e9 - m) = 0; keys past Lk in the last stage are never copied and
// count as scale 0, bias -inf; a fully masked example averages its values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int HD = 64;
constexpr int STAGE_KEYS = 256;     // keys a ring slot holds
constexpr int STAGES = 2;           // slots of the ring
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KW = STAGE_KEYS / WARPS;    // keys of a stage a warp takes
constexpr int PS = KW + 8;                // row stride of a warp's p tile
constexpr int SPT = STAGE_KEYS / THREADS; // scales a thread carries a stage
constexpr int STAGE_BYTES = STAGE_KEYS * HD;     // of K, and again of V
constexpr int MAX_R = 8;
constexpr int U1 = 4;               // key groups of the score pass in flight
constexpr int U3 = 8;               // ... of the p.v pass
constexpr int PART = HD + 2;        // acc[hd], m, l per (block, row)

static_assert(STAGES >= 2, "one stage lands while another is computed");
static_assert(STAGE_KEYS % THREADS == 0 && KW % 8 == 0, "whole key groups");
static_assert(WARPS * MAX_R * PART * 4 <= 2 * STAGE_BYTES,
              "the warps' partials are merged over the first slot");

// Dynamic shared memory of a block that takes R query rows: the ring (K and
// V of every slot, then their scales and bias), the queries in fp32, the
// warps' p tiles, the slots' mbarriers.
constexpr int smem_bytes(int R) {
  return STAGES * (2 * STAGE_BYTES + 3 * STAGE_KEYS * 4) + R * HD * 4 +
         WARPS * R * PS * 4 + STAGES * 8;
}

using tma::bulk_load;
using tma::mbar_expect;
using tma::mbar_init;
using tma::mbar_wait;

// Four int8 -> fp32, exactly, without the conversion unit: with the sign
// bit flipped a byte is u = x + 128 in 0..255; placed in the low mantissa
// byte of 2^23 it reads as the float 2^23 + u, and subtracting 2^23 + 128
// leaves x. One byte permute and one add a value.
__device__ __forceinline__ void unpack4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
}

// dot[4 * j + c] for the lane's c in 0..3: a select chain, since registers
// cannot be indexed by a run-time value.
template <int R>
__device__ __forceinline__ float pick_row(const float (&dot)[R], int j,
                                          int c) {
  float d = dot[4 * j];
  if (4 * j + 1 < R && c == 1) d = dot[4 * j + 1];
  if (4 * j + 2 < R && c == 2) d = dot[4 * j + 2];
  if (4 * j + 3 < R && c == 3) d = dot[4 * j + 3];
  return d;
}

template <int R>
__global__ void __launch_bounds__(THREADS, 2)
decode_walk_kernel(const __nv_bfloat16* __restrict__ q,
                   const int8_t* __restrict__ k8,
                   const float* __restrict__ kscale,
                   const int8_t* __restrict__ v8,
                   const float* __restrict__ vscale,
                   const float* __restrict__ kv_bias,
                   float* __restrict__ part, int R_total, int r0, int nh,
                   int Lk, int stages_per_block, int n_blocks, float scale) {
  constexpr int SL = (R + 3) / 4;           // rows a lane of a quad takes
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* kv_s = reinterpret_cast<int8_t*>(smem);   // [STAGES][K | V]
  float* scal_s = reinterpret_cast<float*>(smem + STAGES * 2 * STAGE_BYTES);
  float* Qs = scal_s + STAGES * 3 * STAGE_KEYS;     // [R][HD]
  float* Ps = Qs + R * HD;                          // [WARPS][R][PS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ps + WARPS * R * PS);

  const int blk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c = lane & 3;                   // scores: 16 bytes of a key row
  const int kq = lane >> 2;                 // ... of key kq of eight
  const int c8 = lane & 7;                  // p.v: 8 bytes of a value row
  const int kg = lane >> 3;                 // ... of key kg of four
  const size_t bh = (size_t)b * nh + h;
  const int k_begin = blk * stages_per_block * STAGE_KEYS;
  const int k_end = min(Lk, k_begin + stages_per_block * STAGE_KEYS);
  const int n_stages = (k_end - k_begin + STAGE_KEYS - 1) / STAGE_KEYS;
  const int8_t* k_run = k8 + (bh * Lk + k_begin) * HD;
  const int8_t* v_run = v8 + (bh * Lk + k_begin) * HD;
  const float* ks_row = kscale + bh * Lk;
  const float* vs_row = vscale + bh * Lk;
  const float* bias_row = kv_bias + (size_t)b * Lk;

  // stage j of the run: its K rows and V rows, both asked for at once
  auto request = [&](int j) {
    const int slot = j % STAGES;
    const uint32_t bytes =
        (uint32_t)min(STAGE_KEYS, k_end - k_begin - j * STAGE_KEYS) * HD;
    int8_t* dst = kv_s + slot * 2 * STAGE_BYTES;
    mbar_expect(bars + slot, 2 * bytes);
    bulk_load(dst, k_run + (size_t)j * STAGE_BYTES, bytes, bars + slot);
    bulk_load(dst + STAGE_BYTES, v_run + (size_t)j * STAGE_BYTES, bytes,
              bars + slot);
  };
  // stage j's (kscale, vscale, bias) of this thread's keys; a key past the
  // run's end gets no weight
  auto load_scales = [&](int j, float (&ks)[SPT], float (&vs)[SPT],
                         float (&bs)[SPT]) {
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      const int key = k_begin + j * STAGE_KEYS + tid + u * THREADS;
      const bool ok = key < k_end;
      ks[u] = ok ? __ldg(ks_row + key) : 0.0f;
      vs[u] = ok ? __ldg(vs_row + key) : 0.0f;
      bs[u] = ok ? __ldg(bias_row + key) : -INFINITY;
    }
  };
  auto store_scales = [&](int j, const float (&ks)[SPT],
                          const float (&vs)[SPT], const float (&bs)[SPT]) {
    float* dst = scal_s + (j % STAGES) * 3 * STAGE_KEYS;
#pragma unroll
    for (int u = 0; u < SPT; ++u) {
      dst[tid + u * THREADS] = ks[u];
      dst[STAGE_KEYS + tid + u * THREADS] = vs[u];
      dst[2 * STAGE_KEYS + tid + u * THREADS] = bs[u];
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < R * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    Qs[i] = __bfloat162float(
        q[(((size_t)b * R_total + r0 + r) * nh + h) * HD + d]);
  }
  {
    float ks[SPT], vs[SPT], bs[SPT];
    load_scales(0, ks, vs, bs);
    store_scales(0, ks, vs, bs);
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_stages) request(s);
    }
  }

  float acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
  float m_run[SL], lsum[SL];
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    m_run[j] = -1e30f;
    lsum[j] = 0.0f;
  }
  float* Pw = Ps + warp * R * PS;

  for (int i = 0; i < n_stages; ++i) {
    const int slot = i % STAGES;
    // the slot freed by the stage before this one takes the stage
    // STAGES - 1 ahead
    if (tid == 0 && i + STAGES - 1 < n_stages) request(i + STAGES - 1);
    const bool has_next = i + 1 < n_stages;
    float nks[SPT], nvs[SPT], nbs[SPT];
    if (has_next) load_scales(i + 1, nks, nvs, nbs);
    mbar_wait(bars + slot, (uint32_t)(i / STAGES) & 1u);

    const int8_t* slot_kv = kv_s + slot * 2 * STAGE_BYTES;
    const uint4* Kq = reinterpret_cast<const uint4*>(slot_kv) + warp * KW * 4;
    const uint2* Vq =
        reinterpret_cast<const uint2*>(slot_kv + STAGE_BYTES) + warp * KW * 8;
    const float* sks = scal_s + slot * 3 * STAGE_KEYS + warp * KW;
    const float* svs = sks + STAGE_KEYS;
    const float* sbs = sks + 2 * STAGE_KEYS;

    // ---- scores of the warp's KW keys, eight keys a pass ----
    float qreg[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(Qs + r * HD + 16 * c + 4 * x);
        qreg[r][4 * x] = v4.x;
        qreg[r][4 * x + 1] = v4.y;
        qreg[r][4 * x + 2] = v4.z;
        qreg[r][4 * x + 3] = v4.w;
      }
    }
    float mx[SL];
#pragma unroll
    for (int j = 0; j < SL; ++j) mx[j] = -INFINITY;
#pragma unroll U1
    for (int it = 0; it < KW / 8; ++it) {
      const int kl = 8 * it + kq;
      const uint4 w = Kq[kl * 4 + c];
      float kf[16];
      unpack4(w.x, kf);
      unpack4(w.y, kf + 4);
      unpack4(w.z, kf + 8);
      unpack4(w.w, kf + 12);
      // CH chains a row, advanced column by column across the rows: each
      // converted key value feeds R independent multiply-adds in a row
      constexpr int CH = R >= 4 ? 1 : (R >= 2 ? 2 : 4);
      float sum[R][CH];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) sum[r][ch] = 0.0f;
#pragma unroll
      for (int x = 0; x < 16; ++x) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sum[r][x % CH] = fmaf(kf[x], qreg[r][x], sum[r][x % CH]);
        }
      }
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = sum[r][0];
#pragma unroll
        for (int ch = 1; ch < CH; ++ch) d += sum[r][ch];
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        dot[r] = d;
      }
      const float ksc = sks[kl] * scale;
      const float bias = sbs[kl];
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        const int r = c + 4 * j;
        const float s = fmaf(pick_row<R>(dot, j, c), ksc, bias);
        if (r < R) {
          mx[j] = fmaxf(mx[j], s);
          Pw[r * PS + kl] = s;
        }
      }
    }

    // ---- the warp's running max; p and p * vscale over its own scores ----
    float corr[SL];
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      float m = mx[j];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      const float m_new = fmaxf(m_run[j], m);
      corr[j] = __expf(m_run[j] - m_new);
      m_run[j] = m_new;
      lsum[j] *= corr[j];
    }
#pragma unroll 2
    for (int it = 0; it < KW / 8; ++it) {
      const int kl = 8 * it + kq;
      const float vs = svs[kl];
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        const int r = c + 4 * j;
        if (r < R) {
          const float p = __expf(Pw[r * PS + kl] - m_run[j]);
          lsum[j] += p;
          Pw[r * PS + kl] = p * vs;
        }
      }
    }
    __syncwarp();

    // ---- p.v: four keys a pass, the lane's eight columns ----
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // row r's correction lives in lane r % 4 (key 0 of the eight)
      const float cr = __shfl_sync(0xffffffffu, corr[r / 4], r % 4);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= cr;
    }
#pragma unroll U3
    for (int i2 = 0; i2 < KW / 4; ++i2) {
      const int kl = kg + 4 * i2;
      const uint2 w = Vq[kl * 8 + c8];
      float vf[8];
      unpack4(w.x, vf);
      unpack4(w.y, vf + 4);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = Pw[r * PS + kl];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }

    if (has_next) store_scales(i + 1, nks, nvs, nbs);
    __syncthreads();                        // the slot and the p tile are free
  }

  // ---- the warp's (acc, m, l), then the four warps in warp order ----
  float* Mg = reinterpret_cast<float*>(smem);       // [WARPS][R][PART]
  float* Mw = Mg + warp * R * PART;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float a = acc[r][e];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      if (kg == 0) Mw[r * PART + 8 * c8 + e] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    float l = lsum[j];
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    l += __shfl_xor_sync(0xffffffffu, l, 8);
    l += __shfl_xor_sync(0xffffffffu, l, 16);
    const int r = c + 4 * j;
    if (kq == 0 && r < R) {
      Mw[r * PART + HD] = m_run[j];
      Mw[r * PART + HD + 1] = l;
    }
  }
  __syncthreads();
  float* dst = part + ((bh * n_blocks + blk) * R) * PART;
  for (int i = tid; i < R * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const float* src = Mg + r * PART;
    float m = src[HD];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, src[w * R * PART + HD]);
    float l = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = __expf(src[w * R * PART + HD] - m);
      l = fmaf(src[w * R * PART + HD + 1], wt, l);
      a = fmaf(src[w * R * PART + d], wt, a);
    }
    dst[r * PART + d] = a;
    if (d == 0) {
      dst[r * PART + HD] = m;
      dst[r * PART + HD + 1] = l;
    }
  }
}

// One block per (head, example), one thread per (row, column): the blocks'
// partials combined in block order.
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      __nv_bfloat16* __restrict__ out,
                                      int R_total, int r0, int R, int nh,
                                      int n_blocks) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r = threadIdx.x / HD;
  const int d = threadIdx.x % HD;
  const size_t bh = (size_t)b * nh + h;
  const float* src = part + (bh * n_blocks * R + r) * PART;
  const size_t step = (size_t)R * PART;
  float m = -INFINITY;
  for (int s = 0; s < n_blocks; ++s) m = fmaxf(m, src[s * step + HD]);
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < n_blocks; ++s) {
    const float w = expf(src[s * step + HD] - m);
    l = fmaf(src[s * step + HD + 1], w, l);
    acc = fmaf(src[s * step + d], w, acc);
  }
  out[(((size_t)b * R_total + r0 + r) * nh + h) * HD + d] =
      __float2bfloat16(l > 0.0f ? acc / l : 0.0f);
}

template <int R>
cudaError_t launch_walk(const void* q, const void* k8, const void* kscale,
                        const void* v8, const void* vscale,
                        const void* kv_bias, void* part, int B, int R_total,
                        int r0, int nh, int Lk, int stages_per_block,
                        int n_blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_walk_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(R));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, nh, B);
  decode_walk_kernel<R><<<grid, THREADS, smem_bytes(R), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(kscale), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vscale), static_cast<const float*>(kv_bias),
      static_cast<float*>(part), R_total, r0, nh, Lk, stages_per_block,
      n_blocks, 1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

// Blocks of the R-row walk a multiprocessor of the current device holds at
// once.
template <int R>
cudaError_t walk_residency(int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_walk_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(R));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_walk_kernel<R>, THREADS, smem_bytes(R));
}

}  // namespace

// The kernel's layout, for the wrapper and for reports: out[0] = keys a
// ring slot holds, out[1] = slots, out[2] = warps a block; then for R =
// 1..8 query rows, out[2 + R] = dynamic shared memory in bytes of a block
// and out[10 + R] = blocks of that kernel a multiprocessor of the current
// device holds at once, by the runtime's occupancy query (registers, shared
// memory and threads together). Returns a cudaError_t (0 = all read).
extern "C" int emdr2_decode_attention_layout(int* out) {
  out[0] = STAGE_KEYS;
  out[1] = STAGES;
  out[2] = WARPS;
  for (int r = 1; r <= MAX_R; ++r) out[2 + r] = smem_bytes(r);
  cudaError_t err = walk_residency<1>(out + 11);
  if (err == cudaSuccess) err = walk_residency<2>(out + 12);
  if (err == cudaSuccess) err = walk_residency<3>(out + 13);
  if (err == cudaSuccess) err = walk_residency<4>(out + 14);
  if (err == cudaSuccess) err = walk_residency<5>(out + 15);
  if (err == cudaSuccess) err = walk_residency<6>(out + 16);
  if (err == cudaSuccess) err = walk_residency<7>(out + 17);
  if (err == cudaSuccess) err = walk_residency<8>(out + 18);
  return (int)err;
}

// q [B, R_total, nh, hd] bf16; k8, v8 [B, nh, Lk, hd] int8; kscale, vscale
// [B, nh, Lk] fp32; kv_bias [B, Lk] fp32; part [B, nh, n_blocks, R, hd + 2]
// fp32 scratch; out [B, R_total, nh, hd] bf16, of which rows [r0, r0 + R)
// are written. All contiguous and 16-byte aligned. A block walks
// stages_per_block stages of 256 keys, so n_blocks = ceil(ceil(Lk / 256) /
// stages_per_block); 1 <= R <= 8. Two launches on `stream`, in order.
// Returns a cudaError_t (0 = launched).
extern "C" int emdr2_decode_attention_int8(
    const void* q, const void* k8, const void* kscale, const void* v8,
    const void* vscale, const void* kv_bias, void* part, void* out, int B,
    int R_total, int r0, int R, int nh, int hd, int Lk, int stages_per_block,
    int n_blocks, void* stream) {
  if (hd != HD || B <= 0 || nh <= 0 || Lk <= 0 || R < 1 || R > MAX_R ||
      r0 < 0 || r0 + R > R_total || B > 65535 || nh > 65535 ||
      stages_per_block < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_stages = (Lk + STAGE_KEYS - 1) / STAGE_KEYS;
  if (n_blocks != (n_stages + stages_per_block - 1) / stages_per_block) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
#define EMDR2_WALK_CASE(N)                                                 \
  case N:                                                                  \
    err = launch_walk<N>(q, k8, kscale, v8, vscale, kv_bias, part, B,      \
                         R_total, r0, nh, Lk, stages_per_block, n_blocks,  \
                         s);                                               \
    break;
  switch (R) {
    EMDR2_WALK_CASE(1)
    EMDR2_WALK_CASE(2)
    EMDR2_WALK_CASE(3)
    EMDR2_WALK_CASE(4)
    EMDR2_WALK_CASE(5)
    EMDR2_WALK_CASE(6)
    EMDR2_WALK_CASE(7)
    EMDR2_WALK_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EMDR2_WALK_CASE
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<dim3(nh, B), R * HD, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out),
      R_total, r0, R, nh, n_blocks);
  return (int)cudaGetLastError();
}
