// Padding-masked flash self-attention on the fused QKV slab (bf16), Hopper:
// forward with in-kernel dropout, and its backward.
//
// Replaces: emdr2_tpu/ops/fid_attention.py:_self_fwd_kernel (forward) and
// :_self_bwd_kernel (backward) of flash_self_attention. For each row b and
// head h,
//   out[b, :, h] = dropout(softmax(q k^T * scale [+ rel[h]] + kv_bias[b])) v
// reading q, k and v straight from the [B, L, 3H] slab at column offsets
// h*hd, H + h*hd and 2H + h*hd, and the backward writes dq, dk and dv into
// the same column slices of a [B, L, 3H] dqkv slab: no split or head
// transpose in memory, in either direction.
//
// What it computes: scores in fp32 as s*scale + bias (bias is 0 / -1e9,
// never -inf); l sums the unrounded, undropped p in fp32; dropped p are
// zeroed (hashing.cuh, keep mask with bh = b*nh + h, j = 0, col = the
// global key index) and p is rounded to bf16 BEFORE the P.V product, which
// accumulates in fp32; the division by l*(1-rate) (guarded > 0) comes after
// the product. The forward also writes the row statistics (rowmax, 1/l)
// [B, nh, 2, L] fp32 for the backward: an lse = rowmax + log(l) would lose
// log(l) in fp32 when a fully padded row has rowmax ~ -1e9, and the TPU
// backward, which recomputes both, does not. A fully padded row walks with
// every score about -1e9: its rowmax is that, l = L and p uniform, so 1/l
// is exact.
//
// Backward (TPU formula): P = exp(s - rowmax) / l; delta = rowsum(do*out);
// dP = do v^T, zeroed where dropped and scaled by 1/(1-rate);
// dS = P (dP - delta); dq = dS k * scale; dk = dS^T q * scale;
// dv = P_d^T do with P_d the dropped, rescaled P. dS and P_d are rounded to
// bf16 for the tensor-core products (the TPU multiplies them in fp32).
//
// What bounds it on the H100: operations. At L=512 (FiD encoder, B*K=400
// rows) the forward is two products of 2*L^2*hd FLOP per row and head and
// one exp per score; the backward seven such products over its two kernels
// and two exp per score. At L=64 (query tower) it is launch bound: one
// half-empty block per head and row.
//
// Design: self-attention on the slab is the one-chunk case (C = L, j = 0)
// of the walks in attention_flash.cuh, with q, k and v given as column
// slices of the slab by their strides: one pass over the keys with the
// scores, p and the accumulators in registers (wgmma on swizzled tiles fed
// by a cp.async ring), shared with the general per-head kernel, which saves
// lse where this one saves (rowmax, 1/l). The online softmax rounds p
// against the running max after each 64-key tile, where the TPU kernel
// rounds against the row's final max: within bf16 rounding of the plain
// version. The backward is that header's two kernels (dq per query tile,
// dk and dv per key tile), with no atomics, so the gradients repeat bit for
// bit. An L that is no multiple of 64 ends in a short tile whose missing
// keys count as bias -inf; rows past L arrive as zeros and are never
// written.
//
// `scale` is given by the caller (hd^-0.5 for standard attention, 1 for
// T5's). With `rel` (a [nh, 2L-1] fp32 vector over the offsets j - i, the
// relative-position bias of T5) the walks' RelBias variant adds
// rel[h, j - i + L - 1] to the scaled score, and the backward writes the
// dq blocks' sums of dS along the diagonals to `drel_part`
// [B * ceil(L / 64), nh, 2L-1] fp32, which the caller sums over its first
// axis: the bias's gradient. Those sums are shared-memory atomic adds, so
// the bias's gradient does not repeat bit for bit; dq, dk and dv do.

#include "attention_flash.cuh"
#include "hashing.cuh"

namespace {

using aflash::HeadRows;

// The q (part 0), k (1) or v (2) column slice of a [B, L, 3H] slab.
HeadRows slab_part(const void* slab, int part, int L, int H) {
  return aflash::head_rows(
      static_cast<const __nv_bfloat16*>(slab) + (size_t)part * H,
      (long long)L * 3 * H, 3 * H);
}

}  // namespace

// qkv [B, L, 3*nh*hd] bf16, kv_bias [B, L] fp32, out [B, L, nh*hd] bf16,
// stats [B, nh, 2, L] fp32 (rowmax, 1/l; or null), all contiguous and
// 16-byte aligned.
// Dropout is on when `drop_on` != 0: `threshold` = min(int(rate*2^32),
// 2^32-1), keep_frac = 1 - rate. `rel` [nh, 2L-1] fp32 or null. Returns a
// cudaError_t (0 = launched).
extern "C" int emdr2_flash_self_attention_bf16(
    const void* qkv, const void* kv_bias, void* out, void* stats, int B, int L,
    int nh, int hd, unsigned int seed, unsigned int threshold, int drop_on,
    float keep_frac, float inv_keep, float scale, const void* rel,
    void* stream) {
  if (aflash::bad_shape(B, L, L, nh, hd, L)) return (int)cudaErrorInvalidValue;
  const int H = nh * hd;
  const aflash::RowMaxInv stat{static_cast<float*>(stats)};
  const Dropout drop = make_dropout(seed, threshold, drop_on, keep_frac,
                                    inv_keep);
  if (rel == nullptr) {
    return (int)aflash::launch_forward(
        slab_part(qkv, 0, L, H), slab_part(qkv, 1, L, H),
        slab_part(qkv, 2, L, H), kv_bias, out, stat, B, L, L, nh, L, drop,
        stream, scale);
  }
  return (int)aflash::launch_forward(
      slab_part(qkv, 0, L, H), slab_part(qkv, 1, L, H),
      slab_part(qkv, 2, L, H), kv_bias, out, stat, B, L, L, nh, L, drop,
      stream, scale, aflash::RelBias{static_cast<const float*>(rel), nullptr});
}

// Backward: qkv, kv_bias as the forward; out [B, L, H] and dout [B, L, H]
// bf16; stats [B, nh, 2, L] fp32 from the forward; delta [B, nh, L] fp32
// scratch; dqkv [B, L, 3H] bf16 (every element written); with `rel`,
// drel_part [B * ceil(L / 64), nh, 2L-1] fp32 (every element written). Two
// launches on `stream`, in order. Returns a cudaError_t (0 = launched).
extern "C" int emdr2_flash_self_attention_bwd_bf16(
    const void* qkv, const void* kv_bias, const void* out, const void* dout,
    const void* stats, void* delta, void* dqkv, int B, int L, int nh, int hd,
    unsigned int seed, unsigned int threshold, int drop_on, float keep_frac,
    float inv_keep, float scale, const void* rel, void* drel_part,
    void* stream) {
  if (aflash::bad_shape(B, L, L, nh, hd, L) ||
      (rel != nullptr && drel_part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int H = nh * hd;
  const aflash::RowMaxInv stat{
      static_cast<float*>(const_cast<void*>(stats))};
  const Dropout drop = make_dropout(seed, threshold, drop_on, keep_frac,
                                    inv_keep);
  if (rel == nullptr) {
    return (int)aflash::launch_backward(
        slab_part(qkv, 0, L, H), slab_part(qkv, 1, L, H),
        slab_part(qkv, 2, L, H), kv_bias, stat, out, dout, delta,
        slab_part(dqkv, 0, L, H), slab_part(dqkv, 1, L, H),
        slab_part(dqkv, 2, L, H), B, L, L, nh, L, drop, stream, scale);
  }
  return (int)aflash::launch_backward(
      slab_part(qkv, 0, L, H), slab_part(qkv, 1, L, H),
      slab_part(qkv, 2, L, H), kv_bias, stat, out, dout, delta,
      slab_part(dqkv, 0, L, H), slab_part(dqkv, 1, L, H),
      slab_part(dqkv, 2, L, H), B, L, L, nh, L, drop, stream, scale,
      aflash::RelBias{static_cast<const float*>(rel),
                      static_cast<float*>(drel_part)});
}

// Dynamic shared memory of a block, in bytes: [0] the forward kernel, [1]
// each backward kernel (the launch configuration beside the registers that
// the compiler reports).
extern "C" int emdr2_flash_self_attention_smem(int* bytes) {
  bytes[0] = aflash::FWD_SMEM;
  bytes[1] = aflash::BWD_SMEM;
  return 0;
}
