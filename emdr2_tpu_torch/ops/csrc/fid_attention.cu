// General per-head flash attention (bf16) with a key-side bias, an online
// softmax over key chunks and in-kernel dropout, Hopper: forward and backward.
//
// Replaces: emdr2_tpu/ops/fid_attention.py:_fwd_kernel (launched by
// _fid_forward) and :_bwd_kernel (launched by _fid_bwd) of
// fid_cross_attention: the route self-attention takes when the sequence is
// longer than the key chunk. For each row b and head h,
//   out[b, :, h] = dropout(softmax(q k^T * hd^-0.5 + kv_bias[b])) v
// with q [B, Lq, nh, hd] and k, v [B, Lk, nh, hd]. The three inputs are
// read through their batch and row strides, so they may be views of one
// fused [B, L, 3H] projection slab: nothing is copied or transposed.
//
// What the TPU kernel computes: it walks the keys in chunks of `key_chunk`
// with an online softmax: per chunk j, m_new = max(m, chunk max), p =
// exp(s - m_new) rounded to bf16 before the fp32-accumulated P.V, l =
// l*exp(m - m_new) + sum(p) over undropped p, acc = acc*exp(m - m_new) +
// P.V; out = acc / (l*(1-rate)) (guarded > 0), lse = m + log(l) (l guarded
// > 0). Dropout zeroes p in the value term only, with the keep mask of
// hashing.cuh at bh = b*nh + h, j = the chunk, col = the key within the
// chunk, row = the query: the chunk's coordinates, whatever tile walks it.
//
// What bounds it on the H100: operations. At the reader encoder's shape
// (400 rows of 512 tokens, 12 heads) it is 4*Lq*Lk*hd FLOP per row and head
// (322 GFLOP) and one exp per score (1.26 G, a third of a millisecond of the
// special-function units alone) for 0.6 GB of reads and 0.3 GB of writes.
//
// Forward design: the shared forward walk of attention_flash.cuh (wgmma on
// swizzled tiles, a cp.async ring, the online softmax in registers; p
// rounds against the running max after each 64-key tile, not after the
// whole chunk as on the TPU: within bf16 rounding of the plain version),
// saving lse. Tiles never straddle a chunk: a chunk that is no multiple of
// 64 keys ends in a short tile whose missing keys count as bias -inf, so
// every shape takes this one kernel.
//
// Backward (the TPU kernel's formula, from the forward's saved lse):
// delta = rowsum(do * out) in fp32; per key, P = exp(s*scale + bias - lse);
// dP = do v^T, zeroed where dropped and scaled by 1/(1-rate);
// dS = P (dP - delta); dq = dS k * scale; dk = dS^T q * scale;
// dv = P_d^T do with P_d the dropped, rescaled P. A fully padded row has
// lse = its (equal) scores, so P = 1 on every key there, as on the TPU. dS
// and P_d are rounded to bf16 for the tensor-core products (the TPU
// multiplies them in fp32). At the reader encoder's shape it is five
// products of 2*Lq*Lk*hd FLOP per row and head: bound by operations.
//
// Backward design: the shared backward pair of attention_flash.cuh, saved
// statistic lse (the walk self-attention on a slab takes with (rowmax,
// 1/l)): two kernels, neither with atomics or partial sums, so the
// gradients repeat bit for bit. One warpgroup per (64-query tile, head, row)
// walks every key tile for dq and writes delta; then one per (64-key tile of
// a chunk, head, row) walks the query tiles for dk and dv. S, dP, P and dS
// live in registers (wgmma results, packed in place as the next product's A
// operand); operands arrive through a cp.async ring. Both take the mask's
// (chunk, column in chunk) from the key's place in its logical chunk; a
// chunk that is no multiple of 64 keys ends in a short tile. q, k, v and the
// three gradients are read and written through their strides, so the
// gradients may land in the column slices of one [B, L, 3H] slab; do and out
// are contiguous [B, L, nh, hd].

#include <math.h>

#include "attention_flash.cuh"
#include "hashing.cuh"

namespace {

bool bad_rows(long long bs, int rs) {
  return aflash::bad_rows(aflash::head_rows(nullptr, bs, rs));
}

bool bad_call(long long q_bs, int q_rs, long long k_bs, int k_rs,
              long long v_bs, int v_rs, int B, int Lq, int Lk, int nh, int hd,
              int key_chunk) {
  return aflash::bad_shape(B, Lq, Lk, nh, hd, key_chunk) ||
         bad_rows(q_bs, q_rs) || bad_rows(k_bs, k_rs) || bad_rows(v_bs, v_rs);
}

}  // namespace

// q [B, Lq, nh, hd], k, v [B, Lk, nh, hd] bf16, each given by its base
// pointer (16-byte aligned), batch stride and row stride in elements
// (multiples of 8; heads and the head dim contiguous); kv_bias [B, Lk] fp32;
// out [B, Lq, nh, hd] bf16 and lse [B, nh, Lq] fp32, contiguous. Lk is a
// multiple of key_chunk. Dropout as in the other attention kernels.
// Returns a cudaError_t (0 = launched).
extern "C" int emdr2_fid_attention_bf16(
    const void* q, const void* k, const void* v, const void* kv_bias,
    void* out, void* lse, long long q_bs, int q_rs, long long k_bs, int k_rs,
    long long v_bs, int v_rs, int B, int Lq, int Lk, int nh, int hd,
    int key_chunk, unsigned int seed, unsigned int threshold, int drop_on,
    float keep_frac, float inv_keep, void* stream) {
  if (bad_call(q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, B, Lq, Lk, nh, hd,
               key_chunk)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)aflash::launch_forward(
      aflash::head_rows(q, q_bs, q_rs), aflash::head_rows(k, k_bs, k_rs),
      aflash::head_rows(v, v_bs, v_rs), kv_bias, out,
      aflash::Lse{static_cast<float*>(lse)}, B, Lq, Lk, nh, key_chunk,
      make_dropout(seed, threshold, drop_on, keep_frac, inv_keep), stream);
}

// Backward: q, k, v (pointer and strides), kv_bias and the dropout arguments
// as the forward; lse [B, nh, Lq] fp32 from the forward; out and dout
// [B, Lq, nh, hd] bf16, contiguous; delta [B, nh, Lq] fp32 scratch; dq
// [B, Lq, nh, hd] and dk, dv [B, Lk, nh, hd] bf16, each given by its pointer
// and (after v's) its batch and row strides like the inputs: every element
// of them is written and nothing else. Two launches on `stream`, in order.
// Returns a cudaError_t (0 = launched).
extern "C" int emdr2_fid_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* kv_bias,
    const void* lse, const void* out, const void* dout, void* delta, void* dq,
    void* dk, void* dv, long long q_bs, int q_rs, long long k_bs, int k_rs,
    long long v_bs, int v_rs, long long dq_bs, int dq_rs, long long dk_bs,
    int dk_rs, long long dv_bs, int dv_rs, int B, int Lq, int Lk, int nh,
    int hd, int key_chunk, unsigned int seed, unsigned int threshold,
    int drop_on, float keep_frac, float inv_keep, void* stream) {
  if (bad_call(q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, B, Lq, Lk, nh, hd,
               key_chunk) ||
      bad_rows(dq_bs, dq_rs) || bad_rows(dk_bs, dk_rs) ||
      bad_rows(dv_bs, dv_rs)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)aflash::launch_backward(
      aflash::head_rows(q, q_bs, q_rs), aflash::head_rows(k, k_bs, k_rs),
      aflash::head_rows(v, v_bs, v_rs), kv_bias,
      aflash::Lse{static_cast<float*>(const_cast<void*>(lse))}, out, dout,
      delta, aflash::head_rows(dq, dq_bs, dq_rs),
      aflash::head_rows(dk, dk_bs, dk_rs), aflash::head_rows(dv, dv_bs, dv_rs),
      B, Lq, Lk, nh, key_chunk,
      make_dropout(seed, threshold, drop_on, keep_frac, inv_keep), stream);
}
