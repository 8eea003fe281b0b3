// Counter-hash attention-dropout mask shared by the flash attention kernels.
//
// Replaces: emdr2_tpu/ops/hashing.py:murmur_fin and
// emdr2_tpu/ops/fid_attention.py:_keep_mask (inlined device code in the TPU
// kernels, not a kernel of its own). The keep bit of score element
// (row r, column col) of (batch*head bh, key chunk j) is
//   murmur_fin((r*0x9E3779B1) ^ (col*0x85EBCA77)
//              ^ (seed + bh*0x27D4EB2F + j*0x165667B1)) >= threshold
// in wrapping uint32 arithmetic, with threshold = min(int(rate*2^32),
// 2^32-1) computed by the caller. A pure function of its coordinates, so the
// forward and backward kernels regenerate the same mask, bit for bit the
// TPU kernels' mask for the same seed. Callers pass logical coordinates
// (col within the key chunk, j the chunk index), never tile coordinates.

#pragma once

#include <stdint.h>

// The dropout arguments every attention kernel takes, made by the host
// entry points from the wrapper's (seed, threshold, on, 1-rate, 1/(1-rate)).
struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  int on;            // rate > 0
  float keep_frac;   // 1 - rate (1 when off)
  float inv_keep;    // 1 / (1 - rate) (1 when off)
};

inline Dropout make_dropout(unsigned int seed, unsigned int threshold, int on,
                            float keep_frac, float inv_keep) {
  Dropout d;
  d.seed = seed;
  d.threshold = threshold;
  d.on = on;
  d.keep_frac = on ? keep_frac : 1.0f;
  d.inv_keep = on ? inv_keep : 1.0f;
  return d;
}

__device__ __forceinline__ uint32_t murmur_fin(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh,
                                             uint32_t j, uint32_t r,
                                             uint32_t col,
                                             uint32_t threshold) {
  uint32_t x = (r * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x ^= seed + bh * 0x27D4EB2Fu + j * 0x165667B1u;
  return murmur_fin(x) >= threshold;
}
