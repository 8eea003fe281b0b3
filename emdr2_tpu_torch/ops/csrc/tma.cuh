// Asynchronous copies into shared memory on Hopper, and the mbarriers that
// count their arrival: bulk copies of contiguous bytes (cp.async.bulk),
// tiles of a tensor map (cp.async.bulk.tensor, the Tensor Memory
// Accelerator), and the barrier operations of a ring filled that way
// (waits that trap instead of hanging). Used by the int8 decode attention
// (decode_attention.cu) and the tensor-core candidate scan
// (candidate_scan.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(arrivals)
               : "memory");
}

// Makes initialized mbarriers visible to the copy engine before a copy
// arrives on them.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both 16-byte
// aligned) by the copy engine; their arrival is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box of the two-dimensional tensor map `map` (a __grid_constant__
// kernel parameter) at element (x, y), x the inner dimension, into `dst`
// (aligned as the map's swizzle needs); elements outside the tensor arrive
// as zeros, and the whole box counts on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int x,
                                            int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity is complete. A copy that
// never lands must not hang the card: after about a second the block traps.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 31)) {
      __trap();
    }
  }
}

}  // namespace tma
