// Bulk copies from global to shared memory that complete on an mbarrier,
// shared by kernels A (flash_decode_gqa1.cu: a block's whole K/V split in
// flight at once as TMA tensor copies, and the merge's partials) and B
// (fused_depth_decode.cu: the producer warp's ring of weight tiles).
//
// A bulk copy's size and both addresses are multiples of 16 bytes; a
// tensor copy's box is the tensor map's, and its destination is aligned as
// the map's swizzle needs (1024 bytes for 128-byte swizzle). A barrier
// expects its bytes (frt_mbar_expect_tx, which also arrives once) before or
// while the copies run; its phase completes when every expected arrival
// and byte has come. After mbarrier.init, the initialising thread runs
// fence.mbarrier_init before the copies may see the barrier.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t frt_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void frt_mbar_init(uint32_t a, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(a), "r"(n) : "memory");
}

__device__ __forceinline__ void frt_mbar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(a) : "memory");
}

__device__ __forceinline__ void frt_mbar_expect_tx(uint32_t a, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(a), "r"(bytes) : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void frt_mbar_wait(uint32_t a, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(a), "r"(parity) : "memory");
}

__device__ __forceinline__ void frt_bulk_copy(uint32_t dst, const void* src,
                                              unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" :: "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One box of a 2-D tensor map (cp.async.bulk.tensor, the TMA unit) at
// element coordinates (c0 inner, c1 outer); bytes past the tensor's bounds
// arrive as zeros and count toward the barrier's bytes.
__device__ __forceinline__ void frt_tma_load_2d(uint32_t dst, const void* map,
                                                int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Fetch a tensor map's descriptor ahead of its first copy.
__device__ __forceinline__ void frt_prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
