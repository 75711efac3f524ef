// The grid-wide barrier of the persistent cooperative kernels: kernel B
// (fused_depth_decode.cu) separates its phases with it, and kernel P
// (gemv_probe.cu) measures it, so both run this one barrier.

#pragma once

#include <cuda_runtime.h>

// Grid-wide barrier. The cooperative launch makes every block resident, so
// spinning is safe. bar[0] counts arrivals, bar[1] is the generation; the
// last block to arrive resets the count, then bumps the generation.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}
