// The grid-wide barrier of the persistent cooperative kernels: kernel B
// (fused_depth_decode.cu) separates its phases with it, and kernel P
// (gemv_probe.cu) measures it, so both run this one barrier. Kernel A
// (flash_decode_gqa1.cu) counts its merges with the acquire-release add.
//
// Four words: bar[0] counts arrivals through a launch, bar[1] is the flag
// of the barriers whose last block works before it lets the others go,
// bar[2] counts the blocks that have left the launch, bar[3] counts every
// barrier block 0 has passed, over all launches (for tests and reports).
// A block's n-th barrier is passed once bar[0] reaches n * gridDim.x: each
// block adds one (release) and spins on an acquire load of bar[0], with no
// sleep, so a barrier costs the last block one round trip to L2 and the
// others one poll. The last block to leave resets bar[0..2], so launches
// may follow each other (and a CUDA graph may replay them) with no reset
// from the host. The cooperative launch makes every block resident, so
// spinning is safe.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned frt_ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void frt_st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned frt_atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// One block's view of the barrier words: n = barriers it has passed in
// this launch (every thread keeps the same count).
struct FrtGrid {
  unsigned* bar;
  unsigned n;
};

// Threads [0, n) of the block, on hardware barrier 1 (n a multiple of 32):
// a block whose other warps never stop at a barrier (kernel B's producer).
__device__ __forceinline__ void frt_bar_sync(int n) {
  asm volatile("bar.sync 1, %0;" :: "r"(n) : "memory");
}

// Thread 0: the block's arrival at barrier g.n (already counted); returns
// whether the block arrived last.
__device__ __forceinline__ bool frt_grid_arrive(const FrtGrid& g) {
  return frt_atom_add_acq_rel(g.bar, 1u) == g.n * gridDim.x - 1;
}

// Thread 0: until every block has arrived at barrier g.n.
__device__ __forceinline__ void frt_grid_wait(const FrtGrid& g) {
  while (frt_ld_acquire(g.bar) < g.n * gridDim.x) {
  }
}

// A barrier whose last block works before the others go: thread 0 of the
// last block releases barrier g.n, the others' thread 0 wait for it.
__device__ __forceinline__ void frt_grid_release_flag(const FrtGrid& g) {
  frt_st_release(g.bar + 1, g.n);
}

__device__ __forceinline__ void frt_grid_wait_flag(const FrtGrid& g) {
  while (frt_ld_acquire(g.bar + 1) < g.n) {
  }
}

// Thread 0, after the block's last barrier of the launch.
__device__ __forceinline__ void frt_grid_exit(const FrtGrid& g) {
  if (blockIdx.x == 0) atomicAdd(g.bar + 3, g.n);
  if (atomicAdd(g.bar + 2, 1u) == gridDim.x - 1) {
    atomicExch(g.bar, 0u);
    atomicExch(g.bar + 1, 0u);
    atomicExch(g.bar + 2, 0u);
  }
}

// Grid-wide barrier among threads [0, n) of every block.
__device__ __forceinline__ void grid_sync_part(FrtGrid& g, int n) {
  frt_bar_sync(n);
  ++g.n;
  if (threadIdx.x == 0) {
    frt_grid_arrive(g);
    frt_grid_wait(g);
  }
  frt_bar_sync(n);
}

// Grid-wide barrier among all threads.
__device__ __forceinline__ void grid_sync(FrtGrid& g) {
  __syncthreads();
  ++g.n;
  if (threadIdx.x == 0) {
    frt_grid_arrive(g);
    frt_grid_wait(g);
  }
  __syncthreads();
}
