// Tensor-core helpers shared by kernels A (flash_decode_gqa1.cu), B
// (fused_depth_decode.cu), C (flash_decode_update.cu) and E
// (int4_matmul.cu): mma.sync m16n8k16 bf16 with fp32 accumulation,
// m16n8k32 s8 with int32 accumulation, ldmatrix, 16-byte cp.async with
// zero fill, and the base-2 exponential of the flash softmaxes (A, C).
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// lane = 4 * gq + t (gq = lane / 4, t = lane % 4):
// - A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//   a0 (row gq, cols 2t, 2t+1), a1 (row gq+8, cols 2t, 2t+1),
//   a2 (row gq, cols 2t+8, 2t+9), a3 (row gq+8, cols 2t+8, 2t+9);
// - B (16 x 8, k by n), two registers: b0 (k 2t, 2t+1; n gq),
//   b1 (k 2t+8, 2t+9; n gq);
// - C/D (16 x 8 fp32): c0, c1 (row gq, cols 2t, 2t+1), c2, c3 (row gq+8).
// The lower 16 bits of a register hold the element of the lower index.
// m16n8k32 s8 takes four int8 a register: A a0 (row gq, k 4t..4t+3), a1
// (row gq+8, the same k), a2 (row gq, k 16+4t..), a3 (row gq+8, k 16+4t..);
// B b0 (k 4t..4t+3; n gq), b1 (k 16+4t..; n gq); C as above, in int32.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void frt_mma_bf16(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void frt_mma_s8(int c[4], const uint32_t a[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one register of two bf16 (x in the lower half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t frt_pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i.
__device__ __forceinline__ void frt_ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void frt_ldmatrix_x4_trans(uint32_t r[4],
                                                      uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes from global to shared memory, bypassing L1; src_bytes = 0 reads
// nothing and fills the 16 bytes with zeros.
__device__ __forceinline__ void frt_cp_async16(uint32_t dst, const void* src,
                                               int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void frt_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

template <int N>
__device__ __forceinline__ void frt_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 2^x in one MUFU instruction (denormal results flush to 0; 2^-inf = 0).
__device__ __forceinline__ float frt_fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
