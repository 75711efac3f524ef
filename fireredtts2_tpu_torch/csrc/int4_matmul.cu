// Kernel E: x (M, K) @ W with W int4, halves-packed, group-wise scales.
//
// Replaces: fireredtts2_tpu/ops/pallas_int4.py: int4_matmul
// (_int4_mm_kernel), the Pallas TPU kernel that streams the packed weights
// in output-column tiles, unpacks them in VMEM with float arithmetic and
// feeds a bf16 dot with fp32 accumulation.
//
// What bounds it on an H100: bytes. On the int4 depth path M = B*S is 1-16,
// so each weight byte (two weights) meets at most 32 multiply-adds; the card
// needs ~295 operations per byte before compute matters. The least time is
// the packed weights plus their scales read once: for the qwen-200m gate
// (1536 x 8960) at M = 1, 6.9 MB + 0.43 MB, ~2.2 us at 3.35 TB/s.
//
// How the design answers that:
// - the weights are stored output-major, (O, K/2) packed bytes and (O, K/g)
//   fp32 scales, laid out once by the caller (ops/int4.py:
//   output_major_int4), so one warp owns one output column and reads its row
//   with contiguous 16-byte loads, 32 weights a lane;
// - nibbles are unpacked with integer shifts in registers
//   (csrc/int4_unpack.cuh), dequantised as q * scale in fp32 and rounded to
//   bf16, as the TPU kernel does;
// - the activations of a block's 16 rows are staged in shared memory, one
//   chunk of 512 packed rows (1024 inputs) at a time, and shared by the
//   block's 8 warps (8 output columns);
// - x is bf16, products are summed in fp32 per lane, then over the warp.
//
// The TPU kernel pads M to 8 sublanes; here a block takes up to 16 rows of x
// and the grid's y dimension covers larger M.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "int4_unpack.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMT = 16;               // rows of x per block
constexpr int kKC = 512;              // packed rows per chunk: one uint4 a lane

__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,   // (M, K)
                   const signed char* __restrict__ wt,    // (O, K/2)
                   const float* __restrict__ st,          // (O, K/g)
                   __nv_bfloat16* __restrict__ out,       // (M, O)
                   int M, int K, int O, int g) {
  __shared__ __align__(16) __nv_bfloat16 xs[kMT][2 * kKC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kMT;
  const int mt = min(kMT, M - m0);
  const int K2 = K / 2, ng = K / g;

  float acc[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < K2; c0 += kKC) {
    const int n = min(kKC, K2 - c0);
    const int v8 = n / 8;             // 16-byte vectors of x per side
    __syncthreads();
    for (int i = tid; i < mt * 2 * v8; i += kThreads) {
      const int m = i / (2 * v8), rem = i % (2 * v8);
      const int side = rem / v8, j = rem % v8;
      *reinterpret_cast<uint4*>(&xs[m][side * kKC + j * 8]) =
          *reinterpret_cast<const uint4*>(
              x + (size_t)(m0 + m) * K + side * K2 + c0 + j * 8);
    }
    __syncthreads();
    const int r = lane * 16;
    if (o < O && r < n) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(
          wt + (size_t)o * K2 + c0 + r));
      const float s_lo = __ldg(st + (size_t)o * ng + (c0 + r) / g);
      const float s_hi = __ldg(st + (size_t)o * ng + (K2 + c0 + r) / g);
      float wl[16], wh[16];
      frt_int4_unpack16(w, s_lo, s_hi, wl, wh);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        if (m < mt) {
          float a = acc[m];
#pragma unroll
          for (int part = 0; part < 4; ++part) {
            const int side = part >> 1, half8 = part & 1;
            float f[8];
            frt_bf16x8(*reinterpret_cast<const uint4*>(
                           &xs[m][side * kKC + r + half8 * 8]), f);
            const float* wp = (side ? wh : wl) + half8 * 8;
#pragma unroll
            for (int e = 0; e < 8; ++e) a = fmaf(wp[e], f[e], a);
          }
          acc[m] = a;
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], s);
  }
  if (o < O && lane == 0) {
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      if (m < mt) out[(size_t)(m0 + m) * O + o] = __float2bfloat16(acc[m]);
    }
  }
}

}  // namespace

// x (M, K) bf16; wt (O, K/2) int8 output-major packed; st (O, K/g) fp32;
// out (M, O) bf16. K % 32 == 0, g % 16 == 0 and K % g == 0, so that the 16
// rows of one load share a scale group on either nibble side.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int frt_int4_matmul(const void* x, const void* wt, const void* st,
                               void* out, int M, int K, int O, int g,
                               void* stream) {
  if (M < 1 || O < 1 || K % 32 != 0 || g < 16 || g % 16 != 0 || K % g != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((O + kWarps - 1) / kWarps, (M + kMT - 1) / kMT);
  int4_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const signed char*>(wt),
      static_cast<const float*>(st), static_cast<__nv_bfloat16*>(out), M, K, O,
      g);
  return (int)cudaGetLastError();
}
