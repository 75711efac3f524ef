// Kernel E: x (M, K) @ W with W int4, halves-packed, group-wise scales.
//
// Replaces: fireredtts2_tpu/ops/pallas_int4.py: int4_matmul
// (_int4_mm_kernel), the Pallas TPU kernel that streams the packed weights
// in output-column tiles, unpacks them in VMEM with float arithmetic and
// feeds a bf16 dot with fp32 accumulation.
//
// What bounds it on an H100: bytes, in principle. On the int4 depth path
// M = B*S is 1-16, so each weight byte (two weights) meets at most 32
// multiply-adds; the card needs ~295 operations per byte before compute
// matters. The least time is the packed weights plus their scales read
// once: for the qwen-200m gate (1536 x 8960), 6.9 MB + 0.43 MB, ~2.2 us at
// 3.35 TB/s. What stands in the way is the work per weight: unpacking and
// scaling each one, then M multiply-adds on it. The first design (a warp a
// column, scalar fp32 FMAs) spent M instructions a weight and lost to
// PyTorch's tinygemm at M = 16.
//
// How the design answers that: bf16 tensor cores, mma.sync m16n8k16, at
// every M (at M = 1 it wastes 15 of 16 rows of each product and still beats
// the scalar design, whose FMAs it replaces by one mma per 128 weights).
// - The weights are read output-major, (O, K/2) packed bytes and (O, K/g)
//   fp32 scales, laid out once by the caller (ops/int4.py:
//   output_major_int4). A warp owns one n-tile of 8 output columns; lane
//   (gq, t) loads 16 bytes of column n0 + gq: packed rows r..r+15 with
//   r = 64 kb + 16 t, i.e. input rows r..r+15 (low nibbles) and
//   K/2 + r..K/2 + r + 15 (high nibbles).
// - In registers those bytes become the B fragments of eight mma, four
//   k-steps on each half (int4_unpack.cuh: frt_int4_bfrags): each nibble a
//   float by a bit trick (no conversion instruction), times its group's
//   scale in fp32, rounded to bf16 -- W = bf16(q * s) per element, as the TPU kernel computes it.
// - A product sums over k in any order that A and B share, so the k-slots
//   of lane t map to input rows 16 t + 4 j + {0, 1, 2, 3} of k-step j: the
//   lane's A fragments are then x[row][r..r+15] and x[row][K/2 + r..], four
//   16-byte loads a row, with no shuffle. x's rows are the A rows, zero past
//   M (M <= 16 is one m-tile; 17..32 two, sharing each unpacked B fragment;
//   more rows take further blocks).
// - Each warp issues the loads of 4 k-blocks (4 x 16 bytes a lane) before
//   it unpacks any, so several loads are in flight; the warps of a block
//   split K (1-8 ways, from K) over the same n-tiles and sum their fp32
//   accumulators through shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int4_unpack.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kKB = 64;               // packed rows per k-block (16 a lane)
constexpr int kPF = 4;                // k-blocks a warp loads before use

// The A fragments' source for one x row: x[row][r..r+15] and
// x[row][K/2 + r..K/2 + r + 15] as 16 words of two bf16; zero past M or K.
__device__ __forceinline__ void load_x_row(const __nv_bfloat16* __restrict__ x,
                                           int row, int M, int K, int r,
                                           bool r_ok, uint32_t w[16]) {
  uint4 u[4] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0),
                make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (row < M && r_ok) {
    const __nv_bfloat16* p = x + (size_t)row * K + r;
    u[0] = __ldg(reinterpret_cast<const uint4*>(p));
    u[1] = __ldg(reinterpret_cast<const uint4*>(p + 8));
    u[2] = __ldg(reinterpret_cast<const uint4*>(p + K / 2));
    u[3] = __ldg(reinterpret_cast<const uint4*>(p + K / 2 + 8));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[4 * i] = u[i].x;
    w[4 * i + 1] = u[i].y;
    w[4 * i + 2] = u[i].z;
    w[4 * i + 3] = u[i].w;
  }
}

// MT m-tiles of 16 rows a block (grid.y covers M); grid.x covers the
// n-tiles, kWarps / KS of them a block, each split KS ways over K.
template <int MT>
__global__ void __launch_bounds__(kWarps * 32)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,     // (M, K)
                const signed char* __restrict__ wt,      // (O, K/2)
                const float* __restrict__ st,            // (O, K/g)
                __nv_bfloat16* __restrict__ out,         // (M, O)
                int M, int K, int O, int g, int KS) {
  __shared__ float red[kWarps][MT][4][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int NT = kWarps / KS, nt = warp / KS, ks = warp % KS;
  const int n0 = (blockIdx.x * NT + nt) * 8;
  const int col = n0 + gq;
  const bool col_ok = col < O;
  const int m0 = blockIdx.y * 16 * MT;
  const int K2 = K / 2, ng = K / g;
  const int nkb = (K2 + kKB - 1) / kKB;

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  }

  for (int kb0 = ks; kb0 < nkb; kb0 += KS * kPF) {
    uint4 w[kPF];
    float s_lo[kPF], s_hi[kPF];
#pragma unroll
    for (int i = 0; i < kPF; ++i) {      // the loads first, all in flight
      const int r = (kb0 + i * KS) * kKB + 16 * t;
      w[i] = make_uint4(0, 0, 0, 0);
      s_lo[i] = s_hi[i] = 0.f;
      if (kb0 + i * KS < nkb && col_ok && r < K2) {
        w[i] = __ldg(reinterpret_cast<const uint4*>(wt + (size_t)col * K2 + r));
        s_lo[i] = __ldg(st + (size_t)col * ng + r / g);
        s_hi[i] = __ldg(st + (size_t)col * ng + (K2 + r) / g);
      }
    }
#pragma unroll
    for (int i = 0; i < kPF; ++i) {
      if (kb0 + i * KS >= nkb) break;    // the same for the whole warp
      const int r = (kb0 + i * KS) * kKB + 16 * t;
      const bool r_ok = r < K2;
      uint32_t blo[4][2], bhi[4][2];
      frt_int4_bfrags(w[i], s_lo[i], s_hi[i], blo, bhi);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = m0 + mt * 16 + gq;
        uint32_t xa[16], xb[16];         // rows gq and gq + 8
        load_x_row(x, row, M, K, r, r_ok, xa);
        load_x_row(x, row + 8, M, K, r, r_ok, xb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t al[4] = {xa[2 * j], xb[2 * j], xa[2 * j + 1],
                                  xb[2 * j + 1]};
          const uint32_t ah[4] = {xa[8 + 2 * j], xb[8 + 2 * j],
                                  xa[8 + 2 * j + 1], xb[8 + 2 * j + 1]};
          frt_mma_bf16(acc[mt], al, blo[j][0], blo[j][1]);
          frt_mma_bf16(acc[mt], ah, bhi[j][0], bhi[j][1]);
        }
      }
    }
  }

  // Sum the KS warps of each n-tile; the first writes bf16.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][mt][e][lane] = acc[mt][e];
  }
  __syncthreads();
  if (ks != 0) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = 0.f;
      for (int k2 = 0; k2 < KS; ++k2) v += red[nt * KS + k2][mt][e][lane];
      const int row = m0 + mt * 16 + gq + (e >= 2 ? 8 : 0);
      const int c = n0 + 2 * t + (e & 1);
      if (row < M && c < O) out[(size_t)row * O + c] = __float2bfloat16(v);
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
  const int nkb = (K / 2 + kKB - 1) / kKB;
  int KS = 1;                          // K split: <= kPF k-blocks a warp
  while (KS < kWarps && KS * kPF < nkb) KS *= 2;
  const int ntiles = (O + 7) / 8, NT = kWarps / KS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const signed char*>(wt);
  const auto* sp = static_cast<const float*>(st);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (M <= 16) {
    int4_matmul_kernel<1><<<dim3((ntiles + NT - 1) / NT, 1), kWarps * 32, 0, s>>>(
        xp, wp, sp, op, M, K, O, g, KS);
  } else {
    int4_matmul_kernel<2><<<dim3((ntiles + NT - 1) / NT, (M + 31) / 32),
                         kWarps * 32, 0, s>>>(xp, wp, sp, op, M, K, O, g, KS);
  }
  return (int)cudaGetLastError();
}
