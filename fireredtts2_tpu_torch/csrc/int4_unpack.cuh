// Halves-packed int4 weights, shared by kernel P (gemv_probe.cu), which
// unpacks to floats, and kernels B (fused_depth_decode.cu, r4 mode) and E
// (int4_matmul.cu), which unpack straight into tensor-core fragments.
//
// Packed byte r of a weight row holds input row r in its low nibble and
// input row r + K/2 in its high nibble, both signed (-8..7), as
// fireredtts2_tpu/models/lm/transformer.py: quantize_transformer_int4 and
// fireredtts2_tpu/ops/pallas_depth.py: _quant4 pack them. The TPU kernels
// unpack with float arithmetic because Mosaic has no vector shift; the card
// has integer shifts, so this unpacks in registers with them.
//
// Dequantisation is q * scale in fp32, rounded to bf16, as the TPU kernels
// do before their bf16 dot (pallas_int4.py:62-63).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

__device__ __forceinline__ float frt_bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One 16-byte load of packed bytes -> 16 low-nibble weights (rows r..r+15)
// and 16 high-nibble weights (rows r+K/2..r+K/2+15), each dequantised with
// its group's scale and rounded to bf16.
__device__ __forceinline__ void frt_int4_unpack16(const uint4 w, float s_lo,
                                                  float s_hi, float lo[16],
                                                  float hi[16]) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int byte = (int)(signed char)((words[i] >> (8 * j)) & 0xffu);
      const int l = ((byte & 15) ^ 8) - 8;   // sign-extended low nibble
      const int h = byte >> 4;               // arithmetic: the high nibble
      lo[4 * i + j] = frt_bf16_round((float)l * s_lo);
      hi[4 * i + j] = frt_bf16_round((float)h * s_hi);
    }
  }
}

// Eight bf16 values of one 16-byte load, as floats.
__device__ __forceinline__ void frt_bf16x8(const uint4 u, float f[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h2[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// 16 packed bytes of one weight row (packed rows r..r+15; word j holds rows
// r+4j..r+4j+3) -> the bf16 fragments of k-step j on the low and the high
// nibble side, each weight bf16(q * scale) with the product in fp32. The
// nibble becomes a float without a conversion instruction: q + 8 in the low
// mantissa bits of 2^23, minus 2^23 + 8, is q exactly.
__device__ __forceinline__ void frt_int4_bfrags(const uint4 w, float s_lo,
                                                float s_hi, uint32_t blo[4][2],
                                                uint32_t bhi[4][2]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t v = words[j] ^ 0x88888888u;       // each nibble q + 8
    float lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e] = (__uint_as_float(0x4B000000u | ((v >> (8 * e)) & 15u)) -
               8388616.f) * s_lo;
      hi[e] = (__uint_as_float(0x4B000000u | ((v >> (8 * e + 4)) & 15u)) -
               8388616.f) * s_hi;
    }
    blo[j][0] = frt_pack_bf16(lo[0], lo[1]);
    blo[j][1] = frt_pack_bf16(lo[2], lo[3]);
    bhi[j][0] = frt_pack_bf16(hi[0], hi[1]);
    bhi[j][1] = frt_pack_bf16(hi[2], hi[3]);
  }
}
