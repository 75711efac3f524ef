// Halves-packed int4 weights, shared by kernel E (int4_matmul.cu) and the
// r4 mode of kernel B (fused_depth_decode.cu).
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
