// Kernel A: S=1 grouped-query decode attention over one layer of a merged
// (L, B, T, Hkv*Dh) KV slab -- the LM backbone's per-frame decode step.
//
// Replaces: fireredtts2_tpu/ops/pallas_flash.py: flash_decode_gqa1
// (_kernel_gqa1), the Pallas TPU kernel that walks the live slab chunks of
// each stream in order on one core with a DMA ring and an fp32 online
// softmax.
//
// What bounds it on an H100: bytes. Each query row does 2*Dh flops per slab
// slot it reads (2 bytes per element), far below the ~295 flop/byte the card
// needs before compute matters, so the kernel's cost is reading the live
// K/V window once. At the flagship (Hkv=2, Dh=128, bf16) that is 1 KB per
// slot per stream, e.g. ~3 MB per layer for a 3000-slot window.
//
// How the design answers that:
// - split-KV: one block per (KV split of 128 slots, kv head, stream), so a
//   single stream at B=1 still spreads its window over many SMs; a second
//   small kernel merges the splits' (m, l, acc) partials. TPU grid steps run
//   in order and carry the softmax state; GPU blocks do not, hence the merge.
//   Short splits also keep each block's walk short: with the slab cold in
//   L2, a block's time is rounds of device-memory latency, one per step.
// - each block reads only the slots of its split that are inside the
//   stream's window [q_start, q_end) and inside the batch's live chunk range
//   (the chunk clamps of pallas_flash.py:_scalars, so nothing past T is ever
//   read). Splits outside the window exit at once and mark their partial
//   empty (m = -inf); the merge skips them. No slab byte is read twice.
// - the G query rows of a kv head (query head h -> kv head h // G, as in
//   q.reshape(B, S, Hkv, G, D)) share every K/V load.
// - loads are 16 bytes a lane: for K, four lanes cover one slot's Dh
//   elements and a warp eight slots per step; for V, Dh/8 lanes cover one
//   slot (each owns 8 head dims) and a warp 32*8/Dh slots per step.
// - fp32 scores and softmax; probabilities are rounded to the V dtype (bf16)
//   before the PV product, as pallas_flash.py:584-587 does; the denominator
//   sums the unrounded fp32 probabilities.
//
// A stream whose window is empty (q_end <= q_start) gets zeros here, where
// the TPU kernel would return the mean of V over the visited chunks; the LM
// never sends one (every stream attends at least to its own fresh slot).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 128;           // slab slots per block
constexpr int kMaxG = 8;              // query heads per kv head
constexpr int kLanesPerSlot = 4;
constexpr int kSlotsPerStep = 32 / kLanesPerSlot;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Live chunk range [lo, hi) of the batch, clamped to the slab
// (fireredtts2_tpu/ops/pallas_flash.py:_scalars with t_cap = T).
__device__ __forceinline__ void chunk_range(const int* live_lo,
                                            const int* live_hi, int T, int C,
                                            int* lo, int* hi) {
  const int nchunks = T / C;
  int nc = max((*live_hi + C - 1) / C, 1);
  int c0 = max(*live_lo, 0) / C;
  nc = min(nc, nchunks);
  c0 = min(c0, nchunks - 1);
  nc = max(nc, c0 + 1);
  *lo = c0 * C;
  *hi = nc * C;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
gqa1_split_kernel(const __nv_bfloat16* __restrict__ q,    // (B, Hq, DH)
                  const __nv_bfloat16* __restrict__ k,    // (B, T, Hkv*DH)
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ q_start,        // (B,)
                  const int* __restrict__ q_end,          // (B,)
                  const int* __restrict__ live_lo,        // () batch min start
                  const int* __restrict__ live_hi,        // () batch max end
                  float* __restrict__ part_m,             // (B, Hkv, NS, G)
                  float* __restrict__ part_l,
                  float* __restrict__ part_acc,           // (..., G, DH)
                  int Hkv, int G, int T, int C, float scale) {
  constexpr int kVecPerLane = DH / 8 / kLanesPerSlot;
  constexpr int kVecRow = DH / 8;                 // lanes per V slot
  constexpr int kVSlotsPerWarp = 32 / kVecRow;
  __shared__ float q_sh[kMaxG][DH];
  __shared__ float p_sh[kMaxG][kSplit];
  __shared__ float red[kWarps][kMaxG][DH];

  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x;
  const int W = Hkv * DH;
  const size_t part = ((size_t)(b * Hkv + kh) * NS + s) * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int lo, hi;
  chunk_range(live_lo, live_hi, T, C, &lo, &hi);
  lo = max(max(lo, q_start[b]), s * kSplit);
  hi = min(min(hi, q_end[b]), (s + 1) * kSplit);
  if (lo >= hi) {
    if (tid < G) {
      part_m[part + tid] = -INFINITY;
      part_l[part + tid] = 0.f;
    }
    return;
  }
  const int n = hi - lo;

  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    q_sh[g][d] = __bfloat162float(q[((size_t)b * Hkv * G + kh * G + g) * DH + d]);
  }
  __syncthreads();

  // Scores. Lane part p of a slot covers the 8-element groups p, p+4, ...,
  // so the four parts read q_sh from four different banks.
  const int sub = lane / kLanesPerSlot, p = lane % kLanesPerSlot;
  const __nv_bfloat16* kb = k + (size_t)b * T * W + kh * DH;
  for (int j0 = warp * kSlotsPerStep; j0 < n; j0 += kWarps * kSlotsPerStep) {
    const int j = j0 + sub;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    if (j < n) {
      const uint4* row = reinterpret_cast<const uint4*>(kb + (size_t)(lo + j) * W);
      uint4 u[kVecPerLane];
#pragma unroll
      for (int i = 0; i < kVecPerLane; ++i) u[i] = row[p + kLanesPerSlot * i];
#pragma unroll
      for (int i = 0; i < kVecPerLane; ++i) {
        const int base = (p + kLanesPerSlot * i) * 8;
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              acc[g] = fmaf(f.x, q_sh[g][base + 2 * e], acc[g]);
              acc[g] = fmaf(f.y, q_sh[g][base + 2 * e + 1], acc[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 1);
      acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], 2);
    }
    if (j < n && p == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) p_sh[g][j] = acc[g] * scale;
      }
    }
  }
  __syncthreads();

  // Softmax statistics of this split, one warp per query head.
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_sh[g][j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p_sh[g][j] - mx);
      sum += e;
      p_sh[g][j] = bf16_round(e);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      part_m[part + g] = mx;
      part_l[part + g] = sum;
    }
  }
  __syncthreads();

  // P @ V: lane owns head dims [8 vi, 8 vi + 8) of one slot per step.
  const int vi = lane % kVecRow;
  float av[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) av[g][e] = 0.f;
  }
  const __nv_bfloat16* vb = v + (size_t)b * T * W + kh * DH + vi * 8;
#pragma unroll 4
  for (int j = warp * kVSlotsPerWarp + lane / kVecRow; j < n;
       j += kWarps * kVSlotsPerWarp) {
    const uint4 u = *reinterpret_cast<const uint4*>(vb + (size_t)(lo + j) * W);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
    float f[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 t = __bfloat1622float2(h2[e]);
      f[2 * e] = t.x;
      f[2 * e + 1] = t.y;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float pj = p_sh[g][j];
#pragma unroll
        for (int e = 0; e < 8; ++e) av[g][e] = fmaf(pj, f[e], av[g][e]);
      }
    }
  }
  // Sum over the warp's slots (lanes with the same vi), then over warps.
#pragma unroll
  for (int o = kVecRow; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        av[g][e] += __shfl_xor_sync(0xffffffffu, av[g][e], o);
    }
  }
  if (lane < kVecRow) {
    // unrolled over kMaxG so that av stays in registers
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp][g][vi * 8 + e] = av[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += red[w][g][d];
    part_acc[(part + g) * DH + d] = acc;
  }
}

// Merge the splits of one (stream, query head): weights exp(m_s - M).
template <int DH>
__global__ void __launch_bounds__(DH)
gqa1_combine_kernel(const float* __restrict__ part_m,
                    const float* __restrict__ part_l,
                    const float* __restrict__ part_acc,
                    __nv_bfloat16* __restrict__ out,      // (B, Hq, DH)
                    int Hkv, int G, int NS) {
  const int bh = blockIdx.x, d = threadIdx.x;
  const int Hq = Hkv * G;
  const int b = bh / Hq, h = bh % Hq, kh = h / G, g = h % G;
  const size_t base = (size_t)(b * Hkv + kh) * NS;
  float M = -INFINITY;
  for (int s = 0; s < NS; ++s) M = fmaxf(M, part_m[(base + s) * G + g]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < NS; ++s) {
    const size_t i = (base + s) * G + g;
    const float m = part_m[i];
    if (m == -INFINITY) continue;     // split outside the window: no partial
    const float w = expf(m - M);
    l = fmaf(w, part_l[i], l);
    acc = fmaf(w, part_acc[i * DH + d], acc);
  }
  out[(size_t)bh * DH + d] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
}

template <int DH>
void launch(const void* q, const void* k, const void* v, const int* q_start,
            const int* q_end, const int* live_lo, const int* live_hi,
            float* part_m, float* part_l,
            float* part_acc, void* out, int B, int Hkv, int G, int T, int C,
            int NS, float scale, cudaStream_t stream) {
  gqa1_split_kernel<DH><<<dim3(NS, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_start, q_end, live_lo, live_hi,
      part_m, part_l,
      part_acc, Hkv, G, T, C, scale);
  gqa1_combine_kernel<DH><<<B * Hkv * G, DH, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<__nv_bfloat16*>(out), Hkv, G, NS);
}

}  // namespace

extern "C" int frt_gqa1_split_size() { return kSplit; }

extern "C" int frt_gqa1_max_group() { return kMaxG; }

// q (B, Hkv*G, Dh) bf16; k, v: one layer of the slab, (B, T, Hkv*Dh) bf16;
// q_start/q_end (B,) int32; live_lo/live_hi () int32 (batch min start, max
// end);
// part_* scratch of NS = ceil(T / split) splits; out (B, Hkv*G, Dh) bf16.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int frt_flash_decode_gqa1(const void* q, const void* k, const void* v,
                                     const int* q_start, const int* q_end,
                                     const int* live_lo, const int* live_hi,
                                     float* part_m, float* part_l,
                                     float* part_acc, void* out, int B, int Hkv,
                                     int G, int Dh, int T, int C, int NS,
                                     float scale, void* stream) {
  if (G < 1 || G > kMaxG || C < 1 || T % C != 0 || NS * kSplit < T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 128) {
    launch<128>(q, k, v, q_start, q_end, live_lo, live_hi, part_m, part_l,
                part_acc, out, B,
                Hkv, G, T, C, NS, scale, st);
  } else if (Dh == 64) {
    launch<64>(q, k, v, q_start, q_end, live_lo, live_hi, part_m, part_l,
               part_acc, out, B,
               Hkv, G, T, C, NS, scale, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
