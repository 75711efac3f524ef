// Kernel B: one frame's depth chain -- 16 micro-steps of the qwen-200m depth
// decoder, each with top-k sampling -- as ONE persistent cooperative launch.
//
// Replaces: fireredtts2_tpu/ops/pallas_depth.py: fused_depth_decode
// (_depth_chain_kernel), the Pallas TPU kernel that keeps the depth
// decoder's int8/int4 weights in VMEM (or streams them from HBM behind a DMA
// ring) and runs the whole chain in one pallas_call.
//
// What bounds it on an H100: bytes. Every micro-step reads all of the
// decoder's weights (187 M int8 at qwen-200m, plus the bf16 projection and
// one bf16 audio-head slice) and does ~2 operations per weight per stream:
// at B <= 8 that is far below the ~295 operations a byte the card needs
// before compute matters. The working set (~200 MB) does not fit the 50 MB
// L2, so each micro-step streams the weights from device memory: ~3.2 GB a
// frame, ~0.95 ms at 3.35 TB/s. The eager plain version pays ~4,000 launches
// a frame instead.
//
// How the design answers that:
// - one launch per frame: a persistent kernel, one block of 512 threads per
//   SM (the grid the occupancy query gives), started with
//   cudaLaunchCooperativeKernel so that all blocks are resident and a grid
//   barrier (an atomic counter and generation word) may separate phases.
//   The TPU kernel's sequential grid becomes a loop over the micro-steps
//   inside the kernel; each micro-step has 2 + 4 * L phases (input
//   projection; per layer: norm + QKV, attention + wo, norm + gate/up, down;
//   then norm + logits and sampling), each ending in a grid barrier;
// - every matrix is stored output-major, (out, in) (int4: (out, in/2)
//   packed bytes and (out, in/g) scales), by ops/depth_chain.py:
//   prepare_depth_chain, so a warp owns up to 4 output rows and streams them
//   with contiguous 16-byte loads; the rows of a matrix are split evenly
//   over all warps of the grid;
// - a phase's input activations (at most B x 8960 bf16, or int8 for the a8
//   modes) are staged once per block in shared memory and shared by the
//   block's 16 warps and a warp's 4 rows, so that activation reads stay
//   well below the weight stream;
// - row-wise norms, the activation quantisation of the a8 modes and the
//   attention over <= 16 slots are recomputed by every block while it stages
//   its input (cheap), which saves a grid barrier each; block 0 alone writes
//   the fresh K/V row into the 16-slot store;
// - intermediates (h, qkv, the MLP activation, the K/V store, logits,
//   tokens) live in a small global scratch the wrapper allocates; they stay
//   in L2 and are read with ld.global.cg so no stale L1 line is seen;
// - arithmetic mirrors the TPU kernel: fp32 sums of bf16 or dequantised
//   products, rounding to bf16 where it rounds (mm8: the dot, then the
//   scale product, then the bias; down: both halves summed in fp32 before
//   the scale), int8 x int8 dots with int32 accumulation (__dp4a) for a8,
//   the exact sampling arithmetic of _kth_largest and the exponential race.
//
// Plan modes: r8 and s8 (int8 weight-only) differ on the TPU only in where
// the weights live; here both stream from device memory, so they are one
// route (kInt8). r8a8 and s8a8 are one route too (kInt8A8), and r4 is
// kInt4 (the nibble unpack is shared with kernel E, int4_unpack.cuh).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "int4_unpack.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBMax = 8;              // streams per launch
constexpr int kR = 4;                 // output rows a warp computes together
constexpr int kMaxSlots = 16;         // micro-steps (codebooks) per frame
constexpr int kDh = 128;              // head dim: 4 dims a lane
constexpr float kNeg = -1e30f;
enum Mode { kInt8 = 0, kInt8A8 = 1, kInt4 = 2 };

struct Args {
  const bf16* last_h; const int* c0; const float* noise; const int* forced;
  const bf16* proj_t; const bf16* emb; const bf16* head_t;
  const float* rcos; const float* rsin;
  const bf16* attn_norm; const bf16* mlp_norm; const bf16* final_norm;
  const bf16* bqkv;
  const signed char* wqkv; const float* wqkv_s;
  const signed char* wo; const float* wo_s;
  const signed char* mw[3]; const float* ms[3];     // gate, up, down
  int* samples; float* logits_out;
  float* h; float* qkv; bf16* t; bf16* kst; bf16* vst; int* tok;
  float* logits; unsigned* bar;
  int B, Db, Dd, Hq, Hkv, I, V, ncb, L, grp[3], mode[3], topk, greedy;
  int xs_bytes;
  float temp, eps, attn_scale;
};

__device__ __forceinline__ float bfr(float x) { return frt_bf16_round(x); }

__device__ __forceinline__ float ld_bf(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__device__ __forceinline__ void zero_acc(float a[kR][kBMax]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int b = 0; b < kBMax; ++b) a[r][b] = 0.f;
  }
}

__device__ __forceinline__ void allreduce_acc(float a[kR][kBMax], int nr, int B) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r < nr) {
#pragma unroll
      for (int b = 0; b < kBMax; ++b) {
        if (b < B) a[r][b] = warp_sum(a[r][b]);
      }
    }
  }
}

// ---- warp GEMVs over rows [o0, o0 + nr) of an output-major matrix; x is the
// staged (B, K) input. On return every lane holds the complete sums. -------

__device__ void gemv_bf16(const bf16* W, int K, int o0, int nr, const bf16* x,
                          int B, float a[kR][kBMax], int lane) {
  zero_acc(a);
  const int nc = K / 8;
  for (int c = lane; c < nc; c += 32) {
    float w[kR][8];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < nr)
        frt_bf16x8(__ldg(reinterpret_cast<const uint4*>(W + (size_t)(o0 + r) * K) + c),
                   w[r]);
    }
#pragma unroll
    for (int b = 0; b < kBMax; ++b) {
      if (b < B) {
        float xf[8];
        frt_bf16x8(*reinterpret_cast<const uint4*>(x + (size_t)b * K + c * 8), xf);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r < nr) {
#pragma unroll
            for (int e = 0; e < 8; ++e) a[r][b] = fmaf(w[r][e], xf[e], a[r][b]);
          }
        }
      }
    }
  }
  allreduce_acc(a, nr, B);
}

__device__ void gemv_i8(const signed char* W, int K, int o0, int nr,
                        const bf16* x, int B, float a[kR][kBMax], int lane) {
  zero_acc(a);
  const int nc = K / 16;
  for (int c = lane; c < nc; c += 32) {
    uint4 w[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      w[r] = r < nr ? __ldg(reinterpret_cast<const uint4*>(W + (size_t)(o0 + r) * K) + c)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int b = 0; b < kBMax; ++b) {
      if (b < B) {
        const uint4* xp = reinterpret_cast<const uint4*>(x + (size_t)b * K + c * 16);
        float xf[16];
        frt_bf16x8(xp[0], xf);
        frt_bf16x8(xp[1], xf + 8);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r < nr) {
            const unsigned wd[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                a[r][b] = fmaf((float)(signed char)(wd[i] >> (8 * j)),
                               xf[4 * i + j], a[r][b]);
            }
          }
        }
      }
    }
  }
  allreduce_acc(a, nr, B);
}

// W (O, K/2) halves-packed int4, S (O, K/g) fp32 scales.
__device__ void gemv_i4(const signed char* W, const float* S, int K, int g,
                        int o0, int nr, const bf16* x, int B,
                        float a[kR][kBMax], int lane) {
  zero_acc(a);
  const int K2 = K / 2, nc = K2 / 16, ng = K / g;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r < nr) {
      const int o = o0 + r;
      for (int c = lane; c < nc; c += 32) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(W + (size_t)o * K2) + c);
        float lo[16], hi[16];
        frt_int4_unpack16(w, __ldg(S + (size_t)o * ng + (c * 16) / g),
                          __ldg(S + (size_t)o * ng + (K2 + c * 16) / g), lo, hi);
#pragma unroll
        for (int b = 0; b < kBMax; ++b) {
          if (b < B) {
            const uint4* xl = reinterpret_cast<const uint4*>(x + (size_t)b * K + c * 16);
            const uint4* xh = reinterpret_cast<const uint4*>(x + (size_t)b * K + K2 + c * 16);
#pragma unroll
            for (int part = 0; part < 4; ++part) {
              float f[8];
              frt_bf16x8(part < 2 ? xl[part] : xh[part - 2], f);
              const float* wp = (part < 2 ? lo : hi) + (part & 1) * 8;
#pragma unroll
              for (int e = 0; e < 8; ++e) a[r][b] = fmaf(wp[e], f[e], a[r][b]);
            }
          }
        }
      }
    }
  }
  allreduce_acc(a, nr, B);
}

// int8 weights x int8 activations (the a8 modes): int32 sums per segment of
// K/nseg inputs, exact over the warp, then a = sum_seg f32(int) * xsc.
__device__ void gemv_a8(const signed char* W, int K, int nseg, int o0, int nr,
                        const signed char* xq, const float* xsc, int B,
                        float a[kR][kBMax], int lane) {
  zero_acc(a);
  const int ncs = K / nseg / 16;
  for (int seg = 0; seg < nseg; ++seg) {
    int ai[kR][kBMax];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int b = 0; b < kBMax; ++b) ai[r][b] = 0;
    }
    for (int c = lane; c < ncs; c += 32) {
      const int cc = seg * ncs + c;
      uint4 w[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        w[r] = r < nr ? __ldg(reinterpret_cast<const uint4*>(W + (size_t)(o0 + r) * K) + cc)
                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int b = 0; b < kBMax; ++b) {
        if (b < B) {
          const uint4 xv = *reinterpret_cast<const uint4*>(xq + (size_t)b * K + cc * 16);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            if (r < nr) {
              int s = ai[r][b];
              s = __dp4a((int)w[r].x, (int)xv.x, s);
              s = __dp4a((int)w[r].y, (int)xv.y, s);
              s = __dp4a((int)w[r].z, (int)xv.z, s);
              s = __dp4a((int)w[r].w, (int)xv.w, s);
              ai[r][b] = s;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < nr) {
#pragma unroll
        for (int b = 0; b < kBMax; ++b) {
          if (b < B) {
            int s = ai[r][b];
#pragma unroll
            for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
            a[r][b] = __fadd_rn(a[r][b], __fmul_rn((float)s, xsc[b * 2 + seg]));
          }
        }
      }
    }
  }
}

// The GEMV of matrix m (0 gate, 1 up, 2 down) of layer l in its plan mode.
__device__ void gemv_mode(const Args& A, int m, int l, int O, int K, int o0,
                          int nr, const bf16* xs, const signed char* xq,
                          const float* xsc, int nseg, float a[kR][kBMax],
                          int lane) {
  const int mode = A.mode[m];
  if (mode == kInt4) {
    const int g = A.grp[m];
    gemv_i4(A.mw[m] + (size_t)l * O * (K / 2), A.ms[m] + (size_t)l * O * (K / g),
            K, g, o0, nr, xs, A.B, a, lane);
  } else if (mode == kInt8A8) {
    gemv_a8(A.mw[m] + (size_t)l * O * K, K, nseg, o0, nr, xq, xsc, A.B, a, lane);
  } else {
    gemv_i8(A.mw[m] + (size_t)l * O * K, K, o0, nr, xs, A.B, a, lane);
  }
}

// Rows [beg, end) of an O-row matrix that this warp of the grid owns.
__device__ __forceinline__ void warp_rows(int O, int& beg, int& end) {
  const int nw = gridDim.x * kWarps;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int rpw = (O + nw - 1) / nw;
  beg = min(O, gw * rpw);
  end = min(O, beg + rpw);
}

struct Shared {
  float red[kWarps * kBMax];
  float stats[kBMax];
  float xsc[kBMax * 2];               // a8 activation scales, (b, segment)
  float gtmp[kWarps][kR][kBMax];      // the gate half of a gate/up row group
  float arg_v[kWarps];
  int arg_i[kWarps];
};

// Per-row block reduction of v[b] (b < B) -> out[b], sum or max.
__device__ void block_rows(float v[kBMax], int B, bool is_max, Shared& sh,
                           float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kBMax; ++b) {
    if (b < B) v[b] = is_max ? warp_max(v[b]) : warp_sum(v[b]);
  }
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < kBMax; ++b) {
      if (b < B) sh.red[warp * kBMax + b] = v[b];
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < B) {
    float r = sh.red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      const float o = sh.red[w * kBMax + threadIdx.x];
      r = is_max ? fmaxf(r, o) : r + o;
    }
    out[threadIdx.x] = r;
  }
  __syncthreads();
}

// One value reduced over the block, returned to every thread.
__device__ float block_one(float v, bool is_max, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) sh.red[warp] = v;
  __syncthreads();
  float r = sh.red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, sh.red[w]) : r + sh.red[w];
  __syncthreads();
  return r;
}

// First-index argmax over the block of per-thread (value, index) pairs.
__device__ int block_argmax(float v, int i, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, s);
    const int oi = __shfl_xor_sync(0xffffffffu, i, s);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
  if (lane == 0) { sh.arg_v[warp] = v; sh.arg_i[warp] = i; }
  __syncthreads();
  v = sh.arg_v[0];
  i = sh.arg_i[0];
  for (int w = 1; w < kWarps; ++w) {
    if (sh.arg_v[w] > v || (sh.arg_v[w] == v && sh.arg_i[w] < i)) {
      v = sh.arg_v[w];
      i = sh.arg_i[w];
    }
  }
  __syncthreads();
  return i;
}

// xs (B, Dd) = rms_norm(h, w) in bf16: (h * rsqrt(mean(h^2) + eps)) rounded,
// times the bf16 weight, rounded (pallas_depth.py:_rms).
__device__ void stage_rms(const Args& A, const bf16* w, bf16* xs, Shared& sh) {
  const int D = A.Dd, B = A.B;
  float v[kBMax];
#pragma unroll
  for (int b = 0; b < kBMax; ++b) {
    v[b] = 0.f;
    if (b < B) {
      for (int k = threadIdx.x; k < D; k += kThreads) {
        const float x = __ldcg(A.h + (size_t)b * D + k);
        v[b] = fmaf(x, x, v[b]);
      }
    }
  }
  block_rows(v, B, false, sh, sh.stats);
  if ((int)threadIdx.x < B)
    sh.stats[threadIdx.x] = rsqrtf(__fdiv_rn(sh.stats[threadIdx.x], (float)D) + A.eps);
  __syncthreads();
  for (int idx = threadIdx.x; idx < B * D; idx += kThreads) {
    const int b = idx / D, k = idx - b * D;
    const float x = bfr(__fmul_rn(__ldcg(A.h + idx), sh.stats[b]));
    xs[idx] = __float2bfloat16(x * bf2f(w[k]));
  }
  __syncthreads();
}

// Per-row int8 quantisation of the staged xs (B, K), separately over nseg
// equal segments (pallas_depth.py:_quant_act): scale = max(|x|, 1e-30) /
// 127, q = round-half-even(x / scale).
__device__ void stage_quant(const Args& A, const bf16* xs, int K, int nseg,
                            signed char* xq, Shared& sh) {
  const int B = A.B, Ks = K / nseg;
  for (int seg = 0; seg < nseg; ++seg) {
    float v[kBMax];
#pragma unroll
    for (int b = 0; b < kBMax; ++b) {
      v[b] = 0.f;
      if (b < B) {
        for (int k = threadIdx.x; k < Ks; k += kThreads)
          v[b] = fmaxf(v[b], fabsf(bf2f(xs[(size_t)b * K + seg * Ks + k])));
      }
    }
    block_rows(v, B, true, sh, sh.stats);
    if ((int)threadIdx.x < B)
      sh.xsc[threadIdx.x * 2 + seg] = __fdiv_rn(fmaxf(sh.stats[threadIdx.x], 1e-30f), 127.f);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < B * K; idx += kThreads) {
    const int b = idx / K, seg = (idx - b * K) / Ks;
    xq[idx] = (signed char)__float2int_rn(__fdiv_rn(bf2f(xs[idx]), sh.xsc[b * 2 + seg]));
  }
  __syncthreads();
}

// RoPE of a lane's 4 dims (d = 4 * lane + i); the partner dims d +- Dh/2
// live in lane ^ 16. fp32, no fused multiply-add, rounded to bf16.
__device__ __forceinline__ void rope4(float x[4], const float c[4],
                                      const float s[4], bool first) {
  float px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) px[i] = __shfl_xor_sync(0xffffffffu, x[i], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = first ? bfr(__fsub_rn(__fmul_rn(x[i], c[i]), __fmul_rn(px[i], s[i])))
                 : bfr(__fadd_rn(__fmul_rn(x[i], c[i]), __fmul_rn(px[i], s[i])));
}

// Attention of micro-step p over slots 0..p of layer l, one warp per
// (stream, query head): RoPE of q and of the fresh k, scores, softmax with
// the probabilities rounded to bf16, the product with V; o (B, Hq*Dh) bf16
// into xs. Slots < p come from the store; slot p from this step's qkv.
// With write_store the fresh K/V row goes into slot p of the store.
__device__ void attention_stage(const Args& A, int l, int p, bf16* xs,
                                bool write_store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = A.B, Hq = A.Hq, Hkv = A.Hkv, G = Hq / Hkv;
  const int HqDh = Hq * kDh, HkvDh = Hkv * kDh, Wqkv = HqDh + 2 * HkvDh;
  const int d0 = lane * 4, j0 = (lane & 15) * 4;
  const bool first = lane < 16;
  float c[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] = __ldg(A.rcos + p * (kDh / 2) + j0 + i);
    s[i] = __ldg(A.rsin + p * (kDh / 2) + j0 + i);
  }
  const size_t slot = (size_t)B * HkvDh;
  for (int item = warp; item < B * Hq; item += kWarps) {
    const int b = item / Hq, h = item - b * Hq, hk = h / G;
    const float* row = A.qkv + (size_t)b * Wqkv;
    float q[4], k[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = __ldcg(row + h * kDh + d0 + i);
      k[i] = __ldcg(row + HqDh + hk * kDh + d0 + i);
      v[i] = __ldcg(row + HqDh + HkvDh + hk * kDh + d0 + i);
    }
    rope4(q, c, s, first);
    rope4(k, c, s, first);
    float qf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[i] = __fmul_rn(q[i], A.attn_scale);
    const size_t base = (size_t)l * A.ncb * slot + (size_t)b * HkvDh + hk * kDh + d0;
    float sc[kMaxSlots];
    float mx = kNeg;
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) {
      if (t <= p) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kk = t < p ? ld_bf(A.kst + base + t * slot + i) : k[i];
          part = fmaf(qf[i], kk, part);
        }
        sc[t] = warp_sum(part);
        mx = fmaxf(mx, sc[t]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) {
      if (t <= p) {
        sc[t] = expf(sc[t] - mx);
        sum += sc[t];
      }
    }
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) {
      if (t <= p) {
        const float pr = bfr(__fdiv_rn(sc[t], sum));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float vv = t < p ? ld_bf(A.vst + base + t * slot + i) : v[i];
          o[i] = fmaf(pr, vv, o[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xs[(size_t)b * HqDh + h * kDh + d0 + i] = __float2bfloat16(o[i]);
    if (write_store && h % G == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        A.kst[base + p * slot + i] = __float2bfloat16(k[i]);
        A.vst[base + p * slot + i] = __float2bfloat16(v[i]);
      }
    }
  }
  __syncthreads();
}

// Token of stream b at micro-step p from its fp32 logits: greedy argmax, or
// temperature, top-k by _kth_largest (ties collapse), softmax and the
// exponential race argmax(probs / noise); first index on ties.
__device__ void sample_row(const Args& A, int b, int p, float* buf, Shared& sh) {
  const int V = A.V;
  const float* lg = A.logits + (size_t)b * V;
  float bv = -INFINITY;
  int bi = V;
  if (A.greedy) {
    for (int v = threadIdx.x; v < V; v += kThreads) {
      const float x = __ldcg(lg + v);
      if (x > bv) { bv = x; bi = v; }
    }
  } else {
    float* lf = buf;
    float* cur = buf + V;
    for (int v = threadIdx.x; v < V; v += kThreads) {
      lf[v] = __fdiv_rn(__ldcg(lg + v), A.temp);
      cur[v] = lf[v];
    }
    for (int it = 0; it < A.topk - 1; ++it) {
      float m = -INFINITY;
      for (int v = threadIdx.x; v < V; v += kThreads) m = fmaxf(m, cur[v]);
      m = block_one(m, true, sh);
      for (int v = threadIdx.x; v < V; v += kThreads)
        if (cur[v] >= m) cur[v] = kNeg;
    }
    float kth = -INFINITY;
    for (int v = threadIdx.x; v < V; v += kThreads) kth = fmaxf(kth, cur[v]);
    kth = block_one(kth, true, sh);
    float m = -INFINITY;
    for (int v = threadIdx.x; v < V; v += kThreads) {
      cur[v] = lf[v] < kth ? kNeg : lf[v];
      m = fmaxf(m, cur[v]);
    }
    m = block_one(m, true, sh);
    float tot = 0.f;
    for (int v = threadIdx.x; v < V; v += kThreads) {
      cur[v] = expf(cur[v] - m);
      tot += cur[v];
    }
    tot = block_one(tot, false, sh);
    const float* nz = A.noise + ((size_t)b * A.ncb + p) * V;
    for (int v = threadIdx.x; v < V; v += kThreads) {
      const float sc = __fdiv_rn(__fdiv_rn(cur[v], tot), nz[v]);
      if (sc > bv) { bv = sc; bi = v; }
    }
  }
  const int tok = block_argmax(bv, bi, sh);
  if (threadIdx.x == 0) {
    A.samples[b * A.ncb + p] = tok;
    A.tok[b] = A.forced ? A.forced[b * A.ncb + p] : tok;
  }
}

// y of an MLP in-projection from its dot: int4 rounds the dot; int8 (and
// a8, whose dot already carries the activation scale) rounds the dot, then
// its product with the bf16-rounded channel scale (pallas_depth.py:548).
__device__ __forceinline__ float mlp_in_out(const Args& A, int m, int l, int o,
                                            float acc) {
  if (A.mode[m] == kInt4) return bfr(acc);
  return bfr(bfr(acc) * bfr(__ldg(A.ms[m] + (size_t)l * A.I + o)));
}

__global__ void __launch_bounds__(kThreads, 1)
depth_chain_kernel(const Args A) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  bf16* xs = reinterpret_cast<bf16*>(dyn);
  signed char* xq = reinterpret_cast<signed char*>(dyn + A.xs_bytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = A.B, Db = A.Db, Dd = A.Dd, I = A.I, V = A.V, ncb = A.ncb;
  const int HqDh = A.Hq * kDh, Wqkv = HqDh + 2 * A.Hkv * kDh;
  const bool a8_in = A.mode[0] == kInt8A8 || A.mode[1] == kInt8A8;
  float acc[kR][kBMax];
  int beg, end;

  if (blockIdx.x == 0 && tid < B) {
    A.tok[tid] = A.c0[tid];
    A.samples[tid * ncb] = A.c0[tid];
  }

  for (int p = 0; p < ncb; ++p) {
    // ---- input: last_h (p = 0) or the previous token's embedding, @ proj
    for (int idx = tid; idx < B * Db; idx += kThreads) {
      const int b = idx / Db, k = idx - b * Db;
      if (p == 0) {
        xs[idx] = A.last_h[idx];
      } else {
        const int tk = min(max(__ldcg(A.tok + b), 0), V - 1);
        xs[idx] = A.emb[(size_t)(tk + (p - 1) * V) * Db + k];
      }
    }
    __syncthreads();
    warp_rows(Dd, beg, end);
    for (int o0 = beg; o0 < end; o0 += kR) {
      const int nr = min(kR, end - o0);
      gemv_bf16(A.proj_t, Db, o0, nr, xs, B, acc, lane);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int b = 0; b < kBMax; ++b)
            if (r < nr && b < B) A.h[(size_t)b * Dd + o0 + r] = bfr(acc[r][b]);
      }
    }
    grid_sync(A.bar);

    for (int l = 0; l < A.L; ++l) {
      // ---- attention norm + merged QKV (mm8 + bias)
      stage_rms(A, A.attn_norm + (size_t)l * Dd, xs, sh);
      warp_rows(Wqkv, beg, end);
      for (int o0 = beg; o0 < end; o0 += kR) {
        const int nr = min(kR, end - o0);
        gemv_i8(A.wqkv + (size_t)l * Wqkv * Dd, Dd, o0, nr, xs, B, acc, lane);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            if (r < nr) {
              const int o = o0 + r;
              const float sc = bfr(__ldg(A.wqkv_s + (size_t)l * Wqkv + o));
              const float bias = bf2f(A.bqkv[(size_t)l * Wqkv + o]);
#pragma unroll
              for (int b = 0; b < kBMax; ++b)
                if (b < B)
                  A.qkv[(size_t)b * Wqkv + o] = bfr(bfr(bfr(acc[r][b]) * sc) + bias);
            }
          }
        }
      }
      grid_sync(A.bar);

      // ---- attention (every block; block 0 writes the store) + wo
      attention_stage(A, l, p, xs, blockIdx.x == 0);
      warp_rows(Dd, beg, end);
      for (int o0 = beg; o0 < end; o0 += kR) {
        const int nr = min(kR, end - o0);
        gemv_i8(A.wo + (size_t)l * Dd * HqDh, HqDh, o0, nr, xs, B, acc, lane);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            if (r < nr) {
              const int o = o0 + r;
              const float sc = bfr(__ldg(A.wo_s + (size_t)l * Dd + o));
#pragma unroll
              for (int b = 0; b < kBMax; ++b) {
                if (b < B) {
                  float* hp = A.h + (size_t)b * Dd + o;
                  *hp = bfr(__ldcg(hp) + bfr(bfr(acc[r][b]) * sc));
                }
              }
            }
          }
        }
      }
      grid_sync(A.bar);

      // ---- MLP norm + gate/up: t = bf16(silu(gate)) * up
      stage_rms(A, A.mlp_norm + (size_t)l * Dd, xs, sh);
      if (a8_in) stage_quant(A, xs, Dd, 1, xq, sh);
      warp_rows(I, beg, end);
      for (int o0 = beg; o0 < end; o0 += kR) {
        const int nr = min(kR, end - o0);
        gemv_mode(A, 0, l, I, Dd, o0, nr, xs, xq, sh.xsc, 1, acc, lane);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int b = 0; b < kBMax; ++b)
              if (r < nr && b < B) {
                const float y = mlp_in_out(A, 0, l, o0 + r, acc[r][b]);
                sh.gtmp[warp][r][b] = bfr(__fmul_rn(y, 1.f / (1.f + expf(-y))));
              }
        }
        __syncwarp();
        gemv_mode(A, 1, l, I, Dd, o0, nr, xs, xq, sh.xsc, 1, acc, lane);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int b = 0; b < kBMax; ++b)
              if (r < nr && b < B) {
                const float u = mlp_in_out(A, 1, l, o0 + r, acc[r][b]);
                A.t[(size_t)b * I + o0 + r] = __float2bfloat16(sh.gtmp[warp][r][b] * u);
              }
        }
        __syncwarp();
      }
      grid_sync(A.bar);

      // ---- down over both halves (fp32), then the scale; h += d
      for (int idx = tid; idx < B * I; idx += kThreads)
        xs[idx] = __ushort_as_bfloat16(
            __ldcg(reinterpret_cast<const unsigned short*>(A.t) + idx));
      __syncthreads();
      if (A.mode[2] == kInt8A8) stage_quant(A, xs, I, 2, xq, sh);
      warp_rows(Dd, beg, end);
      for (int o0 = beg; o0 < end; o0 += kR) {
        const int nr = min(kR, end - o0);
        gemv_mode(A, 2, l, Dd, I, o0, nr, xs, xq, sh.xsc, 2, acc, lane);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            if (r < nr) {
              const int o = o0 + r;
              const float sc = A.mode[2] == kInt4
                                   ? 1.f : bfr(__ldg(A.ms[2] + (size_t)l * Dd + o));
#pragma unroll
              for (int b = 0; b < kBMax; ++b) {
                if (b < B) {
                  float* hp = A.h + (size_t)b * Dd + o;
                  const float d = A.mode[2] == kInt4 ? bfr(acc[r][b])
                                                     : bfr(bfr(acc[r][b]) * sc);
                  *hp = bfr(__ldcg(hp) + d);
                }
              }
            }
          }
        }
      }
      grid_sync(A.bar);
    }
    if (p == 0) continue;             // codebook 0 is c0, recorded above

    // ---- final norm + logits of codebook p (audio head p - 1)
    stage_rms(A, A.final_norm, xs, sh);
    warp_rows(V, beg, end);
    for (int o0 = beg; o0 < end; o0 += kR) {
      const int nr = min(kR, end - o0);
      gemv_bf16(A.head_t + (size_t)(p - 1) * V * Dd, Dd, o0, nr, xs, B, acc, lane);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int b = 0; b < kBMax; ++b)
            if (r < nr && b < B) {
              A.logits[(size_t)b * V + o0 + r] = acc[r][b];
              if (A.logits_out)
                A.logits_out[((size_t)b * ncb + p) * V + o0 + r] = acc[r][b];
            }
      }
    }
    grid_sync(A.bar);

    // ---- sampling: block b takes stream b
    if ((int)blockIdx.x < B)
      sample_row(A, blockIdx.x, p, reinterpret_cast<float*>(dyn), sh);
    grid_sync(A.bar);
  }
}

}  // namespace

// The index of each pointer and integer the wrapper passes
// (ops/depth_chain.py: _PTRS, _INTS).
enum PtrIndex {
  P_LAST_H, P_C0, P_NOISE, P_FORCED, P_PROJ, P_EMB, P_HEAD, P_COS, P_SIN,
  P_ATTN_NORM, P_MLP_NORM, P_FINAL_NORM, P_BQKV, P_WQKV, P_WQKV_S, P_WO,
  P_WO_S, P_GATE, P_GATE_S, P_UP, P_UP_S, P_DOWN, P_DOWN_S, P_SAMPLES,
  P_LOGITS_OUT, P_H, P_QKV, P_T, P_KST, P_VST, P_TOK, P_LOGITS, P_BAR,
  P_COUNT
};
enum IntIndex {
  I_B, I_DB, I_DD, I_HQ, I_HKV, I_DH, I_I, I_V, I_NCB, I_L, I_G_GATE, I_G_UP,
  I_G_DOWN, I_M_GATE, I_M_UP, I_M_DOWN, I_TOPK, I_GREEDY, I_KMAX, I_XS_BYTES,
  I_COUNT
};

extern "C" int frt_depth_chain_counts(int* ptrs, int* ints) {
  *ptrs = P_COUNT;
  *ints = I_COUNT;
  return 0;
}

// Blocks of the cooperative grid for a dynamic shared-memory size: the SM
// count times the blocks an SM holds. Negative: a CUDA error.
extern "C" int frt_depth_chain_grid(int smem_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      depth_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, depth_chain_kernel,
                                                    kThreads, smem_bytes);
  if (e != cudaSuccess) return -(int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

// ptrs: P_COUNT device pointers (P_FORCED, P_LOGITS_OUT may be null);
// ints: I_COUNT integers; floats: temperature, rms eps, 1/sqrt(Dh).
// Returns 0 when the cooperative launch was accepted, else a CUDA error.
extern "C" int frt_fused_depth_decode(void* const* ptrs, const int* ints,
                                      const float* floats, void* stream) {
  Args A;
  A.last_h = (const bf16*)ptrs[P_LAST_H];
  A.c0 = (const int*)ptrs[P_C0];
  A.noise = (const float*)ptrs[P_NOISE];
  A.forced = (const int*)ptrs[P_FORCED];
  A.proj_t = (const bf16*)ptrs[P_PROJ];
  A.emb = (const bf16*)ptrs[P_EMB];
  A.head_t = (const bf16*)ptrs[P_HEAD];
  A.rcos = (const float*)ptrs[P_COS];
  A.rsin = (const float*)ptrs[P_SIN];
  A.attn_norm = (const bf16*)ptrs[P_ATTN_NORM];
  A.mlp_norm = (const bf16*)ptrs[P_MLP_NORM];
  A.final_norm = (const bf16*)ptrs[P_FINAL_NORM];
  A.bqkv = (const bf16*)ptrs[P_BQKV];
  A.wqkv = (const signed char*)ptrs[P_WQKV];
  A.wqkv_s = (const float*)ptrs[P_WQKV_S];
  A.wo = (const signed char*)ptrs[P_WO];
  A.wo_s = (const float*)ptrs[P_WO_S];
  for (int m = 0; m < 3; ++m) {
    A.mw[m] = (const signed char*)ptrs[P_GATE + 2 * m];
    A.ms[m] = (const float*)ptrs[P_GATE_S + 2 * m];
  }
  A.samples = (int*)ptrs[P_SAMPLES];
  A.logits_out = (float*)ptrs[P_LOGITS_OUT];
  A.h = (float*)ptrs[P_H];
  A.qkv = (float*)ptrs[P_QKV];
  A.t = (bf16*)ptrs[P_T];
  A.kst = (bf16*)ptrs[P_KST];
  A.vst = (bf16*)ptrs[P_VST];
  A.tok = (int*)ptrs[P_TOK];
  A.logits = (float*)ptrs[P_LOGITS];
  A.bar = (unsigned*)ptrs[P_BAR];
  A.B = ints[I_B]; A.Db = ints[I_DB]; A.Dd = ints[I_DD]; A.Hq = ints[I_HQ];
  A.Hkv = ints[I_HKV]; A.I = ints[I_I]; A.V = ints[I_V]; A.ncb = ints[I_NCB];
  A.L = ints[I_L];
  for (int m = 0; m < 3; ++m) {
    A.grp[m] = ints[I_G_GATE + m];
    A.mode[m] = ints[I_M_GATE + m];
  }
  A.topk = ints[I_TOPK];
  A.greedy = ints[I_GREEDY];
  A.xs_bytes = ints[I_XS_BYTES];
  A.temp = floats[0];
  A.eps = floats[1];
  A.attn_scale = floats[2];
  const int kmax = ints[I_KMAX];
  if (A.B < 1 || A.B > kBMax || A.ncb < 2 || A.ncb > kMaxSlots ||
      ints[I_DH] != kDh || A.Hkv < 1 || A.Hq % A.Hkv != 0 || A.Db % 32 ||
      A.Dd % 32 || A.I % 32 || A.topk < 1 || A.xs_bytes % 16 ||
      A.xs_bytes < A.B * kmax * 2 || A.xs_bytes < 8 * A.V)
    return (int)cudaErrorInvalidValue;
  for (int m = 0; m < 3; ++m) {
    if (A.mode[m] < kInt8 || A.mode[m] > kInt4) return (int)cudaErrorInvalidValue;
    if (A.mode[m] == kInt4 && (A.grp[m] < 16 || A.grp[m] % 16)) return (int)cudaErrorInvalidValue;
  }
  const int smem = A.xs_bytes + A.B * kmax;
  const int grid = frt_depth_chain_grid(smem);
  if (grid < 0) return -grid;
  if (grid < A.B) return (int)cudaErrorInvalidConfiguration;
  void* params[] = {(void*)&A};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)depth_chain_kernel,
                                              dim3(grid), dim3(kThreads), params,
                                              (size_t)smem,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
