// Kernel P: the weight-streaming GEMV probes beside kernel B.
//
// Replaces the four TPU probe tools' Pallas kernels:
// - tools/probe_depth_kernel.py: probe_vmem_capacity, probe_int8_reuse,
//   probe_int4_reuse, probe_streamed_int8 (P1a-d). On the TPU they asked how
//   much int8 Mosaic keeps resident in VMEM, what a resident int8 (or int4)
//   weight costs per reuse when it is converted at every use, and what a
//   weight streamed from HBM behind a double-buffered make_async_copy ring
//   costs per step;
// - tools/probe_dequant.py: _reuse_call (P3): bf16 against int8
//   convert+dot against s8 x s8 -> int32 at D = 896, 8 rows;
// - tools/probe_s8_chunked.py: _call (P4a): kernel B's MLP dot schedule
//   (4 layers x halves x gate, up, down) with bf16 / int8 / s8s8 / s8s8q
//   weights at M = 8, 16, 32.
//
// What it computes: matrices W_i stored output-major (O_i, K_i) in one
// storage mode, inputs x_i (M, K_i) bf16 (matrices may share an input),
// S steps. Each step computes every y_i = x_i @ deq(W_i)^T; the kernel
// returns y, (M, sum O_i) bf16, of a single step (the capacity form), or
// the fp32 sum over steps, matrices and outputs, (M, 1) (the reuse forms:
// what the TPU probes accumulate). The cross-block sum is one atomicAdd a
// block per row, so the sum's fp32 order varies from run to run.
//
// Modes, with the arithmetic of the warp GEMVs of kernel B's first design
// (fused_depth_decode.cu before its redesign onto the tensor cores; "kernel
// B" below means that design): bf16 (gemv_bf16), int8 converted per use
// (gemv_i8), int4 halves-packed with fp32 group scales, unpacked per use
// by int4_unpack.cuh (gemv_i4), s8s8: the inputs quantised per row once a
// step, int8 x int8 dot products summed in int32 by __dp4a, times the row's
// scale (gemv_a8 with one segment), and s8s8q: the same, re-quantised at the
// start of every group of `qgroup` matrices (one layer of the schedule).
// A warp owns R output rows of a matrix and streams them with 16-byte loads,
// the rows of a matrix split evenly over all warps of the grid (kernel B's
// warp_rows); R x M-tile is kept at 32 accumulators a lane, as in kernel B:
// R = 4 rows for M <= 8, 2 for M <= 16, 1 for M <= 32.
//
// Two switches:
// - sync: no barrier, kernel B's grid barrier (grid_sync.cuh) after every
//   matrix, or one after every step. The launch is cooperative at kernel
//   B's grid, one 512-thread block per SM. No matrices and S steps with a
//   barrier each is the barrier probe; no steps at all is an empty
//   cooperative launch;
// - load: `direct` is kernel B's load, one 16-byte __ldg per lane per row;
//   `staged` copies the same 16-byte chunks with cp.async through a
//   double-buffered ring in shared memory (a lane issues chunk c + 32 before
//   it uses chunk c): the card's counterpart of the TPU's make_async_copy
//   ring (probe_depth_kernel.py:165-189), which that design did not do.
// The inputs are staged in shared memory once a step (and quantised there
// in the s8s8 modes) when they fit beside the ring; otherwise (the
// capacity form's long rows) the GEMVs read them from global memory.
//
// What bounds it on an H100: bytes. At M <= 32 a weight byte meets at most
// 64 operations against the ~295 the card needs before compute matters.
// "Resident" on the TPU meant VMEM; here it means the 50 MB L2 (plus at
// most 227 KB of shared memory a block): weights below ~50 MB that are
// re-read every step may stay in L2, larger ones stream from device memory
// at up to 3.35 TB/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "grid_sync.cuh"
#include "int4_unpack.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;            // the staged load's ring depth
constexpr int kMaxX = 8;              // distinct inputs (s8s8 scales)
enum Mode { kBf16 = 0, kInt8 = 1, kInt4 = 2, kS8S8 = 3, kS8S8Q = 4 };
enum Sync { kNoSync = 0, kSyncMatrix = 1, kSyncStep = 2 };

// One matrix as the wrapper packs it (ops/gemv_probe.py: _MAT_WORDS):
// weights, int4 scales (else 0), input index, O, K, int4 group, the
// matrix's first column of y.
struct Mat { long long w, s, x, O, K, g, yoff, pad; };
// One input: pointer (M, K) bf16, K, byte offset of its staged copy.
struct XEnt { long long ptr, K, off, pad; };

struct Args {
  const Mat* mats; const XEnt* xs; float* out_sum; bf16* out_y; unsigned* bar;
  int nmat, nx, ytot, M, steps, sync, xsmem, qgroup, ring_off;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n"); }
__device__ __forceinline__ void cp_wait0() { asm volatile("cp.async.wait_group 0;\n"); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// The 16-byte chunks of RR rows one lane streams: chunk c of row r is
// rows[r][c]. Direct: __ldg at use. Staged: chunk c + 32 is copied into the
// lane's other ring slot before chunk c is read from its slot.
template <int RR, bool STAGED>
struct Stream {
  const uint4* rows[RR];
  int nr, nc, lane, st;
  uint4* ring;                        // this warp's kStages * RR * 32 slots

  __device__ void issue(int c, int slot) {
#pragma unroll
    for (int r = 0; r < RR; ++r)
      if (r < nr) cp_async16(ring + (slot * RR + r) * 32 + lane, rows[r] + c);
  }
  __device__ void start() {
    st = 0;
    if (STAGED) {
      if (lane < nc) issue(lane, 0);
      cp_commit();
    }
  }
  __device__ void get(int c, uint4 w[RR]) {
    if (STAGED) {
      if (c + 32 < nc) issue(c + 32, st ^ 1);
      cp_commit();
      cp_wait1();
#pragma unroll
      for (int r = 0; r < RR; ++r)
        w[r] = r < nr ? ring[(st * RR + r) * 32 + lane] : make_uint4(0u, 0u, 0u, 0u);
      st ^= 1;
    } else {
#pragma unroll
      for (int r = 0; r < RR; ++r)
        w[r] = r < nr ? __ldg(rows[r] + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ void finish() {
    if (STAGED) cp_wait0();
  }
};

// Rows [o0, o0 + nr) of matrix m against its input xp (bf16 (M, K), or for
// s8s8 int8 (M, K) with scales xsc[M]). On return every lane holds the
// complete fp32 sums a[r][b].
template <int R, int MB, int MODE, bool STAGED>
__device__ void gemv(const Mat& m, int o0, int nr, const void* xp,
                     const float* xsc, int M, float a[R][MB], uint4* ring,
                     int lane) {
  const int K = (int)m.K;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int b = 0; b < MB; ++b) a[r][b] = 0.f;
  }
  if (MODE == kInt4) {
    // kernel B's gemv_i4: one row at a time (32 dequantised weights a lane)
    const int K2 = K / 2, g = (int)m.g, ng = K / g;
    const bf16* x = static_cast<const bf16*>(xp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        const int o = o0 + r;
        const float* S = reinterpret_cast<const float*>(m.s) + (size_t)o * ng;
        Stream<1, STAGED> s;
        s.rows[0] = reinterpret_cast<const uint4*>(
            reinterpret_cast<const signed char*>(m.w) + (size_t)o * K2);
        s.nr = 1; s.nc = K2 / 16; s.lane = lane; s.ring = ring;
        s.start();
        for (int c = lane; c < s.nc; c += 32) {
          uint4 w[1];
          s.get(c, w);
          float lo[16], hi[16];
          frt_int4_unpack16(w[0], __ldg(S + (c * 16) / g),
                            __ldg(S + (K2 + c * 16) / g), lo, hi);
#pragma unroll
          for (int b = 0; b < MB; ++b) {
            if (b < M) {
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
        s.finish();
      }
    }
  } else {
    const int row_bytes = MODE == kBf16 ? 2 * K : K;
    Stream<R, STAGED> s;
#pragma unroll
    for (int r = 0; r < R; ++r)
      s.rows[r] = reinterpret_cast<const uint4*>(
          reinterpret_cast<const unsigned char*>(m.w) +
          (size_t)(o0 + (r < nr ? r : 0)) * row_bytes);
    s.nr = nr; s.nc = row_bytes / 16; s.lane = lane; s.ring = ring;
    int ai[R][MB];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int b = 0; b < MB; ++b) ai[r][b] = 0;
    }
    s.start();
    for (int c = lane; c < s.nc; c += 32) {
      uint4 w[R];
      s.get(c, w);
      if (MODE == kBf16) {              // kernel B's gemv_bf16
        const bf16* x = static_cast<const bf16*>(xp);
        float wf[R][8];
#pragma unroll
        for (int r = 0; r < R; ++r) frt_bf16x8(w[r], wf[r]);
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          if (b < M) {
            float xf[8];
            frt_bf16x8(*reinterpret_cast<const uint4*>(x + (size_t)b * K + c * 8), xf);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (r < nr) {
#pragma unroll
                for (int e = 0; e < 8; ++e) a[r][b] = fmaf(wf[r][e], xf[e], a[r][b]);
              }
            }
          }
        }
      } else if (MODE == kInt8) {       // kernel B's gemv_i8
        const bf16* x = static_cast<const bf16*>(xp);
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          if (b < M) {
            const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)b * K + c * 16);
            float xf[16];
            frt_bf16x8(xv[0], xf);
            frt_bf16x8(xv[1], xf + 8);
#pragma unroll
            for (int r = 0; r < R; ++r) {
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
      } else {                          // kernel B's gemv_a8, one segment
        const signed char* xq = static_cast<const signed char*>(xp);
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          if (b < M) {
            const uint4 xv = *reinterpret_cast<const uint4*>(xq + (size_t)b * K + c * 16);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (r < nr) {
                int v = ai[r][b];
                v = __dp4a((int)w[r].x, (int)xv.x, v);
                v = __dp4a((int)w[r].y, (int)xv.y, v);
                v = __dp4a((int)w[r].z, (int)xv.z, v);
                v = __dp4a((int)w[r].w, (int)xv.w, v);
                ai[r][b] = v;
              }
            }
          }
        }
      }
    }
    s.finish();
    if (MODE == kS8S8) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          if (r < nr && b < M) {
            int v = ai[r][b];
#pragma unroll
            for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_xor_sync(0xffffffffu, v, sh);
            a[r][b] = __fmul_rn((float)v, xsc[b]);
          }
        }
      }
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      if (r < nr && b < M) a[r][b] = warp_sum(a[r][b]);
    }
  }
}

// Every input into shared memory: a bf16 copy, or (s8s8) per-row int8
// quantisation, scale = max(|x|, 1e-30) * fp32(1/127) (the JAX division by
// the constant 127 as XLA compiles it), q = clip(round-half-even(x / scale),
// -127, 127) (probe_s8_chunked.py:105-108, and kernel B's stage_quant).
// One warp takes one row's maximum.
template <int MODE>
__device__ void stage_inputs(const Args& A, unsigned char* dyn,
                             float xsc[kMaxX][32]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, M = A.M;
  __syncthreads();
  for (int xi = 0; xi < A.nx; ++xi) {
    const XEnt e = A.xs[xi];
    const int K = (int)e.K;
    const bf16* src = reinterpret_cast<const bf16*>(e.ptr);
    if (MODE == kS8S8) {
      for (int b = warp; b < M; b += kWarps) {
        float mx = 0.f;
        for (int k = lane; k < K; k += 32)
          mx = fmaxf(mx, fabsf(__bfloat162float(src[(size_t)b * K + k])));
        mx = warp_max(mx);
        if (lane == 0) xsc[xi][b] = __fmul_rn(fmaxf(mx, 1e-30f), 1.f / 127.f);
      }
      __syncthreads();
      signed char* q = reinterpret_cast<signed char*>(dyn + e.off);
      for (int i = tid; i < M * K; i += kThreads) {
        const int v = __float2int_rn(__fdiv_rn(__bfloat162float(src[i]), xsc[xi][i / K]));
        q[i] = (signed char)max(-127, min(127, v));
      }
    } else {
      uint4* d = reinterpret_cast<uint4*>(dyn + e.off);
      const uint4* s = reinterpret_cast<const uint4*>(src);
      for (int i = tid; i < M * K / 8; i += kThreads) d[i] = s[i];
    }
  }
  __syncthreads();
}

template <int R, int MB, int MODE, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1) probe_kernel(const Args A) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float tot[kWarps][32];
  __shared__ float xsc[kMaxX][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, M = A.M;
  uint4* ring = reinterpret_cast<uint4*>(dyn + A.ring_off) + warp * kStages * R * 32;
  for (int i = tid; i < kWarps * 32; i += kThreads) (&tot[0][0])[i] = 0.f;
  const int nw = gridDim.x * kWarps, gw = blockIdx.x * kWarps + warp;
  FrtGrid g{A.bar, 0u};

  for (int step = 0; step < A.steps; ++step) {
    if (A.xsmem) stage_inputs<MODE>(A, dyn, xsc);
    for (int i = 0; i < A.nmat; ++i) {
      if (MODE == kS8S8 && A.qgroup > 0 && i > 0 && i % A.qgroup == 0)
        stage_inputs<MODE>(A, dyn, xsc);
      const Mat m = A.mats[i];
      const int xi = (int)m.x, O = (int)m.O;
      const void* xp = A.xsmem ? (const void*)(dyn + A.xs[xi].off)
                               : (const void*)A.xs[xi].ptr;
      const int rpw = (O + nw - 1) / nw;
      const int beg = min(O, gw * rpw), end = min(O, beg + rpw);
      for (int o0 = beg; o0 < end; o0 += R) {
        const int nr = min(R, end - o0);
        float a[R][MB];
        gemv<R, MB, MODE, STAGED>(m, o0, nr, xp, xsc[xi % kMaxX], M, a, ring, lane);
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int b = 0; b < MB; ++b) {
              if (r < nr && b < M) {
                if (A.out_y)
                  A.out_y[(size_t)b * A.ytot + m.yoff + o0 + r] = __float2bfloat16(a[r][b]);
                else
                  tot[warp][b] += a[r][b];
              }
            }
          }
        }
      }
      if (A.sync == kSyncMatrix) grid_sync(g);
    }
    if (A.sync == kSyncStep) grid_sync(g);
  }
  __syncthreads();
  if (tid == 0) frt_grid_exit(g);
  if (A.out_sum && tid < M) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += tot[w][tid];
    atomicAdd(A.out_sum + tid, v);
  }
}

typedef void (*KernelFn)(const Args);

template <int R, int MB, int MODE>
KernelFn pick_load(bool staged) {
  return staged ? probe_kernel<R, MB, MODE, true> : probe_kernel<R, MB, MODE, false>;
}

template <int R, int MB>
KernelFn pick_mode(int mode, bool staged) {
  switch (mode) {
    case kBf16: return pick_load<R, MB, kBf16>(staged);
    case kInt8: return pick_load<R, MB, kInt8>(staged);
    case kInt4: return pick_load<R, MB, kInt4>(staged);
    default: return pick_load<R, MB, kS8S8>(staged);   // kS8S8, kS8S8Q
  }
}

KernelFn pick(int M, int mode, bool staged) {
  if (M <= 8) return pick_mode<4, 8>(mode, staged);
  if (M <= 16) return pick_mode<2, 16>(mode, staged);
  return pick_mode<1, 32>(mode, staged);
}

int rows_per_warp(int M) { return M <= 8 ? 4 : M <= 16 ? 2 : 1; }

}  // namespace

enum PtrIndex { P_MATS, P_XS, P_OUT_SUM, P_OUT_Y, P_BAR, P_COUNT };
enum IntIndex {
  I_NMAT, I_NX, I_YTOT, I_M, I_STEPS, I_MODE, I_SYNC, I_STAGED, I_XS_BYTES,
  I_QGROUP, I_COUNT
};

extern "C" int frt_gemv_probe_counts(int* ptrs, int* ints) {
  *ptrs = P_COUNT;
  *ints = I_COUNT;
  return 0;
}

// Shared memory a block may opt in to on this card, in bytes.
extern "C" int frt_gemv_probe_smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return v;
}

// Dynamic shared memory of a launch: the staged inputs (xs_bytes, 16-byte
// aligned), then the staged load's rings.
extern "C" int frt_gemv_probe_smem(int M, int staged, int xs_bytes) {
  return ((xs_bytes + 15) / 16) * 16 +
         (staged ? kWarps * kStages * rows_per_warp(M) * 32 * 16 : 0);
}

// Blocks of the cooperative grid (the SM count times the blocks an SM
// holds); negative: a CUDA error.
extern "C" int frt_gemv_probe_grid(int M, int mode, int staged, int smem) {
  const void* fn = (const void*)pick(M, mode, staged != 0);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

// ptrs: P_COUNT device pointers (P_OUT_SUM or P_OUT_Y null: the other form);
// ints: I_COUNT integers. xs_bytes > 0 stages the inputs in shared memory
// at the offsets of the input table. Returns 0 when the cooperative launch
// was accepted, else a CUDA error.
extern "C" int frt_gemv_probe(void* const* ptrs, const int* ints, void* stream) {
  Args A;
  A.mats = (const Mat*)ptrs[P_MATS];
  A.xs = (const XEnt*)ptrs[P_XS];
  A.out_sum = (float*)ptrs[P_OUT_SUM];
  A.out_y = (bf16*)ptrs[P_OUT_Y];
  A.bar = (unsigned*)ptrs[P_BAR];
  A.nmat = ints[I_NMAT]; A.nx = ints[I_NX]; A.ytot = ints[I_YTOT];
  A.M = ints[I_M]; A.steps = ints[I_STEPS]; A.sync = ints[I_SYNC];
  const int mode = ints[I_MODE], staged = ints[I_STAGED], xs_bytes = ints[I_XS_BYTES];
  A.qgroup = mode == kS8S8Q ? ints[I_QGROUP] : 0;
  A.xsmem = xs_bytes > 0;
  A.ring_off = ((xs_bytes + 15) / 16) * 16;
  if (A.M < 1 || A.M > 32 || A.steps < 0 || A.nmat < 0 || A.nx < 0 ||
      mode < kBf16 || mode > kS8S8Q || A.sync < kNoSync || A.sync > kSyncStep ||
      (A.nmat > 0 && A.nx < 1) || (mode >= kS8S8 && (A.nx > kMaxX || !A.xsmem)) ||
      (A.out_sum == nullptr) == (A.out_y == nullptr) || A.bar == nullptr)
    return (int)cudaErrorInvalidValue;
  const int smem = frt_gemv_probe_smem(A.M, staged, xs_bytes);
  const int grid = frt_gemv_probe_grid(A.M, mode, staged, smem);
  if (grid < 0) return -grid;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  void* params[] = {(void*)&A};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)pick(A.M, mode, staged != 0),
                                              dim3(grid), dim3(kThreads), params,
                                              (size_t)smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
