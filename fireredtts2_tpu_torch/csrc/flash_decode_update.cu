// Kernel C: in-place KV slab write + bounded flash attention for one layer of
// a merged (L, B, T, H*Dh) slab -- every vocoder transformer layer of the
// streaming decode. With the write switched off it is kernel D (the
// read-only bounded attention).
//
// Replaces: fireredtts2_tpu/ops/pallas_flash.py: flash_decode_update_bounded
// (_kernel with write=True, via _call) and flash_decode_bounded (the same
// _kernel with write=False).
//
// What bounds it on an H100: bytes, and parallelism at B=1. Each query does
// 4*Dh flops per slot (QK and PV) on 4*Dh bytes of K/V, so the cost is
// reading each head's live K/V rows; at the flagship (H=16, Dh=64, bf16,
// T=3008) a full window is 12 MB per layer per stream. S = 8..128 queries
// share those rows, so they are read once per block of 16 queries. At one
// stream there are only H * S/16 such blocks (16 at S=8), too few for 132
// SMs if each walked the whole window.
//
// How the design answers that:
// - write, then read, with no race: the TPU kernel writes every stream's
//   fresh rows from grid step 0 before any read, because its grid runs in
//   order. GPU blocks run in parallel, so the write is a separate launch on
//   the same stream, ahead of the attention launch; the write, attention
//   and merge launches together are one call of the kernel.
// - the write position is min(pos_b, T - Sw) (pallas_flash.py:162-163): a
//   stream past the slab's end overwrites the last rows instead of writing
//   out of bounds, which on a GPU would corrupt memory silently.
// - attention, split-KV: one block per (16 queries, head, 512-slot split of
//   the slab, stream), 256 threads = 16 query rows x 16 threads. K/V tiles
//   of 64 slots are staged in shared memory as fp32 and shared by the 16
//   queries; each thread keeps 4 score columns and Dh/16 output dims; fp32
//   online softmax (m, l, acc) per row over the split. A third launch
//   merges the splits' partials by exp(m_split - m_max); a split with
//   nothing to read marks m = -inf and the merge skips it.
// - per-query exclusive bounds q_end (B, S) (8-block-causal in the vocoder)
//   mask to -1e30, as the TPU kernel does; the block visits only the tiles
//   between its queries' lowest start and highest end, inside the batch's
//   live chunk range clamped to T (pallas_flash.py:_scalars). Slots beyond
//   that range are not read at all.
// - probabilities are rounded to bf16 before the PV product, the denominator
//   sums them unrounded (pallas_flash.py:219-225).
//
// A query with no live slot gets the mean of V over the slots its block
// visits (TPU: over the visited chunks); the vocoder never sends one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kQT = 16;                 // queries per block
constexpr int kKT = 64;                 // slab slots per tile
constexpr int kSplit = 512;             // slab slots per block (8 tiles)
constexpr int kThreads = kQT * 16;      // 16 threads per query row
constexpr int kCols = kKT / 16;         // score columns per thread
constexpr float kMask = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// live_lo may be null: no lower bound (0).
__device__ __forceinline__ void chunk_range(const int* live_lo,
                                            const int* live_hi, int T, int C,
                                            int* lo, int* hi) {
  const int nchunks = T / C;
  int nc = max((*live_hi + C - 1) / C, 1);
  int c0 = (live_lo != nullptr ? max(*live_lo, 0) : 0) / C;
  nc = min(nc, nchunks);
  c0 = min(c0, nchunks - 1);
  nc = max(nc, c0 + 1);
  *lo = c0 * C;
  *hi = nc * C;
}

// new_k/new_v (B, Sw, D) -> rows [p, p + Sw) of slab (B, T, D), 16 bytes a
// thread; p = min(pos_b, T - Sw), floored at 0.
__global__ void slab_write_kernel(const uint4* __restrict__ new_k,
                                  const uint4* __restrict__ new_v,
                                  uint4* __restrict__ k, uint4* __restrict__ v,
                                  const int* __restrict__ pos, int B, int Sw,
                                  int T, int D8) {
  const long long total = (long long)B * Sw * D8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % D8);
    const int r = (int)((i / D8) % Sw);
    const int b = (int)(i / ((long long)D8 * Sw));
    const int p = max(min(pos[b], T - Sw), 0);
    const size_t dst = ((size_t)b * T + p + r) * D8 + c;
    k[dst] = new_k[i];
    v[dst] = new_v[i];
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
bounded_attn_kernel(const __nv_bfloat16* __restrict__ q,   // (B, S, H*DH)
                    const __nv_bfloat16* __restrict__ k,   // (B, T, H*DH)
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ q_end,         // (B, S)
                    const int* __restrict__ q_start,       // (B, S) or null
                    const int* __restrict__ live_lo,       // () batch min start or null
                    const int* __restrict__ live_hi,       // () batch max end
                    float* __restrict__ part_m,            // (B, NS, H, S)
                    float* __restrict__ part_l,
                    float* __restrict__ part_acc,          // (..., DH)
                    int S, int H, int T, int C, int NS, float scale) {
  constexpr int kDims = DH / 16;        // output dims per thread
  constexpr int kVecRow = DH / 8;       // 16-byte vectors per head row
  __shared__ float q_sh[kQT][DH + 1];
  __shared__ float k_sh[kKT][DH + 1];
  __shared__ float v_sh[kKT][DH];
  __shared__ float p_sh[kQT][kKT + 1];
  __shared__ int bounds[2];

  const int qt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / NS, s = blockIdx.z % NS;
  const int D = H * DH;
  const int tid = threadIdx.x, r = tid / 16, c = tid % 16;
  const int qi = qt * kQT + r;
  const bool row_ok = qi < S;
  const int qe = row_ok ? q_end[(size_t)b * S + qi] : 0;
  const int qs = (row_ok && q_start != nullptr) ? q_start[(size_t)b * S + qi] : 0;

  if (tid == 0) {
    bounds[0] = INT_MAX;
    bounds[1] = INT_MIN;
  }
  for (int i = tid; i < kQT * DH; i += kThreads) {
    const int rr = i / DH, d = i % DH, qq = qt * kQT + rr;
    q_sh[rr][d] = qq < S ? __bfloat162float(q[((size_t)b * S + qq) * D + h * DH + d])
                         : 0.f;
  }
  __syncthreads();
  if (c == 0 && row_ok) {
    atomicMin(&bounds[0], qs);
    atomicMax(&bounds[1], qe);
  }
  __syncthreads();
  int lo, hi;
  chunk_range(live_lo, live_hi, T, C, &lo, &hi);
  lo = max(max(lo, bounds[0]), s * kSplit);
  hi = min(min(hi, bounds[1]), (s + 1) * kSplit);
  const size_t prow = ((size_t)(b * NS + s) * H + h) * S + qi;
  if (lo >= hi) {                       // nothing of this split to read
    if (c == 0 && row_ok) {
      part_m[prow] = -INFINITY;
      part_l[prow] = 0.f;
    }
    return;
  }

  float m = -INFINITY, l = 0.f, acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  const __nv_bfloat16* kb = k + (size_t)b * T * D + h * DH;
  const __nv_bfloat16* vb = v + (size_t)b * T * D + h * DH;
  for (int t0 = lo; t0 < hi; t0 += kKT) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < kKT * kVecRow; i += kThreads) {
      const int jj = i / kVecRow, vi = i % kVecRow, slot = t0 + jj;
      uint4 uk = make_uint4(0, 0, 0, 0), uv = uk;
      if (slot < hi) {
        uk = *reinterpret_cast<const uint4*>(kb + (size_t)slot * D + vi * 8);
        uv = *reinterpret_cast<const uint4*>(vb + (size_t)slot * D + vi * 8);
      }
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&uk);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&uv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fk = __bfloat1622float2(k2[e]);
        const float2 fv = __bfloat1622float2(v2[e]);
        k_sh[jj][vi * 8 + 2 * e] = fk.x;
        k_sh[jj][vi * 8 + 2 * e + 1] = fk.y;
        v_sh[jj][vi * 8 + 2 * e] = fv.x;
        v_sh[jj][vi * 8 + 2 * e + 1] = fv.y;
      }
    }
    __syncthreads();

    // Shared-memory loads bound this loop: each q element is loaded once
    // for the thread's kCols columns.
    float sc[kCols];
#pragma unroll
    for (int ci = 0; ci < kCols; ++ci) sc[ci] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qd = q_sh[r][d];
#pragma unroll
      for (int ci = 0; ci < kCols; ++ci) sc[ci] = fmaf(qd, k_sh[c + 16 * ci][d], sc[ci]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int ci = 0; ci < kCols; ++ci) {
      const int slot = t0 + c + 16 * ci;
      // slots past the block's range take no part; masked slots get -1e30
      sc[ci] = slot >= hi ? -INFINITY
             : (slot < qe && slot >= qs) ? sc[ci] * scale : kMask;
      mx = fmaxf(mx, sc[ci]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);   // finite: a tile starts inside the range
    const float corr = (m == -INFINITY) ? 0.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int ci = 0; ci < kCols; ++ci) {
      const float pe = expf(sc[ci] - m_new);
      psum += pe;
      p_sh[r][c + 16 * ci] = bf16_round(pe);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= corr;
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kKT; ++jj) {
      const float pj = p_sh[r][jj];
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[i] = fmaf(pj, v_sh[jj][c + 16 * i], acc[i]);
    }
  }

  if (row_ok) {
    if (c == 0) {
      part_m[prow] = m;
      part_l[prow] = l;
    }
#pragma unroll
    for (int i = 0; i < kDims; ++i) part_acc[prow * DH + c + 16 * i] = acc[i];
  }
}

// Merge the splits of one (stream, query, head): weights exp(m_s - M).
template <int DH>
__global__ void __launch_bounds__(DH)
bounded_combine_kernel(const float* __restrict__ part_m,
                       const float* __restrict__ part_l,
                       const float* __restrict__ part_acc,
                       __nv_bfloat16* __restrict__ out,    // (B, S, H*DH)
                       int S, int H, int NS) {
  const int idx = blockIdx.x, d = threadIdx.x;       // idx = (b*S + q)*H + h
  const int h = idx % H, q = (idx / H) % S, b = idx / (H * S);
  float M = -INFINITY;
  for (int s = 0; s < NS; ++s)
    M = fmaxf(M, part_m[((size_t)(b * NS + s) * H + h) * S + q]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < NS; ++s) {
    const size_t i = ((size_t)(b * NS + s) * H + h) * S + q;
    const float m = part_m[i];
    if (m == -INFINITY) continue;       // split with nothing to read
    const float w = expf(m - M);
    l = fmaf(w, part_l[i], l);
    acc = fmaf(w, part_acc[i * DH + d], acc);
  }
  out[(size_t)idx * DH + d] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
}

}  // namespace

extern "C" int frt_bounded_split_size() { return kSplit; }

// q (B, S, H*Dh) bf16; new_k/new_v (B, Sw, H*Dh) bf16 (ignored when
// write == 0); k, v: one layer of the slab, (B, T, H*Dh) bf16, written in
// place; pos (B,) int32; q_end (B, S) int32; q_start (B, S) int32 or null;
// live_lo () int32 batch min start, or null for 0; live_hi () int32 batch
// max end; part_* fp32 scratch
// of NS = ceil(T / split) splits; out (B, S, H*Dh) bf16.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int frt_flash_decode_update(const void* q, const void* new_k,
                                       const void* new_v, void* k, void* v,
                                       const int* pos, const int* q_end,
                                       const int* q_start, const int* live_lo,
                                       const int* live_hi, float* part_m,
                                       float* part_l, float* part_acc,
                                       void* out, int B, int S, int Sw, int H,
                                       int Dh, int T, int C, int NS, int write,
                                       float scale, void* stream) {
  // Dh = 64 only: the tiles of a wider head exceed 48 KB of static shared
  // memory.
  if (Dh != 64 || C < 1 || T % C != 0 || NS * kSplit < T ||
      (write && (Sw < 1 || Sw > T)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H * Dh;
  if (write) {
    const long long n = (long long)B * Sw * (D / 8);
    const long long want = (n + 255) / 256;
    const int blocks = (int)(want < 4096 ? want : 4096);
    slab_write_kernel<<<blocks, 256, 0, st>>>(
        static_cast<const uint4*>(new_k), static_cast<const uint4*>(new_v),
        static_cast<uint4*>(k), static_cast<uint4*>(v), pos, B, Sw, T, D / 8);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + kQT - 1) / kQT, H, B * NS);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  bounded_attn_kernel<64><<<grid, kThreads, 0, st>>>(
      qp, kp, vp, q_end, q_start, live_lo, live_hi, part_m, part_l, part_acc,
      S, H, T, C, NS, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bounded_combine_kernel<64><<<B * S * H, 64, 0, st>>>(part_m, part_l, part_acc,
                                                       op, S, H, NS);
  return (int)cudaGetLastError();
}
