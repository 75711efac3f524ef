// Kernel C: in-place KV slab write + bounded flash attention for one layer of
// a merged (L, B, T, H*Dh) slab -- every vocoder transformer layer of the
// streaming decode. With the write switched off it is kernel D (the
// read-only bounded attention).
//
// Replaces: fireredtts2_tpu/ops/pallas_flash.py: flash_decode_update_bounded
// (_kernel with write=True, via _call) and flash_decode_bounded (the same
// _kernel with write=False).
//
// What bounds it on an H100: bytes. S = 8..128 queries of a head share the
// head's live K/V rows, so each query does 4*Dh flops per slot against
// 4*Dh bytes of K/V read once for all S: at S=128 that is ~128 flops a byte,
// below the ~295 at which the bf16 tensor cores become the limit, and far
// above what fp32 FMAs (67 TF/s) sustain at the memory rate. At the flagship
// (H=16, Dh=64, bf16, T=3008) a full window is 12 MB per layer per stream.
// Parallelism matters at B=1: 16 heads, so the window must be split.
//
// How the design answers that:
// - one block per (KV split, head, stream) holds all S <= 128 queries (one
//   warp per 16 query rows, at least four warps for the copies), so each
//   head's live rows are read from device memory once per call; S > 128
//   takes further blocks of 128 queries;
// - K/V tiles of 64 slots stay bf16 in shared memory: a 3-stage ring filled
//   by 16-byte cp.async (zero fill past the range), the 16-byte chunks of
//   each 128-byte row XOR-swizzled by the row so that ldmatrix reads them
//   without bank conflicts;
// - QK^T and PV run on the tensor cores, mma.sync m16n8k16 bf16 with fp32
//   accumulation (what the TPU kernel's two bf16 MXU dots do,
//   pallas_flash.py:212-226): Q's A fragments stay in registers for the
//   whole walk, K's B fragments come from ldmatrix, V's from ldmatrix.trans;
//   the scores' C fragments become PV's A fragments in registers after the
//   probabilities are rounded to bf16 (p.astype(vc.dtype)); the denominator
//   sums the unrounded fp32 probabilities;
// - online softmax per row in fp32 registers, reduced over the four lanes
//   of a row, in base 2 (scores scaled by log2(e)/sqrt(Dh)); masked slots
//   (outside [q_start, q_end)) score -1e30 as in the TPU kernel, slots past
//   the block's range take no part; a warp whose rows all end before a tile
//   (or start after it) skips that tile's products, which changes nothing
//   for a row with a live slot;
// - the block visits only the tiles between its queries' lowest start and
//   highest end, inside the batch's live chunk range clamped to T
//   (pallas_flash.py:_scalars, chunk_range below) and inside its split;
// - the split size is the wrapper's (ops/flash_decode.py: bounded_split, a
//   function of T, B and H that gives the grid ~264 blocks, two per SM);
//   with more than one split, blocks leave fp32 partials (m, l, acc) and the
//   last block of a (stream, head, query block) to finish -- an atomic count
//   that it resets to 0 -- merges them by exp2(m_split - m_max);
// - the slab write is folded into the same launch: slots in [p_b, p_b + Sw)
//   are read straight from new_k/new_v, and the block whose split covers a
//   fresh row (by the split's nominal range, whether or not it attends to
//   it) copies its head's slice of that row into the slab. No block reads
//   those slab rows, so there is no race, and a call is one launch (it was
//   three: write, attention, merge). The write position is
//   p_b = min(pos_b, T - Sw), floored at 0 (pallas_flash.py:162-163): a
//   stream past the slab's end overwrites the last rows instead of writing
//   out of bounds.
//
// A query with no live slot in the visited range gets the mean of V over the
// slots visited before its warp skipped (TPU: over the visited chunks), or
// zeros; the vocoder never sends one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kDh = 64;                 // head width, the vocoder's
constexpr int kKT = 64;                 // slab slots per tile
constexpr int kStages = 3;              // cp.async ring depth
constexpr int kMaxWarps = 8;
constexpr int kQB = kMaxWarps * 16;     // queries per block
constexpr int kTileBytes = kKT * kDh * 2;           // one K or V tile
constexpr int kSmemBytes = kStages * 2 * kTileBytes;  // 48 KB
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSplits = kSmemBytes / (2 * 4 * kQB);  // the merge's (m, l)

struct Args {
  const __nv_bfloat16* q;       // (B, S, H*Dh)
  const __nv_bfloat16* new_k;   // (B, Sw, H*Dh), null without the write
  const __nv_bfloat16* new_v;
  __nv_bfloat16* k;             // (B, T, H*Dh), one layer of the slab
  __nv_bfloat16* v;
  const int* pos;               // (B,), null without the write
  const int* q_end;             // (B, S)
  const int* q_start;           // (B, S) or null (0)
  const int* live_lo;           // () or null (0)
  const int* live_hi;           // ()
  float* part_m;                // (B, H, NS, S), null when NS == 1
  float* part_l;
  float* part_acc;              // (B, H, NS, S, Dh)
  int* counters;                // (B * H * NQ), zero between calls
  __nv_bfloat16* out;           // (B, S, H*Dh)
  int B, S, Sw, H, T, C, SP, NS;
  float scale_log2;             // log2(e) / sqrt(Dh)
};

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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kMaxWarps * 32, 2)
bounded_attn_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ int s_bounds[2];
  __shared__ int s_last;

  const int NQ = (a.S + kQB - 1) / kQB;
  const int s = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / NQ, qg = blockIdx.z % NQ;
  const int D = a.H * kDh;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int q0 = qg * kQB;
  const int qn = min(kQB, a.S - q0);
  const int split_lo = s * a.SP, split_hi = min(split_lo + a.SP, a.T);
  const size_t hoff = (size_t)h * kDh;

  // 1. This split's share of the slab write (query block 0 only).
  int p = 0;
  const bool write = a.pos != nullptr;
  if (write) {
    p = max(min(a.pos[b], a.T - a.Sw), 0);
    if (qg == 0) {
      const int r0 = max(split_lo, p) - p;
      const int n = (min(split_hi, p + a.Sw) - p - r0) * (kDh / 8);
      for (int i = tid; i < n; i += nthr) {
        const int r = r0 + i / (kDh / 8), c = i % (kDh / 8);
        const size_t src = ((size_t)b * a.Sw + r) * D + hoff + c * 8;
        const size_t dst = ((size_t)b * a.T + p + r) * D + hoff + c * 8;
        *reinterpret_cast<uint4*>(a.k + dst) =
            *reinterpret_cast<const uint4*>(a.new_k + src);
        *reinterpret_cast<uint4*>(a.v + dst) =
            *reinterpret_cast<const uint4*>(a.new_v + src);
      }
    }
  }

  // 2. The block's range: its queries' lowest start and highest end, the
  // batch's live chunk range, its split.
  if (tid == 0) {
    s_bounds[0] = INT_MAX;
    s_bounds[1] = INT_MIN;
  }
  __syncthreads();
  {
    int mn = INT_MAX, mx = INT_MIN;
    for (int i = tid; i < qn; i += nthr) {
      const size_t qi = (size_t)b * a.S + q0 + i;
      mx = max(mx, a.q_end[qi]);
      mn = min(mn, a.q_start != nullptr ? a.q_start[qi] : 0);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (lane == 0) {
      atomicMax(&s_bounds[1], mx);
      atomicMin(&s_bounds[0], mn);
    }
  }
  __syncthreads();
  int lo, hi;
  chunk_range(a.live_lo, a.live_hi, a.T, a.C, &lo, &hi);
  lo = max(max(lo, s_bounds[0]), split_lo);
  hi = min(min(hi, s_bounds[1]), split_hi);
  const int ntiles = lo < hi ? (hi - lo + kKT - 1) / kKT : 0;

  // 3. This warp's query rows (gq and gq + 8 of its 16) and their bounds.
  const int wr = warp * 16;
  const bool warp_rows = wr < qn;
  const int ra = wr + gq, rb = ra + 8;                // rows in the block
  const bool ok_a = ra < qn, ok_b = rb < qn;
  const size_t qa_i = (size_t)b * a.S + q0 + ra, qb_i = qa_i + 8;
  const int qe_a = ok_a ? a.q_end[qa_i] : 0;
  const int qe_b = ok_b ? a.q_end[qb_i] : 0;
  const int qs_a = (ok_a && a.q_start != nullptr) ? a.q_start[qa_i] : 0;
  const int qs_b = (ok_b && a.q_start != nullptr) ? a.q_start[qb_i] : 0;
  // The warp's rows (past S excluded): the widest and the narrowest bounds.
  int w_end = max(qe_a, qe_b);
  int w_start = min(ok_a ? qs_a : INT_MAX, ok_b ? qs_b : INT_MAX);
  int w_end_min = min(ok_a ? qe_a : INT_MAX, ok_b ? qe_b : INT_MAX);
  int w_start_max = max(qs_a, qs_b);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    w_end = max(w_end, __shfl_xor_sync(0xffffffffu, w_end, o));
    w_start = min(w_start, __shfl_xor_sync(0xffffffffu, w_start, o));
    w_end_min = min(w_end_min, __shfl_xor_sync(0xffffffffu, w_end_min, o));
    w_start_max = max(w_start_max, __shfl_xor_sync(0xffffffffu, w_start_max, o));
  }

  // Q's A fragments, 4 k-steps of 16 head dims, zero for rows past S.
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const size_t ca = qa_i * D + hoff + 16 * kk + 2 * t;
    const size_t cb = qb_i * D + hoff + 16 * kk + 2 * t;
    qf[kk][0] = ok_a ? ld_u32(a.q + ca) : 0u;
    qf[kk][1] = ok_b ? ld_u32(a.q + cb) : 0u;
    qf[kk][2] = ok_a ? ld_u32(a.q + ca + 8) : 0u;
    qf[kk][3] = ok_b ? ld_u32(a.q + cb + 8) : 0u;
  }

  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  // 4. The walk: a ring of kStages tiles, one commit group per tile.
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(ring);
  const __nv_bfloat16* kb = a.k + (size_t)b * a.T * D + hoff;
  const __nv_bfloat16* vb = a.v + (size_t)b * a.T * D + hoff;
  auto load_tile = [&](int i) {
    const int t0 = lo + i * kKT;
    const uint32_t st = sbase + (i % kStages) * 2 * kTileBytes;
    for (int c = tid; c < 2 * kKT * 8; c += nthr) {
      const int kv = c / (kKT * 8), rr = (c / 8) % kKT, ch = c % 8;
      const int slot = t0 + rr;
      const __nv_bfloat16* src = kv ? vb : kb;
      int bytes = 16;
      if (slot >= hi) {
        bytes = 0;                                   // zero fill
      } else if (write && slot >= p && slot < p + a.Sw) {
        src = (kv ? a.new_v : a.new_k) +
              ((size_t)b * a.Sw + (slot - p)) * D + hoff + ch * 8;
      } else {
        src += (size_t)slot * D + ch * 8;
      }
      frt_cp_async16(st + kv * kTileBytes + rr * 128 + ((ch ^ (rr & 7)) << 4),
                     src, bytes);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) load_tile(i);
    frt_cp_async_commit();
  }
  const int mat = lane >> 3, mr = lane & 7;         // ldmatrix row of a lane
  for (int i = 0; i < ntiles; ++i) {
    frt_cp_async_wait<kStages - 2>();
    __syncthreads();                 // tile i landed; tile i-1 is consumed
    if (i + kStages - 1 < ntiles) load_tile(i + kStages - 1);
    frt_cp_async_commit();

    const int t0 = lo + i * kKT;
    if (!warp_rows || t0 >= w_end || t0 + kKT <= w_start) continue;
    const uint32_t ks = sbase + (i % kStages) * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;

    // S = Q K^T: 16 rows x 64 slots, n-tiles of 8 slots in pairs.
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int rr = 8 * (2 * jp + (mat >> 1)) + mr;
        const int ch = 2 * kk + (mat & 1);
        uint32_t bf[4];
        frt_ldmatrix_x4(bf, ks + rr * 128 + ((ch ^ mr) << 4));
        frt_mma_bf16(sc[2 * jp], qf[kk], bf[0], bf[1]);
        frt_mma_bf16(sc[2 * jp + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // Online softmax in base 2. A tile inside every row's bounds and the
    // block's range needs no mask (most tiles of a long window).
    const bool unmasked = t0 + kKT <= hi && t0 + kKT <= w_end_min &&
                          t0 >= w_start_max;
    if (unmasked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= a.scale_log2;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int slot = t0 + 8 * j + 2 * t + e;
          const bool in = slot < hi;
          sc[j][e] = !in ? -INFINITY
                   : (slot < qe_a && slot >= qs_a) ? sc[j][e] * a.scale_log2
                                                   : kMask;
          sc[j][2 + e] = !in ? -INFINITY
                       : (slot < qe_b && slot >= qs_b)
                           ? sc[j][2 + e] * a.scale_log2 : kMask;
        }
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    // finite: slot t0 lies inside the range, so every row has a score
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = m_a == -INFINITY ? 0.f : frt_fast_exp2(m_a - mn_a);
    const float corr_b = m_b == -INFINITY ? 0.f : frt_fast_exp2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = frt_fast_exp2(sc[j][e] - mn_a);
        sc[j][2 + e] = frt_fast_exp2(sc[j][2 + e] - mn_b);
        ps_a += sc[j][e];
        ps_b += sc[j][2 + e];
      }
    }
    l_a = l_a * corr_a + ps_a;        // this lane's share; reduced at the end
    l_b = l_b * corr_b + ps_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= corr_a;
      acc[j][1] *= corr_a;
      acc[j][2] *= corr_b;
      acc[j][3] *= corr_b;
    }

    // O += bf16(P) V: P's A fragments from the score fragments.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pf[4];
      pf[0] = frt_pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pf[1] = frt_pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pf[2] = frt_pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pf[3] = frt_pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int rr = 16 * kk + 8 * (mat & 1) + mr;
        const int ch = 2 * jp + (mat >> 1);
        uint32_t bf[4];
        frt_ldmatrix_x4_trans(bf, vs + rr * 128 + ((ch ^ mr) << 4));
        frt_mma_bf16(acc[2 * jp], pf, bf[0], bf[1]);
        frt_mma_bf16(acc[2 * jp + 1], pf, bf[2], bf[3]);
      }
    }
  }
  frt_cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }

  // 5a. One split: normalise and write.
  if (a.NS == 1) {
    const float ia = 1.f / fmaxf(l_a, 1e-30f), ib = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (ok_a)
        *reinterpret_cast<__nv_bfloat162*>(a.out + qa_i * D + hoff + d) =
            __floats2bfloat162_rn(acc[j][0] * ia, acc[j][1] * ia);
      if (ok_b)
        *reinterpret_cast<__nv_bfloat162*>(a.out + qb_i * D + hoff + d) =
            __floats2bfloat162_rn(acc[j][2] * ib, acc[j][3] * ib);
    }
    return;
  }

  // 5b. Several splits: leave the partials; the last block merges.
  const size_t bh = (size_t)b * a.H + h;
  const size_t prow = (bh * a.NS + s) * a.S + q0;     // row q0 of this split
  if (t == 0) {
    if (ok_a) {
      a.part_m[prow + ra] = m_a;
      a.part_l[prow + ra] = l_a;
    }
    if (ok_b) {
      a.part_m[prow + rb] = m_b;
      a.part_l[prow + rb] = l_b;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = 8 * j + 2 * t;
    if (ok_a)
      *reinterpret_cast<float2*>(a.part_acc + (prow + ra) * kDh + d) =
          make_float2(acc[j][0], acc[j][1]);
    if (ok_b)
      *reinterpret_cast<float2*>(a.part_acc + (prow + rb) * kDh + d) =
          make_float2(acc[j][2], acc[j][3]);
  }
  __threadfence();
  __syncthreads();
  int* counter = a.counters + bh * NQ + qg;
  if (tid == 0) s_last = atomicAdd(counter, 1) == a.NS - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The merge, in three passes over the block's threads, the partials read
  // from L2 with independent loads: (m, l) of every (split, row) into
  // shared memory (the ring, free now); each row's weights
  // exp2(m_s - M) / L in place of m; then float4s of the output.
  float* sw = reinterpret_cast<float*>(ring);           // (NS, kQB)
  float* sl = sw + a.NS * kQB;
  const size_t base = bh * a.NS * a.S + q0;             // split 0, row q0
  for (int i = tid; i < a.NS * qn; i += nthr) {
    const int sp = i / qn, r = i % qn;
    const size_t pi = base + (size_t)sp * a.S + r;
    sw[sp * kQB + r] = __ldcg(a.part_m + pi);
    sl[sp * kQB + r] = __ldcg(a.part_l + pi);
  }
  __syncthreads();
  for (int r = tid; r < qn; r += nthr) {
    float M = -INFINITY;
    for (int sp = 0; sp < a.NS; ++sp) M = fmaxf(M, sw[sp * kQB + r]);
    float L = 0.f;
    for (int sp = 0; sp < a.NS; ++sp) {
      const float m = sw[sp * kQB + r];
      const float w = m == -INFINITY ? 0.f : frt_fast_exp2(m - M);  // empty split
      sw[sp * kQB + r] = w;
      L = fmaf(w, sl[sp * kQB + r], L);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int sp = 0; sp < a.NS; ++sp) sw[sp * kQB + r] *= inv;
  }
  __syncthreads();
  for (int i = tid; i < qn * (kDh / 4); i += nthr) {
    const int r = i / (kDh / 4), c = (i % (kDh / 4)) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < a.NS; ++sp) {
      const float w = sw[sp * kQB + r];
      const float4 v4 = __ldcg(reinterpret_cast<const float4*>(
          a.part_acc + (base + (size_t)sp * a.S + r) * kDh + c));
      o.x = fmaf(w, v4.x, o.x);
      o.y = fmaf(w, v4.y, o.y);
      o.z = fmaf(w, v4.z, o.z);
      o.w = fmaf(w, v4.w, o.w);
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        a.out + ((size_t)b * a.S + q0 + r) * D + hoff + c);
    dst[0] = __floats2bfloat162_rn(o.x, o.y);
    dst[1] = __floats2bfloat162_rn(o.z, o.w);
  }
  if (tid == 0) *counter = 0;          // ready for the next call
}

}  // namespace

extern "C" int frt_bounded_tile() { return kKT; }
extern "C" int frt_bounded_max_queries() { return kQB; }
extern "C" int frt_bounded_max_splits() { return kMaxSplits; }

// q (B, S, H*Dh) bf16; new_k/new_v (B, Sw, H*Dh) bf16 (ignored when
// write == 0); k, v: one layer of the slab, (B, T, H*Dh) bf16, written in
// place; pos (B,) int32; q_end (B, S) int32; q_start (B, S) int32 or null;
// live_lo () int32 batch min start, or null for 0; live_hi () int32 batch
// max end; NS = ceil(T / SP) splits of SP slots (a multiple of the tile);
// with NS > 1, part_* fp32 scratch (B, H, NS, S[, Dh]) and counters
// (B * H * ceil(S / 128)) int32, zero before the call and left zero after
// it; out (B, S, H*Dh) bf16. One launch.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int frt_flash_decode_update(
    const void* q, const void* new_k, const void* new_v, void* k, void* v,
    const int* pos, const int* q_end, const int* q_start, const int* live_lo,
    const int* live_hi, float* part_m, float* part_l, float* part_acc,
    int* counters, void* out, int B, int S, int Sw, int H, int Dh, int T,
    int C, int SP, int NS, int write, float scale, void* stream) {
  if (Dh != kDh || B < 1 || S < 1 || H < 1 || C < 1 || T % C != 0 ||
      SP < kKT || SP % kKT != 0 || NS < 1 || NS > kMaxSplits ||
      (long long)NS * SP < T ||
      (long long)(NS - 1) * SP >= T || (write && (Sw < 1 || Sw > T)) ||
      (NS > 1 && (part_m == nullptr || part_l == nullptr ||
                  part_acc == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        bounded_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.new_k = write ? static_cast<const __nv_bfloat16*>(new_k) : nullptr;
  a.new_v = write ? static_cast<const __nv_bfloat16*>(new_v) : nullptr;
  a.k = static_cast<__nv_bfloat16*>(k);
  a.v = static_cast<__nv_bfloat16*>(v);
  a.pos = write ? pos : nullptr;
  a.q_end = q_end;
  a.q_start = q_start;
  a.live_lo = live_lo;
  a.live_hi = live_hi;
  a.part_m = part_m;
  a.part_l = part_l;
  a.part_acc = part_acc;
  a.counters = counters;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.S = S;
  a.Sw = write ? Sw : 0;
  a.H = H;
  a.T = T;
  a.C = C;
  a.SP = SP;
  a.NS = NS;
  a.scale_log2 = scale * kLog2e;
  const int nq = (S + kQB - 1) / kQB;
  const int rows = S < kQB ? S : kQB;
  int warps = (rows + 15) / 16;
  warps = warps < 4 ? 4 : warps;
  const dim3 grid(NS, H, B * nq);
  bounded_attn_kernel<<<grid, warps * 32, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
