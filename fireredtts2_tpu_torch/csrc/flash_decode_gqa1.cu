// Kernel A: S=1 grouped-query decode attention over one layer of a merged
// (L, B, T, Hkv*Dh) KV slab -- the LM backbone's per-frame decode step. It
// also serves kernel F (ops/flash_decode.py: pallas_decode_attention) over
// a (1, B, T, Hkv*Dh) view of unmerged slabs.
//
// Replaces: fireredtts2_tpu/ops/pallas_flash.py: flash_decode_gqa1
// (_kernel_gqa1), the Pallas TPU kernel that walks the live slab chunks of
// each stream in order on one core with a DMA ring and an fp32 online
// softmax.
//
// What bounds it on an H100: bytes. Each query row does 4*Dh flops per slab
// slot against 4*Dh bytes of K/V that a kv head's G query heads share, far
// below the ~295 flop/byte the card needs before compute matters, so the
// floor is reading the live K/V window once: 1 KB a slot a stream at the
// flagship (Hkv=2, Dh=128, bf16), ~3 MB a layer for a 3000-slot window at
// B=1, ~0.9 us at 3.35 TB/s. That floor is far below a launch, so what
// costs is latency: round trips to device memory, phases fenced by block
// barriers, and launches. The design spends as few of each as it can:
//
// - one launch a call. One block per (KV split, kv head, stream); a block
//   whose split lies outside the stream's window exits at once. Every block
//   of a (stream, kv head) computes the same count of splits with live
//   slots (n_act) from the same bounds, so only those blocks arrive at the
//   (stream, kv head)'s merge count. With one such split its block writes
//   the output itself; with several, each leaves fp32 partials (m, l, acc)
//   and the last to arrive -- an atomic count, which it resets to 0 --
//   merges them. Nothing syncs with the host, so a CUDA graph can capture
//   the call.
// - the whole split in flight at once: before it computes anything, warp 0
//   issues the split's K and V as TMA tensor copies (cp.async.bulk.tensor,
//   boxes of 32 slots x 64 head dims, a box a lane, bulk_copy.cuh),
//   completing on two mbarriers. The tensor maps (one per slab view, cached
//   by the host) swizzle each 128-byte row by its slot (SWIZZLE_128B), so
//   ldmatrix reads eight rows without a bank conflict. At the flagship a
//   3000-slot window at B=1 is 3 MB in flight across the grid: one round
//   trip.
// - the slots live in the stream's window [q_start, q_end) inside the
//   batch's live chunk range (the chunk clamps of pallas_flash.py:_scalars,
//   so nothing past T is used); a box reads at most 31 slots past the
//   window's end, which take no part.
// - both products on the tensor cores, mma.sync m16n8k16 bf16 with fp32
//   accumulation, with the slots as the 16 rows and the kv head's G <= 8
//   query heads as the 8 columns (6 padded to 8, not to 16): scores
//   S^T = K Q^T (K by ldmatrix, Q^T in registers, loaded before anything
//   else), output O^T = V^T P (V^T by ldmatrix.trans, P from shared
//   memory). Two phases, one block barrier between them: scores, each
//   16-slot tile's P = exp2(s - m_tile) and its sum (a warp a tile, in
//   registers); then P V (a warp a 16-dim slice of the output, over every
//   slot of the split, each tile's product weighted by exp2(m_tile - m)).
// - the merge count is one acquire-release add (grid_sync.cuh); the merge
//   takes one round trip a chunk: the last block copies the partials of
//   the live splits (m and l padded to 8 heads a split, acc) into its
//   shared memory with bulk copies, as many as the allocation holds, and a
//   thread per 4 dims of a head weights them by exp2(m_split - m_max) in
//   registers, rescaling what an earlier chunk summed.
// - fp32 scores scaled by log2(e)/sqrt(Dh) and an fp32 softmax in base 2;
//   probabilities are rounded to bf16 before the P V product, against the
//   tile's maximum as pallas_flash.py:584-587 rounds against the running
//   one; the denominator sums the unrounded fp32 probabilities.
//
// The split size is the library's (frt_gqa1_plan), from what the host
// knows, (B, Hkv, G, T, Dh): among 64, 128 and 256 slots, the smallest whose
// grid over the whole slab fits one wave of resident blocks, else the one
// with the fewest blocks per resident slot; the shared memory grows for a
// one-chunk merge only where the grid still fits one wave with it (at the
// flagship: 64 slots and a one-chunk merge at B=1, 128 slots and a merge in
// chunks of 21 at B=8). The live length sits on the device and is not read.
// FRT_GQA1_SPLIT=<slots> builds a variant with a fixed split,
// FRT_GQA1_NOGROW one whose shared memory never grows, both for sweeps.
//
// A stream whose window is empty (q_end <= q_start) gets zeros here, where
// the TPU kernel would return the mean of V over the visited chunks; the LM
// never sends one (every stream attends at least to its own fresh slot).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "bulk_copy.cuh"
#include "grid_sync.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;              // query heads per kv head: the mma's n
constexpr int kTile = 16;             // slots per score tile: the mma's m
constexpr int kBoxRows = 32;          // slots per TMA box
constexpr int kBoxCols = 64;          // head dims per TMA box: 128 bytes
constexpr int kMaxSplit = 256;
constexpr float kLog2e = 1.4426950408889634f;
#ifdef FRT_GQA1_SPLIT
constexpr int kSplits[] = {FRT_GQA1_SPLIT};
static_assert(FRT_GQA1_SPLIT % kBoxRows == 0 && FRT_GQA1_SPLIT <= kMaxSplit,
              "FRT_GQA1_SPLIT: a multiple of 32 up to 256");
#else
constexpr int kSplits[] = {64, 128, 256};
#endif

// FRT_GQA1_TRACE builds (sweeps only, tools/sweep_gqa1.py): thread 0 of
// each live block of stream 0, kv head 0 (splits < 64) stamps the device
// clock (globaltimer, ns) at the edges of its phases: 0 start, 1 copies
// issued, 2 K landed, 3 scores and P done and V landed, 4 P V, 5 counted at
// the merge, 6 the merge's first chunk landed, 7 its sums, 8 output written
// (the merging block, or a lone split's).
// frt_gqa1_trace reads and clears the stamps. The serving build has none.
#ifdef FRT_GQA1_TRACE
constexpr int kTraceBlocks = 64, kTraceStamps = 9;
__device__ unsigned long long g_trace[kTraceBlocks][kTraceStamps];
#define FRT_STAMP(i)                                                        \
  do {                                                                      \
    if (tid == 0 && b == 0 && kh == 0 && s < kTraceBlocks) {                \
      unsigned long long t_;                                                \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \
      g_trace[s][i] = t_;                                                   \
    }                                                                       \
  } while (0)
#else
#define FRT_STAMP(i) \
  do {               \
  } while (0)
#endif

struct Args {
  const __nv_bfloat16* q;     // (B, Hkv*G, Dh)
  const int* q_start;         // (B,)
  const int* q_end;           // (B,)
  const int* live_lo;         // () batch min start
  const int* live_hi;         // () batch max end
  float* part_m;              // (B, Hkv, NS, kMaxG)
  float* part_l;
  float* part_acc;            // (B, Hkv, NS, G, Dh)
  int* counters;              // (B * Hkv), zero between calls
  __nv_bfloat16* out;         // (B, Hkv*G, Dh)
  int Hkv, G, T, C, SP, NS;
  int merge_cap;              // splits a merge chunk holds
  float scale_log2;           // log2(e) / sqrt(Dh)
};

// Dynamic shared memory of a block: up to 1 KB to align the K/V rows to the
// swizzle's 1024 bytes, then K and V, each as Dh/64 column halves of SP
// rows of 128 bytes, the probabilities (kMaxG, SP + 8) bf16 (the pad puts
// the rows a warp touches together in different banks), and each 16-slot
// tile's score maximum and probability sum per head. The merge reuses it
// from the K rows for as many splits' partials as fit: all NS when the
// allocation may grow to hold them.
constexpr int kMaxDynSmem = 231424;   // 226 KB of the 227 a block may have

__host__ __device__ constexpr int compute_bytes(int dh, int sp) {
  return 2 * sp * dh * 2 + kMaxG * (sp + 8) * 2 + 2 * (sp / kTile) * kMaxG * 4;
}

__host__ __device__ constexpr int split_bytes(int dh, int g) {
  return 2 * kMaxG * 4 + g * dh * 4;          // m and l padded to 8, acc
}

// A launch's dynamic shared memory: the compute's, or grown to hold every
// split's partials for a one-chunk merge (at most kMaxDynSmem).
__host__ __device__ constexpr int compute_smem(int dh, int sp) {
  return 1024 + compute_bytes(dh, sp);
}

__host__ __device__ constexpr int grown_smem(int dh, int sp, int ns, int g) {
  return 1024 + ns * split_bytes(dh, g) > kMaxDynSmem
             ? kMaxDynSmem
             : (ns * split_bytes(dh, g) > compute_bytes(dh, sp)
                    ? 1024 + ns * split_bytes(dh, g)
                    : compute_smem(dh, sp));
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

// Over the 8 lanes of a fragment column pair (lanes t, t + 4, ..., t + 28).
__device__ __forceinline__ float col_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Byte offset of head dim `col`'s 16-byte chunk in slot row `row` of a
// K/V region of SP rows: its 64-dim half, the row, the swizzled chunk.
__device__ __forceinline__ uint32_t kv_offset(int row, int col, int SP) {
  return (uint32_t)((col >> 6) * SP * 128 + row * 128 +
                    ((((col & 63) >> 3) ^ (row & 7)) << 4));
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
gqa1_kernel(const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const Args a) {
  constexpr int KSTEPS = DH / 16;     // k-steps of a score tile = output slices
  constexpr int HALVES = DH / kBoxCols;
  constexpr int kTilesPerWarp = kMaxSplit / kTile / kWarps;
  static_assert(KSTEPS <= kWarps, "a warp per 16-dim output slice");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];
  __shared__ int s_last;

  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;       // mma fragment row, column pair
  const int mat = lane >> 3, mr = lane & 7;     // ldmatrix matrix, row
  const int G = a.G, SP = a.SP;
  const size_t bh = (size_t)b * a.Hkv + kh;
  __nv_bfloat16* out = a.out + bh * G * DH;     // (G, DH) of (stream, kv head)

  // The tensor maps' descriptors and Q^T's B fragments, first: k = head
  // dims 2t, 2t+1 (+8) of each 16-dim step, n = query head gq (zeros past
  // G).
  if (tid == 0) {
    frt_prefetch_tensormap(&tk);
    frt_prefetch_tensormap(&tv);
  }
  uint32_t qf[KSTEPS][2];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        a.q + (bh * G + (gq < G ? gq : 0)) * DH) + t;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      qf[kk][0] = gq < G ? __ldg(qr + 8 * kk) : 0u;
      qf[kk][1] = gq < G ? __ldg(qr + 8 * kk + 4) : 0u;
    }
  }

  // 1. The stream's window, its splits with live slots, this block's slots.
  int lo, hi;
  chunk_range(a.live_lo, a.live_hi, a.T, a.C, &lo, &hi);
  lo = max(lo, a.q_start[b]);
  hi = min(hi, a.q_end[b]);
  const int s_lo = lo / SP;
  const int n_act = hi > lo ? (hi - 1) / SP - s_lo + 1 : 0;
  if (n_act == 0) {                             // empty window: zeros
    if (s == 0) {
      for (int i = tid; i < G * DH; i += kThreads) out[i] = __float2bfloat16(0.f);
    }
    return;
  }
  if (s < s_lo || s >= s_lo + n_act) return;
  const int r0 = max(lo, s * SP);
  const int n = min(hi, (s + 1) * SP) - r0;
  const int ntiles = (n + kTile - 1) / kTile;
  FRT_STAMP(0);

  const uint32_t raw = frt_smem_addr(smem_raw);
  const uint32_t ks_a = (raw + 1023u) & ~1023u;  // K rows, 1024-aligned
  const uint32_t vs_a = ks_a + SP * DH * 2;
  unsigned char* ks = smem_raw + (ks_a - raw);
  unsigned char* vs = ks + SP * DH * 2;
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(vs + SP * DH * 2);
  const int PP = SP + 8;
  float* tmax = reinterpret_cast<float*>(ps + kMaxG * PP);   // (SP/16, kMaxG)
  float* tsum = tmax + (SP / kTile) * kMaxG;
  const uint32_t kbar = frt_smem_addr(&bars[0]), vbar = kbar + 8, mbar = kbar + 16;

  // 2. The split's K and V in flight: boxes of 32 slots x 64 dims, a box a
  // lane of warp 0.
  if (warp == 0) {
    const int nbox = (n + kBoxRows - 1) / kBoxRows;
    if (lane == 0) {
      frt_mbar_init(kbar, 1);
      frt_mbar_init(vbar, 1);
      frt_mbar_init(mbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      const unsigned bytes = (unsigned)(nbox * kBoxRows * DH * 2);
      frt_mbar_expect_tx(kbar, bytes);
      frt_mbar_expect_tx(vbar, bytes);
    }
    __syncwarp();
    const int nk = HALVES * nbox, row = b * a.T + r0;
    for (int i = lane; i < 2 * nk; i += 32) {
      const bool isv = i >= nk;
      const int h = (isv ? i - nk : i) / nbox, x = (isv ? i - nk : i) % nbox;
      frt_tma_load_2d((isv ? vs_a : ks_a) + (h * SP + x * kBoxRows) * 128,
                      isv ? &tv : &tk, kh * DH + h * kBoxCols,
                      row + x * kBoxRows, isv ? vbar : kbar);
    }
    FRT_STAMP(1);
  }
  __syncthreads();                              // the barriers' init is seen

  // 3. Scores S^T = K Q^T in registers, a warp a 16-slot tile (two at 256
  // slots), two accumulators; then P = exp2(s - m_tile) in bf16 with the
  // tile's maximum m_tile and its sum of the unrounded P, per head.
  frt_mbar_wait(kbar, 0);
  FRT_STAMP(2);
  __nv_bfloat16* p0r = ps + 2 * t * PP;         // rows of heads 2t, 2t + 1
  __nv_bfloat16* p1r = p0r + PP;
#pragma unroll
  for (int u = 0; u < kTilesPerWarp; ++u) {
    const int j = warp + kWarps * u;
    if (j >= ntiles) continue;
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    const int row = kTile * j + 8 * (mat & 1) + mr;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; kk += 2) {
      uint32_t af[4];
      frt_ldmatrix_x4(af, ks_a + kv_offset(row, 16 * kk + 8 * (mat >> 1), SP));
      frt_mma_bf16(c0, af, qf[kk][0], qf[kk][1]);
      if (kk + 1 < KSTEPS) {
        frt_ldmatrix_x4(af, ks_a + kv_offset(row, 16 * kk + 16 + 8 * (mat >> 1), SP));
        frt_mma_bf16(c1, af, qf[kk + 1][0], qf[kk + 1][1]);
      }
    }
    // [0], [1]: slot 16j + gq, heads 2t, 2t + 1; [2], [3]: slot + 8
    const int sa = kTile * j + gq, sb = sa + 8;
    const float v0 = sa < n ? (c0[0] + c1[0]) * a.scale_log2 : -INFINITY;
    const float v1 = sa < n ? (c0[1] + c1[1]) * a.scale_log2 : -INFINITY;
    const float v2 = sb < n ? (c0[2] + c1[2]) * a.scale_log2 : -INFINITY;
    const float v3 = sb < n ? (c0[3] + c1[3]) * a.scale_log2 : -INFINITY;
    // finite: slot 16j lies inside the split
    const float m0 = col_max(fmaxf(v0, v2)), m1 = col_max(fmaxf(v1, v3));
    const float e0 = frt_fast_exp2(v0 - m0), e1 = frt_fast_exp2(v1 - m1);
    const float e2 = frt_fast_exp2(v2 - m0), e3 = frt_fast_exp2(v3 - m1);
    p0r[sa] = __float2bfloat16(e0);
    p1r[sa] = __float2bfloat16(e1);
    p0r[sb] = __float2bfloat16(e2);
    p1r[sb] = __float2bfloat16(e3);
    const float l0 = col_sum(e0 + e2), l1 = col_sum(e1 + e3);
    if (gq == 0) {
      tmax[j * kMaxG + 2 * t] = m0;
      tmax[j * kMaxG + 2 * t + 1] = m1;
      tsum[j * kMaxG + 2 * t] = l0;
      tsum[j * kMaxG + 2 * t + 1] = l1;
    }
  }
  // V rows from n to the tile edge: zeros once the copies have landed
  // (their probabilities are 0, and 0 * what the boxes brought or what
  // shared memory held could be NaN).
  frt_mbar_wait(vbar, 0);
  for (int i = tid; i < (ntiles * kTile - n) * (DH / 8); i += kThreads) {
    const int row = n + i / (DH / 8), col = (i % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(vs + kv_offset(row, col, SP)) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  FRT_STAMP(3);

  // 4. The split's maximum and sum per head from the tiles': M = max m_tile,
  // L = sum l_tile * exp2(m_tile - M).
  float M0 = -INFINITY, M1 = -INFINITY;         // heads 2t, 2t + 1
  for (int j = 0; j < ntiles; ++j) {
    M0 = fmaxf(M0, tmax[j * kMaxG + 2 * t]);
    M1 = fmaxf(M1, tmax[j * kMaxG + 2 * t + 1]);
  }
  float L0 = 0.f, L1 = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    L0 = fmaf(tsum[j * kMaxG + 2 * t],
              frt_fast_exp2(tmax[j * kMaxG + 2 * t] - M0), L0);
    L1 = fmaf(tsum[j * kMaxG + 2 * t + 1],
              frt_fast_exp2(tmax[j * kMaxG + 2 * t + 1] - M1), L1);
  }

  // 5. O^T = V^T P: warp w < Dh/16 owns head dims [16w, 16w + 16) of every
  // head, over all the split's slots: a fresh product a tile, added with
  // the tile's weight exp2(m_tile - M).
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  if (warp < KSTEPS) {
    const int col = 16 * warp + 8 * (mat & 1);
    const int vr = 8 * (mat >> 1) + mr;
    const __nv_bfloat16* prow = ps + gq * PP + 2 * t;
#pragma unroll 4
    for (int j = 0; j < ntiles; ++j) {
      uint32_t af[4];
      frt_ldmatrix_x4_trans(af, vs_a + kv_offset(kTile * j + vr, col, SP));
      const uint32_t* pj = reinterpret_cast<const uint32_t*>(prow + kTile * j);
      float ot[4] = {0.f, 0.f, 0.f, 0.f};
      frt_mma_bf16(ot, af, pj[0], pj[4]);
      const float w0 = frt_fast_exp2(tmax[j * kMaxG + 2 * t] - M0);
      const float w1 = frt_fast_exp2(tmax[j * kMaxG + 2 * t + 1] - M1);
      o[0] = fmaf(ot[0], w0, o[0]);
      o[1] = fmaf(ot[1], w1, o[1]);
      o[2] = fmaf(ot[2], w0, o[2]);
      o[3] = fmaf(ot[3], w1, o[3]);
    }
  }
  FRT_STAMP(4);
  // o[0], o[1]: head dim 16w + gq of heads 2t, 2t + 1; o[2], o[3]: dim + 8.
  const int d = 16 * warp + gq, g0 = 2 * t, g1 = g0 + 1;

  // 6a. One split with live slots: normalise and write.
  if (n_act == 1) {
    if (warp < KSTEPS && g0 < G) {
      out[g0 * DH + d] = __float2bfloat16(o[0] / L0);
      out[g0 * DH + d + 8] = __float2bfloat16(o[2] / L0);
    }
    if (warp < KSTEPS && g1 < G) {
      out[g1 * DH + d] = __float2bfloat16(o[1] / L1);
      out[g1 * DH + d + 8] = __float2bfloat16(o[3] / L1);
    }
    FRT_STAMP(8);
    return;
  }

  // 6b. Several: leave the partials; the last block to arrive merges.
  const size_t pacc = (bh * a.NS + s) * G * DH;  // (split s, head 0, dim 0)
  if (warp < KSTEPS && g0 < G) {
    a.part_acc[pacc + g0 * DH + d] = o[0];
    a.part_acc[pacc + g0 * DH + d + 8] = o[2];
  }
  if (warp < KSTEPS && g1 < G) {
    a.part_acc[pacc + g1 * DH + d] = o[1];
    a.part_acc[pacc + g1 * DH + d + 8] = o[3];
  }
  if (tid < 4) {                                // heads 2t, 2t + 1 of 8
    const size_t pm = (bh * a.NS + s) * kMaxG + g0;
    a.part_m[pm] = M0;
    a.part_m[pm + 1] = M1;
    a.part_l[pm] = L0;
    a.part_l[pm + 1] = L1;
  }
  // the merge's bulk copies may reuse the rows this block touched
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  int* counter = a.counters + bh;
  if (tid == 0)                                 // releases the partials, and
    s_last = frt_atom_add_acq_rel(              // acquires the others'
        reinterpret_cast<unsigned*>(counter), 1u) == (unsigned)(n_act - 1);
  __syncthreads();
  FRT_STAMP(5);
  if (!s_last) return;

  // The merge, in chunks of merge_cap splits (one chunk when the
  // allocation holds them all): bulk copies bring a chunk's m, l and acc
  // into shared memory in one round trip; a thread per 4 dims of a head
  // weights each split by exp2(m_s - M), rescaling what earlier chunks
  // summed, all in registers.
  const int cap = a.merge_cap;
  const int per_split = split_bytes(DH, G);
  const float* st_m = reinterpret_cast<const float*>(ks);   // (cap, kMaxG)
  const float* st_l = st_m + cap * kMaxG;
  const float* st_acc = st_l + cap * kMaxG;                  // (cap, G, DH)
  const int gi = tid / (DH / 4), ci = (tid % (DH / 4)) * 4;  // head, dims
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float M = -INFINITY, L = 0.f;
  unsigned phase = 0;
  for (int c0 = 0; c0 < n_act; c0 += cap, phase ^= 1u) {
    const int cnt = min(cap, n_act - c0);
    if (c0 > 0) {                               // the last chunk's rows are free
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    }
    if (tid == 0) {
      asm volatile("fence.proxy.async.global;" ::: "memory");
      const size_t sp0 = bh * a.NS + s_lo + c0;
      frt_mbar_expect_tx(mbar, (unsigned)(cnt * per_split));
      frt_bulk_copy(ks_a, a.part_m + sp0 * kMaxG, cnt * kMaxG * 4, mbar);
      frt_bulk_copy(ks_a + cap * kMaxG * 4, a.part_l + sp0 * kMaxG,
                    cnt * kMaxG * 4, mbar);
      frt_bulk_copy(ks_a + 2 * cap * kMaxG * 4, a.part_acc + sp0 * G * DH,
                    cnt * G * DH * 4, mbar);
    }
    frt_mbar_wait(mbar, phase);
    if (c0 == 0) FRT_STAMP(6);
    if (gi < G) {
      float Mn = M;
      for (int i = 0; i < cnt; ++i) Mn = fmaxf(Mn, st_m[i * kMaxG + gi]);
      const float scale = frt_fast_exp2(M - Mn);   // 0 for the first chunk
      acc.x *= scale;
      acc.y *= scale;
      acc.z *= scale;
      acc.w *= scale;
      L *= scale;
      M = Mn;
      const float* src = st_acc + gi * DH + ci;
#pragma unroll 4
      for (int i = 0; i < cnt; ++i) {
        const float w = frt_fast_exp2(st_m[i * kMaxG + gi] - M);
        const float4 x = *reinterpret_cast<const float4*>(src + (size_t)i * G * DH);
        L = fmaf(w, st_l[i * kMaxG + gi], L);
        acc.x = fmaf(w, x.x, acc.x);
        acc.y = fmaf(w, x.y, acc.y);
        acc.z = fmaf(w, x.z, acc.z);
        acc.w = fmaf(w, x.w, acc.w);
      }
    }
    if (c0 == 0) FRT_STAMP(7);
  }
  if (gi < G) {
    const float inv = 1.f / L;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + gi * DH + ci);
    dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
  if (tid == 0) *counter = 0;                   // ready for the next call
  FRT_STAMP(8);
}

template <int DH>
cudaError_t prepare() {
  static const cudaError_t e = cudaFuncSetAttribute(
      gqa1_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  return e;
}

template <int DH>
int blocks_per_sm(int smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, gqa1_kernel<DH>, kThreads, smem) != cudaSuccess)
    return 0;
  return n;
}

size_t partial_count(int B, int Hkv, int NS) { return (size_t)B * Hkv * NS; }

// The TMA tensor map of a (rows, W) bf16 slab view: boxes of 32 rows x 64
// columns, 128-byte swizzle. Encoded once per view (the LM's slabs live for
// an utterance) through the driver's entry point, so the library links the
// runtime only.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int tensor_map(const void* ptr, long long rows, int W, CUtensorMap* map) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, long long, int>, CUtensorMap> cache;
  static EncodeTiled encode = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(ptr, rows, W);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)W * 2};
  const cuuint32_t box[2] = {kBoxCols, kBoxRows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

}  // namespace

// The trace build's stamps (kTraceBlocks x kTraceStamps, ns; 0 where a
// block did not stamp), copied to `out` and cleared. Other builds return
// cudaErrorNotSupported.
extern "C" int frt_gqa1_trace(unsigned long long* out, int* shape) {
#ifdef FRT_GQA1_TRACE
  shape[0] = kTraceBlocks;
  shape[1] = kTraceStamps;
  cudaError_t e = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[kTraceBlocks][kTraceStamps] = {};
  return (int)cudaMemcpyToSymbol(g_trace, zero, sizeof(g_trace));
#else
  (void)out;
  (void)shape;
  return (int)cudaErrorNotSupported;
#endif
}

// The launch plan of a call, from what the host knows: the split in slab
// slots, the number of splits NS = ceil(T / split), the launch's dynamic
// shared memory (grown for a one-chunk merge where the grid still fits one
// wave), and the fp32 scratch the call needs (part_m and part_l of
// B*Hkv*NS*8 floats each, then part_acc of B*Hkv*NS*G*Dh). Returns 0, or a CUDA error for shapes the kernel does
// not take.
extern "C" int frt_gqa1_plan(int B, int Hkv, int G, int T, int Dh, int* split,
                             int* ns, int* smem_bytes,
                             long long* scratch_floats) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxG || T < 1 || B > 65535 ||
      Hkv > 65535 || (Dh != 64 && Dh != 128))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = Dh == 128 ? prepare<128>() : prepare<64>();
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)e;
  // the smallest split whose grid fits one wave; else the fewest blocks per
  // resident slot
  int best = 0, best_smem = 0;
  double best_load = 0.0;
  for (int sp : kSplits) {
    const int nsp = (T + sp - 1) / sp;
    const long long blocks = (long long)B * Hkv * nsp;
    const int small = compute_smem(Dh, sp);
    if (small > kMaxDynSmem) continue;
    // grow the allocation for a one-chunk merge only where the grid still
    // fits one wave with it
    int smem = grown_smem(Dh, sp, nsp, G);
#ifdef FRT_GQA1_NOGROW
    smem = small;
#endif
    int per_sm = Dh == 128 ? blocks_per_sm<128>(smem) : blocks_per_sm<64>(smem);
    if (blocks > (long long)sms * per_sm) {
      smem = small;
      per_sm = Dh == 128 ? blocks_per_sm<128>(smem) : blocks_per_sm<64>(smem);
    }
    if (per_sm < 1) continue;
    const double load = (double)blocks / ((double)sms * per_sm);
    if (best == 0 || (best_load > 1.0 && load < best_load)) {
      best = sp;
      best_smem = smem;
      best_load = load;
    }
  }
  if (best == 0) return (int)cudaErrorInvalidValue;
  *split = best;
  *ns = (T + best - 1) / best;
  *smem_bytes = best_smem;
  const size_t n = partial_count(B, Hkv, *ns);
  *scratch_floats = (long long)(2 * n * kMaxG + n * G * Dh);
  return 0;
}

// q (B, Hkv*G, Dh) bf16; k, v: one layer of the slab, (B, T, Hkv*Dh) bf16,
// 16-byte aligned; q_start/q_end (B,) int32; live_lo/live_hi () int32
// (batch min start, max end); split, NS and smem from frt_gqa1_plan; part:
// its fp32 scratch; counters (B * Hkv) int32, zero before the call and left
// zero after it; out (B, Hkv*G, Dh) bf16. One launch.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int frt_flash_decode_gqa1(const void* q, const void* k, const void* v,
                                     const int* q_start, const int* q_end,
                                     const int* live_lo, const int* live_hi,
                                     float* part, int* counters, void* out,
                                     int B, int Hkv, int G, int Dh, int T, int C,
                                     int split, int NS, int smem, float scale,
                                     void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxG || C < 1 || T % C != 0 ||
      (Dh != 64 && Dh != 128) || split < kBoxRows || split % kBoxRows != 0 ||
      split > kMaxSplit || NS != (T + split - 1) / split ||
      smem < compute_smem(Dh, split) || smem > kMaxDynSmem || part == nullptr ||
      counters == nullptr || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = Dh == 128 ? prepare<128>() : prepare<64>();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tk, tv;
  int err = tensor_map(k, (long long)B * T, Hkv * Dh, &tk);
  if (err == 0) err = tensor_map(v, (long long)B * T, Hkv * Dh, &tv);
  if (err != 0) return err;
  const size_t n = partial_count(B, Hkv, NS);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.q_start = q_start;
  a.q_end = q_end;
  a.live_lo = live_lo;
  a.live_hi = live_hi;
  a.part_m = part;
  a.part_l = part + n * kMaxG;
  a.part_acc = part + 2 * n * kMaxG;
  a.counters = counters;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.Hkv = Hkv;
  a.G = G;
  a.T = T;
  a.C = C;
  a.SP = split;
  a.NS = NS;
  a.scale_log2 = scale * kLog2e;
  a.merge_cap = (smem - 1024) / split_bytes(Dh, G);
  const dim3 grid(NS, Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 128)
    gqa1_kernel<128><<<grid, kThreads, smem, st>>>(tk, tv, a);
  else
    gqa1_kernel<64><<<grid, kThreads, smem, st>>>(tk, tv, a);
  return (int)cudaGetLastError();
}
