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
// frame, ~0.92 ms at 3.35 TB/s (the streamed floor).
//
// The first design (a warp per output row, each 16-byte load consumed in
// the iteration that issued it, scalar FMAs per stream, 302 grid barriers a
// frame, attention recomputed by every block with one L2 round trip per
// slot, top-k by 9 serial block-wide passes) took 9.04 ms a frame at B = 1
// and 22.96 ms at B = 8 (queued CUDA events, NVIDIA H100 80GB HBM3, 700 W).
// Its ablation builds split that into the MLP weight loads (~2.7-3.0 ms:
// one load in flight a lane, ~0.4 TB/s), barriers with skew (1.8-2.0 ms;
// 2.5-2.6 us each alone), the attention phases (4.1 ms; 9.6 at B = 8), of
// which the attention core alone (NOATTNCORE) 1.62 ms (4.45 at B = 8),
// sampling (~0.7 ms), and at B = 8 the per-stream int8 conversion and FMAs
// (~5 ms). This design answers each (PERF.md section 6 has its times):
//
// 1. A weight stream that runs ahead of the barriers. The weights of every
//    phase are fixed; only activations (a few KB) pass through the barriers.
//    Each matrix's rows are cut into tiles of 16 (the mma's m); block b owns
//    tiles [b T / G, (b + 1) T / G) of every matrix of every layer and step
//    (tile_range; exported as frt_depth_chain_tiles). A tile's rows are
//    contiguous bytes of the output-major bundle. One producer warp per
//    block walks the block's tiles in the order the phases consume them and
//    copies each tile in chunks of 16 rows x 448 bytes (one cp.async.bulk a
//    row, completing on an mbarrier) into a ring of stages in shared memory.
//    Seven consumer warps compute from the ring and free each stage (eight
//    warps, two a scheduler, leave a thread 255 registers; nine warps
//    capped it at 168 and spilled). The producer never waits at a grid
//    barrier or during sampling, so the next phase's bytes arrive while the
//    grid synchronises. The ring takes what a block has left after the
//    staged activations, up to 16 stages (147 KB at B = 1; 8 stages at
//    B = 8, where the down phase's input is 143 KB); frt_depth_chain_plan
//    sizes it, and every launch uses its layout. Stage rows are 576
//    bytes apart and staged activation rows 2K + 16 (or + 64), so the lanes
//    of a quarter warp read distinct banks.
// 2. Tensor cores for every GEMV: the weights are the 16-row A operand and
//    the <= 8 streams the n = 8 B operand of mma.sync. Weight-only int8 is
//    exact in bf16 (|q| <= 127): a byte permute makes 2^23 + q + 128, one
//    subtraction q, then a bf16 pair, so the work per weight no longer grows
//    with B. The a8 modes run m16n8k32 s8 with int32 sums, exact, so their
//    dots equal the first design's __dp4a sums bit for bit; r4 shares kernel
//    E's nibble unpack (int4_unpack.cuh). The k order inside a product is
//    free, so a lane's 16 bytes of a weight row and its activations come
//    from 16-byte shared loads with no shuffle. The consumer warps split
//    each chunk's k; a tile's partial sums meet in shared memory, and every
//    epilogue rounds where the TPU kernel does (mm8: the dot, then the scale
//    product, then the bias; down: both halves in fp32 before the scale).
//    An epilogue's scales and h are loaded before its tile's products.
// 3. Cheaper grid barriers, and one fewer a step: the barrier
//    (grid_sync.cuh) is one acquire-release add per block and a spin on an
//    acquire load of the count, with no sleep, among the consumer threads
//    only; the logits phase's barrier and the sampling phase's are one: the
//    last block to arrive samples every stream before it lets the others
//    go. While the weight stream keeps device memory busy, an L2 round trip
//    takes microseconds, so each phase's inputs (h with the norm weight, o,
//    the MLP activation, the embedding rows, the logits) are copied to
//    shared memory with cp.async, every copy in flight at once.
// 4. Attention once across the grid, chosen by measurement: a warp takes
//    one (stream, query head) with every load issued before any is used,
//    writes o to global memory, and one more barrier follows. Recomputed in
//    every block (a warp per (stream, KV head)), the core still cost this
//    design 0.44 ms a frame at B = 1 and 2.14 ms at B = 8 (its NOATTNCORE
//    build, tools/ablate_depth.py), against ~0.2 ms for 64 barriers more
//    (about 2.5 us each); PERF.md has the times once across the grid.
//    Scores reduce over the warp by halving exchanges (16 shuffles for 16
//    slots), and each lane takes one exponent and one division. A frame has
//    ncb (1 + 5 L) + ncb - 1 grid barriers: 351 at qwen-200m (the first
//    design: 302).
// 5. Sampling in warp-wide passes: the last block's warp w takes stream w
//    (and w + 7) from shared memory; the k-th largest distinct logit
//    (pallas_depth.py: _kth_largest, ties collapsed) is k - 1 passes of
//    "the largest value below the last one", floored at -1e30 as
//    _kth_largest's replacement value floors it, each pass eight
//    independent maxima a lane and a warp max, not a block barrier. The
//    race skips the entries outside the top k (probability 0, they cannot
//    win), which also keeps their divisions off the slow path.
//
// Intermediates (h, qkv, the MLP activation, the K/V store, logits, tokens)
// live in a small global scratch the wrapper allocates; they stay in L2 and
// are read with ld.global.cg after the barriers. Plan modes: r8 and s8
// (int8 weight-only) are one route (kInt8), r8a8 and s8a8 one (kInt8A8), r4
// is kInt4; the projection and the audio head are bf16 (kBf16).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "grid_sync.cuh"
#include "int4_unpack.cuh"
#include "mma_bf16.cuh"

// Ablation builds, for the probe tools only (fireredtts2_tpu_torch/tools/
// ablate_depth.py; the counterpart of tools/_ablate_depth_kernel.py's ABL
// and tools/probe_s8_chunked.py: probe_step). FRT_ABL is a sum of the bits
// below; the serving wrapper (ops/depth_chain.py) loads the build without
// defines, FRT_ABL = 0, whose code is the production code. Under any bit
// but TRACE the numbers are garbage and the timing is honest; TRACE keeps
// the numbers and records when thread 0 of blocks 0, G / 2 and G - 1 enters
// and leaves each barrier, staging, tile, attention and sampling
// (frt_depth_chain_trace), at the cost of a timer read and a store each.
#ifndef FRT_ABL
#define FRT_ABL 0
#endif
#define FRT_ABL_HALF 1       // MLP matrices (gate, up, down): half of each row
#define FRT_ABL_TINY 2       // ... one chunk (448 bytes) of each row
#define FRT_ABL_NOLOAD 4     // no weight copies; the math on stale stages
#define FRT_ABL_NOATTN 8     // skip the QKV, attention and wo phases
#define FRT_ABL_NOSAMPLE 16  // skip the logits and sampling phases
#define FRT_ABL_NOSYNC 32    // the grid barrier becomes a block barrier
#define FRT_ABL_NOATTNCORE 64  // attention core skipped: o = the fresh v
#define FRT_ABL_TRACE 128    // per-phase timestamps of three blocks

namespace {

typedef __nv_bfloat16 bf16;

// 7 consumer warps and a producer: 8 warps, 2 per scheduler, so a thread
// may hold 255 registers (9 warps put 3 on one scheduler and cap it at 168,
// which spilled to local memory, and local memory falls through the small
// L1 that 227 KB of shared memory leaves to L2).
constexpr int kCWarps = 7;                   // consumer warps
constexpr int kCThreads = kCWarps * 32;
constexpr int kThreads = kCThreads + 32;     // + the producer warp
constexpr int kBMax = 8;                     // streams per launch (the mma's n)
constexpr int kTile = 16;                    // rows of a tile (the mma's m)
constexpr int kKB = 64;                      // bytes of a row per warp and stage
constexpr int kChunk = kCWarps * kKB;        // bytes of each row a stage holds
constexpr int kPitch = (kChunk + 127) / 128 * 128 + 64;  // row pitch, mod 128: 64
constexpr int kStage = kTile * kPitch;
constexpr int kMaxStages = 16;
constexpr int kStaticReserve = 12288;        // static shared memory, at most
constexpr int kMaxSlots = 16;                // micro-steps (codebooks) per frame
constexpr int kDh = 128;                     // head dim: 4 dims a lane
constexpr float kNeg = -1e30f;
enum Mode { kInt8 = 0, kInt8A8 = 1, kInt4 = 2, kBf16 = 3 };

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
  float* h; float* qkv; bf16* o; bf16* t; bf16* kst; bf16* vst; int* tok;
  float* logits; unsigned* bar;
  int B, Db, Dd, Hq, Hkv, I, V, ncb, L, grp[3], mode[3], topk, greedy;
  int stages, act_bytes;
  float temp, eps, attn_scale;
};

// One phase's matrix for one layer: O output rows of row_bytes each, of
// which this build streams read_bytes.
struct Mat {
  const unsigned char* w;
  int O, row_bytes, read_bytes, mode;
};

struct Shared {
  int red[kCWarps][8][32];            // a tile's partial sums, by warp
  float rows[kCWarps * kBMax];        // block_rows
  float stats[kBMax];
  float xsc[kBMax * 2];               // a8 activation scales, (b, segment)
  int last;
};

__device__ __forceinline__ float bfr(float x) { return frt_bf16_round(x); }
__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void csync() { frt_bar_sync(kCThreads); }

// The phase barrier: the grid barrier, or under NOSYNC the consumers'.
__device__ __forceinline__ void phase_sync(FrtGrid& g) {
#if FRT_ABL & FRT_ABL_NOSYNC
  csync();
#else
  grid_sync_part(g, kCThreads);
#endif
}

// ---- the TRACE build's timestamps ---------------------------------------

// Events of a traced block's thread 0, each stored as (globaltimer ns) << 4
// | event; tools/ablate_depth.py: trace_frame reads them back.
enum Event {
  kEvBarIn = 1, kEvBarOut, kEvStageIn, kEvStageOut, kEvTileIn, kEvTileOut,
  kEvAttnIn, kEvAttnOut, kEvSampIn, kEvSampOut
};
constexpr int kTraceSlots = 3;               // blocks 0, G / 2, G - 1
constexpr int kTraceCap = 8192;              // events a block and launch

#if FRT_ABL & FRT_ABL_TRACE
__device__ unsigned long long g_trace[kTraceSlots][kTraceCap];
__device__ int g_trace_n[kTraceSlots];

struct Tracer {
  int slot, n;
  __device__ Tracer() : slot(-1), n(0) {
    const int b = blockIdx.x, G = gridDim.x;
    if (threadIdx.x == 0) slot = b == 0 ? 0 : b == G / 2 ? 1 : b == G - 1 ? 2 : -1;
  }
  __device__ void mark(int ev) {
    if (slot < 0 || n >= kTraceCap) return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[slot][n++] = t << 4 | (unsigned long long)ev;
  }
  __device__ void done() const {
    if (slot >= 0) g_trace_n[slot] = n;
  }
};
#else
struct Tracer {
  __device__ void mark(int) {}
  __device__ void done() const {}
};
#endif

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

// ---- the ring (mbarriers and bulk copies: bulk_copy.cuh) ----------------

struct Ring {
  unsigned char* base;                // stage 0
  uint32_t full, empty;               // mbarrier arrays, 8 bytes apart
  int stages;
  unsigned it;                        // stages passed so far
  __device__ int slot() const { return (int)(it % (unsigned)stages); }
  __device__ unsigned parity() const { return (it / (unsigned)stages) & 1u; }
};

// ---- the schedule, walked alike by the producer and the consumers ---------

// Tiles [t0, t1) of an O-row matrix that block `block` of `grid` owns.
__host__ __device__ __forceinline__ void tile_range(int O, int block, int grid,
                                                    int& t0, int& t1) {
  const int T = (O + kTile - 1) / kTile;
  t0 = (int)((long long)block * T / grid);
  t1 = (int)((long long)(block + 1) * T / grid);
}

__device__ __forceinline__ void tile_range(int O, int& t0, int& t1) {
  tile_range(O, blockIdx.x, gridDim.x, t0, t1);
}

__device__ __forceinline__ int chunks(const Mat& m) {
  return (m.read_bytes + kChunk - 1) / kChunk;
}

// Bytes of an MLP row that an ablation build streams (a multiple of kKB).
__device__ __forceinline__ int mlp_read(int row_bytes) {
#if FRT_ABL & FRT_ABL_TINY
  return min(row_bytes, kChunk);
#elif FRT_ABL & FRT_ABL_HALF
  return row_bytes / 2 / kKB * kKB;
#else
  return row_bytes;
#endif
}

__device__ __forceinline__ Mat mat_proj(const Args& A) {
  return Mat{reinterpret_cast<const unsigned char*>(A.proj_t), A.Dd, 2 * A.Db,
             2 * A.Db, kBf16};
}

__device__ __forceinline__ Mat mat_qkv(const Args& A, int l) {
  const int W = (A.Hq + 2 * A.Hkv) * kDh;
  return Mat{reinterpret_cast<const unsigned char*>(A.wqkv) + (size_t)l * W * A.Dd,
             W, A.Dd, A.Dd, kInt8};
}

__device__ __forceinline__ Mat mat_wo(const Args& A, int l) {
  const int K = A.Hq * kDh;
  return Mat{reinterpret_cast<const unsigned char*>(A.wo) + (size_t)l * A.Dd * K,
             A.Dd, K, K, kInt8};
}

// m: 0 gate, 1 up, 2 down.
__device__ __forceinline__ Mat mat_mlp(const Args& A, int m, int l) {
  const int O = m == 2 ? A.Dd : A.I, K = m == 2 ? A.I : A.Dd;
  const int rb = A.mode[m] == kInt4 ? K / 2 : K;
  return Mat{reinterpret_cast<const unsigned char*>(A.mw[m]) + (size_t)l * O * rb,
             O, rb, mlp_read(rb), A.mode[m]};
}

__device__ __forceinline__ Mat mat_head(const Args& A, int p) {
  return Mat{reinterpret_cast<const unsigned char*>(A.head_t) +
                 (size_t)(p - 1) * A.V * A.Dd * 2,
             A.V, 2 * A.Dd, 2 * A.Dd, kBf16};
}

// ---- the producer warp ---------------------------------------------------

__device__ __forceinline__ void produce_tile(const Mat& m, int t, Ring& r, int lane) {
  const int row0 = t * kTile, nr = min(kTile, m.O - row0);
  for (int c = 0; c < chunks(m); ++c) {
    const int s = r.slot();
    frt_mbar_wait(r.empty + 8 * s, r.parity() ^ 1u);
#if FRT_ABL & FRT_ABL_NOLOAD
    if (lane == 0) frt_mbar_arrive(r.full + 8 * s);
#else
    const int off = c * kChunk, nb = min(kChunk, m.read_bytes - off);
    if (lane == 0) frt_mbar_expect_tx(r.full + 8 * s, (unsigned)(nr * nb));
    __syncwarp();
    if (lane < nr)
      frt_bulk_copy(frt_smem_addr(r.base + s * kStage + lane * kPitch),
                    m.w + (size_t)(row0 + lane) * m.row_bytes + off, nb,
                    r.full + 8 * s);
#endif
    ++r.it;
  }
}

__device__ __forceinline__ void produce_phase(const Mat& m, Ring& r, int lane) {
  int t0, t1;
  tile_range(m.O, t0, t1);
  for (int t = t0; t < t1; ++t) produce_tile(m, t, r, lane);
}

__device__ __forceinline__ void producer(const Args& A, Ring& r, int lane) {
  for (int p = 0; p < A.ncb; ++p) {
    produce_phase(mat_proj(A), r, lane);
    for (int l = 0; l < A.L; ++l) {
#if !(FRT_ABL & FRT_ABL_NOATTN)
      produce_phase(mat_qkv(A, l), r, lane);
      produce_phase(mat_wo(A, l), r, lane);
#endif
      const Mat g = mat_mlp(A, 0, l), u = mat_mlp(A, 1, l);
      int t0, t1;
      tile_range(A.I, t0, t1);
      for (int t = t0; t < t1; ++t) {
        produce_tile(g, t, r, lane);
        produce_tile(u, t, r, lane);
      }
      produce_phase(mat_mlp(A, 2, l), r, lane);
    }
#if !(FRT_ABL & FRT_ABL_NOSAMPLE)
    if (p > 0) produce_phase(mat_head(A, p), r, lane);
#endif
  }
}

// ---- the consumers' tile products ---------------------------------------

// The activations a phase's products read: xs (B rows of bf16, xs_pitch
// bytes apart) and, for the a8 modes, xq (int8, xq_pitch bytes apart) with
// its scales in Shared::xsc, over nseg equal segments of K.
struct XIn {
  const unsigned char* xs; int xs_pitch;
  const unsigned char* xq; int xq_pitch;
  int K, nseg;
};

struct Acc {
  float f[4];
  int i[2][4];                        // a8: per segment
};

__device__ __forceinline__ uint4 lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Activations from global memory (L2) into shared memory with every copy in
// flight at once: while the weight stream keeps device memory busy, each
// L2 round trip takes microseconds, so a phase's staging pays one, not one
// per loop iteration. n16 16-byte pieces, src and dst 16-byte aligned,
// spread over the consumers; rows: `rows` of row16 pieces, src rows
// src_stride bytes apart and dst rows dst_pitch bytes apart. The caller
// waits with copy_wait().
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_pitch,
                                          const void* src, size_t src_stride,
                                          int rows, int row16) {
  for (int i = threadIdx.x; i < rows * row16; i += kCThreads) {
    const int rr = i / row16, c = i - rr * row16;
    frt_cp_async16(frt_smem_addr(dst + rr * dst_pitch + 16 * c),
                   static_cast<const unsigned char*>(src) + rr * src_stride + 16 * c, 16);
  }
  frt_cp_async_commit();
}

__device__ __forceinline__ void copy_wait() {
  frt_cp_async_wait<0>();
  csync();
}

// Bytes e, e + 1 of v (int8 with the sign bit flipped) as two bf16: the byte
// is the low mantissa of 2^23 + q + 128, exact in fp32 and in bf16.
__device__ __forceinline__ uint32_t i8x2(uint32_t v, int e) {
  const float a = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + e)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7541 + e)) - 8388736.f;
  return frt_pack_bf16(a, b);
}

// This warp's 64 bytes of every row of one stage (row bytes kb .. kb + 63
// of the tile). Lane (gq, t) reads bytes 16 t .. 16 t + 15 of rows gq and
// gq + 8, and the activations of stream gq at the same k.
__device__ __forceinline__ void kblock(const Mat& m, const XIn& x,
                                                       const unsigned char* sb, int kb,
                                       int row0, const float* scales, int g,
                                       int B, Acc& acc, int lane) {
  const int gq = lane >> 2, t = lane & 3;
  const bool live = gq < B;
  const uint4 wa = lds16(sb + gq * kPitch + 16 * t);
  const uint4 wb = lds16(sb + (gq + 8) * kPitch + 16 * t);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  if (m.mode == kBf16) {              // 8 k a lane: kb / 2 + 8 t ..
    const uint4 xv = live ? lds16(x.xs + gq * x.xs_pitch + kb + 16 * t) : z;
    const uint32_t a0[4] = {wa.x, wb.x, wa.y, wb.y};
    const uint32_t a1[4] = {wa.z, wb.z, wa.w, wb.w};
    frt_mma_bf16(acc.f, a0, xv.x, xv.y);
    frt_mma_bf16(acc.f, a1, xv.z, xv.w);
  } else if (m.mode == kInt8) {       // 16 k a lane: kb + 16 t ..
    const unsigned char* xp = x.xs + gq * x.xs_pitch + 2 * (kb + 16 * t);
    const uint4 x0 = live ? lds16(xp) : z, x1 = live ? lds16(xp + 16) : z;
    const uint32_t va[4] = {wa.x ^ 0x80808080u, wa.y ^ 0x80808080u,
                            wa.z ^ 0x80808080u, wa.w ^ 0x80808080u};
    const uint32_t vb[4] = {wb.x ^ 0x80808080u, wb.y ^ 0x80808080u,
                            wb.z ^ 0x80808080u, wb.w ^ 0x80808080u};
    const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a[4] = {i8x2(va[j], 0), i8x2(vb[j], 0), i8x2(va[j], 2),
                             i8x2(vb[j], 2)};
      frt_mma_bf16(acc.f, a, xw[2 * j], xw[2 * j + 1]);
    }
  } else if (m.mode == kInt4) {       // packed rows r..r+15: k r.. and K/2 + r..
    const int r = kb + 16 * t, K2 = x.K / 2, ng = x.K / g;
    const int oa = row0 + gq, ob = oa + 8;
    const float sa_lo = oa < m.O ? __ldg(scales + (size_t)oa * ng + r / g) : 0.f;
    const float sa_hi = oa < m.O ? __ldg(scales + (size_t)oa * ng + (K2 + r) / g) : 0.f;
    const float sb_lo = ob < m.O ? __ldg(scales + (size_t)ob * ng + r / g) : 0.f;
    const float sb_hi = ob < m.O ? __ldg(scales + (size_t)ob * ng + (K2 + r) / g) : 0.f;
    uint32_t alo[4][2], ahi[4][2], blo[4][2], bhi[4][2];
    frt_int4_bfrags(wa, sa_lo, sa_hi, alo, ahi);
    frt_int4_bfrags(wb, sb_lo, sb_hi, blo, bhi);
    const unsigned char* xp = x.xs + gq * x.xs_pitch + 2 * r;
    const uint4 l0 = live ? lds16(xp) : z, l1 = live ? lds16(xp + 16) : z;
    const uint4 h0 = live ? lds16(xp + 2 * K2) : z;
    const uint4 h1 = live ? lds16(xp + 2 * K2 + 16) : z;
    const uint32_t xl[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
    const uint32_t xh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t al[4] = {alo[j][0], blo[j][0], alo[j][1], blo[j][1]};
      const uint32_t ah[4] = {ahi[j][0], bhi[j][0], ahi[j][1], bhi[j][1]};
      frt_mma_bf16(acc.f, al, xl[2 * j], xl[2 * j + 1]);
      frt_mma_bf16(acc.f, ah, xh[2 * j], xh[2 * j + 1]);
    }
  } else {                            // kInt8A8: exact int32 sums per segment
    const int seg = kb / (x.K / x.nseg);
    const uint4 xv = live ? lds16(x.xq + gq * x.xq_pitch + kb + 16 * t) : z;
    const uint32_t a0[4] = {wa.x, wb.x, wa.y, wb.y};
    const uint32_t a1[4] = {wa.z, wb.z, wa.w, wb.w};
    if (seg == 0) {                   // constant indices keep acc in registers
      frt_mma_s8(acc.i[0], a0, xv.x, xv.y);
      frt_mma_s8(acc.i[0], a1, xv.z, xv.w);
    } else {
      frt_mma_s8(acc.i[1], a0, xv.x, xv.y);
      frt_mma_s8(acc.i[1], a1, xv.z, xv.w);
    }
  }
}

// The products of tile t of matrix m from the ring, each consumer warp
// taking its 64 bytes of every chunk; the partial sums are left in sh.red.
__device__ __forceinline__ void tile_products(const Args& A, const Mat& m,
                                              const XIn& x, const float* scales,
                                              int g, int t, Ring& r, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Acc acc;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc.f[e] = 0.f;
    acc.i[0][e] = acc.i[1][e] = 0;
  }
  for (int c = 0; c < chunks(m); ++c) {
    const int s = r.slot();
    frt_mbar_wait(r.full + 8 * s, r.parity());
    const int kb = c * kChunk + kKB * warp;
    if (kb < m.read_bytes)
      kblock(m, x, r.base + s * kStage + kKB * warp, kb, t * kTile, scales, g,
             A.B, acc, lane);
    __syncwarp();
    if (lane == 0) frt_mbar_arrive(r.empty + 8 * s);
    ++r.it;
  }
  csync();                            // the last tile's sums have been read
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (m.mode == kInt8A8) {
      sh.red[warp][e][lane] = acc.i[0][e];
      sh.red[warp][4 + e][lane] = acc.i[1][e];
    } else {
      sh.red[warp][e][lane] = __float_as_int(acc.f[e]);
    }
  }
  csync();
}

// Consumer thread i < 128: the tile's element (row i / 8, stream i % 8)
// summed over the warps; a8: the exact int32 sum of each segment, then
// sum_seg f32(s) * scale as the first design's __dp4a route.
__device__ __forceinline__ float tile_sum(const Mat& m, const XIn& x, int i,
                                          const Shared& sh) {
  const int row = i >> 3, n = i & 7;
  const int e = (row >> 3) * 2 + (n & 1), lane = (row & 7) * 4 + (n >> 1);
  if (m.mode == kInt8A8) {
    float a = 0.f;
    for (int seg = 0; seg < x.nseg; ++seg) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kCWarps; ++w) s += sh.red[w][4 * seg + e][lane];
      a = __fadd_rn(a, __fmul_rn((float)s, sh.xsc[n * 2 + seg]));
    }
    return a;
  }
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < kCWarps; ++w) v += __int_as_float(sh.red[w][e][lane]);
  return v;
}

// ---- staging (consumer threads) -------------------------------------------

// Per-row reduction over the consumers of v[b] (b < B) -> out[b].
__device__ __forceinline__ void block_rows(float v[kBMax], int B, bool is_max,
                                           Shared& sh, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kBMax; ++b) {
    if (b < B) v[b] = is_max ? warp_max(v[b]) : warp_sum(v[b]);
  }
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < kBMax; ++b) {
      if (b < B) sh.rows[warp * kBMax + b] = v[b];
    }
  }
  csync();
  if ((int)threadIdx.x < B) {
    float r = sh.rows[threadIdx.x];
    for (int w = 1; w < kCWarps; ++w) {
      const float o = sh.rows[w * kBMax + threadIdx.x];
      r = is_max ? fmaxf(r, o) : r + o;
    }
    out[threadIdx.x] = r;
  }
  csync();
}

// xs (B, Dd) = rms_norm(h, w) in bf16: (h * rsqrt(mean(h^2) + eps)) rounded,
// times the bf16 weight, rounded (pallas_depth.py:_rms); rows pitch bytes
// apart. h and the norm weight are first copied to hs in shared memory
// (one round trip).
__device__ __forceinline__ void stage_rms(const Args& A, const bf16* w,
                                          unsigned char* xs, int pitch,
                                          float* hs, Shared& sh) {
  const int D = A.Dd, B = A.B;
  const bf16* ws = reinterpret_cast<const bf16*>(hs + B * D);
  copy_rows(reinterpret_cast<unsigned char*>(hs), 0, A.h, 0, 1, B * D / 4);
  copy_rows(reinterpret_cast<unsigned char*>(hs + B * D), 0, w, 0, 1, D / 8);
  copy_wait();
  float v[kBMax];
#pragma unroll
  for (int b = 0; b < kBMax; ++b) v[b] = 0.f;
  for (int k = threadIdx.x; k < D; k += kCThreads) {
#pragma unroll
    for (int b = 0; b < kBMax; ++b) {
      if (b < B) v[b] = fmaf(hs[b * D + k], hs[b * D + k], v[b]);
    }
  }
  block_rows(v, B, false, sh, sh.stats);
  if ((int)threadIdx.x < B)
    sh.stats[threadIdx.x] = rsqrtf(__fdiv_rn(sh.stats[threadIdx.x], (float)D) + A.eps);
  csync();
  for (int k = threadIdx.x; k < D; k += kCThreads) {
    const float wk = bf2f(ws[k]);
#pragma unroll
    for (int b = 0; b < kBMax; ++b) {
      if (b < B) {
        const float x = bfr(__fmul_rn(hs[b * D + k], sh.stats[b]));
        reinterpret_cast<bf16*>(xs + b * pitch)[k] = __float2bfloat16(x * wk);
      }
    }
  }
  csync();
}

// Per-row int8 quantisation of (B, K) activations, separately over nseg
// equal segments (pallas_depth.py:_quant_act): scale = max(|x|, 1e-30) *
// fp32(1/127) (the JAX division by the constant 127 as XLA compiles it),
// q = round-half-even(x / scale). The activations come from shared memory
// (src, rows src_pitch bytes apart) or, with src null, from global t.
__device__ __forceinline__ void stage_quant(const Args& A,
                                            const unsigned char* src,
                                            int src_pitch, int K, int nseg,
                                            unsigned char* xq, int xq_pitch,
                                            Shared& sh) {
  const int B = A.B, Ks = K / nseg;
  auto at = [&](int b, int k) {
    return src ? bf2f(reinterpret_cast<const bf16*>(src + b * src_pitch)[k])
               : __bfloat162float(__ushort_as_bfloat16(__ldcg(
                     reinterpret_cast<const unsigned short*>(A.t) + (size_t)b * K + k)));
  };
  for (int seg = 0; seg < nseg; ++seg) {
    float v[kBMax];
#pragma unroll
    for (int b = 0; b < kBMax; ++b) {
      v[b] = 0.f;
      if (b < B) {
#pragma unroll 8
        for (int k = threadIdx.x; k < Ks; k += kCThreads)
          v[b] = fmaxf(v[b], fabsf(at(b, seg * Ks + k)));
      }
    }
    block_rows(v, B, true, sh, sh.stats);
    if ((int)threadIdx.x < B)
      sh.xsc[threadIdx.x * 2 + seg] =
          __fmul_rn(fmaxf(sh.stats[threadIdx.x], 1e-30f), 1.f / 127.f);
    csync();
  }
#pragma unroll 8
  for (int idx = threadIdx.x; idx < B * K; idx += kCThreads) {
    const int b = idx / K, k = idx - b * K, seg = k / Ks;
    reinterpret_cast<signed char*>(xq + b * xq_pitch)[k] =
        (signed char)__float2int_rn(__fdiv_rn(at(b, k), sh.xsc[b * 2 + seg]));
  }
  csync();
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

__device__ __forceinline__ void bf4(uint2 u, float f[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// Attention of micro-step p over slots 0..p of layer l, once across the
// grid: warp w of block i takes query head item = i + G w, (stream b, head
// h): RoPE of q and of the fresh k, scores, softmax with the probabilities
// rounded to bf16, the product with V, o (B, Hq*Dh) bf16 into global
// memory. Slots < p come from the store, slot p from this step's qkv; each
// KV head's first query head writes the fresh K/V row into slot p. Every
// load is issued before any is used.
__device__ __forceinline__ void attention_once(const Args& A, int l, int p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = A.B, Hq = A.Hq, Hkv = A.Hkv, G = Hq / Hkv;
  const int HqDh = Hq * kDh, HkvDh = Hkv * kDh, Wqkv = HqDh + 2 * HkvDh;
  const int d0 = lane * 4, j0 = (lane & 15) * 4;
  const bool first = lane < 16;
  const size_t slot = (size_t)B * HkvDh;
  for (int item = blockIdx.x + gridDim.x * warp; item < B * Hq;
       item += gridDim.x * kCWarps) {
    const int b = item / Hq, h = item - b * Hq, hk = h / G;
    const float* row = A.qkv + (size_t)b * Wqkv;
    const size_t base = (size_t)l * A.ncb * slot + (size_t)b * HkvDh + hk * kDh + d0;
    uint2 ks[kMaxSlots], vs[kMaxSlots];
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) {
      if (t < p) {
        ks[t] = __ldcg(reinterpret_cast<const uint2*>(A.kst + base + t * slot));
        vs[t] = __ldcg(reinterpret_cast<const uint2*>(A.vst + base + t * slot));
      }
    }
    float q[4], k[4], v[4], c[4], s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = __ldcg(row + h * kDh + d0 + i);
      k[i] = __ldcg(row + HqDh + hk * kDh + d0 + i);
      v[i] = __ldcg(row + HqDh + HkvDh + hk * kDh + d0 + i);
      c[i] = __ldg(A.rcos + p * (kDh / 2) + j0 + i);
      s[i] = __ldg(A.rsin + p * (kDh / 2) + j0 + i);
    }
    rope4(k, c, s, first);
    if (h % G == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        A.kst[base + p * slot + i] = __float2bfloat16(k[i]);
        A.vst[base + p * slot + i] = __float2bfloat16(v[i]);
      }
    }
    bf16* out = A.o + (size_t)b * HqDh + h * kDh + d0;
#if FRT_ABL & FRT_ABL_NOATTNCORE
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __float2bfloat16(v[i]);
#else
    rope4(q, c, s, first);
    float qf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[i] = __fmul_rn(q[i], A.attn_scale);
    // each lane's partial dots over its 4 dims, one per slot, reduced
    // over the warp by halving exchanges (16 shuffles for 16 sums): lanes
    // 2t and 2t + 1 end with slot t's score
    float part[kMaxSlots];
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) {
      float kk[4];
      if (t < p) {
        bf4(ks[t], kk);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) kk[i] = t == p ? k[i] : 0.f;
      }
      part[t] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) part[t] = fmaf(qf[i], kk[i], part[t]);
    }
#pragma unroll
    for (int w = 8; w >= 1; w >>= 1) {          // offsets 16, 8, 4, 2
      const bool hi = lane & (2 * w);
#pragma unroll
      for (int i = 0; i < w; ++i) {
        const float give = hi ? part[i] : part[i + w];
        part[i] = (hi ? part[i + w] : part[i]) +
                  __shfl_xor_sync(0xffffffffu, give, 2 * w);
      }
    }
    const int ts = (lane >> 1) & 15;            // this lane's slot
    const float score = part[0] + __shfl_xor_sync(0xffffffffu, part[0], 1);
    float mx = ts <= p ? score : kNeg;
#pragma unroll
    for (int w = 2; w < 32; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float e = ts <= p ? expf(score - mx) : 0.f;
    float sum = e;
#pragma unroll
    for (int w = 2; w < 32; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    const float pr = bfr(__fdiv_rn(e, sum));
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) {
      if (t <= p) {
        const float pt = __shfl_sync(0xffffffffu, pr, 2 * t);
        float vv[4];
        if (t < p) {
          bf4(vs[t], vv);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) vv[i] = v[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = fmaf(pt, vv[i], o[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __float2bfloat16(o[i]);
#endif
  }
}

// First-index argmax over the warp of per-lane (value, index) pairs.
__device__ __forceinline__ int warp_argmax(float v, int i) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, s);
    const int oi = __shfl_xor_sync(0xffffffffu, i, s);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
  return i;
}

// Token of stream b at micro-step p from its fp32 logits, by one warp:
// greedy argmax, or temperature, top-k, softmax and the exponential race
// argmax(probs / noise), first index on ties. The k-th largest distinct
// value (_kth_largest: k - 1 rounds of replacing the row's maximum by -1e30,
// then the maximum) is t_0 = max(x), t_i = max(max{x < t_{i-1}}, -1e30)
// (ops/depth_chain.py: kth_largest_by_passes). The logits and noise rows
// are copied to shared memory with every copy in flight at once, and each
// pass keeps eight independent maxima a lane.
__device__ __forceinline__ float lane_max(const float* x, int V, float below) {
  const int lane = threadIdx.x & 31;
  float m[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) m[u] = -INFINITY;
  int v = lane;
  for (; v + 224 < V; v += 256) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float y = x[v + 32 * u];
      m[u] = fmaxf(m[u], y < below ? y : -INFINITY);
    }
  }
  for (; v < V; v += 32) m[0] = fmaxf(m[0], x[v] < below ? x[v] : -INFINITY);
#pragma unroll
  for (int u = 1; u < 8; ++u) m[0] = fmaxf(m[0], m[u]);
  return warp_max(m[0]);
}

__device__ __forceinline__ void sample_stream(const Args& A, int b, int p, float* buf) {
  const int lane = threadIdx.x & 31, V = A.V, Vp = (V + 3) / 4 * 4;
  float* nz = buf + Vp;
  for (int i = lane; i < Vp / 4; i += 32)
    frt_cp_async16(frt_smem_addr(buf + 4 * i), A.logits + (size_t)b * Vp + 4 * i, 16);
  const float* ng = A.noise + ((size_t)b * A.ncb + p) * V;
  for (int v = lane; v < V; v += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(frt_smem_addr(nz + v)), "l"(ng + v) : "memory");
  frt_cp_async_commit();
  frt_cp_async_wait<0>();
  __syncwarp();
  float bv = -INFINITY;
  int bi = V;
  if (A.greedy) {
    for (int v = lane; v < V; v += 32) {
      if (buf[v] > bv) { bv = buf[v]; bi = v; }
    }
  } else {
#pragma unroll 4
    for (int v = lane; v < V; v += 32) buf[v] = __fdiv_rn(buf[v], A.temp);
    __syncwarp();
    float kth = lane_max(buf, V, INFINITY);
    for (int it = 1; it < A.topk; ++it) kth = fmaxf(lane_max(buf, V, kth), kNeg);
#pragma unroll 4
    for (int v = lane; v < V; v += 32) buf[v] = buf[v] < kth ? kNeg : buf[v];
    __syncwarp();
    const float mx = lane_max(buf, V, INFINITY);
    float tot = 0.f;
#pragma unroll 4
    for (int v = lane; v < V; v += 32) {
      buf[v] = expf(buf[v] - mx);
      tot += buf[v];
    }
    tot = warp_sum(tot);
    // entries outside the top k have probability 0 and cannot win the race
    // (the largest logit's is positive); skipping them also keeps their
    // divisions off the division's slow path for zero numerators
#pragma unroll 4
    for (int v = lane; v < V; v += 32) {
      if (buf[v] > 0.f) {
        const float sc = __fdiv_rn(__fdiv_rn(buf[v], tot), nz[v]);
        if (sc > bv) { bv = sc; bi = v; }
      }
    }
  }
  const int tok = warp_argmax(bv, bi);
  if (lane == 0) {
    A.samples[b * A.ncb + p] = tok;
    A.tok[b] = A.forced ? A.forced[b * A.ncb + p] : tok;
  }
}

// The logits phase's barrier, whose last block samples every stream (warp
// w takes streams w, w + 7) before it releases the others.
__device__ __forceinline__ void sample_sync(const Args& A, int p, float* buf,
                                            FrtGrid& g, Shared& sh) {
  const int warp = threadIdx.x >> 5, Vp = (A.V + 3) / 4 * 4;
  csync();
#if FRT_ABL & FRT_ABL_NOSYNC
  if (blockIdx.x == 0)
    for (int b = warp; b < A.B; b += kCWarps) sample_stream(A, b, p, buf + b * 2 * Vp);
  csync();
#else
  ++g.n;
  if (threadIdx.x == 0) sh.last = frt_grid_arrive(g);
  csync();
  if (sh.last) {
    for (int b = warp; b < A.B; b += kCWarps) sample_stream(A, b, p, buf + b * 2 * Vp);
    csync();
    if (threadIdx.x == 0) frt_grid_release_flag(g);
  } else if (threadIdx.x == 0) {
    frt_grid_wait_flag(g);
  }
  csync();
#endif
}

// The bf16-rounded channel scale of row o of MLP in-projection m (none for
// int4, whose scales sit in the weights).
__device__ __forceinline__ float mlp_scale(const Args& A, int m, int l, int o) {
  return A.mode[m] == kInt4 ? 0.f : bfr(__ldg(A.ms[m] + (size_t)l * A.I + o));
}

// y of an MLP in-projection from its dot: int4 rounds the dot; int8 (and
// a8, whose dot already carries the activation scale) rounds the dot, then
// its product with the channel scale sc (pallas_depth.py:548).
__device__ __forceinline__ float mlp_in_out(const Args& A, int m, float sc,
                                            float acc) {
  if (A.mode[m] == kInt4) return bfr(acc);
  return bfr(bfr(acc) * sc);
}

// Row pitches (bytes) of staged activations: products of bf16 weights read
// 16 bytes at 16 t of a row (pitch mod 128 = 64), of int8 and int4 weights
// 32 bytes at 32 t (mod 128 = 16); a8 int8 rows 16 bytes at 16 t (mod 128
// = 64). frt_depth_chain_plan sizes the staging from these.
__host__ __device__ __forceinline__ int pitch_bf(int K) { return 2 * K + 64; }
__host__ __device__ __forceinline__ int pitch_x(int K) { return 2 * K + 16; }
__host__ __device__ __forceinline__ int pitch_q(int K) { return (K + 127) / 128 * 128 + 64; }
__host__ __device__ __forceinline__ int round128(int n) { return (n + 127) / 128 * 128; }

__device__ __forceinline__ void consumer(const Args& A, Ring& r,
                                         unsigned char* act, Shared& sh) {
  const int tid = threadIdx.x;
  const int B = A.B, Db = A.Db, Dd = A.Dd, I = A.I, V = A.V, ncb = A.ncb;
  const int HqDh = A.Hq * kDh, Wqkv = HqDh + 2 * A.Hkv * kDh;
  const bool a8_in = A.mode[0] == kInt8A8 || A.mode[1] == kInt8A8;
  const bool a8_down = A.mode[2] == kInt8A8;
  const int er = tid >> 3, en = tid & 7;    // epilogue element (tid < 128)
  FrtGrid gbar{A.bar, 0u};
  Tracer tr;
  auto sync = [&]() {               // a phase barrier, stamped
    tr.mark(kEvBarIn);
    phase_sync(gbar);
    tr.mark(kEvBarOut);
  };
  const int Vp = (V + 3) / 4 * 4;           // logits rows, padded to 16 bytes
  // a copy of h (for the norms) in shared memory, past what the phases
  // stage (frt_depth_chain_plan)
  float* hs = reinterpret_cast<float*>(
      act + round128(B * pitch_bf(Dd)) + round128(B * pitch_q(Dd)));
  int t0, t1;

  for (int p = 0; p < ncb; ++p) {
    // ---- input: last_h (p = 0) or the previous token's embedding, @ proj
    {
      const Mat m = mat_proj(A);
      tile_range(m.O, t0, t1);
      const XIn x{act, pitch_bf(Db), nullptr, 0, Db, 1};
      tr.mark(kEvStageIn);
      if (t0 < t1) {
        const int row16 = Db / 8;
        for (int i = tid; i < B * row16; i += kCThreads) {
          const int b = i / row16, c = i - b * row16;
          const bf16* src = A.last_h + (size_t)b * Db;
          if (p > 0) {
            const int tk = min(max(__ldcg(A.tok + b), 0), V - 1);
            src = A.emb + (size_t)(tk + (p - 1) * V) * Db;
          }
          frt_cp_async16(frt_smem_addr(act + b * x.xs_pitch + 16 * c), src + 8 * c, 16);
        }
        frt_cp_async_commit();
        copy_wait();
      }
      tr.mark(kEvStageOut);
      for (int t = t0; t < t1; ++t) {
        tr.mark(kEvTileIn);
        tile_products(A, m, x, nullptr, 0, t, r, sh);
        const int o = t * kTile + er;
        if (tid < 128 && o < m.O && en < B)
          A.h[(size_t)en * Dd + o] = bfr(tile_sum(m, x, tid, sh));
        tr.mark(kEvTileOut);
      }
      sync();
    }

    for (int l = 0; l < A.L; ++l) {
#if !(FRT_ABL & FRT_ABL_NOATTN)
      // ---- attention norm + merged QKV (mm8 + bias)
      {
        const Mat m = mat_qkv(A, l);
        tile_range(m.O, t0, t1);
        const XIn x{act, pitch_x(Dd), nullptr, 0, Dd, 1};
        tr.mark(kEvStageIn);
        if (t0 < t1)
          stage_rms(A, A.attn_norm + (size_t)l * Dd, act, x.xs_pitch, hs, sh);
        tr.mark(kEvStageOut);
        for (int t = t0; t < t1; ++t) {
          tr.mark(kEvTileIn);
          // each epilogue's global loads are issued before the tile's products
          const int o = t * kTile + er;
          const bool mine = tid < 128 && o < m.O && en < B;
          const float sc = mine ? bfr(__ldg(A.wqkv_s + (size_t)l * Wqkv + o)) : 0.f;
          const float bias = mine ? bf2f(A.bqkv[(size_t)l * Wqkv + o]) : 0.f;
          tile_products(A, m, x, nullptr, 0, t, r, sh);
          if (mine)
            A.qkv[(size_t)en * Wqkv + o] =
                bfr(bfr(bfr(tile_sum(m, x, tid, sh)) * sc) + bias);
          tr.mark(kEvTileOut);
        }
        sync();
      }

      // ---- attention, once across the grid
      tr.mark(kEvAttnIn);
      attention_once(A, l, p);
      tr.mark(kEvAttnOut);
      sync();

      // ---- wo
      {
        const Mat m = mat_wo(A, l);
        tile_range(m.O, t0, t1);
        const XIn x{act, pitch_x(HqDh), nullptr, 0, HqDh, 1};
        tr.mark(kEvStageIn);
        if (t0 < t1) {
          copy_rows(act, x.xs_pitch, A.o, (size_t)HqDh * 2, B, HqDh / 8);
          copy_wait();
        }
        tr.mark(kEvStageOut);
        for (int t = t0; t < t1; ++t) {
          tr.mark(kEvTileIn);
          const int o = t * kTile + er;
          const bool mine = tid < 128 && o < m.O && en < B;
          float* hp = A.h + (size_t)en * Dd + o;
          const float sc = mine ? bfr(__ldg(A.wo_s + (size_t)l * Dd + o)) : 0.f;
          const float h0 = mine ? __ldcg(hp) : 0.f;
          tile_products(A, m, x, nullptr, 0, t, r, sh);
          if (mine) *hp = bfr(h0 + bfr(bfr(tile_sum(m, x, tid, sh)) * sc));
          tr.mark(kEvTileOut);
        }
        sync();
      }
#endif

      // ---- MLP norm + gate/up: t = bf16(silu(gate)) * up
      {
        const Mat g = mat_mlp(A, 0, l), u = mat_mlp(A, 1, l);
        tile_range(I, t0, t1);
        const int xsb = round128(B * pitch_x(Dd));
        const XIn x{act, pitch_x(Dd), act + xsb, pitch_q(Dd), Dd, 1};
        tr.mark(kEvStageIn);
        if (t0 < t1) {
          stage_rms(A, A.mlp_norm + (size_t)l * Dd, act, x.xs_pitch, hs, sh);
          if (a8_in) stage_quant(A, act, x.xs_pitch, Dd, 1, act + xsb, x.xq_pitch, sh);
        }
        tr.mark(kEvStageOut);
        const float* gs = A.ms[0] + (A.mode[0] == kInt4 ? (size_t)l * I * (Dd / A.grp[0]) : 0);
        const float* us = A.ms[1] + (A.mode[1] == kInt4 ? (size_t)l * I * (Dd / A.grp[1]) : 0);
        for (int t = t0; t < t1; ++t) {
          tr.mark(kEvTileIn);
          const int o = t * kTile + er;
          const bool mine = tid < 128 && o < I && en < B;
          const float gsc = mine ? mlp_scale(A, 0, l, o) : 0.f;
          const float usc = mine ? mlp_scale(A, 1, l, o) : 0.f;
          tile_products(A, g, x, gs, A.grp[0], t, r, sh);
          float gv = 0.f;
          if (mine) {
            const float y = mlp_in_out(A, 0, gsc, tile_sum(g, x, tid, sh));
            gv = bfr(__fmul_rn(y, 1.f / (1.f + expf(-y))));
          }
          tile_products(A, u, x, us, A.grp[1], t, r, sh);
          if (mine)
            A.t[(size_t)en * I + o] =
                __float2bfloat16(gv * mlp_in_out(A, 1, usc, tile_sum(u, x, tid, sh)));
          tr.mark(kEvTileOut);
        }
        sync();
      }

      // ---- down over both halves (fp32), then the scale; h += d
      {
        const Mat m = mat_mlp(A, 2, l);
        tile_range(m.O, t0, t1);
        const XIn x{act, pitch_x(I), act, pitch_q(I), I, 2};
        tr.mark(kEvStageIn);
        if (t0 < t1) {
          if (a8_down) {
            stage_quant(A, nullptr, 0, I, 2, act, x.xq_pitch, sh);
          } else {
            copy_rows(act, x.xs_pitch, A.t, (size_t)I * 2, B, I / 8);
            copy_wait();
          }
        }
        tr.mark(kEvStageOut);
        const float* ds = A.ms[2] + (A.mode[2] == kInt4 ? (size_t)l * Dd * (I / A.grp[2]) : 0);
        for (int t = t0; t < t1; ++t) {
          tr.mark(kEvTileIn);
          const int o = t * kTile + er;
          const bool mine = tid < 128 && o < m.O && en < B;
          float* hp = A.h + (size_t)en * Dd + o;
          const float sc = mine && A.mode[2] != kInt4
              ? bfr(__ldg(A.ms[2] + (size_t)l * Dd + o)) : 0.f;
          const float h0 = mine ? __ldcg(hp) : 0.f;
          tile_products(A, m, x, ds, A.grp[2], t, r, sh);
          if (mine) {
            const float acc = tile_sum(m, x, tid, sh);
            *hp = bfr(h0 + (A.mode[2] == kInt4 ? bfr(acc) : bfr(bfr(acc) * sc)));
          }
          tr.mark(kEvTileOut);
        }
        sync();
      }
    }
    if (p == 0) continue;             // codebook 0 is c0, recorded at the start

#if !(FRT_ABL & FRT_ABL_NOSAMPLE)
    // ---- final norm + logits of codebook p (audio head p - 1), then the
    // barrier whose last block samples
    {
      const Mat m = mat_head(A, p);
      tile_range(m.O, t0, t1);
      const XIn x{act, pitch_bf(Dd), nullptr, 0, Dd, 1};
      tr.mark(kEvStageIn);
      if (t0 < t1) stage_rms(A, A.final_norm, act, x.xs_pitch, hs, sh);
      tr.mark(kEvStageOut);
      for (int t = t0; t < t1; ++t) {
        tr.mark(kEvTileIn);
        tile_products(A, m, x, nullptr, 0, t, r, sh);
        const int o = t * kTile + er;
        if (tid < 128 && o < V && en < B) {
          const float lg = tile_sum(m, x, tid, sh);
          A.logits[(size_t)en * Vp + o] = lg;
          if (A.logits_out) A.logits_out[((size_t)en * ncb + p) * V + o] = lg;
        }
        tr.mark(kEvTileOut);
      }
      tr.mark(kEvSampIn);
      sample_sync(A, p, reinterpret_cast<float*>(act), gbar, sh);
      tr.mark(kEvSampOut);
    }
#endif
  }
  if (tid == 0) frt_grid_exit(gbar);
  tr.done();
}

__global__ void __launch_bounds__(kThreads, 1)
depth_chain_kernel(const Args A) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ Shared sh;
  __shared__ __align__(8) unsigned long long bars[2 * kMaxStages];
  const int tid = threadIdx.x;
  Ring r{dyn + round128(A.act_bytes), frt_smem_addr(bars),
         frt_smem_addr(bars + kMaxStages), A.stages, 0u};
  if (tid == 0) {
    for (int s = 0; s < A.stages; ++s) {
      frt_mbar_init(r.full + 8 * s, 1);
      frt_mbar_init(r.empty + 8 * s, kCWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (blockIdx.x == 0 && tid < A.B) {
    A.tok[tid] = A.c0[tid];
    A.samples[tid * A.ncb] = A.c0[tid];
  }
  __syncthreads();
  if (tid >= kCThreads) {
    producer(A, r, tid & 31);
    return;
  }
  consumer(A, r, dyn, sh);
}

static_assert(sizeof(Shared) + 16 * kMaxStages <= kStaticReserve,
              "static shared memory outgrew its reserve");

}  // namespace

// The index of each pointer and integer the wrapper passes
// (ops/depth_chain.py: _PTRS, _INTS).
enum PtrIndex {
  P_LAST_H, P_C0, P_NOISE, P_FORCED, P_PROJ, P_EMB, P_HEAD, P_COS, P_SIN,
  P_ATTN_NORM, P_MLP_NORM, P_FINAL_NORM, P_BQKV, P_WQKV, P_WQKV_S, P_WO,
  P_WO_S, P_GATE, P_GATE_S, P_UP, P_UP_S, P_DOWN, P_DOWN_S, P_SAMPLES,
  P_LOGITS_OUT, P_H, P_QKV, P_T, P_KST, P_VST, P_TOK, P_LOGITS, P_BAR, P_O,
  P_COUNT
};
enum IntIndex {
  I_B, I_DB, I_DD, I_HQ, I_HKV, I_DH, I_I, I_V, I_NCB, I_L, I_G_GATE, I_G_UP,
  I_G_DOWN, I_M_GATE, I_M_UP, I_M_DOWN, I_TOPK, I_GREEDY, I_COUNT
};

// The FRT_ABL bits this library was built with (0: the serving build).
extern "C" int frt_depth_chain_abl() { return FRT_ABL; }

extern "C" int frt_depth_chain_counts(int* ptrs, int* ints) {
  *ptrs = P_COUNT;
  *ints = I_COUNT;
  return 0;
}

// Tiles [t0, t1) of an O-row matrix that block `block` of `grid` owns: the
// kernel's own tile_range, for the wrapper's card test of its partition.
extern "C" int frt_depth_chain_tiles(int O, int block, int grid, int* t01) {
  tile_range(O, block, grid, t01[0], t01[1]);
  return 0;
}

// Blocks of the cooperative grid for a dynamic shared-memory size: the SM
// count times the blocks an SM holds. Negative: a CUDA error.
static int chain_grid(int smem_bytes) {
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

// The layout of a launch for the shape in ints (I_COUNT integers, as the
// launch takes them): out[0] the cooperative grid, out[1] the ring's
// stages, out[2] the bytes of staged activations: the largest any phase
// stages, rows padded as the phases pad them, with the copy of h and the
// norm weight past the largest input (see consumer), rounded to 128. The
// ring takes what is left of the block's shared memory after them and the
// static reserve, at most kMaxStages. Every launch uses this layout;
// ops/depth_chain.py: chain_layout is its reference, held equal on the
// card. Returns 0, or a CUDA error when fewer than two stages fit.
extern "C" int frt_depth_chain_plan(const int* ints, int* out) {
  const int B = ints[I_B], Db = ints[I_DB], Dd = ints[I_DD], I = ints[I_I];
  const int HqDh = ints[I_HQ] * kDh, Vp = (ints[I_V] + 3) / 4 * 4;
  const bool a8_in = ints[I_M_GATE] == kInt8A8 || ints[I_M_UP] == kInt8A8;
  const int need[7] = {
      B * pitch_bf(Db),                                              // proj
      round128(B * pitch_x(Dd)) + (a8_in ? B * pitch_q(Dd) : 0),     // QKV, gate/up
      B * pitch_x(HqDh),                                             // wo
      B * (ints[I_M_DOWN] == kInt8A8 ? pitch_q(I) : pitch_x(I)),     // down
      B * pitch_bf(Dd),                                              // logits
      B * 2 * Vp * 4,                                                // sampling
      round128(B * pitch_bf(Dd)) + round128(B * pitch_q(Dd)) + B * Dd * 4 +
          Dd * 2};                                                   // h, norm weight
  int act = 0;
  for (int i = 0; i < 7; ++i) act = need[i] > act ? need[i] : act;
  act = round128(act);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  int stages = (optin - kStaticReserve - act) / kStage;
  stages = stages < kMaxStages ? stages : kMaxStages;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int grid = chain_grid(act + stages * kStage);
  if (grid < 0) return -grid;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = grid; out[1] = stages; out[2] = act;
  return 0;
}

// The TRACE build's events of its last launch: out (kTraceSlots x kTraceCap)
// and counts (kTraceSlots). Other builds record none: cudaErrorNotSupported.
extern "C" int frt_depth_chain_trace(unsigned long long* out, int* counts) {
#if FRT_ABL & FRT_ABL_TRACE
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(counts, g_trace_n, sizeof(g_trace_n));
  return (int)e;
#else
  (void)out; (void)counts;
  return (int)cudaErrorNotSupported;
#endif
}

// The TRACE build's capacity: traced blocks, events a block.
extern "C" int frt_depth_chain_trace_shape(int* out) {
  out[0] = kTraceSlots; out[1] = kTraceCap;
  return 0;
}

// ptrs: P_COUNT device pointers (P_FORCED, P_LOGITS_OUT may be null);
// ints: I_COUNT integers; floats: temperature, rms eps, 1/sqrt(Dh); layout:
// 3 integers, where the launch writes the layout it used (grid, stages,
// activation bytes: frt_depth_chain_plan). Returns 0 when the cooperative
// launch was accepted, else a CUDA error.
extern "C" int frt_fused_depth_decode(void* const* ptrs, const int* ints,
                                      const float* floats, void* stream,
                                      int* layout) {
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
  A.o = (bf16*)ptrs[P_O];
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
  A.temp = floats[0];
  A.eps = floats[1];
  A.attn_scale = floats[2];
  bool ok = A.B >= 1 && A.B <= kBMax && A.ncb >= 2 && A.ncb <= kMaxSlots &&
            ints[I_DH] == kDh && A.Hkv >= 1 && A.Hq % A.Hkv == 0 &&
            A.Db % 32 == 0 && A.Dd % 128 == 0 && A.I % 128 == 0 && A.topk >= 1;
  for (int m = 0; m < 3; ++m) {
    ok = ok && A.mode[m] >= kInt8 && A.mode[m] <= kInt4;
    if (A.mode[m] == kInt4) ok = ok && A.grp[m] >= 16 && A.grp[m] % 16 == 0;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const int err = frt_depth_chain_plan(ints, layout);
  if (err) return err;
  const int grid = layout[0];
  A.stages = layout[1];
  A.act_bytes = layout[2];
  const int smem = A.act_bytes + A.stages * kStage;
  void* params[] = {(void*)&A};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)depth_chain_kernel,
                                              dim3(grid), dim3(kThreads), params,
                                              (size_t)smem,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
