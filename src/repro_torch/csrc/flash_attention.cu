// flash_attention.cu — forward attention with an online softmax over
// (B*H, S, D) q, k, v: causal and sliding-window masks, k-blocks wholly
// outside the mask skipped, rows with no visible key -> exact zeros, output
// in q's dtype, scale passed in (the wrapper gives D**-0.5).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, _flash_kernel /
// flash_attention_bhsd (the Pallas TPU kernel behind ops.flash_attention,
// called from models/attention.py for full-sequence self-attention).
//
// Bound on an H100: operations.  At qwen1.5-4b's shape (B*H = 20, S = 4096,
// D = 128, causal) the visible half of the score matrix costs
// 4 * 20 * (4096^2 / 2) * 128 ~ 86 GFLOP (Q.K^T and P.V), against 84 MB of
// q, k, v and o: about 1000 flops per byte, far above the ~295 at which
// the bf16 tensor cores rather than the memory become the limit.  So the
// design keeps both products on the tensor cores at their full rate, keeps
// them fed, never writes the (S, S) scores to device memory, and visits
// only the k-blocks the mask leaves (half of them under the causal mask).
//
// The TPU grid (BH, S/block_q, S/block_k) runs its k axis in order on one
// core, carrying m, l and the accumulator in VMEM scratch.  Here one block
// owns (bh, one q-block of 128 rows) and loops over its k-blocks itself,
// keeping m, l and the output accumulator in registers in f32; blocks run
// in parallel, the latest (most loaded, under the causal mask) q-blocks of
// every head first.
//
// bf16: a warp-specialised wgmma kernel of two consumer warpgroups and one
// producer warp, 288 threads, one block per SM (the design of
// csrc/matmul_tuned.cu's bf16 path):
//   * loads: one thread of the producer warp issues TMA loads: Q once (two
//     64-column boxes at D = 128), then K and V of each relevant k-block
//     through a ring of STAGES stages, each behind a "full" mbarrier
//     (bytes arrived) and an "empty" one (both consumers done with it).
//     Every tile is stored with TMA's 128-byte swizzle, the layout wgmma
//     reads.
//   * S = Q.K^T: two consumer warpgroups own 64 query rows each and run
//     wgmma.m64n{block_k}k16 straight from shared memory; Q and K are both
//     K-major (D contiguous), so neither operand takes the transpose bit.
//   * O += P.V: the register-A form of wgmma.  The f32 accumulator layout
//     of S packs pairwise into the A-fragment layout of the next k16
//     slices, so P is rounded to bf16 in place, with no shuffle and no
//     trip through shared memory.  V is read MN-major (D contiguous)
//     through the transpose bit, in 64-wide boxes: it is never transposed
//     in memory.  P IS ROUNDED TO BF16 for P.V (the row sums l stay in
//     f32); the bf16 tolerance (2e-2 + 2e-2 |want|) covers it.
//   * online softmax in the accumulator layout: each thread holds two
//     rows; row max and sum by quad shuffles; 2^x (ex2.approx) of one
//     FFMA with scale * log2(e) folded in; the per-element mask only on
//     k-blocks that cross the diagonal or the window's edge; the k-loop
//     runs over the first to the last relevant k-block, computed from the
//     mask, and tests no other.
//   * ping-pong: the two consumers take turns on the tensor cores through
//     two named barriers.  A turn issues P.V of the previous k-block and
//     Q.K^T of the next in one commit group, so one warpgroup's softmax
//     runs while the other's products do.  (Overlapping a warpgroup's own
//     softmax with its next Q.K^T is left for later.)
//   * epilogue: O is scaled by 1/l, rounded to bf16 into this consumer's
//     rows of the Q tile (which it no longer reads), in the same 128-byte
//     swizzle so the stores are free of bank conflicts, then written with
//     16-byte stores.
// block_q = 128 and D in {64, 128} are fixed per instantiation, block_k is
// 64 or 128, and the ring is as deep as 227 KB allows (3 stages at D = 128,
// block_k = 128; 6 at block_k = 64).  A block with no relevant k-block (a
// causal window of 0) loads nothing, waits on no barrier, and writes exact
// zeros.
//
// Registers bound the widest tile.  ptxas gives this kernel 168 registers
// a thread (it counts whole warpgroups, and a setmaxnreg.inc does not raise
// what it allocates the consumers), and a turn holds O, P and S at once:
// D / 2 + block_k / 4 + block_k / 2 of them.  At block_k = D = 128 that is
// 160, so ptxas keeps P in S's registers and serialises every wgmma of
// that instantiation (C7512, no spill); block_k = 64 at D = 128 (112) runs
// pipelined and is the faster tile.
//
// f32: on the FMA units (no TF32; the bound is 67 TFLOP/s), both products
// register-tiled, with the online softmax between them.  Its predecessor
// (four threads a row) read one float of K or V from shared memory
// per FFMA and staged K/V synchronously; here:
//   * S = Q.K^T as an outer product: a thread owns 8 query rows and
//     block_k / 16 keys; Q (once) and K are staged row-major with a
//     16-byte-chunk XOR swizzle, and a d step of 4 reads 8 + block_k / 16
//     float4 for 32 block_k / 16 FFMAs, each read a broadcast or a
//     conflict-free pair of wavefronts;
//   * online softmax: a row's 16 threads (a half-warp) reduce its max by
//     shuffles; scores are scaled by scale * log2(e) once (an FMUL) and
//     2^(s - m) is one FADD and one MUFU.EX2 (ex2.approx holds the f32
//     tolerance: its relative error is ~2^-22).  The bf16 path folds the
//     scale into one FFMA instead; here the row's largest score then gave
//     2^(rounding error), not exactly 1, and a one-hot row (one visible
//     key) was no longer V's row bit for bit.  The row sum stays a
//     per-thread part until the epilogue; the per-element mask only on
//     k-blocks that cross the diagonal or the window's edge; the k-loop
//     over the first to the last relevant k-block only;
//   * O += P.V as a second outer product: P goes through shared memory
//     (the half-warp's own rows, so __syncwarp orders it), a thread owns
//     8 rows x D / 16 columns of O in registers, and a step of 4 keys reads
//     8 + D / 16 float4 for 32 D / 16 FFMAs;
//   * overlap: K and V of the next k-block are copied by 16-byte cp.async
//     into the other stage of a two-stage ring while this one computes; one
//     barrier a k-block;
//   * the heaviest q-blocks of every head first, as the bf16 grid.
// Threads: 16 per 8 query rows, so 256 at block_q = 128 and 128 at 64.
// Each (block_q, block_k, D) in {64, 128} x {32, 64} x {64, 128} is a
// template instantiation.  ptxas gives a thread 160-224 registers (with a
// minimum of one block an SM stated: left to its own choice it capped some
// instantiations at 128 and spilled), so a block of 256 threads has an SM
// to itself; two of 128 share one where their shared memory allows.
//
// The mask value is finite (-0.7 * FLT_MAX, as the TPU kernel's MASK_VALUE):
// with -inf the first fully masked block would give exp(-inf - -inf) = NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DT_F32 = 1, DT_BF16 = 2;

struct Mask {
  int causal, has_window, window;

  __device__ __forceinline__ bool visible(int qi, int ki) const {
    if (causal && ki > qi) return false;
    if (has_window && ki < qi - window + 1) return false;
    return true;
  }
  // The k-blocks of size bk that hold a key some row of [q_lo, q_hi] sees:
  // the first one and how many.  Each row sees one interval of keys and
  // neighbouring rows' intervals touch, so the blocks are contiguous; a
  // causal window of 0 leaves every row without a key (count 0).
  __device__ __forceinline__ void k_blocks(int q_lo, int q_hi, int S, int bk,
                                           int& first, int& count) const {
    const int lo = has_window ? max(0, q_lo - window + 1) : 0;
    const int hi = causal ? q_hi : S - 1;
    first = lo / bk;
    count = (causal && has_window && window < 1) || lo > hi ? 0 : hi / bk - first + 1;
  }
  // every (q, k) pair of the two ranges visible: no per-element mask
  __device__ __forceinline__ bool all_visible(int q_lo, int q_hi, int k_lo,
                                              int k_hi) const {
    return (!causal || k_hi <= q_lo) && (!has_window || k_lo >= q_hi - window + 1);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// 2^x in one MUFU.EX2, flushing subnormals to zero (exp2f adds range
// handling around it); 2^0 = 1 and 2^MASK_VALUE = 0 exactly
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: TMA ring + warp-specialised, ping-ponged wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;
constexpr int CONSUMERS = 2;                    // warpgroups of 64 rows
constexpr int PRODUCER = 128 * CONSUMERS;       // the producer warp's first thread
// Two consumer warpgroups and one producer warp (see the note on registers
// at the top: no setmaxnreg, which would not raise what ptxas allocates)
constexpr int THREADS = PRODUCER + 32;
constexpr int SMEM_MAX = 232448;                // 227 KB, a block's most
// named barriers: BAR_TURN + c is consumer c's turn on the tensor cores,
// BAR_EPI + c its epilogue (0 is __syncthreads)
constexpr int BAR_TURN = 1, BAR_EPI = 3;

template <int BK, int D>
struct Tile {
  static constexpr int Q_BYTES = BQ * D * 2;               // 16 or 32 KB
  static constexpr int KV_BYTES = BK * D * 2;              // K (or V) of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // 1024 bytes of slack to align Q and the ring for the 128-byte swizzle,
  // Q, the ring, then Q's barrier and a full and an empty one per stage;
  // the ring as deep as that allows
  static constexpr int STAGES = (SMEM_MAX - 1024 - Q_BYTES - 8) / (STAGE_BYTES + 16);
  static constexpr size_t smem =
      1024 + Q_BYTES + (size_t)STAGES * STAGE_BYTES + (1 + 2 * STAGES) * sizeof(uint64_t);
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(smem <= SMEM_MAX, "ring exceeds 227 KB");
};

// S (64 x BK) = Q (this consumer's 64 rows) . K^T, both K-major in 64-column
// boxes: a k16 slice is 32 bytes into a 128-byte row, 4 slices a box
template <int BK, int D>
__device__ __forceinline__ void qk(float (&s)[BK / 2], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sm90::desc_sw128(q + (kk / 4) * BQ * 128 + 32 * (kk % 4), 16, 1024);
    const uint64_t db = sm90::desc_sw128(k + (kk / 4) * BK * 128 + 32 * (kk % 4), 16, 1024);
    if constexpr (BK == 128)
      sm90::wgmma_m64n128k16_bf16<0, 0>(s, da, db, kk > 0);
    else
      sm90::wgmma_m64n64k16_bf16<0, 0>(s, da, db, kk > 0);
  }
}

// O (64 x D) += P (registers) . V, V MN-major: a k16 slice is 16 rows
// (2048 bytes) on, the 64-wide boxes of D BK * 128 bytes apart (LBO)
template <int BK, int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&p)[BK / 16][4],
                                   uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = sm90::desc_sw128(v + 2048 * kk, BK * 128, 1024);
    if constexpr (D == 128)
      sm90::wgmma_m64n128k16_bf16_rs<1>(o, p[kk], db, 1);
    else
      sm90::wgmma_m64n64k16_bf16_rs<1>(o, p[kk], db, 1);
  }
}

// The online softmax of one k-block in the accumulator layout: S (raw
// scores) -> P (bf16 A fragments of P.V), the rows' max m (in raw score
// units) and this thread's part of the sums l updated, O rescaled.  Entry
// e of S is row qi[h], h = (e >> 1) & 1, key k_lo + 2 tq + 8 (e / 4) +
// (e & 1).  p = 2^(s scale log2(e) - m scale log2(e)), one FFMA and one
// MUFU.EX2 an entry.  The per-element mask runs only where the k-block
// crosses the diagonal or the window's edge.
template <int BK, int D>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&o)[D / 2],
                                        uint32_t (&p)[BK / 16][4], float (&m)[2],
                                        float (&l)[2], const Mask& mask,
                                        const int (&qi)[2], int k_lo, int rows_lo,
                                        int tq, float scale_log2) {
  float mx[2] = {m[0], m[1]};
  if (!mask.all_visible(rows_lo, rows_lo + 63, k_lo, k_lo + BK - 1)) {
    // entry e's key is k_lo + 2 tq + off(e), off(e) = 8 (e / 4) + (e & 1) a
    // constant; row h sees it iff lo[h] <= off(e) <= hi[h].  Two bounds a
    // row and block, so nothing per entry is left for the compiler to hoist
    // out of the k-loop into registers.
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = qi[h] - k_lo - 2 * tq;
      hi[h] = mask.causal ? d : INT_MAX;
      lo[h] = mask.has_window ? d - mask.window + 1 : INT_MIN;
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int h = (e >> 1) & 1, off = (e / 4) * 8 + (e & 1);
      if (off < lo[h] || off > hi[h]) s[e] = MASK_VALUE;
    }
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = quad_max(mx[h]);
    const float alpha = ex2((m[h] - mn) * scale_log2);
    m[h] = mn;
    // a row that has seen no key yet (m still MASK_VALUE) subtracts 0, so
    // its masked entries give 2^(MASK_VALUE scale log2(e)) = 0, not 2^0 = 1
    base[h] = mn == MASK_VALUE ? 0.0f : mn * scale_log2;
    l[h] *= alpha;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * h] *= alpha;
      o[4 * j + 2 * h + 1] *= alpha;
    }
  }
  // P a pair at a time, so each pair of S dies as its P is born
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int e = 8 * kk + 2 * a, h = a & 1;
      const float x0 = ex2(fmaf(s[e], scale_log2, -base[h]));
      const float x1 = ex2(fmaf(s[e + 1], scale_log2, -base[h]));
      l[h] += x0 + x1;
      p[kk][a] = pack_bf16(x0, x1);
    }
}

template <int BK, int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_bf16(const __grid_constant__ CUtensorMap tmQ, const __grid_constant__ CUtensorMap tmK,
        const __grid_constant__ CUtensorMap tmV, bf16* __restrict__ O, int S,
        float scale_log2, Mask mask) {
  using T = Tile<BK, D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sQ + T::Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + T::STAGES;

  const int bh = blockIdx.x;
  const int q_lo = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;
  const int row0 = bh * S;             // (bh, 0)'s row in the (BH * S, D) view
  int kb0, n;
  mask.k_blocks(q_lo, q_lo + BQ - 1, S, BK, kb0, n);

  if (threadIdx.x == PRODUCER) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= PRODUCER) {
    // producer: one thread issues the TMA loads of Q and of every stage
    if (threadIdx.x == PRODUCER && n > 0) {
      sm90::prefetch_tensormap(&tmQ);
      sm90::prefetch_tensormap(&tmK);
      sm90::prefetch_tensormap(&tmV);
      sm90::mbar_arrive_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int j = 0; j < D / 64; ++j)
        sm90::tma_load_2d(sQ + j * BQ * 128, &tmQ, q_full, 64 * j, row0 + q_lo);
      for (int i = 0; i < n; ++i) {
        const int s = i % T::STAGES;
        sm90::mbar_wait(&empty[s], ((i / T::STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * T::STAGE_BYTES;
        const int key = row0 + (kb0 + i) * BK;
        sm90::mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
#pragma unroll
        for (int j = 0; j < D / 64; ++j) {
          sm90::tma_load_2d(st + j * BK * 128, &tmK, &full[s], 64 * j, key);
          sm90::tma_load_2d(st + T::KV_BYTES + j * BK * 128, &tmV, &full[s], 64 * j, key);
        }
      }
    }
  } else {
    // consumers: warpgroup c owns rows [64 c, 64 c + 64) of the q-block;
    // this thread rows r and r + 8 of them, and in every n8 column group j
    // the accumulator entries 4 j .. 4 j + 3 at columns 8 j + 2 tq, + 1.
    const int c = threadIdx.x / 128;
    const int t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
    const int r = c * 64 + (t / 32) * 16 + lane / 4;
    const int rows_lo = q_lo + c * 64;
    const int qi[2] = {q_lo + r, q_lo + r + 8};

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    // pinned here: left free, the compiler sinks the zeros into the loop
    // among the in-flight wgmmas, and ptxas then serialises them (C7515)
    sm90::fence_operands(o);
    float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.0f, 0.0f};

    if (n > 0) {
      float s[BK / 2];
      uint32_t p[BK / 16][4];
      const uint32_t q = sm90::smem_u32(sQ) + c * 64 * 128;
      auto k_of = [&](int i) { return sm90::smem_u32(ring + (i % T::STAGES) * T::STAGE_BYTES); };
      auto v_of = [&](int i) { return k_of(i) + T::KV_BYTES; };
      auto wait_full = [&](int i) {
        sm90::mbar_wait(&full[i % T::STAGES], (i / T::STAGES) & 1);
      };
      // a turn: wait for this consumer's turn, issue, hand the turn over
      // (the last turn of consumer 1 hands over nothing: consumer 0 is done),
      // wait for the products
      auto turn_begin = [&] {
        sm90::named_bar_sync(BAR_TURN + c, 256);
        sm90::wgmma_fence();
      };
      auto turn_end = [&](bool last) {
        sm90::wgmma_commit();
        if (c == 0 || !last) sm90::named_bar_arrive(BAR_TURN + 1 - c, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_operands(s);
        sm90::fence_operands(o);
      };
      auto release = [&](int i) {
        if (t == 0) sm90::mbar_arrive(&empty[i % T::STAGES]);
      };
      sm90::mbar_wait(q_full, 0);
      if (c == 1) sm90::named_bar_arrive(BAR_TURN, 256);   // consumer 0 goes first
      wait_full(0);
      turn_begin();
      qk<BK, D>(s, q, k_of(0));
      turn_end(false);
      softmax<BK, D>(s, o, p, m, l, mask, qi, kb0 * BK, rows_lo, tq, scale_log2);
      for (int i = 1; i < n; ++i) {
        wait_full(i);
        turn_begin();
        pv<BK, D>(o, p, v_of(i - 1));
        qk<BK, D>(s, q, k_of(i));
        turn_end(false);
        release(i - 1);
        softmax<BK, D>(s, o, p, m, l, mask, qi, (kb0 + i) * BK, rows_lo, tq,
                       scale_log2);
      }
      turn_begin();
      pv<BK, D>(o, p, v_of(n - 1));
      turn_end(true);
      release(n - 1);
    }

    // epilogue: rows with no visible key have l == 0 and o == 0, so they stay
    // exact zeros.  The bf16 tile goes into this consumer's own rows of the
    // Q tile in its 128-byte swizzle (16-byte chunk j of a row at j ^ (row %
    // 8)), then out as 16-byte stores, a row's chunks on consecutive threads.
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lh = quad_sum(l[h]);
      inv[h] = 1.0f / (lh == 0.0f ? 1.0f : lh);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        unsigned char* dst = sQ + (j / 8) * BQ * 128 + row * 128 +
                             (((j % 8) ^ (row % 8)) * 16) + 4 * tq;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
      }
    sm90::named_bar_sync(BAR_EPI + c, 128);
    constexpr int CHUNKS = D / 8;         // 16-byte chunks of a row
#pragma unroll 4
    for (int v = t; v < 64 * CHUNKS; v += 128) {
      const int row = c * 64 + v / CHUNKS, ch = v % CHUNKS;
      const unsigned char* src =
          sQ + (ch / 8) * BQ * 128 + row * 128 + (((ch % 8) ^ (row % 8)) * 16);
      *reinterpret_cast<uint4*>(&O[(size_t)(row0 + q_lo + row) * D + ch * 8]) =
          *reinterpret_cast<const uint4*>(src);
    }
  }
}

template <int BK, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
                   float scale, Mask mask, cudaStream_t s) {
  using T = Tile<BK, D>;
  const uint64_t rows = (uint64_t)BH * S;
  CUtensorMap tq, tk, tv;
  if (!sm90::tma_map_bf16_sw128(&tq, q, rows, D, D, BQ, 64) ||
      !sm90::tma_map_bf16_sw128(&tk, k, rows, D, D, BK, 64) ||
      !sm90::tma_map_bf16_sw128(&tv, v, rows, D, D, BK, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bf16<BK, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem);
  if (err != cudaSuccess) return err;
  fa_bf16<BK, D><<<dim3(BH, S / BQ), THREADS, T::smem, s>>>(
      tq, tk, tv, static_cast<bf16*>(o), S, scale * LOG2E, mask);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: FMA units, register-tiled S = Q.K^T and O += P.V
// ---------------------------------------------------------------------------

namespace ffma {

constexpr int ROWS = 8;            // query rows a thread
constexpr int TPR = 16;            // threads sharing those rows: a half-warp
constexpr int STAGES = 2;          // the K/V ring

template <int BQ, int BK, int D>
struct Tile {
  static constexpr int RG = BQ / ROWS;               // row groups
  static constexpr int THREADS = RG * TPR;           // 256 or 128
  static constexpr int KEYS = BK / TPR;              // keys a thread in S
  static constexpr int G = D / 64;                   // float4 columns of O a thread
  static constexpr int Q_FLOATS = BQ * D, KV_FLOATS = BK * D, P_FLOATS = BQ * BK;
  static constexpr size_t smem = (size_t)(Q_FLOATS + STAGES * 2 * KV_FLOATS + P_FLOATS) * 4;
  static_assert(smem <= 232448, "tile exceeds 227 KB");
  static_assert(D / 4 >= 8 && BK / 4 >= 8, "a row must span the 8-chunk swizzle");
};

// Float offset of (row, 16-byte chunk ch) in a tile of rows W floats wide:
// the chunk is XORed with row % 8, so the eight rows of an atom put any
// one chunk on eight different bank groups.
template <int W>
__device__ __forceinline__ int sw(int row, int ch) {
  return row * W + ((ch ^ (row & 7)) << 2);
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// `rows` rows of D floats from global `src` (row stride D) into the
// swizzled tile `dst`, 16 bytes a cp.async
template <int W, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int rows) {
  for (int v = threadIdx.x; v < rows * (W / 4); v += THREADS) {
    const int r = v / (W / 4), ch = v % (W / 4);
    sm90::cp_async16(dst + sw<W>(r, ch), src + (size_t)r * W + 4 * ch);
  }
}

// Thread t of a block is row group rg = t / 16 and lane c = t % 16 of its
// half-warp.  It owns query rows rg + RG i (i < 8) of the q-block; in S,
// keys c + 16 j (j < BK / 16) of the k-block; in O, the float4 columns
// 4 c + 64 g (g < D / 64).  So:
//   * S: a d4 step reads 8 float4 of Q (the warp's two row groups, each a
//     broadcast; rows rg and rg + 1 differ in row % 8, so swizzled they
//     sit on different banks) and BK / 16 float4 of K (16 consecutive
//     keys, two wavefronts) for 32 BK / 16 FFMAs;
//   * O += P.V: a step of 4 keys reads 8 float4 of P (broadcast, as Q)
//     and 4 D / 64 float4 of V (16 consecutive chunks of a key's row) for
//     32 D / 16 FFMAs;
//   * the half-warp holds a row's max and sum by shuffles, and P goes
//     through shared memory rows that only its own warp writes and reads,
//     so __syncwarp orders it.
template <int BQ, int BK, int D>
__global__ void __launch_bounds__(Tile<BQ, BK, D>::THREADS, 1)
fa_f32(const float* __restrict__ Q, const float* __restrict__ K,
       const float* __restrict__ V, float* __restrict__ O, int S,
       float scale_log2, Mask mask) {
  using T = Tile<BQ, BK, D>;
  constexpr int RG = T::RG, KEYS = T::KEYS, G = T::G;
  extern __shared__ __align__(128) float smem_f[];
  float* Qs = smem_f;                               // [BQ][D], swizzled
  float* ring = Qs + T::Q_FLOATS;                   // STAGES x (K, V) [BK][D]
  float* Ps = ring + STAGES * 2 * T::KV_FLOATS;     // [BQ][BK], swizzled

  const int rg = threadIdx.x / TPR, c = threadIdx.x % TPR;
  // the latest (most loaded, under the causal mask) q-blocks of every head
  // first: x is the head, the fastest-varying index of the launch order
  const int q_lo = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;
  const size_t base = (size_t)blockIdx.x * S * D;
  int kb0, n;
  mask.k_blocks(q_lo, q_lo + BQ - 1, S, BK, kb0, n);

  float4 o[ROWS][G];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) o[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  auto load_kv = [&](int i) {
    float* st = ring + (i % STAGES) * 2 * T::KV_FLOATS;
    const size_t key = base + (size_t)(kb0 + i) * BK * D;
    copy_rows<D, T::THREADS>(st, K + key, BK);
    copy_rows<D, T::THREADS>(st + T::KV_FLOATS, V + key, BK);
    sm90::cp_async_commit();
  };
  if (n > 0) {
    copy_rows<D, T::THREADS>(Qs, Q + base + (size_t)q_lo * D, BQ);
    load_kv(0);                                    // one group: Q and k-block 0
  }

  for (int it = 0; it < n; ++it) {
    sm90::cp_async_wait<0>();
    // the one barrier of a k-block: every thread's copies of it landed,
    // and every thread is done with k-block it - 1, whose stage (and P)
    // the next loads (and this block's softmax) overwrite
    __syncthreads();
    if (it + 1 < n) load_kv(it + 1);
    const float* Ks = ring + (it % STAGES) * 2 * T::KV_FLOATS;
    const float* Vs = Ks + T::KV_FLOATS;
    const int k_lo = (kb0 + it) * BK;

    // S = Q . K^T for this thread's ROWS x KEYS scores
    float s[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 kf[KEYS];
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
        kf[j] = *reinterpret_cast<const float4*>(Ks + sw<D>(c + 16 * j, d4));
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(Qs + sw<D>(rg + RG * i, d4));
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

    // scores in units of log2: s scale log2(e), one FMUL each, so the
    // row's largest score gives exactly 2^0 = 1 below; the per-element
    // mask only where the k-block crosses the diagonal or the window's edge
    const bool edge = !mask.all_visible(q_lo, q_lo + BQ - 1, k_lo, k_lo + BK - 1);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
        s[i][j] = edge && !mask.visible(q_lo + rg + RG * i, k_lo + c + 16 * j)
                      ? MASK_VALUE : s[i][j] * scale_log2;

    // online softmax: p = 2^(s - m), one FADD and one MUFU.EX2 a score; m
    // in log2 units; l is this thread's part of the row sum
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KEYS; ++j) mx = fmaxf(mx, s[i][j]);
      const float mn = fmaxf(m[i], half_max(mx));
      const float alpha = ex2(m[i] - mn);
      m[i] = mn;
      // a row that has seen no key yet (m still MASK_VALUE) subtracts 0,
      // so its masked scores give 2^MASK_VALUE = 0
      const float b = mn == MASK_VALUE ? 0.f : mn;
      l[i] *= alpha;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        o[i][g].x *= alpha; o[i][g].y *= alpha; o[i][g].z *= alpha; o[i][g].w *= alpha;
      }
      const int row = rg + RG * i;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const float p = ex2(s[i][j] - b);
        l[i] += p;
        const int key = c + 16 * j;
        Ps[sw<BK>(row, key >> 2) + (key & 3)] = p;
      }
    }
    __syncwarp();

    // O += P . V
#pragma unroll 2
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      float4 pf[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pf[i] = *reinterpret_cast<const float4*>(Ps + sw<BK>(rg + RG * i, k4));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 vf[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          vf[g] = *reinterpret_cast<const float4*>(Vs + sw<D>(4 * k4 + kk, c + 16 * g));
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float p = lane_of(pf[i], kk);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            o[i][g].x = fmaf(p, vf[g].x, o[i][g].x);
            o[i][g].y = fmaf(p, vf[g].y, o[i][g].y);
            o[i][g].z = fmaf(p, vf[g].z, o[i][g].z);
            o[i][g].w = fmaf(p, vf[g].w, o[i][g].w);
          }
        }
      }
    }
  }

  // rows with no visible key have l == 0 and o == 0: exact zeros
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float li = half_sum(l[i]);
    const float inv = 1.f / (li == 0.f ? 1.f : li);
    float* dst = O + base + (size_t)(q_lo + rg + RG * i) * D + 4 * c;
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float4*>(dst + 64 * g) =
          make_float4(o[i][g].x * inv, o[i][g].y * inv, o[i][g].z * inv, o[i][g].w * inv);
  }
}

template <int BQ, int BK, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
                   float scale, Mask mask, cudaStream_t s) {
  using T = Tile<BQ, BK, D>;
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32<BQ, BK, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem);
  if (err != cudaSuccess) return err;
  fa_f32<BQ, BK, D><<<dim3(BH, S / BQ), T::THREADS, T::smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, scale * LOG2E, mask);
  return cudaGetLastError();
}

}  // namespace ffma

}  // namespace

// q, k, v, o: (BH, S, D) contiguous, 16-byte aligned, all of one dtype
// (1 = f32, 2 = bf16); S divisible by bq and bk; window used only when
// has_window (0 <= window <= S).  bf16 tiles: bq = 128, bk in {64, 128};
// f32 tiles: {64, 128} x {32, 64}; D in {64, 128} for both.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or tile that
// was not compiled or operands TMA cannot describe.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int BH, int S, int D, int dtype, int causal,
                          int has_window, int window, float scale, int bq,
                          int bk, void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || bq < 1 || bk < 1 || S % bq || S % bk ||
      (has_window && (window < 0 || window > S)))
    return (int)cudaErrorInvalidValue;
  const Mask mask{causal ? 1 : 0, has_window ? 1 : 0, has_window ? window : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) {
    if (bq != wg::BQ) return (int)cudaErrorInvalidValue;
#define FA_BF16(BK, DD) \
  if (bk == BK && D == DD) return (int)wg::launch<BK, DD>(q, k, v, o, BH, S, scale, mask, s);
    FA_BF16(64, 64) FA_BF16(64, 128) FA_BF16(128, 64) FA_BF16(128, 128)
#undef FA_BF16
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != DT_F32) return (int)cudaErrorInvalidValue;
#define FA_CASE(BQ, BK, DD)                                                    \
  if (bq == BQ && bk == BK && D == DD)                                         \
    return (int)ffma::launch<BQ, BK, DD>(q, k, v, o, BH, S, scale, mask, s);
#define FA_CASES(DD)                                                           \
  FA_CASE(64, 32, DD) FA_CASE(64, 64, DD) FA_CASE(128, 32, DD) FA_CASE(128, 64, DD)
  FA_CASES(64)
  FA_CASES(128)
#undef FA_CASES
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
