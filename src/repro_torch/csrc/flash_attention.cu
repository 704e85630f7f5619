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
// f32: on the FMA units (no TF32), four threads per query row, each holding
// a quarter of D (interleaved, so K/V reads are conflict-free broadcasts);
// scores are reduced with two shuffles and the online softmax steps over 8
// keys at a time; K and V staged in shared memory by every thread.  Each
// (block_q, block_k, D) in {64, 128} x {32, 64, 128} x {64, 128} is a
// template instantiation.
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

  // the TPU kernel's pl.when(relevant): any (q, k) pair of the two blocks
  // in range?
  __device__ __forceinline__ bool block_relevant(int q_lo, int q_hi, int k_lo,
                                                 int k_hi) const {
    if (causal && k_lo > q_hi) return false;
    if (has_window && k_hi < q_lo - window + 1) return false;
    return true;
  }
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
// f32: FMA units, four threads per query row
// ---------------------------------------------------------------------------

constexpr int TPR = 4;       // threads per query row
constexpr int CHUNK = 8;     // keys per online-softmax step

template <int BQ, int BK, int D>
struct F32Tile {
  static constexpr int THREADS = BQ * TPR;
  static constexpr size_t smem = (size_t)(2 * BK * D) * sizeof(float);
};

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(F32Tile<BQ, BK, D>::THREADS)
fa_f32(const float* __restrict__ Q, const float* __restrict__ K,
       const float* __restrict__ V, float* __restrict__ O, int S,
       float scale, Mask mask) {
  using T = F32Tile<BQ, BK, D>;
  constexpr int DS = D / TPR;    // this thread's d = i * TPR + part
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);   // [BK][D]
  float* Vs = Ks + BK * D;                      // [BK][D]

  const int qb = S / BQ - 1 - (int)blockIdx.x;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int part = threadIdx.x % TPR;
  const int q_lo = qb * BQ, q_hi = q_lo + BQ - 1;
  const int qi = q_lo + threadIdx.x / TPR;

  float q[DS], o[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    q[i] = Q[base + (size_t)qi * D + i * TPR + part];
    o[i] = 0.f;
  }
  float m = MASK_VALUE, l = 0.f;

  for (int kb = 0; kb < S / BK; ++kb) {
    const int k_lo = kb * BK;
    if (!mask.block_relevant(q_lo, q_hi, k_lo, k_lo + BK - 1)) continue;
    __syncthreads();
    const float4* kg = reinterpret_cast<const float4*>(K + base + (size_t)k_lo * D);
    const float4* vg = reinterpret_cast<const float4*>(V + base + (size_t)k_lo * D);
    for (int i = threadIdx.x; i < BK * D / 4; i += T::THREADS) {
      reinterpret_cast<float4*>(Ks)[i] = kg[i];
      reinterpret_cast<float4*>(Vs)[i] = vg[i];
    }
    __syncthreads();

    for (int j0 = 0; j0 < BK; j0 += CHUNK) {
      float s[CHUNK];
      float mx = MASK_VALUE;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const float* kr = Ks + (j0 + c) * D + part;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < DS; ++i) acc = fmaf(q[i], kr[i * TPR], acc);
        acc = quad_sum(acc);     // the row's four threads agree bit for bit
        s[c] = mask.visible(qi, k_lo + j0 + c) ? acc * scale : MASK_VALUE;
        mx = fmaxf(mx, s[c]);
      }
      const float mn = fmaxf(m, mx);
      const float alpha = expf(m - mn);
      m = mn;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        s[c] = mask.visible(qi, k_lo + j0 + c) ? expf(s[c] - mn) : 0.f;
        rs += s[c];
      }
      l = l * alpha + rs;
#pragma unroll
      for (int i = 0; i < DS; ++i) {
        float acc = o[i] * alpha;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
          acc = fmaf(s[c], Vs[(j0 + c) * D + i * TPR + part], acc);
        o[i] = acc;
      }
    }
  }

  const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
  for (int i = 0; i < DS; ++i) O[base + (size_t)qi * D + i * TPR + part] = o[i] * inv;
}

template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int BQ, int BK, int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
                       int S, float scale, Mask mask, cudaStream_t s) {
  using T = F32Tile<BQ, BK, D>;
  cudaError_t err = grant_smem(fa_f32<BQ, BK, D>, T::smem);
  if (err != cudaSuccess) return err;
  fa_f32<BQ, BK, D><<<dim3(S / BQ, BH), T::THREADS, T::smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, scale, mask);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (BH, S, D) contiguous, 16-byte aligned, all of one dtype
// (1 = f32, 2 = bf16); S divisible by bq and bk; window used only when
// has_window (0 <= window <= S).  bf16 tiles: bq = 128, bk in {64, 128};
// f32 tiles: {64, 128} x {32, 64, 128}; D in {64, 128} for both.  Returns
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
    return (int)launch_f32<BQ, BK, DD>(q, k, v, o, BH, S, scale, mask, s);
#define FA_CASES(DD)                                                           \
  FA_CASE(64, 32, DD) FA_CASE(64, 64, DD) FA_CASE(64, 128, DD)                 \
  FA_CASE(128, 32, DD) FA_CASE(128, 64, DD) FA_CASE(128, 128, DD)
  FA_CASES(64)
  FA_CASES(128)
#undef FA_CASES
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
