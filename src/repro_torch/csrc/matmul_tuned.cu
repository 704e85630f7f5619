// matmul_tuned.cu — C (M, N) = A (M, K) x B (K, N), both row-major, the
// sum in f32, the output cast to the inputs' dtype, in (bm, bn) output
// tiles stepping bk along K: the tile the tuner searches.
//
// Replaces: src/repro/kernels/matmul_tuned/kernel.py, _matmul_kernel /
// matmul (the Pallas TPU kernel behind ops.matmul_tuned, the paper's
// section 8 case study).  The TPU kernel's sequential K grid axis becomes
// a loop inside each block: blocks on Hopper run in parallel and in no
// order.
//
// Bound on an H100: operations.  At 8192^3 the product does 2*8192^3 =
// 1.1e12 flops on 0.4 GB of operands — thousands of flops per byte, well
// above the bf16 tensor cores' ~295 flops per byte of device memory — so
// the floor is flops over 989 TFLOP/s (bf16: 1.112 ms) or 67 TFLOP/s (f32
// on the FMA units, no TF32).
//
// bf16: a warp-specialised wgmma kernel.  Its predecessor (WMMA through
// registers) ran at 10 % of the bound for four reasons, each answered here:
//   * synchronous loads: a producer warp keeps a ring of STAGES (128 x 64)
//     A and (64 x bn) B tiles in flight with TMA, each stage behind a
//     "full" mbarrier (TMA bytes arrived) and an "empty" one (both
//     consumers done), so loads overlap the tensor cores;
//   * mma.sync: two consumer warpgroups, 64 rows each, run
//     wgmma.m64n{bn}k16 straight from the swizzled shared tiles (A
//     K-major, B MN-major through the instruction's transpose bit; B is
//     not transposed in memory), one commit group per stage, keeping one
//     group in flight while the previous stage is released;
//   * registers: setmaxnreg moves registers from the producer warpgroup
//     (40) to the consumers (232), whose 64 x bn f32 accumulators take bn/2
//     registers a thread, within one block of 384 threads per SM;
//   * the epilogue: each consumer casts its accumulators to bf16 into the
//     (then idle) ring, rows padded so the stores are free of bank
//     conflicts, and writes them out as coalesced 16-byte stores.
// bm = 128 and bk = 64 (one 128-byte swizzle row of bf16) are fixed; bn is
// 128 or 256, and the ring is as deep as 227 KB allows: 7 stages of 32 KB
// or 4 of 48 KB, since one block per SM leaves the rest of the shared
// memory idle.  Blocks take their tiles in groups of 16 along M, so the
// blocks that run together share their A and B panels in L2.
//
// f32: on the FMA units (fmaf, not TF32, so the f32 tolerance of the
// reference holds), 256 threads in a 16 x 16 grid, each computing a
// (bm/16) x (bn/16) block of outputs (8 x 8 at 128 x 128) in registers.
// Its predecessor made 16 LDS.32 reads for 64 FFMAs, the ratio at which
// the shared-memory pipe saturates, and staged each k-tile synchronously.  Here:
//   * vector reads: A is kept row-major (rows padded by 16 bytes) and read
//     as float4 along k, four k steps of a row at once; B row-major and
//     read as float4 along n; 16 LDS.128 per 256 FFMAs at 128 x 128, each
//     a single conflict-free or broadcast wavefront (see mm_f32);
//   * fragments double-buffered in registers: the next k step's float4
//     are read while this step's FFMAs run;
//   * a cp.async ring: both operands go to shared memory as 16-byte
//     cp.async copies (.cg, no registers on the way), STAGES k-tiles deep,
//     the deepest ring that lets two blocks share an SM (at least 2; the
//     128 x 128 tiles take one block an SM for their registers), with
//     the next STAGES - 1 k-tiles in flight while one computes; one
//     barrier a k-tile;
//   * float4 epilogue stores.
// Each output's sum is one sequential fmaf chain over k, as before.  Each
// (bm, bn, bk) in {64, 128} x {64, 128} x {32, 64} is a template
// instantiation; shared memory is dynamic, granted with
// cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DT_F32 = 1, DT_BF16 = 2;

// ---- bf16: TMA ring + warp-specialised wgmma ---------------------------------

namespace wg {

constexpr int BM = 128, BK = 64;
constexpr int CONSUMERS = 2;                    // warpgroups of 64 rows
constexpr int THREADS = 128 * (1 + CONSUMERS);  // warpgroup 0 produces
constexpr int GROUP_M = 16;

template <int BN>
struct Tile {
  static constexpr int A_BYTES = BM * BK * 2;             // 16 KB
  static constexpr int B_BYTES = BK * BN * 2;             // 16 or 32 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 4 : 7;        // deepest that fits
  static constexpr int LDC = BN + 8;                      // epilogue row
  // 1024 bytes of slack to align the ring for the 128-byte swizzle, the
  // ring, then a full and an empty barrier per stage
  static constexpr size_t smem =
      1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
  static_assert(smem <= 227 * 1024, "ring exceeds 227 KB");
  static_assert(BM * LDC * 2 <= STAGES * STAGE_BYTES, "epilogue exceeds ring");
};

template <int BN>
__device__ __forceinline__ void mma_k16(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    sm90::wgmma_m64n256k16_bf16<0, 1>(acc, da, db, 1);
  else
    sm90::wgmma_m64n128k16_bf16<0, 1>(acc, da, db, 1);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
mm_bf16(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
        bf16* __restrict__ C, int M, int N, int K) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + T::STAGES;

  // this block's output tile, grouped GROUP_M tiles deep along M
  const int tiles_m = M / BM, tiles_n = N / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * BN;
  const int steps = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues the TMA loads of every stage
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      sm90::prefetch_tensormap(&tmA);
      sm90::prefetch_tensormap(&tmB);
      for (int i = 0; i < steps; ++i) {
        const int s = i % T::STAGES;
        sm90::mbar_wait(&empty[s], ((i / T::STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * T::STAGE_BYTES;
        sm90::mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
        sm90::tma_load_2d(st, &tmA, &full[s], i * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          sm90::tma_load_2d(st + T::A_BYTES + j * BK * 128, &tmB, &full[s], n0 + 64 * j,
                            i * BK);
      }
    }
  } else {
    // consumers: warpgroup c owns rows [64 c, 64 c + 64) of the tile
    sm90::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    // pinned here: left free, the compiler sinks the zeros into the loop
    // among the in-flight wgmmas, and ptxas then serialises them (C7515)
    sm90::fence_operands(acc);
    for (int i = 0; i < steps; ++i) {
      const int s = i % T::STAGES;
      sm90::mbar_wait(&full[s], (i / T::STAGES) & 1);
      const uint32_t a = sm90::smem_u32(ring + s * T::STAGE_BYTES) + c * 64 * 128;
      const uint32_t b = sm90::smem_u32(ring + s * T::STAGE_BYTES + T::A_BYTES);
      // no other instruction may touch acc until the last wait: one that
      // did while a group is in flight would serialise the wgmmas
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_k16<BN>(acc, sm90::desc_sw128(a + 32 * kk, 16, 1024),
                    sm90::desc_sw128(b + 2048 * kk, BK * 128, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();            // the previous stage's products are done
      if (i > 0 && threadIdx.x % 128 == 0)
        sm90::mbar_arrive(&empty[(i - 1) % T::STAGES]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);

    // epilogue: stage the bf16 tile in the ring (both consumers are done
    // reading it), then 16-byte stores, a warp per 16 * BN / 8 bytes
    sm90::named_bar_sync(1, 128 * CONSUMERS);
    bf16* sC = reinterpret_cast<bf16*>(ring);
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r = c * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
    for (int g = 0; g < BN / 8; ++g) {
      const int col = 8 * g + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(&sC[r * T::LDC + col]) =
          __floats2bfloat162_rn(acc[4 * g], acc[4 * g + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&sC[(r + 8) * T::LDC + col]) =
          __floats2bfloat162_rn(acc[4 * g + 2], acc[4 * g + 3]);
    }
    sm90::named_bar_sync(2 + c, 128);
    constexpr int CHUNKS = BN / 8;      // 16-byte chunks of a row
#pragma unroll 4
    for (int v = t; v < 64 * CHUNKS; v += 128) {
      const int row = c * 64 + v / CHUNKS, ch = v % CHUNKS;
      *reinterpret_cast<uint4*>(&C[(size_t)(m0 + row) * N + n0 + ch * 8]) =
          *reinterpret_cast<const uint4*>(&sC[row * T::LDC + ch * 8]);
    }
  }
}

template <int BN>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t s) {
  using T = Tile<BN>;
  CUtensorMap ta, tb;
  if (!sm90::tma_map_bf16_sw128(&ta, a, M, K, K, BM, BK) ||
      !sm90::tma_map_bf16_sw128(&tb, b, K, N, N, BK, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mm_bf16<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem);
  if (err != cudaSuccess) return err;
  mm_bf16<BN><<<(M / BM) * (N / BN), THREADS, T::smem, s>>>(
      ta, tb, static_cast<bf16*>(c), M, N, K);
  return cudaGetLastError();
}

}  // namespace wg

// ---- f32: FMA units -------------------------------------------------------------

namespace ffma {

constexpr int THREADS = 256;                  // a 16 x 16 grid of threads
constexpr int SMEM_PAIR = 115712;             // the most each of two blocks on an SM may have

template <int BM, int BN, int BK>
struct Tile {
  static constexpr int LDA = BK + 4;          // A row-major, rows padded by 16 bytes
  static constexpr int A_FLOATS = BM * LDA, B_FLOATS = BK * BN;
  static constexpr int STAGE_BYTES = (A_FLOATS + B_FLOATS) * 4;
  // the deepest ring that still lets two blocks share an SM, never below 2
  static constexpr int STAGES = SMEM_PAIR / STAGE_BYTES < 2 ? 2 : SMEM_PAIR / STAGE_BYTES;
  static constexpr size_t smem = (size_t)STAGES * STAGE_BYTES;
  static constexpr int TM = BM / 16, TN = BN / 16;   // outputs a thread
  // two blocks an SM where the ring allows and 128 registers a thread hold
  // the accumulators (32 or fewer outputs a thread; the 8 x 8 of the
  // 128 x 128 tile would spill at that cap and takes one block an SM)
  static constexpr int MIN_BLOCKS = smem <= SMEM_PAIR && TM * TN <= 32 ? 2 : 1;
  static constexpr int A_CHUNKS = BM * BK / 4 / THREADS, B_CHUNKS = BK * BN / 4 / THREADS;
  static_assert(smem <= 227 * 1024, "ring exceeds 227 KB");
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1 && TN % 4 == 0, "tile too small");
};

// Copies k-tile kt of A (BM x BK) and B (BK x BN) into one stage, 16 bytes
// a cp.async, consecutive threads on consecutive chunks of a row.
template <int BM, int BN, int BK>
__device__ __forceinline__ void load_stage(float* st, const float* A, const float* B,
                                           int row0, int col0, int kt, int N, int K) {
  using T = Tile<BM, BN, BK>;
  float* As = st;
  float* Bs = st + T::A_FLOATS;
#pragma unroll
  for (int c = 0; c < T::A_CHUNKS; ++c) {
    const int v = threadIdx.x + c * THREADS;
    const int r = v / (BK / 4), ch = v % (BK / 4);
    sm90::cp_async16(As + r * T::LDA + 4 * ch,
                     A + (size_t)(row0 + r) * K + (size_t)kt * BK + 4 * ch);
  }
#pragma unroll
  for (int c = 0; c < T::B_CHUNKS; ++c) {
    const int v = threadIdx.x + c * THREADS;
    const int r = v / (BN / 4), ch = v % (BN / 4);
    sm90::cp_async16(Bs + r * BN + 4 * ch,
                     B + (size_t)(kt * BK + r) * N + col0 + 4 * ch);
  }
}

// Thread (ty, tx) owns rows ty + 16 i (i < TM) and the float4 columns
// 64 g + 4 tx .. + 3 (g < TN / 4) of the block's tile.  A warp is a 4 x 8
// patch of the grid (warps 4 deep, 2 wide), so a warp's LDS.128 of A
// reads 4 rows (padded apart onto distinct banks) and one of B 8
// consecutive float4: each is one shared-memory wavefront.  Per 4 k steps
// a thread reads TM float4 of A (4 k values of each of its rows) and
// 4 * TN / 4 float4 of B for 4 TM TN FFMAs: 16 LDS.128 for 256 FFMAs at
// the 128 x 128 tile, against 64 LDS.32 in a column-by-column kernel.
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS, (Tile<BM, BN, BK>::MIN_BLOCKS))
mm_f32(const float* __restrict__ A, const float* __restrict__ B,
       float* __restrict__ C, int M, int N, int K) {
  using T = Tile<BM, BN, BK>;
  constexpr int TM = T::TM, TG = T::TN / 4;
  extern __shared__ __align__(128) float smem_f[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int KT = K / BK;

  float4 acc[TM][TG];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < TG; ++g) acc[i][g] = make_float4(0.f, 0.f, 0.f, 0.f);

  // fill all but one stage of the ring; every step commits one group (empty
  // past the last k-tile), so "STAGES - 2 groups in flight" always means
  // "k-tile kt has landed"
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < KT) load_stage<BM, BN, BK>(smem_f + s * (T::A_FLOATS + T::B_FLOATS), A, B,
                                       row0, col0, s, N, K);
    sm90::cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    sm90::cp_async_wait<T::STAGES - 2>();
    // one barrier a k-tile: every thread's copies of tile kt are visible,
    // and every thread is done with tile kt - 1, whose stage is refilled now
    __syncthreads();
    const int next = kt + T::STAGES - 1;
    if (next < KT)
      load_stage<BM, BN, BK>(smem_f + (next % T::STAGES) * (T::A_FLOATS + T::B_FLOATS), A, B,
                             row0, col0, next, N, K);
    sm90::cp_async_commit();

    const float* As = smem_f + (kt % T::STAGES) * (T::A_FLOATS + T::B_FLOATS);
    const float* Bs = As + T::A_FLOATS;
    // fragments double-buffered in registers: k step k + 1's B (and, every
    // fourth step, the next four steps' A) are read while step k's FFMAs run
    float4 a[2][TM], b[2][TG];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[0][i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * T::LDA);
#pragma unroll
    for (int g = 0; g < TG; ++g)
      b[0][g] = *reinterpret_cast<const float4*>(Bs + 64 * g + 4 * tx);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const int k4 = k / 4, kk = k % 4;
      if (k + 1 < BK) {
#pragma unroll
        for (int g = 0; g < TG; ++g)
          b[(k + 1) & 1][g] =
              *reinterpret_cast<const float4*>(Bs + (k + 1) * BN + 64 * g + 4 * tx);
      }
      if (kk == 0 && k + 4 < BK) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[(k4 + 1) & 1][i] =
              *reinterpret_cast<const float4*>(As + (ty + 16 * i) * T::LDA + k + 4);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4& ai = a[k4 & 1][i];
        const float av = kk == 0 ? ai.x : kk == 1 ? ai.y : kk == 2 ? ai.z : ai.w;
#pragma unroll
        for (int g = 0; g < TG; ++g) {
          const float4& bg = b[k & 1][g];
          acc[i][g].x = fmaf(av, bg.x, acc[i][g].x);
          acc[i][g].y = fmaf(av, bg.y, acc[i][g].y);
          acc[i][g].z = fmaf(av, bg.z, acc[i][g].z);
          acc[i][g].w = fmaf(av, bg.w, acc[i][g].w);
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

  // epilogue: float4 stores, a warp's 8 threads of a row on 128 contiguous
  // bytes
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < TG; ++g)
      *reinterpret_cast<float4*>(C + (size_t)(row0 + ty + 16 * i) * N + col0 + 64 * g +
                                 4 * tx) = acc[i][g];
}

template <int BM, int BN, int BK>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t s) {
  using T = Tile<BM, BN, BK>;
  const dim3 grid(N / BN, M / BM);
  cudaError_t err = cudaFuncSetAttribute(
      mm_f32<BM, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem);
  if (err != cudaSuccess) return err;
  mm_f32<BM, BN, BK><<<grid, THREADS, T::smem, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K);
  return cudaGetLastError();
}

}  // namespace ffma

}  // namespace

// a: (M, K), b: (K, N), c: (M, N), row-major and contiguous, 16-byte
// aligned; M, N, K divisible by bm, bn, bk.  bf16 tiles: (128, 128, 64),
// (128, 256, 64); f32 tiles: {64, 128} x {64, 128} x {32, 64}.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tile shape that was
// not compiled or operands TMA cannot describe.
extern "C" int mm_matmul(const void* a, const void* b, void* c, int M, int N,
                         int K, int dtype, int bm, int bn, int bk,
                         void* stream) {
  if (M < 1 || N < 1 || K < 1 || bm < 1 || bn < 1 || bk < 1 || M % bm ||
      N % bn || K % bk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) {
    if (bm != wg::BM || bk != wg::BK) return (int)cudaErrorInvalidValue;
    if (bn == 128) return (int)wg::launch<128>(a, b, c, M, N, K, s);
    if (bn == 256) return (int)wg::launch<256>(a, b, c, M, N, K, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != DT_F32) return (int)cudaErrorInvalidValue;
#define MM_CASE(BM, BN, BK) \
  if (bm == BM && bn == BN && bk == BK) return (int)ffma::launch<BM, BN, BK>(a, b, c, M, N, K, s);
  MM_CASE(64, 64, 32)
  MM_CASE(64, 64, 64)
  MM_CASE(64, 128, 32)
  MM_CASE(64, 128, 64)
  MM_CASE(128, 64, 32)
  MM_CASE(128, 64, 64)
  MM_CASE(128, 128, 32)
  MM_CASE(128, 128, 64)
#undef MM_CASE
  return (int)cudaErrorInvalidValue;
}
