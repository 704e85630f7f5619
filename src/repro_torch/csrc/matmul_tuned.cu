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
// f32: a 16 x 16 thread grid, each thread computing a (bm/16) x (bn/16)
// block of outputs with fmaf — the f32 FMA path, not TF32, so the f32
// tolerance of the reference holds.  A is staged transposed (padded by one
// column) so each k step reads one broadcast column of A and one row of B.
// Each (bm, bn, bk) in {64, 128} x {64, 128} x {32, 64} is a template
// instantiation; shared memory is dynamic (up to 65 KB for 128x128x64,
// above the 48 KB default, granted with cudaFuncSetAttribute).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;    // the f32 kernel
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

template <int BM, int BN, int BK>
struct F32Tile {
  static constexpr int LDA = BM + 1, LDB = BN;
  static constexpr size_t smem = (size_t)(BK * LDA + BK * LDB) * sizeof(float);
};

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
mm_f32(const float* __restrict__ A, const float* __restrict__ B,
       float* __restrict__ C, int M, int N, int K) {
  using T = F32Tile<BM, BN, BK>;
  constexpr int TM = BM / 16, TN = BN / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);   // [BK][LDA], A transposed
  float* Bs = As + BK * T::LDA;                 // [BK][LDB]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int v = threadIdx.x; v < BM * BK; v += THREADS) {
      const int r = v / BK, c = v % BK;
      As[c * T::LDA + r] = A[(size_t)(row0 + r) * K + k0 + c];
    }
    for (int v = threadIdx.x; v < BK * BN; v += THREADS) {
      const int r = v / BN, c = v % BN;
      Bs[r * T::LDB + c] = B[(size_t)(k0 + r) * N + col0 + c];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * T::LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * T::LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      C[(size_t)(row0 + ty + 16 * i) * N + col0 + tx + 16 * j] = acc[i][j];
}

template <int BM, int BN, int BK>
cudaError_t launch_f32(const void* a, const void* b, void* c, int M, int N, int K,
                       cudaStream_t s) {
  const dim3 grid(N / BN, M / BM);
  const size_t smem = F32Tile<BM, BN, BK>::smem;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mm_f32<BM, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  mm_f32<BM, BN, BK><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K);
  return cudaGetLastError();
}

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
  if (bm == BM && bn == BN && bk == BK) return (int)launch_f32<BM, BN, BK>(a, b, c, M, N, K, s);
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
