// matmul_tuned.cu — a tiled GEMM, C (M, N) = A (M, K) x B (K, N), both
// row-major, with the (bm, bn, bk) tile the tuner searches.
//
// Replaces: src/repro/kernels/matmul_tuned/kernel.py, _matmul_kernel /
// matmul (the Pallas TPU kernel behind ops.matmul_tuned, the paper's
// section 8 case study).
//
// Bound on an H100: operations.  At 8192^3 the product does 2*8192^3 =
// 1.1e12 flops on 0.4 GB of operands — thousands of flops per byte, well
// above the bf16 tensor cores' ~295 flops per byte of device memory —
// so the floor is flops over 989 TFLOP/s (bf16) or 67 TFLOP/s (f32 on
// the FMA units, no TF32).
//
// Design.  Each block of 256 threads owns one (bm, bn) output tile and
// keeps its f32 accumulators in registers.  A loop over K stages a
// (bm, bk) tile of A and a (bk, bn) tile of B through shared memory; it
// takes the place of the TPU kernel's sequential K grid axis, since blocks
// on Hopper run in parallel and in no order.  The output is cast to the
// inputs' dtype on store.
//   * bf16: the 8 warps form a 2 x 4 grid over the tile, and each warp
//     runs WMMA 16x16x16 bf16 x bf16 -> f32 products on the tensor cores.
//     Tiles are loaded with 16-byte vectors; rows are padded by 8 elements
//     so consecutive rows start on different banks.
//   * f32: a 16 x 16 thread grid, each thread computing a (bm/16) x (bn/16)
//     block of outputs with fmaf — the f32 FMA path, not TF32, so the f32
//     tolerance of the reference holds.  A is staged transposed (padded by
//     one column) so each k step reads one broadcast column of A and one
//     row of B.
// Each (bm, bn, bk) in {64, 128} x {64, 128} x {32, 64} is a template
// instantiation; shared memory is dynamic (up to 65 KB for f32 128x128x64,
// above the 48 KB default, granted with cudaFuncSetAttribute).  This first
// kernel neither pipelines its loads (cp.async / TMA) nor uses wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int DT_F32 = 1, DT_BF16 = 2;

template <int BM, int BN, int BK>
struct Bf16Tile {
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static constexpr size_t smem =
      (size_t)(BM * LDA + BK * LDB) * sizeof(bf16) + THREADS / 32 * 256 * sizeof(float);
};

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
mm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
        bf16* __restrict__ C, int M, int N, int K) {
  using T = Bf16Tile<BM, BN, BK>;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                 // [BM][LDA]
  bf16* Bs = As + BM * T::LDA;                              // [BK][LDB]
  float* stage = reinterpret_cast<float*>(Bs + BK * T::LDB);  // [warp][16*16]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int v = threadIdx.x; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[r * T::LDA + c]) =
          *reinterpret_cast<const uint4*>(&A[(size_t)(row0 + r) * K + k0 + c]);
    }
    for (int v = threadIdx.x; v < BK * BN / 8; v += THREADS) {
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * T::LDB + c]) =
          *reinterpret_cast<const uint4*>(&B[(size_t)(k0 + r) * N + col0 + c]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfg[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * WM + i * 16) * T::LDA + kk, T::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfg[j], Bs + kk * T::LDB + wn * WN + j * 16, T::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfg[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 f32 fragment at a time, casts to
  // bf16 and writes it out
  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = row0 + wm * WM + i * 16, c0 = col0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32)
        C[(size_t)(r0 + e / 16) * N + c0 + e % 16] = __float2bfloat16(st[e]);
      __syncwarp();
    }
}

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
cudaError_t launch(int dtype, const void* a, const void* b, void* c, int M,
                   int N, int K, cudaStream_t s) {
  const dim3 grid(N / BN, M / BM);
  if (dtype == DT_BF16) {
    const size_t smem = Bf16Tile<BM, BN, BK>::smem;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          mm_bf16<BM, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    mm_bf16<BM, BN, BK><<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<bf16*>(c), M, N, K);
  } else if (dtype == DT_F32) {
    const size_t smem = F32Tile<BM, BN, BK>::smem;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          mm_f32<BM, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    mm_f32<BM, BN, BK><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), M, N, K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// a: (M, K), b: (K, N), c: (M, N), row-major, 16-byte aligned; M, N, K
// divisible by bm, bn, bk.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tile shape that was not compiled.
extern "C" int mm_matmul(const void* a, const void* b, void* c, int M, int N,
                         int K, int dtype, int bm, int bn, int bk,
                         void* stream) {
  if (M < 1 || N < 1 || K < 1 || bm < 1 || bn < 1 || bk < 1 || M % bm ||
      N % bn || K % bk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MM_CASE(BM, BN, BK) \
  if (bm == BM && bn == BN && bk == BK) return (int)launch<BM, BN, BK>(dtype, a, b, c, M, N, K, s);
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
