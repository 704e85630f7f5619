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
// D = 128, causal) the visited half of the score matrix costs
// 4 * 20 * (4096^2 / 2) * 128 ~ 86 GFLOP (Q.K^T and P.V), against 84 MB of
// q, k, v and o: about 1000 flops per byte, far above the ~295 at which
// the bf16 tensor cores rather than the memory become the limit.  So the
// design keeps the two products on the tensor cores, never writes the
// (S, S) scores to device memory, and skips the k-blocks the mask hides
// (half of them under the causal mask).
//
// Design.  The TPU grid (BH, S/block_q, S/block_k) runs its k axis in
// order on one core, carrying m, l and the accumulator in VMEM scratch.
// Here one block owns (bh, one q-block) and loops over the k-blocks itself,
// keeping m, l and the output accumulator in registers in f32; blocks run
// in parallel, the latest (most loaded, under the causal mask) q-blocks
// first.  Each k-block is staged in shared memory (K row-major, V
// transposed so both products read their B operand as 32-bit words); the
// loads are not pipelined (no cp.async / TMA) and there is no wgmma yet.
//   * bf16: one warp per 16 query rows (block_q / 16 warps).  Each warp
//     keeps its Q rows as mma A-fragments in registers, computes its
//     16 x block_k scores with mma.sync m16n8k16 (bf16 in, f32 accumulate),
//     applies scale and mask, updates the online softmax with quad shuffles,
//     and reuses the score accumulators as the A operand of P.V.  P IS
//     ROUNDED TO BF16 for P.V (the row sums l stay in f32); the output
//     tolerance of the bf16 tests (2e-2 + 2e-2 |want|) covers it.
//   * f32: on the FMA units (no TF32), four threads per query row, each
//     holding a quarter of D (interleaved, so K/V reads are conflict-free
//     broadcasts); scores are reduced with two shuffles and the online
//     softmax steps over 8 keys at a time.
// The mask value is finite (-0.7 * FLT_MAX, as the TPU kernel's MASK_VALUE):
// with -inf the first fully masked block would give exp(-inf - -inf) = NaN.
// Each (block_q, block_k, D) in {64, 128} x {32, 64, 128} x {64, 128} is a
// template instantiation with dynamic shared memory (up to 68 KB for bf16,
// 128 KB for f32, above the 48 KB default, granted with
// cudaFuncSetAttribute).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float MASK_VALUE = -0.7f * FLT_MAX;
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
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), one warp per 16 query rows
// ---------------------------------------------------------------------------

template <int BQ, int BK, int D>
struct Bf16Tile {
  static constexpr int THREADS = BQ / 16 * 32;
  static constexpr int LDK = D + 8;    // K tile [BK][LDK]: rows on distinct banks
  static constexpr int LDV = BK + 8;   // V^T tile [D][LDV]
  static constexpr size_t smem = (size_t)(BK * LDK + D * LDV) * sizeof(bf16);
};

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(Bf16Tile<BQ, BK, D>::THREADS)
fa_bf16(const bf16* __restrict__ Q, const bf16* __restrict__ K,
        const bf16* __restrict__ V, bf16* __restrict__ O, int S, float scale,
        Mask mask) {
  using T = Bf16Tile<BQ, BK, D>;
  constexpr int NT = BK / 8;     // n8 score tiles per warp
  constexpr int KD = D / 16;     // k16 steps of Q.K^T
  constexpr int ND = D / 8;      // n8 output tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + BK * T::LDK;

  const int qb = S / BQ - 1 - (int)blockIdx.x;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = qb * BQ, q_hi = q_lo + BQ - 1;
  const int row0 = q_lo + warp * 16 + g;     // this lane's rows: row0, row0 + 8

  // Q as A-fragments, read once from device memory
  uint32_t qf[KD][4];
  {
    const bf16* q0 = Q + base + (size_t)row0 * D;
    const bf16* q8 = q0 + 8 * D;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = kd * 16 + t * 2;
      qf[kd][0] = ld32(q0 + c);
      qf[kd][1] = ld32(q8 + c);
      qf[kd][2] = ld32(q0 + c + 8);
      qf[kd][3] = ld32(q8 + c + 8);
    }
  }

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {MASK_VALUE, MASK_VALUE};
  float l[2] = {0.f, 0.f};

  for (int kb = 0; kb < S / BK; ++kb) {
    const int k_lo = kb * BK;
    if (!mask.block_relevant(q_lo, q_hi, k_lo, k_lo + BK - 1)) continue;
    __syncthreads();                       // the previous tile is consumed
    const bf16* kg = K + base + (size_t)k_lo * D;
    const bf16* vg = V + base + (size_t)k_lo * D;
    for (int i = threadIdx.x; i < BK * D / 8; i += T::THREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(&Ks[r * T::LDK + c]) =
          *reinterpret_cast<const uint4*>(&kg[(size_t)r * D + c]);
    }
    // V transposed: lanes take consecutive keys of one 8-column strip, so
    // the 16-bit stores into V^T hit distinct banks
    for (int i = threadIdx.x; i < BK * D / 8; i += T::THREADS) {
      const int r = i % BK, c = (i / BK) * 8;
      const uint4 vv = *reinterpret_cast<const uint4*>(&vg[(size_t)r * D + c]);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * T::LDV + r] = ve[e];
    }
    __syncthreads();

    // scores for this warp's 16 rows: s[n] is keys k_lo + 8n .. + 7
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* kr = Ks + (n * 8 + g) * T::LDK + t * 2;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint32_t b[2] = {ld32(kr + kd * 16), ld32(kr + kd * 16 + 8)};
        mma_bf16(s[n], qf[kd], b);
      }
    }

    // scale and mask; element e of a tile is row row0 + 8*(e>>1), key
    // k_lo + 8n + 2t + (e&1)
    float mx[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row0 + (e >> 1) * 8, ki = k_lo + n * 8 + t * 2 + (e & 1);
        const float x = mask.visible(qi, ki) ? s[n][e] * scale : MASK_VALUE;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row0 + (e >> 1) * 8, ki = k_lo + n * 8 + t * 2 + (e & 1);
        const float p = mask.visible(qi, ki) ? expf(s[n][e] - m[e >> 1]) : 0.f;
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(rs[h]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    // O += P V, the score accumulators re-packed as bf16 A-fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const bf16* vr = Vt + (nd * 8 + g) * T::LDV + kk * 16 + t * 2;
        const uint32_t b[2] = {ld32(vr), ld32(vr + 8)};
        mma_bf16(o[nd], a, b);
      }
    }
  }

  // rows with no visible key have l == 0 and o == 0: they stay exact zeros
  const float inv0 = 1.f / (l[0] == 0.f ? 1.f : l[0]);
  const float inv1 = 1.f / (l[1] == 0.f ? 1.f : l[1]);
  bf16* o0 = O + base + (size_t)row0 * D + t * 2;
  bf16* o8 = o0 + 8 * D;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    *reinterpret_cast<uint32_t*>(o0 + nd * 8) =
        pack_bf16(o[nd][0] * inv0, o[nd][1] * inv0);
    *reinterpret_cast<uint32_t*>(o8 + nd * 8) =
        pack_bf16(o[nd][2] * inv1, o[nd][3] * inv1);
  }
}

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
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int BH, int S, float scale, Mask mask,
                   cudaStream_t s) {
  const dim3 grid(S / BQ, BH);
  if (dtype == DT_BF16) {
    using T = Bf16Tile<BQ, BK, D>;
    cudaError_t err = grant_smem(fa_bf16<BQ, BK, D>, T::smem);
    if (err != cudaSuccess) return err;
    fa_bf16<BQ, BK, D><<<grid, T::THREADS, T::smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), S, scale, mask);
  } else if (dtype == DT_F32) {
    using T = F32Tile<BQ, BK, D>;
    cudaError_t err = grant_smem(fa_f32<BQ, BK, D>, T::smem);
    if (err != cudaSuccess) return err;
    fa_f32<BQ, BK, D><<<grid, T::THREADS, T::smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, scale, mask);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: (BH, S, D) contiguous, 16-byte aligned, all of one dtype
// (1 = f32, 2 = bf16); S divisible by bq and bk; window used only when
// has_window (0 <= window <= S).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or tile that was not compiled.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int BH, int S, int D, int dtype, int causal,
                          int has_window, int window, float scale, int bq,
                          int bk, void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || bq < 1 || bk < 1 || S % bq || S % bk ||
      (has_window && (window < 0 || window > S)))
    return (int)cudaErrorInvalidValue;
  const Mask mask{causal ? 1 : 0, has_window ? 1 : 0, has_window ? window : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_CASE(BQ, BK, DD)                                                    \
  if (bq == BQ && bk == BK && D == DD)                                         \
    return (int)launch<BQ, BK, DD>(dtype, q, k, v, o, BH, S, scale, mask, s);
#define FA_CASES(DD)                                                           \
  FA_CASE(64, 32, DD) FA_CASE(64, 64, DD) FA_CASE(64, 128, DD)                 \
  FA_CASE(128, 32, DD) FA_CASE(128, 64, DD) FA_CASE(128, 128, DD)
  FA_CASES(64)
  FA_CASES(128)
#undef FA_CASES
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
