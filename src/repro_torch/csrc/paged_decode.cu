// paged_decode.cu — one-token (T = 1) attention of every serving slot
// against a shared pool of K/V pages, read in place through the slot's
// page table: grouped-query attention with an online softmax, causal up
// to the slot's length, an optional sliding window, unallocated pages
// (-1) skipped, rows with no valid key -> exact zeros, output in the
// pool's dtype, scale passed in (the wrapper gives hd**-0.5).
//
// Replaces no TPU kernel: the JAX package computes paged decode in plain
// jnp (src/repro/models/attention.py, decode_attention_paged), and the
// port's plain version (kernels/paged_decode/ref.py) gathers every slot's
// whole page table into a contiguous copy, upcasts it to f32 and runs the
// scores and values as GEMVs: at qwen1.5-4b chat serving (64 slots of 64
// pages of 16, 20 heads of 128) that moves ~670 MB of K/V a layer and a
// step, where the slots' live keys are a few tens of MB.  Added so that
// decode reads only the live keys.
//
// Bound on an H100: device-memory bytes.  A key is read once for all g =
// H / Hkv query heads that share it, with 4 * g * hd flops per key for
// 4 * hd bytes (bf16 K and V): g flops a byte, far below the ~295 at
// which the tensor cores, or the ~20 at which the f32 FMA units, become
// the limit.  So the design moves no byte it does not need, and keeps
// enough loads in flight to stream at the memory's rate:
//   * one block of 4 warps per (slot, kv head, split): the block loads the
//     g query rows once (16-byte loads, scale * log2(e) folded in) and
//     reads each K and V row once for all g of them (GQA without a head
//     repeat);
//   * it reads only the pages that overlap [window start, cur_len[b]]:
//     the range comes from cur_len and page_table on the device, so there
//     is no host sync; an entry of -1 (or outside the pool) is never
//     read; the split's page-table entries are staged in shared memory
//     first;
//   * a key's row of hd values is LPK = hd * sizeof(T) / 16 lanes of one
//     16-byte load each, so a warp reads 32 / LPK consecutive keys, 512
//     contiguous bytes of a page's ps x hd run, in one coalesced load;
//     each lane keeps U keys' K and V loads in flight (U = 4, 2 at G >=
//     4) and issues the next step's before it computes on this one
//     (double-buffered in registers: every loaded value is used by the
//     one lane that loaded it, so staging through shared memory would
//     buy nothing);
//   * the softmax is online and in f32 registers, in base 2: per key, a
//     dot product of VEC values a lane and an xor-shuffle over its LPK
//     lanes; per lane group and query row a running max, sum and output
//     slice; the groups of a warp merge by shuffles, the warps through
//     shared memory;
//   * splitting over pages fills the card when B * Hkv is small (one slot
//     of qwen3-32b has 8 kv heads for 132 SMs): the host picks the number
//     of splits from B, Hkv and M alone (kernels/paged_decode/ops.py), the
//     device deals each row's live pages out evenly among them, and a
//     second small launch merges the splits' (output, log-sum-exp) pairs.
//     With one split the first launch writes the output itself.
// The arithmetic is f32 throughout, as in the plain version; only the
// order of the sums differs (and exp2 of a log2(e)-scaled score stands in
// for exp).  Instantiated for hd in {16, 64, 128}, f32 / bf16 / fp16 K, V,
// q and output of one dtype, and G = g rounded up to 1, 2, 4 or 8 query
// rows (rows past g compute on a copy of row g - 1 and store nothing).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
// the page-table entries of one split, staged in shared memory beside the
// warps' merge buffers (at most 4 * 8 * 130 floats): under 48 KB in all
constexpr int MAX_PAGES = 4096;

enum DType { DT_F32 = 1, DT_BF16 = 2, DT_F16 = 3 };

// ---- 16-byte vectors of T as floats ---------------------------------------

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void to_float(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  __device__ static float store(float x) { return x; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void pair(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);            // the low half comes first
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static void to_float(const uint4& r, float* f) {
    pair(r.x, f); pair(r.y, f + 2); pair(r.z, f + 4); pair(r.w, f + 6);
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

template <> struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void pair(uint32_t w, float* f) {
    __half2 h = *reinterpret_cast<__half2*>(&w);
    float2 x = __half22float2(h);
    f[0] = x.x; f[1] = x.y;
  }
  __device__ static void to_float(const uint4& r, float* f) {
    pair(r.x, f); pair(r.y, f + 2); pair(r.z, f + 4); pair(r.w, f + 6);
  }
  __device__ static __half store(float x) { return __float2half(x); }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// exp2 of a difference of base-2 logits; a max of -inf (no key yet) gives
// weight 0, never the NaN of -inf - -inf
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

struct Args {
  const void* q;              // (B, H, hd)
  const void* k;              // (P, Hkv, ps, hd)
  const void* v;
  void* o;                    // (B, H, hd), written when splits == 1
  const int* page_table;      // (B, M) rows pt_stride apart
  const long long* cur_len;   // (B,) len_stride apart
  float* part_o;              // (B, H, splits, hd), splits > 1
  float* part_lse;            // (B, H, splits)
  int pt_stride, len_stride;
  int B, H, Hkv, g, ps, M, P, splits;
  int has_window, window;
  float scale;
};

// The live key range of row b: [lo, hi], empty when hi < lo (M * ps fits
// an int: the entry point checks).
__device__ __forceinline__ void key_range(const Args& a, int b, int& lo,
                                          int& hi) {
  const long long L = a.cur_len[(long long)b * a.len_stride];
  const long long n = (long long)a.M * a.ps;
  hi = (int)min(L, n - 1);
  lo = a.has_window ? (int)min(max(0LL, L - a.window + 1), n) : 0;
  if (L < 0) hi = -1;
}

// a block's registers: up to 128 a thread at G <= 2 (four blocks an SM),
// 255 at G >= 4 (two), where the G query rows' slices and sums take most
// of them; stated, since ptxas otherwise may cap them lower and spill
template <typename T, int D, int G, int U>
__global__ void __launch_bounds__(THREADS, G >= 4 ? 2 : 4)
pd_kernel(const Args a) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = D / VEC;              // lanes a key
  constexpr int KPW = 32 / LPK;             // keys a warp and load
  constexpr int SLICE = WARPS * KPW;        // keys a block and load
  constexpr int STEP = U * SLICE;           // keys a block and step
  static_assert(LPK >= 1 && LPK <= 32 && (32 % LPK) == 0, "head dim");

  __shared__ float red_m[WARPS][G], red_l[WARPS][G];
  __shared__ float red_acc[WARPS][G][D];
  extern __shared__ int pages[];            // this split's page entries

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPK, lk = lane % LPK;
  const int split = blockIdx.x % a.splits;
  const int kvh = (blockIdx.x / a.splits) % a.Hkv;
  const int b = blockIdx.x / (a.splits * a.Hkv);

  // this split's pages and keys
  int lo, hi;
  key_range(a, b, lo, hi);
  int kbeg = 0, kend = -1;                  // keys [kbeg, kend]
  int page0 = 0, npages = 0;
  if (hi >= lo) {
    const int p_lo = lo / a.ps, p_hi = hi / a.ps;
    const int per = (p_hi - p_lo + a.splits) / a.splits;
    const int first = p_lo + split * per;
    const int last = min(p_hi, first + per - 1);
    if (first <= last) {
      page0 = first;
      npages = last - first + 1;
      kbeg = max(lo, first * a.ps);
      kend = min(hi, (last + 1) * a.ps - 1);
    }
  }
  const int* pt = a.page_table + (long long)b * a.pt_stride;
  for (int i = tid; i < npages; i += THREADS) {
    const int e = pt[page0 + i];
    pages[i] = (e >= 0 && e < a.P) ? e : -1;
  }

  // the G query rows' slices of this lane, in base-2 logit units
  float qf[G][VEC];
  {
    const T* qb = static_cast<const T*>(a.q) +
                  ((long long)b * a.H + (long long)kvh * a.g) * D + lk * VEC;
    const float qs = a.scale * LOG2E;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const int rr = r < a.g ? r : a.g - 1;
      Vec<T>::to_float(load16(qb + (long long)rr * D), qf[r]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[r][e] *= qs;
    }
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();                          // pages[] staged

  const T* kbase = static_cast<const T*>(a.k);
  const T* vbase = static_cast<const T*>(a.v);
  const int nkeys = kend - kbeg + 1;
  const int steps = nkeys > 0 ? (nkeys + STEP - 1) / STEP : 0;

  // this lane's U keys of step s, their validity and their loads
  auto fetch = [&](int s, uint4 (&kr)[U], uint4 (&vr)[U], bool (&ok)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = kbeg + s * STEP + u * SLICE + warp * KPW + sub;
      int phys = -1;
      if (j <= kend) phys = pages[j / a.ps - page0];
      ok[u] = phys >= 0;
      if (ok[u]) {
        const long long row =
            ((long long)phys * a.Hkv + kvh) * a.ps + (j % a.ps);
        kr[u] = load16(kbase + row * D + lk * VEC);
        vr[u] = load16(vbase + row * D + lk * VEC);
      } else {
        kr[u] = make_uint4(0, 0, 0, 0);
        vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
  };

  uint4 kn[U], vn[U];
  bool okn[U];
  if (steps > 0) fetch(0, kn, vn, okn);
  for (int s = 0; s < steps; ++s) {
    uint4 kc[U], vc[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) { kc[u] = kn[u]; vc[u] = vn[u]; ok[u] = okn[u]; }
    if (s + 1 < steps) fetch(s + 1, kn, vn, okn);

    // scores: a lane's partial dot products, summed over the key's lanes
    float sc[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      Vec<T>::to_float(kc[u], kf);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) x = fmaf(qf[r][e], kf[e], x);
#pragma unroll
        for (int off = LPK / 2; off > 0; off /= 2)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        sc[u][r] = x;
      }
    }
    // online softmax: rescale, then the keys' weights (in place of sc)
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[u][r]);
      const float corr = mx == -INFINITY ? 1.f : weight(m[r], mx);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
      m[r] = mx;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u][r] = ok[u] ? exp2f(sc[u][r] - mx) : 0.f;
        l[r] += sc[u][r];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      Vec<T>::to_float(vc[u], vf);
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(sc[u][r], vf[e], acc[r][e]);
    }
  }

  // merge the lane groups of the warp (lanes lk, lk + LPK, ... hold one
  // slice of the output each)
#pragma unroll
  for (int off = LPK; off < 32; off *= 2) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float wa = weight(m[r], mx), wb = weight(mo, mx);
      l[r] = l[r] * wa + lo_ * wb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * wa + ao * wb;
      }
      m[r] = mx;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red_acc[warp][r][lk * VEC + e] = acc[r][e];
      if (lk == 0) { red_m[warp][r] = m[r]; red_l[warp][r] = l[r]; }
    }
  }
  __syncthreads();

  // merge the warps: thread i owns output element (row i / D, dim i % D)
  for (int i = tid; i < G * D; i += THREADS) {
    const int r = i / D, d = i % D;
    if (r >= a.g) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red_m[w][r]);
    float sum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = weight(red_m[w][r], mx);
      sum += red_l[w][r] * wt;
      out += red_acc[w][r][d] * wt;
    }
    out = sum > 0.f ? out / sum : 0.f;
    const long long h = (long long)b * a.H + (long long)kvh * a.g + r;
    if (a.splits == 1) {
      static_cast<T*>(a.o)[h * D + d] = Vec<T>::store(out);
    } else {
      a.part_o[(h * a.splits + split) * D + d] = out;
      if (d == 0)
        a.part_lse[h * a.splits + split] =
            sum > 0.f ? mx + log2f(sum) : -INFINITY;
    }
  }
}

// one block of hd threads per (slot, head): the splits' outputs weighted
// by 2^lse, in split order
template <typename T>
__global__ void pd_merge(const float* part_o, const float* part_lse, void* o,
                         int splits, int D) {
  const long long h = blockIdx.x;
  const int d = threadIdx.x;
  const float* lse = part_lse + h * splits;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, lse[s]);
  float sum = 0.f, out = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float wt = weight(lse[s], mx);
    sum += wt;
    out += wt * part_o[(h * splits + s) * D + d];
  }
  static_cast<T*>(o)[h * D + d] = Vec<T>::store(sum > 0.f ? out / sum : 0.f);
}

template <typename T, int D, int G>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int U = G >= 4 ? 2 : 4;         // keys in flight a lane
  const int per = (a.M + a.splits - 1) / a.splits;   // most pages a split
  const long long blocks = (long long)a.B * a.Hkv * a.splits;
  pd_kernel<T, D, G, U><<<(unsigned)blocks, THREADS, per * sizeof(int), s>>>(a);
  if (a.splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    pd_merge<T><<<(unsigned)((long long)a.B * a.H), D, 0, s>>>(
        a.part_o, a.part_lse, a.o, a.splits, D);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_shape(const Args& a, int D, int G, cudaStream_t s) {
#define PD_CASE(DD, GG) \
  if (D == DD && G == GG) return launch<T, DD, GG>(a, s);
#define PD_CASES(DD) PD_CASE(DD, 1) PD_CASE(DD, 2) PD_CASE(DD, 4) PD_CASE(DD, 8)
  PD_CASES(16) PD_CASES(64) PD_CASES(128)
#undef PD_CASES
#undef PD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o, page_table, pt_stride, cur_len, len_stride, B, H, Hkv, D,
// ps, M, P, dtype, has_window, window, scale, splits, part_o, part_lse,
// stream.  G, the compiled row count, is g = H / Hkv rounded up to a
// power of two.
extern "C" int pd_decode(const void* q, const void* k, const void* v, void* o,
                         const int* page_table, int pt_stride,
                         const long long* cur_len, int len_stride, int B,
                         int H, int Hkv, int D, int ps, int M, int P,
                         int dtype, int has_window, int window, float scale,
                         int splits, void* part_o, void* part_lse,
                         void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv || ps < 1 || M < 1 || P < 1 ||
      splits < 1 || (has_window && window < 0) ||
      (long long)M * ps > 0x7fffffffLL - 4096 ||
      (M + splits - 1) / splits > MAX_PAGES ||
      (long long)B * Hkv * splits > 0x7fffffffLL ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int g = H / Hkv;
  const int G = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : g <= 8 ? 8 : 0;
  if (G == 0) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, page_table, cur_len, static_cast<float*>(part_o),
         static_cast<float*>(part_lse), pt_stride, len_stride, B, H, Hkv, g,
         ps, M, P, splits, has_window, has_window ? window : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32: return (int)by_shape<float>(a, D, G, s);
    case DT_BF16: return (int)by_shape<__nv_bfloat16>(a, D, G, s);
    case DT_F16: return (int)by_shape<__half>(a, D, G, s);
  }
  return (int)cudaErrorInvalidValue;
}
