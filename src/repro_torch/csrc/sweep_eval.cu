// sweep_eval.cu — the section 7 Minimum wave-model time for a batch of
// (WG, TS) configurations: the tuner's lattice evaluated on the card.
//
// Replaces: src/repro/kernels/sweep_eval/kernel.py, _sweep_kernel /
// sweep_eval_rows (the Pallas TPU kernel behind ops.sweep_eval).
//
// Bound on an H100: instruction issue or device-memory bytes, whichever
// is larger.  Each configuration reads two int32 and writes one (12
// bytes: 0.060 ms for the 2^24-point lattice at 3.35 TB/s), and the card
// has no integer divider: a division by a runtime divisor is some fifteen
// instructions.  With the plain version's eleven signed floor divisions a
// point, instruction issue would hold the kernel at 4x its bytes bound.
//
// Design.
//   * Invalid points follow the exact engine's rule, as the plain
//     version (sweep_ref, model_time_torch) does: TS <= 0 or size / TS
//     == 0 (no work item) gives the sentinel; WG is clamped to 1 only as
//     the divisor of items.  The fast path takes every point with WG >= 1
//     and TS >= 1: with size >= 0 (the wrapper checks it) every dividend
//     lies in [0, 2^31), where floor and truncation agree, so its
//     arithmetic (model_time_fast) is unsigned, with no floor fix-ups,
//     and a remainder is a - q*b from its quotient.  A point with WG <= 0
//     (and work items) branches on load to model_time_wg0, which follows
//     the plain version's signed floor arithmetic with min(WG, items) =
//     WG; no lattice the tuner sweeps holds one, so the branch is never
//     taken there.  Sums and products wrap mod 2^32 as the int32 plain version
//     does, on both paths.
//   * Divisors that are the same for every point of a launch (NP, U and
//     warp) are divided by multiply-high with magic numbers
//     (Granlund-Montgomery for 31-bit dividends), which the wrapper
//     computes on the host (kernel.py, magic_u31): q = umulhi(a, m) >> s,
//     or a >> s for a power of two (m = 0).
//   * With r = (g-1) mod U, ceil(g/U) and ceil((g-r)/U) are the same
//     number, floor((g-1)/U) + 1, so one magic division gives count0, r
//     and count_r.
//   * gmt_eff depends only on resident = min(cnt, NP).  With warp
//     scheduling and NP <= TABLE_MAX each block tabulates it in shared
//     memory (NP + 1 entries, a few divisions a thread), so a point reads
//     it instead of dividing GMT by its warp count twice.  Above that the
//     point divides.
//   * The two divisions by per-point divisors (size / TS, items / WG) stay
//     divisions, unsigned.
//   * Loads and stores are 16 bytes (4 configurations) when the three
//     arrays are 16-byte aligned; thread t of a block takes vector
//     b*threads*ept + k*threads + t at step k, so every step is coalesced.
//     The ragged tail, and unaligned arrays, go element by element.
// One thread evaluates `ept` vectors of 4 configurations.  The wave
// parameters and the magic numbers are kernel ARGUMENTS, so one build
// serves every platform.  sweep_point_probe<MODE> is one configuration's
// fast path alone, never launched: tools/reduce_sweep_report.py and
// chip_smoke.py count its SASS instructions for the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SENTINEL = 0x7fffffff;
constexpr int TABLE_MAX = 1024;

// how a point gets gmt_eff(resident)
enum Mode { GMT_CONST = 0, GMT_TABLE = 1, GMT_DIV = 2 };

struct Magic {
  uint32_t m, s;     // q = (m ? umulhi(a, m) : a) >> s, exact for a < 2^31
};

struct Wave {
  uint32_t size, NP, GMT, L, U, warp;   // warp == 0: no warp scheduling
  Magic np, u, w;
};

__device__ __forceinline__ uint32_t udiv(uint32_t a, Magic d) {
  return (d.m ? __umulhi(a, d.m) : a) >> d.s;
}
// ceil(a / b) for a < 2^31, b >= 1, through b's magic numbers
__device__ __forceinline__ uint32_t ucdiv(uint32_t a, uint32_t b, Magic d) {
  const uint32_t q = udiv(a, d);
  return q + (a != q * b ? 1u : 0u);
}

__device__ __forceinline__ uint32_t gmt_divide(const Wave& p, uint32_t resident) {
  const uint32_t n_warps = max(1u, ucdiv(resident, p.warp, p.w));
  return max(1u, (p.GMT + n_warps - 1) / n_warps);
}

template <int MODE>
__device__ __forceinline__ uint32_t gmt_eff(const Wave& p, uint32_t resident,
                                            const uint32_t* tab) {
  if (MODE == GMT_CONST) return p.GMT;
  if (MODE == GMT_TABLE) return tab[resident];
  return gmt_divide(p, resident);
}

// one group of cnt >= 1 elements: waves * g * TS + (resident - 1) + g + L
template <int MODE>
__device__ __forceinline__ uint32_t group_time(const Wave& p, uint32_t cnt,
                                               uint32_t TS, const uint32_t* tab) {
  const uint32_t waves = ucdiv(cnt, p.NP, p.np);
  const uint32_t resident = min(cnt, p.NP);
  const uint32_t g = gmt_eff<MODE>(p, resident, tab);
  return waves * g * TS + (resident - 1) + g + p.L;
}

// floor(a / b) and ceil(a / b) for b >= 1 as the plain version's int32
// tensors give them, negation wrapping (-INT_MIN == INT_MIN)
__device__ __forceinline__ int sneg(int a) { return (int)(0u - (uint32_t)a); }
__device__ __forceinline__ int sfdiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int scdiv(int a, int b) { return sneg(sfdiv(sneg(a), b)); }

// A point with WG <= 0 and items >= 1 work items: items / max(WG, 1) =
// items groups of rem 0, each of cnt = min(WG, items) = WG elements, so
// resident = min(WG, NP) = WG; the group time's waves and gmt_eff in the
// plain version's signed floor arithmetic.
__device__ __forceinline__ int model_time_wg0(const Wave& p, int wg, uint32_t TS,
                                              uint32_t items) {
  const int waves = scdiv(wg, (int)p.NP);
  uint32_t g = p.GMT;
  if (p.warp) {
    const int n_warps = max(1, scdiv(wg, (int)p.warp));
    g = (uint32_t)max(1, scdiv((int)p.GMT, n_warps));
  }
  const uint32_t t_full = (uint32_t)waves * g * TS + ((uint32_t)wg - 1u) + g + p.L;
  const uint32_t count = udiv(items - 1, p.u) + 1;    // ceil(items / U)
  return (int)(count * t_full + items);               // host-side final reduce
}

// The fast path: WG >= 1 and TS >= 1.
template <int MODE>
__device__ __forceinline__ int model_time_fast(const Wave& p, uint32_t WG, uint32_t TS,
                                               const uint32_t* tab) {
  const uint32_t items = p.size / TS;
  if (items == 0) return SENTINEL;
  const uint32_t full = items / WG;
  const uint32_t rem = items - full * WG;      // = items when full == 0
  const uint32_t g_total = full + (rem > 0 ? 1u : 0u);

  const uint32_t t_full = group_time<MODE>(p, min(WG, items), TS, tab);
  const uint32_t t_rem = rem > 0 ? group_time<MODE>(p, rem, TS, tab) : 0u;
  // round-robin over U units: count0 = count_r = floor((g_total-1)/U) + 1
  const uint32_t q = udiv(g_total - 1, p.u);
  const uint32_t r = g_total - 1 - q * p.U;
  const uint32_t count = q + 1;
  const uint32_t t0 = count * t_full - (r == 0 ? t_full - t_rem : 0u);
  const uint32_t tr = count * t_full - (t_full - t_rem);
  const uint32_t device_t =
      rem > 0 ? (uint32_t)max((int)t0, (int)tr) : count * t_full;
  return (int)(device_t + g_total);              // host-side final reduce
}

template <int MODE>
__device__ __forceinline__ int model_time(const Wave& p, int wg, int ts,
                                          const uint32_t* tab) {
  if (ts < 1) return SENTINEL;
  if (wg < 1) {
    const uint32_t items = p.size / (uint32_t)ts;
    return items == 0 ? SENTINEL : model_time_wg0(p, wg, (uint32_t)ts, items);
  }
  return model_time_fast<MODE>(p, (uint32_t)wg, (uint32_t)ts, tab);
}

template <int MODE>
__device__ __forceinline__ void fill_table(const Wave& p, uint32_t* tab) {
  if (MODE != GMT_TABLE) return;
  for (uint32_t r = threadIdx.x; r <= p.NP; r += blockDim.x)
    tab[r] = gmt_divide(p, r);
  __syncthreads();
}

template <int MODE, bool VEC>
__global__ void sweep_eval_kernel(const int* __restrict__ wg,
                                  const int* __restrict__ ts,
                                  int* __restrict__ out, long long n, Wave p,
                                  int ept) {
  __shared__ uint32_t tab[MODE == GMT_TABLE ? TABLE_MAX + 1 : 1];
  fill_table<MODE>(p, tab);
  const long long nvec = (n + 3) / 4;
  const long long v0 = (long long)blockIdx.x * blockDim.x * ept + threadIdx.x;
  for (int k = 0; k < ept; ++k) {
    const long long v = v0 + (long long)k * blockDim.x;
    if (v >= nvec) break;
    const long long i = 4 * v;
    if (VEC && i + 4 <= n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(wg) + v);
      const int4 b = __ldg(reinterpret_cast<const int4*>(ts) + v);
      int4 o;
      o.x = model_time<MODE>(p, a.x, b.x, tab);
      o.y = model_time<MODE>(p, a.y, b.y, tab);
      o.z = model_time<MODE>(p, a.z, b.z, tab);
      o.w = model_time<MODE>(p, a.w, b.w, tab);
      reinterpret_cast<int4*>(out)[v] = o;
    } else {
      for (long long j = i; j < i + 4 && j < n; ++j)
        out[j] = model_time<MODE>(p, wg[j], ts[j], tab);
    }
  }
}

// One configuration's fast path, for counting its instructions: the
// TS test and model_time_fast, without the WG <= 0 branch, which no
// lattice the tuner sweeps takes.  The table comes from a pointer, so its
// read is one LDG where the sweep has one LDS.
template <int MODE>
__global__ void sweep_point_probe(const int* __restrict__ wg,
                                  const int* __restrict__ ts,
                                  int* __restrict__ out, Wave p,
                                  const uint32_t* __restrict__ tab) {
  const int t = ts[0];
  out[0] = t < 1 ? SENTINEL : model_time_fast<MODE>(p, (uint32_t)wg[0], (uint32_t)t, tab);
}

template <int MODE>
cudaError_t launch(const int* wg, const int* ts, int* out, long long n,
                   const Wave& p, int threads, int ept, cudaStream_t stream) {
  const long long per_block = (long long)threads * ept * 4;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const bool vec = ((reinterpret_cast<uintptr_t>(wg) |
                     reinterpret_cast<uintptr_t>(ts) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec)
    sweep_eval_kernel<MODE, true><<<blocks, threads, 0, stream>>>(
        wg, ts, out, n, p, ept);
  else
    sweep_eval_kernel<MODE, false><<<blocks, threads, 0, stream>>>(
        wg, ts, out, n, p, ept);
  return cudaGetLastError();
}

}  // namespace

// The probes' addresses, which keeps them in the library (never launched).
extern "C" const void* se_probes(int mode) {
  return mode == GMT_TABLE ? (const void*)sweep_point_probe<GMT_TABLE>
                           : (const void*)sweep_point_probe<GMT_CONST>;
}

// wg, ts, out: n int32 each.  Wave parameters as sweep_ref takes them
// (size >= 0, NP >= 1, U = ND*NU >= 1, warp >= 0 with 0 for none), and the
// magic numbers (m, s) of NP, U and warp (kernel.py, magic_u31; any for
// warp == 0).  Returns cudaGetLastError().
extern "C" int se_sweep_eval(const void* wg, const void* ts, void* out,
                             long long n, int size, int NP, int GMT, int L,
                             int U, int warp, unsigned m_np, unsigned s_np,
                             unsigned m_u, unsigned s_u, unsigned m_w,
                             unsigned s_w, int threads, int ept,
                             void* stream) {
  if (n < 1 || threads < 1 || threads > 1024 || ept < 1 || size < 0 ||
      NP < 1 || GMT < 0 || L < 0 || U < 1 || warp < 0 || s_np > 31 ||
      s_u > 31 || s_w > 31)
    return (int)cudaErrorInvalidValue;
  const Wave p{(uint32_t)size, (uint32_t)NP, (uint32_t)GMT, (uint32_t)L,
               (uint32_t)U, (uint32_t)warp, {m_np, s_np}, {m_u, s_u},
               {m_w, s_w}};
  const int* a = static_cast<const int*>(wg);
  const int* b = static_cast<const int*>(ts);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warp == 0) return (int)launch<GMT_CONST>(a, b, o, n, p, threads, ept, s);
  if (NP <= TABLE_MAX)
    return (int)launch<GMT_TABLE>(a, b, o, n, p, threads, ept, s);
  return (int)launch<GMT_DIV>(a, b, o, n, p, threads, ept, s);
}
