// sweep_eval.cu — the section 7 Minimum wave-model time for a batch of
// (WG, TS) configurations: the tuner's lattice evaluated on the card.
//
// Replaces: src/repro/kernels/sweep_eval/kernel.py, _sweep_kernel /
// sweep_eval_rows (the Pallas TPU kernel behind ops.sweep_eval).
//
// Bound on an H100: device-memory bytes.  Each configuration reads two
// int32 and writes one (12 bytes) for a few dozen integer operations;
// at 3.35 TB/s the 2^24-point lattice has a floor of ~0.06 ms.
//
// Design.  One thread evaluates `ept` configurations, strided by the block
// width so that every load and store is coalesced; the tail is masked in
// the kernel (no padding).  The WaveParams (size, NP, GMT, L, ND*NU, warp
// or 0) are kernel ARGUMENTS, so one build serves every platform.  The
// arithmetic is the TPU kernel's, in int32, with two care points:
//   * jnp's // and % round toward minus infinity, C's / and % toward zero:
//     fdiv/fmod below implement floor semantics (operands are >= 0 on every
//     valid configuration, but the plain version and JAX use floor ops, and
//     so does this kernel, to agree bit for bit everywhere);
//   * int32 overflow wraps in JAX but is undefined for signed C++ ints, so
//     add/sub/mul go through uint32_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SENTINEL = 0x7fffffff;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}
// floor division / remainder for b > 0
__device__ __forceinline__ int fdiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int fmod_(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}
// jnp: -(-a // b)
__device__ __forceinline__ int cdiv(int a, int b) {
  return wsub(0, fdiv(wsub(0, a), b));
}

struct Wave {
  int size, NP, GMT, L, U, warp;   // warp == 0: no warp scheduling
};

__device__ __forceinline__ int gmt_eff(const Wave& p, int resident) {
  if (p.warp == 0) return p.GMT;
  const int n_warps = max(1, cdiv(resident, p.warp));
  return max(1, cdiv(p.GMT, n_warps));
}

__device__ __forceinline__ int group_time(const Wave& p, int cnt, int TS) {
  const int waves = cdiv(cnt, p.NP);
  const int resident = min(cnt, p.NP);
  const int g = gmt_eff(p, resident);
  int t = wmul(wmul(waves, g), TS);              // minimum-kernel wave time
  t = wadd(wadd(t, resident - 1), g);
  return wadd(t, p.L);
}

__device__ int model_time(const Wave& p, int WG, int TS) {
  const int items = fdiv(p.size, max(TS, 1));
  int full = fdiv(items, max(WG, 1));
  int rem = fmod_(items, max(WG, 1));
  if (full == 0) {                               // single short group
    full = 0;
    rem = items;
  }
  const int g_total = full + (rem > 0 ? 1 : 0);
  const int cnt_full = min(WG, items);

  const int t_full = group_time(p, cnt_full, TS);
  const int t_rem = rem > 0 ? group_time(p, max(rem, 1), TS) : 0;
  const int count0 = cdiv(g_total, p.U);
  const int r = fmod_(wsub(g_total, 1), p.U);
  const int count_r = cdiv(wsub(g_total, r), p.U);
  const int t0 = wsub(wmul(count0, t_full), r == 0 ? wsub(t_full, t_rem) : 0);
  const int tr = wsub(wmul(count_r, t_full), wsub(t_full, t_rem));
  const int device_t = rem > 0 ? max(t0, tr) : wmul(count0, t_full);
  const int t = wadd(device_t, g_total);         // host-side final reduce
  return items >= 1 ? t : SENTINEL;
}

__global__ void sweep_eval_kernel(const int* __restrict__ wg,
                                  const int* __restrict__ ts,
                                  int* __restrict__ out, long long n, Wave p,
                                  int ept) {
  const long long base = (long long)blockIdx.x * blockDim.x * ept + threadIdx.x;
  for (int k = 0; k < ept; ++k) {
    const long long i = base + (long long)k * blockDim.x;
    if (i < n) out[i] = model_time(p, wg[i], ts[i]);
  }
}

}  // namespace

// wg, ts, out: n int32 each.  Returns cudaGetLastError().
extern "C" int se_sweep_eval(const void* wg, const void* ts, void* out,
                             long long n, int size, int NP, int GMT, int L,
                             int U, int warp, int threads, int ept,
                             void* stream) {
  if (n < 1 || threads < 1 || threads > 1024 || ept < 1 || NP < 1 || U < 1 ||
      warp < 0)
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)threads * ept;
  const long long blocks = (n + per_block - 1) / per_block;
  Wave p{size, NP, GMT, L, U, warp};
  sweep_eval_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wg), static_cast<const int*>(ts),
      static_cast<int*>(out), n, p, ept);
  return (int)cudaGetLastError();
}
