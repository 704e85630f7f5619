// tuned_reduction.cu — min / max / sum of a 1-D array: the paper's OpenCL
// Minimum kernel (section 7) brought back to a GPU.
//
// Replaces: src/repro/kernels/tuned_reduction/kernel.py, _reduce_kernel /
// reduce_rows (the Pallas TPU kernel behind ops.reduce_1d).
//
// Bound on an H100: device-memory bytes.  Every element is read once and
// folded with one compare or add, so the kernel moves n * sizeof(T) bytes
// for ~n operations — far below the card's ~20 operations per byte at
// 3.35 TB/s.  Full size (2^28 int32, 1 GiB) has a floor of ~0.32 ms.
//
// Design.  The launch parameters ARE the paper's tunables: a block is a
// work-group of WG threads, and each thread folds TS elements of its
// block's chunk [b*WG*TS, (b+1)*WG*TS).  Within that contract:
//   * Loads are 16 bytes (V = 4 int32/f32 or 8 bf16 a load, ld.global.nc),
//     four of them in flight a thread before it folds.  The chunk is read
//     in groups of W = min(V, the largest power of two dividing TS)
//     elements: at step j thread t folds the group at chunk offset
//     (j*WG + t)*W, its elements in order, so each step is one coalesced
//     sweep.  When W = V and x is 16-byte aligned a group is one vector
//     load.  When W < V (TS < V, an odd TS), or where x is not 16-byte
//     aligned (a view such as x[1:] is contiguous), the same groups are
//     read element by element: the order of the fold does not depend on
//     x's address.  Elements past n (the ragged tail) fold the monoid
//     identity.
//   * The block folds each warp with shuffles (__reduce_*_sync for int32,
//     an xor butterfly for floats), then the warps' partials with one more
//     butterfly in warp 0: no log2(WG) rounds of __syncthreads.
//   * One launch: each block writes its partial, and the last block to
//     take a ticket (an atomic after __threadfence) folds all G partials in
//     index order — thread t folds partials t, t + B, ... — through the
//     same block fold, writes the result and resets the ticket for the
//     next call.  The wrapper owns the partials and the ticket per device
//     and per stream.  No float atomics: the result is deterministic, and
//     the plain version (ref.py, reduce_chunked) follows the fold step for
//     step.
// A block has B = 32 * ceil(WG / 32) threads; threads past WG fold only
// identities in the first pass and take their share of the partials in
// the last block's fold.
//
// Semantics that differ from the C defaults:
//   * min/max propagate NaN (fminf/fmaxf would drop it; jnp.minimum and
//     torch.minimum keep it);
//   * the int32 sum accumulates in uint32_t, so it wraps mod 2^32 like
//     JAX instead of overflowing a signed int (undefined in C++);
//   * f32 and bf16 accumulate in f32 and round once at the end;
//   * identities are +-inf for floats and the int32 bounds for ints.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 4;       // vector loads in flight a thread

enum Op { OP_MIN = 0, OP_MAX = 1, OP_SUM = 2 };
enum DType { DT_INT32 = 0, DT_F32 = 1, DT_BF16 = 2 };

// ---- accumulator type per (input type, op) --------------------------------

template <typename T, int OP> struct Acc;
template <> struct Acc<int, OP_MIN> { using type = int; };
template <> struct Acc<int, OP_MAX> { using type = int; };
template <> struct Acc<int, OP_SUM> { using type = uint32_t; };
template <int OP> struct Acc<float, OP> { using type = float; };
template <int OP> struct Acc<__nv_bfloat16, OP> { using type = float; };

// ---- monoid: identity, combine and a warp's fold ---------------------------

template <typename A, int OP> struct Monoid;

template <> struct Monoid<int, OP_MIN> {
  __device__ static int identity() { return 0x7fffffff; }
  __device__ static int combine(int a, int b) { return b < a ? b : a; }
  __device__ static int warp(int v) { return __reduce_min_sync(~0u, v); }
};
template <> struct Monoid<int, OP_MAX> {
  __device__ static int identity() { return (int)0x80000000; }
  __device__ static int combine(int a, int b) { return b > a ? b : a; }
  __device__ static int warp(int v) { return __reduce_max_sync(~0u, v); }
};
template <> struct Monoid<uint32_t, OP_SUM> {
  __device__ static uint32_t identity() { return 0u; }
  __device__ static uint32_t combine(uint32_t a, uint32_t b) { return a + b; }
  __device__ static uint32_t warp(uint32_t v) {
    return __reduce_add_sync(~0u, v);
  }
};
// Floats: lane i folds (i, i ^ h) for h = 16, 8, 4, 2, 1, its own value
// first.  Lane 0 so folds the halving tree of ref.py (_tree): the lanes
// below h hold the tree's entries when lane 0 reads them.
template <int OP> struct FloatMonoid {
  __device__ static float warp(float v) {
#pragma unroll
    for (int h = 16; h > 0; h >>= 1)
      v = Monoid<float, OP>::combine(v, __shfl_xor_sync(~0u, v, h));
    return v;
  }
};
template <> struct Monoid<float, OP_MIN> : FloatMonoid<OP_MIN> {
  __device__ static float identity() { return __int_as_float(0x7f800000); }
  // NaN in either operand wins
  __device__ static float combine(float a, float b) {
    return (a != a || a < b) ? a : b;
  }
};
template <> struct Monoid<float, OP_MAX> : FloatMonoid<OP_MAX> {
  __device__ static float identity() { return -__int_as_float(0x7f800000); }
  __device__ static float combine(float a, float b) {
    return (a != a || a > b) ? a : b;
  }
};
template <> struct Monoid<float, OP_SUM> : FloatMonoid<OP_SUM> {
  __device__ static float identity() { return 0.0f; }
  __device__ static float combine(float a, float b) { return a + b; }
};

// ---- elements: into the accumulator type, out of it, 16-byte vectors -------

template <typename T, typename A> struct Convert;
template <typename A> struct Convert<int, A> {            // A: int or uint32_t
  __device__ static A in(int v) { return static_cast<A>(v); }
  __device__ static int out(A v) { return static_cast<int>(v); }
};
template <> struct Convert<float, float> {
  __device__ static float in(float v) { return v; }
  __device__ static float out(float v) { return v; }
};
template <> struct Convert<__nv_bfloat16, float> {
  __device__ static float in(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 out(float v) { return __float2bfloat16(v); }
};

template <typename T> struct Vec { static constexpr int V = 16 / sizeof(T); };

// how a group of W elements is read
enum Path {
  PATH_VEC = 0,     // W = V, x 16-byte aligned: one vector
  PATH_SCALAR = 1   // W < V, or x misaligned: element by element
};

__device__ __forceinline__ uint4 ld_stream_v4(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// fold the V elements of one 16-byte vector, lowest address first
template <typename T, int OP, typename A>
__device__ __forceinline__ A fold_vec(A acc, const uint4& v) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int k = 0; k < Vec<T>::V; ++k)
    acc = Monoid<A, OP>::combine(acc, Convert<T, A>::in(e[k]));
  return acc;
}

// The block's B = blockDim.x values (one a thread) folded: warps first,
// then warp 0 over the warps' partials (identity-padded to 32).  Every
// thread calls it; thread 0 gets the result.
template <typename A, int OP>
__device__ __forceinline__ A block_fold(A v, A* sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = Monoid<A, OP>::warp(v);
  __syncthreads();                       // sh may still be read by a caller
  if (lane == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < (int)(blockDim.x >> 5) ? sh[lane] : Monoid<A, OP>::identity();
    v = Monoid<A, OP>::warp(v);
  }
  return v;
}

template <typename T, int OP, int PATH>
__global__ void __launch_bounds__(1024)
reduce_kernel(const T* __restrict__ x, long long n, int WG, int TS, int W,
              typename Acc<T, OP>::type* __restrict__ partials,
              unsigned int* __restrict__ ticket, T* __restrict__ out) {
  using A = typename Acc<T, OP>::type;
  constexpr int V = Vec<T>::V;
  __shared__ A sh[32];
  __shared__ bool last;
  const int t = threadIdx.x;
  const long long chunk = (long long)WG * TS;
  const long long cb = (long long)blockIdx.x * chunk;
  const int steps = TS / W;

  A acc = Monoid<A, OP>::identity();
  if (t < WG && PATH == PATH_VEC) {
    // group j at element cb + (j*WG + t)*V, 16 bytes
    const char* p = reinterpret_cast<const char*>(x + cb + (long long)t * V);
    const long long stride = (long long)WG * V * sizeof(T);
    int j = 0;
    if (cb + chunk <= n) {                        // whole chunk in range
      for (; j + UNROLL <= steps; j += UNROLL) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          v[u] = ld_stream_v4(p + (j + u) * stride);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc = fold_vec<T, OP, A>(acc, v[u]);
      }
    }
    for (; j < steps; ++j) {                      // remainder and the tail
      const long long i = cb + ((long long)j * WG + t) * V;
      if (i + V <= n) {
        acc = fold_vec<T, OP, A>(acc, ld_stream_v4(x + i));
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc = Monoid<A, OP>::combine(
              acc, i + k < n ? Convert<T, A>::in(x[i + k])
                             : Monoid<A, OP>::identity());
      }
    }
  } else if (t < WG) {
    // groups of W elements, element by element
#pragma unroll 4
    for (int j = 0; j < steps; ++j) {
      const long long i = cb + ((long long)j * WG + t) * W;
      T e[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (k < W && i + k < n) e[k] = __ldg(x + i + k);
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (k < W)
          acc = Monoid<A, OP>::combine(
              acc, i + k < n ? Convert<T, A>::in(e[k])
                             : Monoid<A, OP>::identity());
    }
  }

  acc = block_fold<A, OP>(acc, sh);
  if (t == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();                              // the partial, then the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: thread t folds partials t, t + B, ... in order
  __threadfence();
  acc = Monoid<A, OP>::identity();
  for (long long g = t; g < gridDim.x; g += blockDim.x)
    acc = Monoid<A, OP>::combine(acc, __ldcg(partials + g));
  acc = block_fold<A, OP>(acc, sh);
  if (t == 0) {
    *out = Convert<T, A>::out(acc);
    *ticket = 0u;                                 // ready for the next call
  }
}

template <typename T, int OP>
cudaError_t launch(const void* x, long long n, int WG, int TS, void* partials,
                   void* ticket, void* out, cudaStream_t stream) {
  using A = typename Acc<T, OP>::type;
  constexpr int V = Vec<T>::V;
  const long long G = (n + (long long)WG * TS - 1) / ((long long)WG * TS);
  const int B = (WG + 31) / 32 * 32;
  const int W = (TS & -TS) < V ? (TS & -TS) : V;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const T* xt = static_cast<const T*>(x);
  A* pt = static_cast<A*>(partials);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  T* o = static_cast<T*>(out);
  if (W == V && aligned)
    reduce_kernel<T, OP, PATH_VEC><<<(unsigned)G, B, 0, stream>>>(
        xt, n, WG, TS, W, pt, tk, o);
  else
    reduce_kernel<T, OP, PATH_SCALAR><<<(unsigned)G, B, 0, stream>>>(
        xt, n, WG, TS, W, pt, tk, o);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int op, const void* x, long long n, int WG, int TS,
                      void* partials, void* ticket, void* out,
                      cudaStream_t stream) {
  switch (op) {
    case OP_MIN:
      return launch<T, OP_MIN>(x, n, WG, TS, partials, ticket, out, stream);
    case OP_MAX:
      return launch<T, OP_MAX>(x, n, WG, TS, partials, ticket, out, stream);
    case OP_SUM:
      return launch<T, OP_SUM>(x, n, WG, TS, partials, ticket, out, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: n elements of `dtype`; partials: ceil(n / (WG*TS)) 4-byte slots;
// ticket: one zeroed uint32 that no launch on another stream uses at the
// same time (the kernel leaves it zero); out: one element of `dtype`.
// Returns cudaGetLastError().
extern "C" int tr_reduce(const void* x, long long n, int dtype, int op, int WG,
                         int TS, void* partials, void* ticket, void* out,
                         void* stream) {
  if (n < 1 || WG < 1 || WG > 1024 || TS < 1 ||
      (n + (long long)WG * TS - 1) / ((long long)WG * TS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_INT32:
      return (int)launch_op<int>(op, x, n, WG, TS, partials, ticket, out, s);
    case DT_F32:
      return (int)launch_op<float>(op, x, n, WG, TS, partials, ticket, out, s);
    case DT_BF16:
      return (int)launch_op<__nv_bfloat16>(op, x, n, WG, TS, partials, ticket,
                                           out, s);
  }
  return (int)cudaErrorInvalidValue;
}
