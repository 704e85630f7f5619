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
// work-group of WG threads, and each thread folds a tile of TS elements.
// Block b owns the contiguous chunk [b*WG*TS, (b+1)*WG*TS); in step j its
// threads read x[b*WG*TS + j*WG + tid], so every step is one coalesced
// sweep of WG neighbouring elements and enough blocks stay in flight to
// keep the memory system busy.  The ragged tail is masked inside the
// kernel (no padded copy of x).  Each block tree-reduces its WG partials
// in shared memory and writes ONE partial; a second launch folds the
// partials with one block of FOLD_THREADS threads.  No atomics: the
// result is deterministic and the fold order is fixed, which the plain
// version (ref.py, reduce_chunked) reproduces step for step.
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

constexpr int FOLD_THREADS = 1024;

enum Op { OP_MIN = 0, OP_MAX = 1, OP_SUM = 2 };
enum DType { DT_INT32 = 0, DT_F32 = 1, DT_BF16 = 2 };

// ---- accumulator type per (input type, op) --------------------------------

template <typename T, int OP> struct Acc;
template <> struct Acc<int, OP_MIN> { using type = int; };
template <> struct Acc<int, OP_MAX> { using type = int; };
template <> struct Acc<int, OP_SUM> { using type = uint32_t; };
template <int OP> struct Acc<float, OP> { using type = float; };
template <int OP> struct Acc<__nv_bfloat16, OP> { using type = float; };

// ---- monoid: identity and combine ------------------------------------------

template <typename A, int OP> struct Monoid;

template <> struct Monoid<int, OP_MIN> {
  __device__ static int identity() { return 0x7fffffff; }
  __device__ static int combine(int a, int b) { return b < a ? b : a; }
};
template <> struct Monoid<int, OP_MAX> {
  __device__ static int identity() { return (int)0x80000000; }
  __device__ static int combine(int a, int b) { return b > a ? b : a; }
};
template <> struct Monoid<uint32_t, OP_SUM> {
  __device__ static uint32_t identity() { return 0u; }
  __device__ static uint32_t combine(uint32_t a, uint32_t b) { return a + b; }
};
template <> struct Monoid<float, OP_MIN> {
  __device__ static float identity() { return __int_as_float(0x7f800000); }
  // NaN in either operand wins
  __device__ static float combine(float a, float b) {
    return (a != a || a < b) ? a : b;
  }
};
template <> struct Monoid<float, OP_MAX> {
  __device__ static float identity() { return -__int_as_float(0x7f800000); }
  __device__ static float combine(float a, float b) {
    return (a != a || a > b) ? a : b;
  }
};
template <> struct Monoid<float, OP_SUM> {
  __device__ static float identity() { return 0.0f; }
  __device__ static float combine(float a, float b) { return a + b; }
};

// ---- load into the accumulator type, store back ---------------------------

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

// Shared-memory tree over n values (any n, not only powers of two): the
// stride starts at the largest power of two below n, and a thread folds
// its partner only when the partner exists.  Leaves the result in sh[0].
template <typename A, int OP>
__device__ void block_tree(A* sh, int n) {
  int s = 1;
  while (s < n) s <<= 1;
  for (s >>= 1; s > 0; s >>= 1) {
    const int t = threadIdx.x;
    if (t < s && t + s < n) sh[t] = Monoid<A, OP>::combine(sh[t], sh[t + s]);
    __syncthreads();
  }
}

// Pass 1: block b folds its WG*TS chunk into partials[b].
template <typename T, int OP>
__global__ void reduce_partials(const T* __restrict__ x, long long n, int TS,
                                typename Acc<T, OP>::type* __restrict__ partials) {
  using A = typename Acc<T, OP>::type;
  extern __shared__ unsigned char smem_raw[];
  A* sh = reinterpret_cast<A*>(smem_raw);
  const int WG = blockDim.x;
  const long long chunk = (long long)WG * TS;
  const long long base = (long long)blockIdx.x * chunk + threadIdx.x;

  A acc = Monoid<A, OP>::identity();
  if ((long long)blockIdx.x * chunk + chunk <= n) {     // whole chunk in range
    for (int j = 0; j < TS; ++j)
      acc = Monoid<A, OP>::combine(acc, Convert<T, A>::in(x[base + (long long)j * WG]));
  } else {                                               // the ragged tail
    for (int j = 0; j < TS; ++j) {
      const long long i = base + (long long)j * WG;
      if (i < n) acc = Monoid<A, OP>::combine(acc, Convert<T, A>::in(x[i]));
    }
  }
  sh[threadIdx.x] = acc;
  __syncthreads();
  block_tree<A, OP>(sh, WG);
  if (threadIdx.x == 0) partials[blockIdx.x] = sh[0];
}

// Pass 2: one block of FOLD_THREADS threads folds the G partials; thread t
// takes partials t, t + FOLD_THREADS, ... in order, then the block's tree.
template <typename T, int OP>
__global__ void reduce_final(const typename Acc<T, OP>::type* __restrict__ partials,
                             long long G, T* __restrict__ out) {
  using A = typename Acc<T, OP>::type;
  __shared__ A sh[FOLD_THREADS];
  A acc = Monoid<A, OP>::identity();
  for (long long i = threadIdx.x; i < G; i += FOLD_THREADS)
    acc = Monoid<A, OP>::combine(acc, partials[i]);
  sh[threadIdx.x] = acc;
  __syncthreads();
  block_tree<A, OP>(sh, FOLD_THREADS);
  if (threadIdx.x == 0) *out = Convert<T, A>::out(sh[0]);
}

template <typename T, int OP>
cudaError_t launch(const void* x, long long n, int WG, int TS, void* partials,
                   void* out, cudaStream_t stream) {
  using A = typename Acc<T, OP>::type;
  const long long chunk = (long long)WG * TS;
  const long long G = (n + chunk - 1) / chunk;
  reduce_partials<T, OP><<<(unsigned)G, WG, WG * sizeof(A), stream>>>(
      static_cast<const T*>(x), n, TS, static_cast<A*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_final<T, OP><<<1, FOLD_THREADS, 0, stream>>>(
      static_cast<const A*>(partials), G, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int op, const void* x, long long n, int WG, int TS,
                      void* partials, void* out, cudaStream_t stream) {
  switch (op) {
    case OP_MIN: return launch<T, OP_MIN>(x, n, WG, TS, partials, out, stream);
    case OP_MAX: return launch<T, OP_MAX>(x, n, WG, TS, partials, out, stream);
    case OP_SUM: return launch<T, OP_SUM>(x, n, WG, TS, partials, out, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: n elements of `dtype`; partials: ceil(n / (WG*TS)) 4-byte scratch
// slots; out: one element of `dtype`.  Returns cudaGetLastError().
extern "C" int tr_reduce(const void* x, long long n, int dtype, int op, int WG,
                         int TS, void* partials, void* out, void* stream) {
  if (n < 1 || WG < 1 || WG > 1024 || TS < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_INT32: return (int)launch_op<int>(op, x, n, WG, TS, partials, out, s);
    case DT_F32: return (int)launch_op<float>(op, x, n, WG, TS, partials, out, s);
    case DT_BF16:
      return (int)launch_op<__nv_bfloat16>(op, x, n, WG, TS, partials, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
