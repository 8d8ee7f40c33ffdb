// segmented_scan for Hopper (sm_90a): an inclusive segmented sum, min or
// max over each [P, N] row, reset at boundary lanes.
//
// Replaces the Pallas kernel `segmented_scan`
// (ballista_tpu/ops/tpu/pallas_kernels.py:421, pallas_call at :410, built
// by `_build_seg_scan` :376), a Hillis-Steele scan over one VMEM-resident
// row per program: log2(N) steps of where(f, v, op(v, pv)) with the flags
// OR-propagated and the identity shifted in at the row start.
//
// Contract (the Pallas function's): vals [P, N] of int32, int64, float32 or
// float64; boundary u8 [P, N] (bool, one byte a lane: never widened);
// lane 0 is an implicit boundary. out[i] = op over vals[s..i], s the last
// boundary at or before i. Identities: 0 for sum, the type's max / +inf
// for min, its min / -inf for max. Float min and max follow jnp.minimum /
// jnp.maximum: a NaN operand wins, and -0.0 < +0.0 (written out below:
// CUDA's fmin/fmax drop NaN and leave the zero sign unspecified). With
// that, min, max and integer sums (two's complement, wrapping) are
// associative and commutative, so this kernel's grouping gives the Pallas
// kernel's bits. A float sum associates differently from Hillis-Steele
// and agrees within a float tolerance.
//
// Bound: bytes. Each lane reads its value and flag once and writes its
// value once: [1, 2^20] x 17 B = 17.8 MB for i64/f64, 0.0053 ms at
// 3.35 TB/s. One add or compare per lane.
//
// Design: a scan of the monoid (value, flag), with
//   combine((pv, pf), (v, f)) = (f ? v : op(v, pv), pf | f),
// in three launches, since blocks cannot carry a value to each other:
//   1. reduce: one block per 2048-lane tile folds its tile to one (v, f);
//   2. carries: one block per row scans the tile aggregates (exclusive),
//      starting from the identity;
//   3. apply: one block per tile scans its tile from its carry and writes.
// Inside a block each thread folds 8 consecutive lanes from shared memory,
// and the 256 thread aggregates are scanned with warp shuffles. The tile
// is staged through shared memory with element loads, so inputs off a
// 16-byte boundary need nothing special. Deterministic: no atomics.
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 lanes
constexpr int kWarps = kThreads / 32;

enum { kSum = 0, kMin = 1, kMax = 2 };

template <typename T> struct Lim;
template <> struct Lim<int32_t> {
  static __device__ int32_t lo() { return INT32_MIN; }
  static __device__ int32_t hi() { return INT32_MAX; }
};
template <> struct Lim<long long> {
  static __device__ long long lo() { return (long long)(-9223372036854775807LL - 1); }
  static __device__ long long hi() { return 9223372036854775807LL; }
};
template <> struct Lim<float> {
  static __device__ float lo() { return -__int_as_float(0x7f800000); }
  static __device__ float hi() { return __int_as_float(0x7f800000); }
};
template <> struct Lim<double> {
  static __device__ double lo() { return -__longlong_as_double(0x7ff0000000000000LL); }
  static __device__ double hi() { return __longlong_as_double(0x7ff0000000000000LL); }
};

template <typename T> __device__ __forceinline__ bool is_nan(T x) { return x != x; }
template <typename T> __device__ __forceinline__ bool neg_sign(T x) { return x < T(0); }
template <> __device__ __forceinline__ bool neg_sign<float>(float x) {
  return signbit(x);
}
template <> __device__ __forceinline__ bool neg_sign<double>(double x) {
  return signbit(x);
}

template <typename T> __device__ __forceinline__ T add(T a, T b) { return a + b; }
// integer sums wrap, as XLA's do: add in the unsigned type
template <> __device__ __forceinline__ int32_t add<int32_t>(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
template <> __device__ __forceinline__ long long add<long long>(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// jnp.maximum / jnp.minimum: a NaN operand wins (a's first), then the
// larger (smaller) value, and of two equal values (only +0.0 and -0.0 can
// differ) the one with the sign bit clear (set).
template <int OP, typename T>
__device__ __forceinline__ T apply(T a, T b) {
  if (OP == kSum) return add<T>(a, b);
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  if (OP == kMax) {
    if (a > b) return a;
    if (b > a) return b;
    return neg_sign(a) ? b : a;
  }
  if (a < b) return a;
  if (b < a) return b;
  return neg_sign(a) ? a : b;
}

template <int OP, typename T>
__device__ __forceinline__ T identity() {
  if (OP == kSum) return T(0);
  return OP == kMin ? Lim<T>::hi() : Lim<T>::lo();
}

// (pv, pf) then (v, f): the segmented-scan monoid, v the later lane
template <int OP, typename T>
__device__ __forceinline__ void combine(T pv, bool pf, T& v, bool& f) {
  if (!f) v = apply<OP, T>(v, pv);
  f = f || pf;
}

// Exclusive scan of one (v, f) per thread across the block, in thread
// order: thread 0 gets (identity, false). Every thread also gets the block
// total (tot_v, tot_f).
template <int OP, typename T>
__device__ void block_scan(T v, bool f, T& ex_v, bool& ex_f, T& tot_v, bool& tot_f) {
  __shared__ T wv[kWarps + 1];
  __shared__ bool wf[kWarps + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T iv = v;
  bool ifl = f;
  for (int d = 1; d < 32; d <<= 1) {  // inclusive scan within the warp
    const T ov = __shfl_up_sync(0xffffffffu, iv, d);
    const bool of = __shfl_up_sync(0xffffffffu, (int)ifl, d) != 0;
    if (lane >= d) combine<OP, T>(ov, of, iv, ifl);
  }
  // exclusive within the warp: the inclusive value of the lane before
  T xv = __shfl_up_sync(0xffffffffu, iv, 1);
  bool xf = __shfl_up_sync(0xffffffffu, (int)ifl, 1) != 0;
  if (lane == 31) {
    wv[warp] = iv;
    wf[warp] = ifl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive scan of the warp totals, in order
    T rv = identity<OP, T>();
    bool rf = false;
    for (int w = 0; w < kWarps; ++w) {
      T cv = wv[w];
      bool cf = wf[w];
      wv[w] = rv;
      wf[w] = rf;
      combine<OP, T>(rv, rf, cv, cf);
      rv = cv;
      rf = cf;
    }
    wv[kWarps] = rv;  // the block total
    wf[kWarps] = rf;
  }
  __syncthreads();
  const T pv = wv[warp];
  const bool pf = wf[warp];
  if (lane == 0) {
    ex_v = pv;
    ex_f = pf;
  } else {
    combine<OP, T>(pv, pf, xv, xf);
    ex_v = xv;
    ex_f = xf;
  }
  tot_v = wv[kWarps];
  tot_f = wf[kWarps];
  __syncthreads();  // the scratch is reused by the next call
}

template <typename T>
__device__ void load_tile(const T* v, const uint8_t* f, T* sv, uint8_t* sf,
                          long long base, int t) {
  for (int i = threadIdx.x; i < t; i += blockDim.x) {
    sv[i] = v[base + i];
    sf[i] = f[base + i];
  }
  __syncthreads();
}

// fold this thread's lanes [lo, hi) of the staged tile, in order
template <int OP, typename T>
__device__ void fold_run(const T* sv, const uint8_t* sf, int lo, int hi, T& v, bool& f) {
  v = identity<OP, T>();
  f = false;
  for (int i = lo; i < hi; ++i) {
    T cv = sv[i];
    bool cf = sf[i] != 0;
    combine<OP, T>(v, f, cv, cf);
    v = cv;
    f = cf;
  }
}

// 1. one (v, f) per tile: agg[row * tiles + tile]
template <int OP, typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* v, const uint8_t* f, T* agg_v, uint8_t* agg_f, long long n, int t) {
  __shared__ T sv[kTile];
  __shared__ uint8_t sf[kTile];
  const long long tiles = n / t;
  const long long row = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  load_tile<T>(v, f, sv, sf, row * n + tile * t, t);
  const int lo = min((int)threadIdx.x * kItems, t), hi = min(lo + kItems, t);
  T rv;
  bool rf;
  fold_run<OP, T>(sv, sf, lo, hi, rv, rf);
  T ex, tot;
  bool ex_f, tot_f;
  block_scan<OP, T>(rv, rf, ex, ex_f, tot, tot_f);
  if (threadIdx.x == 0) {
    agg_v[blockIdx.x] = tot;
    agg_f[blockIdx.x] = tot_f ? 1 : 0;
  }
}

// 2. one block per row: carry[tile] = the scan of the tiles before it,
// from the identity (the implicit boundary at lane 0)
template <int OP, typename T>
__global__ void __launch_bounds__(kThreads)
carry_kernel(const T* agg_v, const uint8_t* agg_f, T* carry, long long tiles) {
  const long long base = (long long)blockIdx.x * tiles;
  T run_v = identity<OP, T>();  // every thread keeps the same running carry
  bool run_f = true;
  for (long long c0 = 0; c0 < tiles; c0 += kThreads) {
    const long long i = c0 + threadIdx.x;
    T v = identity<OP, T>();
    bool f = false;
    if (i < tiles) {
      v = agg_v[base + i];
      f = agg_f[base + i] != 0;
    }
    T ex, tot;
    bool ex_f, tot_f;
    block_scan<OP, T>(v, f, ex, ex_f, tot, tot_f);
    if (i < tiles) {
      combine<OP, T>(run_v, run_f, ex, ex_f);
      carry[base + i] = ex;
    }
    combine<OP, T>(run_v, run_f, tot, tot_f);
    run_v = tot;
    run_f = tot_f;
  }
}

// 3. scan each tile from its carry and write it
template <int OP, typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* v, const uint8_t* f, const T* carry, T* out, long long n, int t) {
  __shared__ T sv[kTile];
  __shared__ uint8_t sf[kTile];
  const long long tiles = n / t;
  const long long row = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long base = row * n + tile * t;
  load_tile<T>(v, f, sv, sf, base, t);
  const int lo = min((int)threadIdx.x * kItems, t), hi = min(lo + kItems, t);
  T rv;
  bool rf;
  fold_run<OP, T>(sv, sf, lo, hi, rv, rf);
  T ex, tot;
  bool ex_f, tot_f;
  block_scan<OP, T>(rv, rf, ex, ex_f, tot, tot_f);
  // the lanes before this thread's: the tile's carry, then the block prefix
  T acc = carry[blockIdx.x];
  combine<OP, T>(acc, true, ex, ex_f);
  acc = ex;
  for (int i = lo; i < hi; ++i) {
    T cv = sv[i];
    bool cf = sf[i] != 0;
    combine<OP, T>(acc, true, cv, cf);
    acc = cv;
    sv[i] = acc;  // only this thread reads lane i
  }
  __syncthreads();
  for (int i = threadIdx.x; i < t; i += blockDim.x) out[base + i] = sv[i];
}

template <int OP, typename T>
int run(const void* v, const uint8_t* f, void* out, void* agg_v, uint8_t* agg_f,
        void* carry, long long rows, long long n, cudaStream_t s) {
  const int t = n < kTile ? (int)n : kTile;
  const long long tiles = n / t;
  const unsigned blocks = (unsigned)(rows * tiles);
  reduce_kernel<OP, T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(v), f, static_cast<T*>(agg_v), agg_f, n, t);
  int err = (int)cudaGetLastError();
  if (err) return err;
  carry_kernel<OP, T><<<(unsigned)rows, kThreads, 0, s>>>(
      static_cast<const T*>(agg_v), agg_f, static_cast<T*>(carry), tiles);
  err = (int)cudaGetLastError();
  if (err) return err;
  apply_kernel<OP, T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(v), f, static_cast<const T*>(carry), static_cast<T*>(out), n, t);
  return (int)cudaGetLastError();
}

template <typename T>
int run_op(int func, const void* v, const uint8_t* f, void* out, void* agg_v,
           uint8_t* agg_f, void* carry, long long rows, long long n, cudaStream_t s) {
  switch (func) {
    case kSum: return run<kSum, T>(v, f, out, agg_v, agg_f, carry, rows, n, s);
    case kMin: return run<kMin, T>(v, f, out, agg_v, agg_f, carry, rows, n, s);
    case kMax: return run<kMax, T>(v, f, out, agg_v, agg_f, carry, rows, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The lanes one block scans (the tile).
extern "C" int sc_tile() { return kTile; }

// dtype: 0 int32, 1 int64, 2 float32, 3 float64; func: 0 sum, 1 min,
// 2 max. vals and out [P, N] of the dtype, flags u8 [P, N]; scratch agg_v
// and carry of P * (N / tile) values of the dtype, agg_f of as many bytes,
// tile = min(N, sc_tile()). All contiguous; N a power of two.
extern "C" int sc_launch(int dtype, int func, const void* vals, const uint8_t* flags,
                         void* out, void* agg_v, uint8_t* agg_f, void* carry,
                         long long rows, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return 0;
  switch (dtype) {
    case 0: return run_op<int32_t>(func, vals, flags, out, agg_v, agg_f, carry, rows, n, s);
    case 1: return run_op<long long>(func, vals, flags, out, agg_v, agg_f, carry, rows, n, s);
    case 2: return run_op<float>(func, vals, flags, out, agg_v, agg_f, carry, rows, n, s);
    case 3: return run_op<double>(func, vals, flags, out, agg_v, agg_f, carry, rows, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
