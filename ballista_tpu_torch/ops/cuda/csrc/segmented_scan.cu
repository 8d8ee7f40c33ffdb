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
// Design: one launch (after one memset of the tile counters) scans the
// monoid (value, flag), with
//   combine((pv, pf), (v, f)) = (f ? v : op(v, pv), pf | f),
// so every lane is read and written once:
//   - each block takes the next tile number from an atomic ticket, so a
//     block only ever waits on tiles that started before it;
//   - it stages its 4096-lane tile through shared memory with 16-byte
//     loads (the flags straight into registers, 8 a thread), each of 512
//     threads folds 8 consecutive lanes, and the thread aggregates are
//     scanned with warp shuffles; the tile's aggregate is published at
//     once: the value, then a status word (1: no boundary in the tile,
//     2: one or more) stored with release semantics;
//   - warp 0 then looks back over the published aggregates of the tiles
//     before it in windows of 32, one tile a lane, waiting for each
//     status (acquire loads) before reading its value, and combines each
//     window in a fixed shuffle tree, latest first, until a window holds
//     a boundary or the row's first tile. It never reads a neighbour's
//     inclusive prefix, whose readiness depends on timing: what it
//     combines, and in which grouping, depends on the data alone, so a
//     float sum gives the same bits on every run;
//   - the tile is scanned from that carry and written back through shared
//     memory with 16-byte stores.
// Rows shorter than a tile (N < 4096) take one tile of N lanes, loaded
// lane by lane. Shared memory: 32 KB a block for 8-byte values.
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;                 // consecutive lanes a thread folds
constexpr int kTile = kThreads * kItems;  // 4096 lanes
constexpr int kWarps = kThreads / 32;

enum { kSum = 0, kMin = 1, kMax = 2 };

struct alignas(kItems) Flags {  // a thread's flags: one vector load
  uint8_t v[kItems];
};

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
  const bool beats = OP == kMax ? (a > b || (a == b && !neg_sign(a)))
                                : (a < b || (a == b && neg_sign(a)));
  return (is_nan(a) || (!is_nan(b) && beats)) ? a : b;
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

// Inclusive scan of one (v, f) per lane across the warp, lane 0 first.
template <int OP, typename T>
__device__ __forceinline__ void warp_scan(T& v, bool& f) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const T ov = __shfl_up_sync(0xffffffffu, v, d);
    const bool of = __shfl_up_sync(0xffffffffu, (int)f, d) != 0;
    if (lane >= d) combine<OP, T>(ov, of, v, f);
  }
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
  warp_scan<OP, T>(iv, ifl);
  // exclusive within the warp: the inclusive value of the lane before
  T xv = __shfl_up_sync(0xffffffffu, iv, 1);
  bool xf = __shfl_up_sync(0xffffffffu, (int)ifl, 1) != 0;
  if (lane == 31) {
    wv[warp] = iv;
    wf[warp] = ifl;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the warp totals, in warp order
    T tv = lane < kWarps ? wv[lane] : identity<OP, T>();
    bool tf = lane < kWarps ? wf[lane] : false;
    warp_scan<OP, T>(tv, tf);
    T ev = __shfl_up_sync(0xffffffffu, tv, 1);
    bool ef = __shfl_up_sync(0xffffffffu, (int)tf, 1) != 0;
    if (lane == 0) {
      ev = identity<OP, T>();
      ef = false;
    }
    if (lane < kWarps) {
      wv[lane] = ev;
      wf[lane] = ef;
    }
    if (lane == kWarps - 1) {  // the block total
      wv[kWarps] = tv;
      wf[kWarps] = tf;
    }
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
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The staged tile is an array of 16-byte slots; slot s lives at s ^ ((s
// >> 3) & 7), which keeps both the coalesced pass (slot k * kThreads +
// thread) and the per-thread pass (slot thread * V + k, V = 2 or 4) free
// of bank conflicts.
__device__ __forceinline__ int slot(int s) { return s ^ ((s >> 3) & 7); }

// ctr[0] is the ticket, ctr[1 + tile] the tile's status (0: not yet
// published); agg[tile] the published aggregate's value. Tiles are
// numbered row by row: tile id = row * tiles + tile in the row. `full`:
// N >= kTile, every tile is kTile lanes and 16-byte aligned.
template <int OP, typename T, bool FULL>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ v, const uint8_t* __restrict__ f, T* __restrict__ out,
            T* agg, unsigned* ctr, long long n, int t, long long tiles) {
  constexpr int V = kItems * (int)sizeof(T) / 16;  // 16-byte slots a thread owns
  constexpr int E = 16 / (int)sizeof(T);           // values in a slot
  __shared__ uint4 stage[FULL ? kTile * sizeof(T) / 16 : 1];
  __shared__ long long s_id;
  __shared__ T s_carry;
  if (threadIdx.x == 0) s_id = (long long)atomicAdd(ctr, 1u);
  __syncthreads();
  const long long id = s_id;
  const long long row = id / tiles;
  const long long first = row * tiles;  // the row's first tile
  const long long base = row * n + (id - first) * t;
  const int lo = threadIdx.x * kItems;
  const int cnt = FULL ? kItems : max(0, min(kItems, t - lo));  // this thread's lanes
  T x[kItems];
  bool fl[kItems];
  if (FULL) {
    const uint4* src = reinterpret_cast<const uint4*>(v + base);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int s = k * kThreads + threadIdx.x;
      stage[slot(s)] = src[s];
    }
    const Flags fv = reinterpret_cast<const Flags*>(f + base)[threadIdx.x];
#pragma unroll
    for (int i = 0; i < kItems; ++i) fl[i] = fv.v[i] != 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const uint4 w = stage[slot(threadIdx.x * V + k)];
      memcpy(&x[k * E], &w, 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i < cnt) {
        x[i] = v[base + lo + i];
        fl[i] = f[base + lo + i] != 0;
      }
    }
  }
  // this thread's aggregate, in lane order
  T rv = identity<OP, T>();
  bool rf = false;
  if (cnt > 0) {
    rv = x[0];
    rf = fl[0];
  }
#pragma unroll
  for (int i = 1; i < kItems; ++i) {
    if (i < cnt) {
      T cv = x[i];
      bool cf = fl[i];
      combine<OP, T>(rv, rf, cv, cf);
      rv = cv;
      rf = cf;
    }
  }
  T ex, tot;
  bool ex_f, tot_f;
  block_scan<OP, T>(rv, rf, ex, ex_f, tot, tot_f);
  if (threadIdx.x == 0) {  // publish the tile's aggregate
    agg[id] = tot;
    __threadfence();
    st_release(ctr + 1 + id, tot_f ? 2u : 1u);
  }
  if (threadIdx.x < 32) {  // warp 0: the carry from the tiles before this one
    const int lane = threadIdx.x;
    T acc = identity<OP, T>();
    bool acc_f = true;  // the row start is a boundary
    bool have = false;
    for (long long hi = id; hi > first; hi -= 32) {  // window [hi - 32, hi)
      const long long j = hi - 32 + lane;
      T wv = identity<OP, T>();
      bool wf = true;
      if (j >= first) {
        unsigned st;
        while ((st = ld_acquire(ctr + 1 + j)) == 0) {
        }
        wv = __ldcg(agg + j);
        wf = st == 2u;
      }
      warp_scan<OP, T>(wv, wf);
      T win = __shfl_sync(0xffffffffu, wv, 31);
      bool win_f = __shfl_sync(0xffffffffu, (int)wf, 31) != 0;
      if (have) {  // the window is earlier than what is gathered so far
        combine<OP, T>(win, win_f, acc, acc_f);
      } else {
        acc = win;
        acc_f = win_f;
        have = true;
      }
      if (acc_f) break;
    }
    if (lane == 0) s_carry = acc;
  }
  __syncthreads();
  // the lanes before this thread's: the carry, then the block prefix
  T acc = s_carry;
  combine<OP, T>(acc, true, ex, ex_f);
  acc = ex;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i < cnt) {
      T cv = x[i];
      bool cf = fl[i];
      combine<OP, T>(acc, true, cv, cf);
      acc = cv;
      x[i] = acc;
    }
  }
  if (FULL) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      uint4 w;
      memcpy(&w, &x[k * E], 16);
      stage[slot(threadIdx.x * V + k)] = w;  // the slots this thread read
    }
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int s = k * kThreads + threadIdx.x;
      dst[s] = stage[slot(s)];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i < cnt) out[base + lo + i] = x[i];
    }
  }
}

template <int OP, typename T>
int run(const void* v, const uint8_t* f, void* out, void* status, long long rows,
        long long n, cudaStream_t s) {
  const int t = n < kTile ? (int)n : kTile;
  const long long tiles = n / t;
  const long long total = rows * tiles;
  T* agg = static_cast<T*>(status);
  unsigned* ctr = reinterpret_cast<unsigned*>(static_cast<char*>(status) + total * 8);
  int err = (int)cudaMemsetAsync(ctr, 0, (size_t)(1 + total) * 4, s);
  if (err) return err;
  if (n >= kTile) {
    scan_kernel<OP, T, true><<<(unsigned)total, kThreads, 0, s>>>(
        static_cast<const T*>(v), f, static_cast<T*>(out), agg, ctr, n, t, tiles);
  } else {
    scan_kernel<OP, T, false><<<(unsigned)total, kThreads, 0, s>>>(
        static_cast<const T*>(v), f, static_cast<T*>(out), agg, ctr, n, t, tiles);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run_op(int func, const void* v, const uint8_t* f, void* out, void* status,
           long long rows, long long n, cudaStream_t s) {
  switch (func) {
    case kSum: return run<kSum, T>(v, f, out, status, rows, n, s);
    case kMin: return run<kMin, T>(v, f, out, status, rows, n, s);
    case kMax: return run<kMax, T>(v, f, out, status, rows, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The lanes one block scans (the tile).
extern "C" int sc_tile() { return kTile; }

// dtype: 0 int32, 1 int64, 2 float32, 3 float64; func: 0 sum, 1 min,
// 2 max. vals and out [P, N] of the dtype, flags u8 [P, N], all contiguous
// and 16-byte aligned; N a power of two. status: P * tiles * 8 bytes of
// aggregates, then (1 + P * tiles) u32 counters, tiles = N / min(N,
// sc_tile()); the counters are zeroed here, on the stream, before the
// kernel runs.
extern "C" int sc_launch(int dtype, int func, const void* vals, const uint8_t* flags,
                         void* out, void* status, long long rows, long long n,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return 0;
  switch (dtype) {
    case 0: return run_op<int32_t>(func, vals, flags, out, status, rows, n, s);
    case 1: return run_op<long long>(func, vals, flags, out, status, rows, n, s);
    case 2: return run_op<float>(func, vals, flags, out, status, rows, n, s);
    case 3: return run_op<double>(func, vals, flags, out, status, rows, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
