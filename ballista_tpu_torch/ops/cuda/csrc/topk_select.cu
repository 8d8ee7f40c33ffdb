// topk_select for Hopper (sm_90a): the k smallest (i64 a, i64 b, i32 pos)
// triples of each [P, N] row, in ascending order, without the full sort.
//
// Replaces the Pallas kernel `topk_select`
// (ballista_tpu/ops/tpu/pallas_kernels.py:351, pallas_call at :336), which
// sorts C-lane chunks of one VMEM-resident row and folds them pairwise
// (elementwise min of one sorted chunk against the other reversed, then a
// bitonic merge) until C lanes are left.
//
// Contract (the Pallas function's): a, b i64 [P, N], pos i32 [P, N], N a
// power of two; C = min(max(pow2(k), 128), N), computed by the wrapper.
// Out: the C smallest triples of each row, ascending, [P, C] (the wrapper
// slices them to k). The result is unique (pos makes triples unique), so
// it equals the plain form's exactly, whatever order blocks finish in.
//
// Bound: bytes. Any implementation must read every lane's a and b (16 B);
// pos is needed only where (a, b) does not exceed the C-th smallest, and
// C triples are written: 16.8 MB at [1, 2^20], 0.0050 ms at 3.35 TB/s.
//
// Design (C <= kCap = 2048): a threshold filter, not a sort.
//   1. A grid sized to the card: each block streams one contiguous span of
//      a row, 1024 lanes a step, reading a and b as 16-byte pairs through
//      L2, the next step's loads in flight while a step is filtered. It
//      keeps its C best triples sorted in shared memory (top triples until
//      it has C); the C-th is its threshold. A lane whose (a, b) does not
//      exceed the threshold's reads its pos and, if its triple is below
//      the threshold, is compacted into a 2048-lane shared buffer (a
//      block-wide prefix of the passing counts). When the next step might
//      not fit, and at the span's end, the buffer's C smallest are merged
//      into the kept lanes and the threshold tightens. After a few
//      thousand lanes of random data almost no lane passes: a step is its
//      loads and one barrier (__syncthreads_or).
//   2. The blocks' lists meet in a tournament of fan-in F = max(2, 2048 /
//      C): the last of a group's blocks to finish (an atomic ticket per
//      group, zeroed by one memset) merges their F sorted lists in shared
//      memory, keeping the first C, and goes on; 2 levels for 128 blocks
//      at C = 128, whatever the data. The block that merges the root
//      writes the row's C. One block per row when the row is one span.
// Merging (the buffer, and the tournament's lists): sorted 8-lane runs
// and merge-path levels in shared memory (mergesort3.cuh), each pair
// keeping its first C. The latency of these levels in one block (chains
// of dependent shared-memory loads and compares), not the row's loads,
// sets the kernel's time (PERF.md).
// One memset and one kernel a call. Worst case, descending input: every
// lane is a new minimum and every buffer is merged full.
// A C above kCap (k > 2048) sorts the rows whole with segmented_sort's
// merge sort (mergesort3.cuh) into scratch and copies the first C lanes.
// Deterministic: the output is the unique set, in order.
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include "mergesort3.cuh"

namespace {

using mergesort3::kItems;
using mergesort3::kThreads;
using mergesort3::merge_items;
using mergesort3::put_run;
using mergesort3::sort_items;
using mergesort3::Tile;
using mergesort3::Tri;

constexpr int kPairs = 2;                 // 16-byte pairs of a and b a thread reads a step
constexpr int kStep = kThreads * 2 * kPairs;  // lanes a block reads a step
constexpr int kBuf = kThreads * kItems;   // lanes of the candidate buffer (one sort)
constexpr int kCap = 2048;                // the largest C the filter takes
constexpr int kWarps = kThreads / 32;
constexpr int kLevels = 16;               // tournament levels a ticket array provides for
constexpr long long kMax64 = 9223372036854775807LL;
constexpr int kMax32 = 2147483647;

__device__ __forceinline__ Tri top() { return {kMax64, kMax64, kMax32}; }

// shared bytes of a Tile holding `lanes` lanes (padded as Tile pads them)
constexpr int tile_bytes(int lanes) {
  return 16 * (lanes + lanes / 16 + 1) + 4 * (lanes + lanes / 32 + 1);
}

// One step's lanes of a thread: a and b of 2 * kPairs lanes, in flight
// while the previous step is filtered.
struct Step {
  long long a[2 * kPairs], b[2 * kPairs];

  __device__ __forceinline__ void load(const long long* __restrict__ pa,
                                       const long long* __restrict__ pb, long long g0,
                                       long long hi) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const long long i = g0 + 2 * ((long long)j * kThreads + threadIdx.x);
      if ((i & 1) == 0 && i + 1 < hi) {
        const longlong2 va = __ldcg(reinterpret_cast<const longlong2*>(pa + i));
        const longlong2 vb = __ldcg(reinterpret_cast<const longlong2*>(pb + i));
        a[2 * j] = va.x; a[2 * j + 1] = va.y;
        b[2 * j] = vb.x; b[2 * j + 1] = vb.y;
      } else {
        a[2 * j] = i < hi ? __ldcg(pa + i) : kMax64;
        b[2 * j] = i < hi ? __ldcg(pb + i) : kMax64;
        a[2 * j + 1] = i + 1 < hi ? __ldcg(pa + i + 1) : kMax64;
        b[2 * j + 1] = i + 1 < hi ? __ldcg(pb + i + 1) : kMax64;
      }
    }
  }
};

// The block's filter state, the same in every thread: the kept lanes
// [0, C) of the tile, ascending (top triples until C real lanes are
// kept), the buffered lanes [C, C + nb), and the threshold, the C-th kept
// lane: a lane passes when it is below it.
struct Filter {
  Tile s;
  int c, nb;
  Tri thr;

  // Merge sorted runs into one: runs of min(run, C) lanes at stride `run`
  // over tile lanes [off, off + n) (n / run a power of two) become the
  // first min(n, C) lanes at off, ascending. Each pair keeps only the
  // first C of its merge: no lane past them can be among the C smallest.
  __device__ void merge_levels(int off, int run, int n) {
    for (; run < n; run <<= 1) {
      const int in = run < c ? run : c;
      const int out = 2 * run < c ? 2 * run : c;
      const int k0 = threadIdx.x * kItems;
      const int pair = k0 / out, k = k0 - pair * out;
      const bool act = pair < n / (2 * run);
      const int pb = off + pair * 2 * run;
      Tri r[kItems];
      if (act) merge_items(s, pb, in, pb + run, in, k, r);
      __syncthreads();
      if (act) {
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          if (k + i < out) s.st(pb + k + i, r[i]);
        }
      }
      __syncthreads();
    }
  }

  // the buffer sorted (8 lanes a thread in registers, then merge levels),
  // its first C merged with the kept lanes
  __device__ void flush() {
    int n = kItems;
    while (n < nb) n <<= 1;
    for (int i = nb + threadIdx.x; i < n; i += kThreads) s.st(c + i, top());
    __syncthreads();
    const int k0 = threadIdx.x * kItems;
    Tri r[kItems];
    if (k0 < n) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) r[i] = s.ld(c + k0 + i);
      sort_items(r);
      put_run(s, c + k0, r);
    }
    __syncthreads();
    merge_levels(c, kItems, n);
    if (k0 < c) merge_items(s, 0, c, c, nb < c ? nb : c, k0, r);
    __syncthreads();
    if (k0 < c) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (k0 + i < c) s.st(k0 + i, r[i]);
      }
    }
    __syncthreads();
    nb = 0;
    thr = s.ld(c - 1);
  }

  // the C smallest of m sorted C-lane runs at tile lanes [0, m * C), at
  // tile lanes [0, C): top runs up to a power of two, then merge levels
  __device__ void merge_lists(int m) {
    int mm = 1;
    while (mm < m) mm <<= 1;
    for (int i = m * c + threadIdx.x; i < mm * c; i += kThreads) s.st(i, top());
    __syncthreads();
    merge_levels(0, c, mm * c);
  }

  // Stream lanes [lo, hi) of (a, b, p) through the filter, reading every
  // operand through L2 only. A lane's pos is read only where its (a, b)
  // does not exceed the threshold's.
  __device__ void stream(const long long* a, const long long* b, const int* p,
                         long long lo, long long hi, int* s_cnt) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    Step nxt;
    nxt.load(a, b, lo, hi);
    for (long long g0 = lo; g0 < hi; g0 += kStep) {
      const Step cur = nxt;
      if (g0 + kStep < hi) nxt.load(a, b, g0 + kStep, hi);
      Tri x[2 * kPairs];
      unsigned hit = 0;
      int np = 0;
#pragma unroll
      for (int i = 0; i < 2 * kPairs; ++i) {
        const long long li = g0 + 2 * ((long long)(i >> 1) * kThreads + threadIdx.x) + (i & 1);
        x[i].a = cur.a[i];
        x[i].b = cur.b[i];
        bool ok = false;
        if (li < hi) {
          if (x[i].a < thr.a || (x[i].a == thr.a && x[i].b < thr.b)) {
            x[i].p = __ldcg(p + li);
            ok = true;
          } else if (x[i].a == thr.a && x[i].b == thr.b) {
            x[i].p = __ldcg(p + li);
            ok = x[i].p < thr.p;
          }
        }
        hit |= (unsigned)ok << i;
        np += ok;
      }
      if (!__syncthreads_or(np)) continue;  // the common case: nothing passes
      // where this thread's passing lanes go: a prefix over the block
      int incl = np;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) s_cnt[warp] = incl;
      __syncthreads();
      int at = c + nb + incl - np, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int cw = s_cnt[w];
        at += w < warp ? cw : 0;
        total += cw;
      }
#pragma unroll
      for (int i = 0; i < 2 * kPairs; ++i) {
        if (hit >> i & 1u) s.st(at++, x[i]);
      }
      __syncthreads();  // also orders this step's reads of s_cnt before the next writes
      nb += total;
      if (nb > kBuf - kStep) flush();  // the next step might not fit
    }
    if (nb > 0) flush();
  }

  // kept lanes [0, C) to (oa, ob, op) + o
  __device__ void write(long long* oa, long long* ob, int* op, long long o) const {
    for (int i = threadIdx.x; i < c; i += kThreads) {
      const Tri x = s.ld(i);
      oa[o + i] = x.a;
      ob[o + i] = x.b;
      op[o + i] = x.p;
    }
  }
};

// One block per (span, row): blockIdx.x takes lanes [x * span, (x + 1) *
// span) of row blockIdx.y and keeps its C best. With blocks > 1 the
// blocks' lists meet in a tournament of fan-in F = max(2, kBuf / C): at
// level L a group takes the list slots g * F^(L+1) + j * F^L (j < F) of
// (ca, cb, cp) [P, blocks, C]; the last of the group's blocks to arrive
// (an atomic ticket per group) merges their lists in shared memory,
// keeps the first C in the group's first slot and goes on. The block
// that merges the root writes the row's C. ceil(log_F(blocks)) levels:
// 2 for 128 blocks at C = 128.
__global__ void __launch_bounds__(kThreads)
filter_kernel(const long long* __restrict__ a, const long long* __restrict__ b,
              const int* __restrict__ p, long long* __restrict__ oa,
              long long* __restrict__ ob, int* __restrict__ op, long long* ca,
              long long* cb, int* cp, unsigned* tickets, long long n, int c,
              long long span, int blocks) {
  extern __shared__ long long smem[];
  const int pad8 = c + kBuf + (c + kBuf) / 16 + 1;
  Filter f;
  f.s = Tile{smem, smem + pad8, reinterpret_cast<int*>(smem + 2 * pad8)};
  f.c = c;
  f.nb = 0;
  f.thr = top();
  for (int i = threadIdx.x; i < c; i += kThreads) f.s.st(i, top());
  __shared__ int s_cnt[kWarps];
  __shared__ int s_go;
  const long long row = blockIdx.y;
  const long long lo = row * n + (long long)blockIdx.x * span;
  const long long end = row * n + n;
  __syncthreads();
  f.stream(a, b, p, lo, lo + span < end ? lo + span : end, s_cnt);
  if (blocks == 1) {
    f.write(oa, ob, op, row * c);
    return;
  }
  const int fan = kBuf / c > 2 ? kBuf / c : 2;
  const long long base = row * blocks;
  int slot = blockIdx.x;
  int level = 0;
  for (long long w = 1; w < blocks; w *= fan, ++level) {
    const int lead = (int)(slot / (w * fan) * (w * fan));
    const long long left = blocks - lead;
    const int m = (int)((left + w - 1) / w < fan ? (left + w - 1) / w : fan);  // group's blocks
    if (m == 1) continue;  // alone in its group: the list moves up as it is
    f.write(ca, cb, cp, (base + slot) * c);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_go = atomicAdd(&tickets[(row * kLevels + level) * blocks + lead], 1u) == (unsigned)m - 1;
    }
    __syncthreads();
    if (!s_go) return;  // a later block of the group merges
    __threadfence();
    // this block's list stays at tile lanes [0, C); the others follow it
    for (int j = 0, t = 1; j < m; ++j) {
      const long long sj = lead + j * w;
      if (sj == slot) continue;
      const long long o = (base + sj) * c;
      for (int i = threadIdx.x; i < c; i += kThreads) {
        f.s.st(t * c + i, Tri{__ldcg(ca + o + i), __ldcg(cb + o + i), __ldcg(cp + o + i)});
      }
      ++t;
    }
    __syncthreads();
    f.merge_lists(m);
    slot = lead;
  }
  f.write(oa, ob, op, row * c);
}

// i64 lanes rounded up to 16 bytes, so the next array stays 16-aligned
long long even(long long lanes) { return (lanes + 1) & ~1LL; }

}  // namespace

// The largest C the filter takes, and the lanes a block reads a step (a
// span is a multiple of it).
extern "C" int tk_cap() { return kCap; }
extern "C" int tk_step() { return kStep; }

// a, b i64 [P, N], pos i32 [P, N] in, 16-byte aligned; oa, ob i64 and op
// i32 [P, C] out; all contiguous; N and C powers of two with C <= N.
// scratch (16-byte aligned): for C <= tk_cap() and blocks > 1, the
// lists ca, cb i64 and cp i32 of P * blocks * C lanes each (every array
// rounded up to 16 bytes), then P * 16 * blocks u32 tickets; for C > tk_cap(), two
// sort triples of P * N lanes (i64 a, i64 b of both, then i32 pos of both).
// Block x of a row takes lanes [x * span, (x + 1) * span); blocks * span >= N.
extern "C" int tk_launch(const long long* a, const long long* b, const int* pos,
                         long long* oa, long long* ob, int* op, void* scratch,
                         long long rows, long long n, int c, int blocks, long long span,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || c <= 0) return 0;
  long long* s8 = static_cast<long long*>(scratch);
  if (c > kCap) {
    const long long m = even(rows * n);
    long long* s1a = s8;
    long long* s1b = s8 + m;
    int* s1p = reinterpret_cast<int*>(s8 + 4 * m);
    int err = mergesort3::sort_rows(a, b, pos, s1a, s1b, s1p, s8 + 2 * m, s8 + 3 * m,
                                    s1p + m, rows, n, s);
    if (err) return err;
    const size_t w8 = (size_t)c * 8, w4 = (size_t)c * 4;
    cudaMemcpy2DAsync(oa, w8, s1a, (size_t)n * 8, w8, (size_t)rows, cudaMemcpyDeviceToDevice, s);
    cudaMemcpy2DAsync(ob, w8, s1b, (size_t)n * 8, w8, (size_t)rows, cudaMemcpyDeviceToDevice, s);
    cudaMemcpy2DAsync(op, w4, s1p, (size_t)n * 4, w4, (size_t)rows, cudaMemcpyDeviceToDevice, s);
    return (int)cudaGetLastError();
  }
  const long long m = even(rows * blocks * c);
  long long* ca = s8;
  long long* cb = s8 + m;
  int* cp = reinterpret_cast<int*>(s8 + 2 * m);
  unsigned* tickets = reinterpret_cast<unsigned*>(s8 + 2 * m + m / 2);
  if (blocks > 1) {
    const cudaError_t e = cudaMemsetAsync(tickets, 0, (size_t)(rows * kLevels * blocks) * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  const int smem = tile_bytes(c + kBuf);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  filter_kernel<<<dim3(blocks, (unsigned)rows), kThreads, smem, s>>>(
      a, b, pos, oa, ob, op, ca, cb, cp, tickets, n, c, span, blocks);
  return (int)cudaGetLastError();
}
