// A stable merge sort over rows of (i64 a, i64 b, i32 pos) triples, for
// Hopper (sm_90a). Shared by segmented_sort.cu and topk_select.cu (which
// also sorts its candidate buffers with sort_items and merge_items).
//
// A row is up to 2^20 lanes x 20 B = 20 MB; a block has at most 227 KB of
// shared memory. The sort is bound by the bytes its passes move, so it
// makes as few passes over the row as it can:
//   1. one tile pass sorts every 2048-lane tile: each of 256 threads sorts
//      8 lanes in registers, then runs of 8, 16, ..., 1024 lanes are
//      merged pairwise in shared memory (merge path: each thread finds
//      where its 8 outputs start by a binary search, then merges them
//      with the two run heads in registers): 8 levels through shared
//      memory where a bitonic network over the tile takes 66;
//   2. log2(N / 2048) merge passes; pass m merges pairs of sorted runs of
//      w = 2048 * 2^m lanes into runs of 2w. Each block writes one span of
//      2048 output lanes: two warps find where the span starts and ends in
//      the two input runs by a merge-path search (32 probes a step, so
//      four rounds of loads at 2^20), the block stages both sub-ranges in
//      shared memory with coalesced loads, merges them as the tile pass
//      does, and writes the span back coalesced.
// 10 launches at 2^20 (8 at 2^18), each reading and writing the row once:
// 40 B a lane a pass. The passes ping-pong between the output and one
// scratch triple, the parity chosen so that the last lands in the output;
// the input is never written.
//
// Order: gt3, lexicographic on (a, b, pos). Ties take the left run first
// (a stable merge); equal triples are equal values, so the output is the
// one sorted order whatever the ties do. N is a power of two, so every
// span lies inside one pair of runs and no span is ragged; runs never
// cross a row. Offsets are 64-bit. Deterministic: no atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mergesort3 {

// Branch-free: every operand is loaded before the compare, and a warp
// does not diverge on it (the short-circuit form compiled to branches and
// reconvergence barriers in every merge step).
__device__ __forceinline__ bool gt3(long long a1, long long b1, int p1,
                                    long long a2, long long b2, int p2) {
  return (a1 > a2) | ((a1 == a2) & ((b1 > b2) | ((b1 == b2) & (p1 > p2))));
}

constexpr int kThreads = 256;
constexpr int kItems = 8;                 // consecutive lanes a thread holds
constexpr int kTile = kThreads * kItems;  // lanes a block sorts, and a merge block writes
constexpr int kPad8 = kTile + kTile / 16;  // padded lengths of the shared arrays
constexpr int kPad4 = kTile + kTile / 32;

struct Tri {
  long long a, b;
  int p;
};

__device__ __forceinline__ bool gt(const Tri& x, const Tri& y) {
  return gt3(x.a, x.b, x.p, y.a, y.b, y.p);
}

// The block's lanes in shared memory, one array per operand. Lane i lives
// at pad8(i) / pad4(i): one slot of padding per 16 8-byte (per 32 4-byte)
// lanes keeps a warp's strided accesses (8 lanes a thread when it writes
// its run, about 4 while merging) off the same banks.
struct Tile {
  long long* a;
  long long* b;
  int* p;
  __device__ __forceinline__ static int pad8(int i) { return i + (i >> 4); }
  __device__ __forceinline__ static int pad4(int i) { return i + (i >> 5); }
  __device__ __forceinline__ Tri ld(int i) const { return {a[pad8(i)], b[pad8(i)], p[pad4(i)]}; }
  __device__ __forceinline__ void st(int i, const Tri& t) const {
    a[pad8(i)] = t.a;
    b[pad8(i)] = t.b;
    p[pad4(i)] = t.p;
  }
};

// The kItems outputs [k, k + kItems) of the stable merge of the sorted runs
// A = tile lanes [a0, a0 + la) and B = [b0, b0 + lb) (ties to A), into r:
// a merge-path search for the thread's split, then a sequential merge
// with the two heads in registers. An exhausted run's head reads as the
// largest triple; each step loads one lane, from the run it took from,
// without a branch.
__device__ __forceinline__ void merge_items(const Tile& s, int a0, int la, int b0, int lb,
                                            int k, Tri (&r)[kItems]) {
  int lo = k > lb ? k - lb : 0, hi = k < la ? k : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!gt(s.ld(a0 + mid), s.ld(b0 + k - 1 - mid))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const Tri top{9223372036854775807LL, 9223372036854775807LL, 2147483647};
  int x = lo, y = k - lo;
  Tri ha = x < la ? s.ld(a0 + x) : top;
  Tri hb = y < lb ? s.ld(b0 + y) : top;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool take_a = !gt(ha, hb);
    r[i] = take_a ? ha : hb;
    x += take_a;
    y += !take_a;
    const bool more = take_a ? x < la : y < lb;
    const Tri next = s.ld(more ? (take_a ? a0 + x : b0 + y) : a0);
    if (take_a) {
      ha = more ? next : top;
    } else {
      hb = more ? next : top;
    }
  }
}

// a thread's kItems lanes sorted in registers (odd-even transposition)
__device__ __forceinline__ void sort_items(Tri (&r)[kItems]) {
#pragma unroll
  for (int round = 0; round < kItems; ++round) {
#pragma unroll
    for (int i = round & 1; i + 1 < kItems; i += 2) {
      if (gt(r[i], r[i + 1])) {
        const Tri x = r[i];
        r[i] = r[i + 1];
        r[i + 1] = x;
      }
    }
  }
}

// this thread's run r to tile lanes [k0, k0 + kItems)
__device__ __forceinline__ void put_run(const Tile& s, int k0, const Tri (&r)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) s.st(k0 + i, r[i]);
}

// The tile pass: one block per (row, tile) of t lanes (t = min(n, kTile)).
// It loads the tile (lanes past t, when t < kTile, take the largest
// triple, so they sort last and are not written back), sorts each
// thread's 8 lanes in registers (odd-even transposition), merges runs of
// 8, 16, ..., kTile / 2 lanes pairwise in shared memory, and writes the
// sorted tile to (oa, ob, op) at the input's offsets.
__global__ void __launch_bounds__(kThreads)
tile_sort_kernel(const long long* __restrict__ a, const long long* __restrict__ b,
                 const int* __restrict__ p, long long* __restrict__ oa,
                 long long* __restrict__ ob, int* __restrict__ op, long long n, int t) {
  __shared__ long long sa[kPad8];
  __shared__ long long sb[kPad8];
  __shared__ int sp[kPad4];
  const Tile s{sa, sb, sp};
  const long long tiles = n / t;
  const long long row = blockIdx.x / tiles;
  const long long base = row * n + (blockIdx.x - row * tiles) * t;
  const Tri top{9223372036854775807LL, 9223372036854775807LL, 2147483647};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    s.st(i, i < t ? Tri{a[base + i], b[base + i], p[base + i]} : top);
  }
  __syncthreads();
  const int k0 = threadIdx.x * kItems;
  Tri r[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) r[i] = s.ld(k0 + i);
  sort_items(r);
  for (int run = kItems; run < kTile; run <<= 1) {
    __syncthreads();  // every thread has read the previous level
    put_run(s, k0, r);
    __syncthreads();
    const int pb = k0 & ~(2 * run - 1);  // the pair of runs this thread's lanes fall in
    merge_items(s, pb, run, pb + run, run, k0 - pb, r);
  }
  __syncthreads();
  put_run(s, k0, r);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < t) {
      const Tri x = s.ld(i);
      oa[base + i] = x.a;
      ob[base + i] = x.b;
      op[base + i] = x.p;
    }
  }
}

// lane i goes after lane j (global lanes): all six operands loaded before
// the compare, so their loads are in flight together
__device__ __forceinline__ bool after(const long long* a, const long long* b, const int* p,
                                      long long i, long long j) {
  const long long ai = a[i], aj = a[j], bi = b[i], bj = b[j];
  const int pi = p[i], pj = p[j];
  return gt3(ai, bi, pi, aj, bj, pj);
}

// The merge-path split of output diagonal d (0 <= d <= 2w) of the sorted
// runs A = lanes [ra, ra + w) and B = [rb, rb + w): how many of the first
// d outputs come from A, ties to A. Run by one whole warp; every lane
// returns the answer. Each step probes 32 evenly spaced candidates at
// once, one a lane (four steps of loads at w = 2^19). More probes a step
// save a step but load more, and were slower on an H100.
__device__ long long split(const long long* a, const long long* b, const int* p,
                           long long ra, long long rb, long long w, long long d) {
  const int lane = threadIdx.x & 31;
  // P(i) = A[i] goes before B[d - 1 - i]: true below the answer, false from it
  long long lo = d > w ? d - w : 0, hi = d < w ? d : w;
  while (lo < hi) {
    const long long n = hi - lo;
    // probe m (0 <= m < 32) sits at q(m) = lo + (m + 1) * n / 32 - 1, the
    // last at hi - 1; q(m) = lo - 1 (fewer candidates than lanes) is true
    // by definition
    const long long q = lo + ((long long)(lane + 1) * n) / 32 - 1;
    const bool take_a = q < lo || !after(a, b, p, ra + q, rb + (d - 1 - q));
    // P is monotone in q, so the true probes come first
    const int c = __popc(__ballot_sync(0xffffffffu, take_a));
    const long long base = lo;
    if (c > 0) lo = base + ((long long)c * n) / 32;  // q(c - 1) + 1
    if (c < 32) hi = base + ((long long)(c + 1) * n) / 32 - 1;  // q(c)
  }
  return lo;
}

// One merge pass over every row: runs of w lanes (w >= kTile / 2) merged
// pairwise from (a, b, p) into (oa, ob, op). One block per kTile output
// lanes.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const long long* __restrict__ a, const long long* __restrict__ b,
             const int* __restrict__ p, long long* __restrict__ oa,
             long long* __restrict__ ob, int* __restrict__ op, long long n, long long w) {
  __shared__ long long sa[kPad8];
  __shared__ long long sb[kPad8];
  __shared__ int sp[kPad4];
  __shared__ long long s_split[2];
  const Tile s{sa, sb, sp};
  const long long spans = n / kTile;
  const long long row = blockIdx.x / spans;
  const long long o0 = (blockIdx.x - row * spans) * (long long)kTile;  // in the row
  const long long pair0 = o0 & ~(2 * w - 1);
  const long long d = o0 - pair0;  // the span's first diagonal in its pair
  const long long ra = row * n + pair0, rb = ra + w;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0: where the span starts; warp 1: where it ends
    const long long sp_ = split(a, b, p, ra, rb, w, d + warp * kTile);
    if ((threadIdx.x & 31) == 0) s_split[warp] = sp_;
  }
  __syncthreads();
  const long long i0 = s_split[0];
  const int la = (int)(s_split[1] - i0);  // lanes from A, staged at [0, la); B's at [la, kTile)
  const long long j0 = d - i0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const long long g = i < la ? ra + i0 + i : rb + j0 + (i - la);
    s.st(i, Tri{a[g], b[g], p[g]});
  }
  __syncthreads();
  const int k0 = threadIdx.x * kItems;
  Tri r[kItems];
  merge_items(s, 0, la, la, kTile - la, k0, r);
  __syncthreads();
  put_run(s, k0, r);
  __syncthreads();
  const long long out0 = row * n + o0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const Tri x = s.ld(i);
    oa[out0 + i] = x.a;
    ob[out0 + i] = x.b;
    op[out0 + i] = x.p;
  }
}

// Merge passes a row of n lanes takes after the tile pass.
inline int merge_passes(long long n) {
  int m = 0;
  for (long long w = n < kTile ? n : kTile; w < n; w <<= 1) ++m;
  return m;
}

// Sort every row of P x n (n a power of two) from (a, b, p) into
// (oa, ob, op), ascending by (a, b, pos). (sa, sb, sp) is scratch of
// P x n lanes, unused (may be null) when n <= kTile. Returns
// cudaGetLastError() after the last launch (0 on success), or the first
// launch error.
inline int sort_rows(const long long* a, const long long* b, const int* p,
                     long long* oa, long long* ob, int* op, long long* sa,
                     long long* sb, int* sp, long long rows, long long n,
                     cudaStream_t s) {
  if (rows <= 0 || n <= 0) return 0;
  const int t = n < kTile ? (int)n : kTile;
  const int m = merge_passes(n);
  // an odd number of merge passes starts from the scratch
  long long* xa = (m & 1) ? sa : oa;
  long long* xb = (m & 1) ? sb : ob;
  int* xp = (m & 1) ? sp : op;
  long long* ya = (m & 1) ? oa : sa;
  long long* yb = (m & 1) ? ob : sb;
  int* yp = (m & 1) ? op : sp;
  tile_sort_kernel<<<(unsigned)(rows * (n / t)), kThreads, 0, s>>>(a, b, p, xa, xb, xp, n, t);
  int err = (int)cudaGetLastError();
  if (err) return err;
  for (long long w = t; w < n; w <<= 1) {
    merge_kernel<<<(unsigned)(rows * (n / kTile)), kThreads, 0, s>>>(xa, xb, xp, ya, yb, yp, n,
                                                                      w);
    err = (int)cudaGetLastError();
    if (err) return err;
    long long* ta = xa;
    long long* tb = xb;
    int* tp = xp;
    xa = ya; xb = yb; xp = yp;
    ya = ta; yb = tb; yp = tp;
  }
  return 0;
}

}  // namespace mergesort3
