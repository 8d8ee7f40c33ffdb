// A bitonic sorting network over rows of (i64 a, i64 b, i32 pos) triples,
// split across blocks, for Hopper (sm_90a). Shared by segmented_sort.cu and
// topk_select.cu.
//
// The Pallas kernels hold one whole row in VMEM, one program per row, and
// run every compare-exchange pass (`_cx3`, pallas_kernels.py:214) over it.
// One row here is up to 2^20 lanes x 20 B = 20 MB; a block has at most
// 227 KB of shared memory. So the network runs in two kinds of step:
//   - passes whose partner distance j is below the tile (kTile lanes,
//     40 KB of shared memory) run inside one block per tile, many passes
//     per launch, with __syncthreads() between passes;
//   - passes with j >= kTile run as global compare-exchange passes, one
//     launch each, one thread per pair.
// A row of N = 2^n lanes takes 1 + sum over k > kTile of (log2(k/kTile) + 1)
// launches: 55 at 2^20. Every pass follows the classic rule of `_cx3`: the
// pair (i, i + j) sorts ascending when (i & k) == 0, descending otherwise,
// and the compare is lexicographic on (a, b, pos).
//
// Loads are element-wise (8- and 4-byte), so an input that starts off a
// 16-byte boundary needs nothing special. Rows are flattened into the grid:
// block x covers tile (x % tiles) of row (x / tiles), so P > 1 keeps the
// contract with no per-row launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bitonic3 {

constexpr int kTile = 2048;     // lanes a block sorts in shared memory (40 KB)
constexpr int kThreads = 1024;  // one compare-exchange pair per thread per pass
constexpr int kPassThreads = 256;

__device__ __forceinline__ bool gt3(long long a1, long long b1, int p1,
                                    long long a2, long long b2, int p2) {
  return a1 > a2 || (a1 == a2 && (b1 > b2 || (b1 == b2 && p1 > p2)));
}

// One block per (row, tile) of t lanes: load the tile, run the network's
// passes for k = k_lo, 2 k_lo, ..., k_hi with j from min(k, t) / 2 down to
// 1, then write the first `keep` lanes of the tile to
// dst + (row * tiles + tile) * keep. With keep == t the output layout is the
// input's, so the sort runs in place (src == dst). The direction of a pass
// follows the lane's index in its row, as the whole-row network needs
// (odd tiles end descending), or with `local` its index in the tile, so
// that every tile ends ascending (top-k's candidates).
__global__ void __launch_bounds__(kThreads)
tile_kernel(const long long* a, const long long* b, const int* p,
            long long* oa, long long* ob, int* op, long long n, int t,
            long long k_lo, long long k_hi, int keep, bool local) {
  __shared__ long long sa[kTile];
  __shared__ long long sb[kTile];
  __shared__ int sp[kTile];
  const long long tiles = n / t;
  const long long row = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long base = row * n + tile * t;
  for (int i = threadIdx.x; i < t; i += blockDim.x) {
    sa[i] = a[base + i];
    sb[i] = b[base + i];
    sp[i] = p[base + i];
  }
  __syncthreads();
  const long long lane0 = local ? 0 : tile * t;  // the tile's first lane
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = (int)((k < t ? k : t) >> 1); j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (t >> 1); q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int m = i + j;
        const bool up = ((lane0 + i) & k) == 0;
        const long long la = sa[i], ha = sa[m], lb = sb[i], hb = sb[m];
        const int lp = sp[i], hp = sp[m];
        const bool sw = up ? gt3(la, lb, lp, ha, hb, hp) : gt3(ha, hb, hp, la, lb, lp);
        if (sw) {
          sa[i] = ha; sa[m] = la;
          sb[i] = hb; sb[m] = lb;
          sp[i] = hp; sp[m] = lp;
        }
      }
      __syncthreads();
    }
  }
  const long long obase = (row * tiles + tile) * keep;
  for (int i = threadIdx.x; i < keep; i += blockDim.x) {
    oa[obase + i] = sa[i];
    ob[obase + i] = sb[i];
    op[obase + i] = sp[i];
  }
}

// One compare-exchange pass at partner distance j (>= the tile) in place
// over every row; one thread per pair, the grid striding over P * n / 2.
__global__ void __launch_bounds__(kPassThreads)
pass_kernel(long long* a, long long* b, int* p, long long n, long long k,
            long long j, long long pairs) {
  const long long half = n >> 1;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < pairs;
       q += (long long)gridDim.x * blockDim.x) {
    const long long row = q / half;
    const long long qq = q - row * half;
    const long long i = ((qq & ~(j - 1)) << 1) | (qq & (j - 1));
    const long long lo = row * n + i;
    const long long hi = lo + j;
    const bool up = (i & k) == 0;
    const long long la = a[lo], ha = a[hi], lb = b[lo], hb = b[hi];
    const int lp = p[lo], hp = p[hi];
    const bool sw = up ? gt3(la, lb, lp, ha, hb, hp) : gt3(ha, hb, hp, la, lb, lp);
    if (sw) {
      a[lo] = ha; a[hi] = la;
      b[lo] = hb; b[hi] = lb;
      p[lo] = hp; p[hi] = lp;
    }
  }
}

// Sort every row of P x n (n a power of two) from (a, b, p) into
// (oa, ob, op), ascending by (a, b, pos). Returns cudaGetLastError() after
// the last launch (0 on success), or the first launch error.
inline int sort_rows(const long long* a, const long long* b, const int* p,
                     long long* oa, long long* ob, int* op, long long rows,
                     long long n, int num_sms, cudaStream_t s) {
  if (rows <= 0 || n <= 0) return 0;
  const int t = n < kTile ? (int)n : kTile;
  const long long blocks = rows * (n / t);
  tile_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a, b, p, oa, ob, op, n, t, 2, t, t, false);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long pairs = rows * (n >> 1);
  long long pass_blocks = (pairs + kPassThreads - 1) / kPassThreads;
  const long long cap = (long long)num_sms * 16;
  if (pass_blocks > cap) pass_blocks = cap;
  if (pass_blocks < 1) pass_blocks = 1;
  for (long long k = 2LL * t; k <= n; k <<= 1) {
    for (long long j = k >> 1; j >= t; j >>= 1) {
      pass_kernel<<<(unsigned)pass_blocks, kPassThreads, 0, s>>>(oa, ob, op, n, k, j, pairs);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
    tile_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(oa, ob, op, oa, ob, op, n, t, k, k, t, false);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // namespace bitonic3
