// A bitonic sorting network over tiles of (i64 a, i64 b, i32 pos) triples
// in shared memory, for Hopper (sm_90a). Shared by mergesort3.cuh (the
// tile pass of the full-row sort) and topk_select.cu (its candidate sets).
//
// The Pallas kernels hold one whole row in VMEM, one program per row, and
// run every compare-exchange pass (`_cx3`, pallas_kernels.py:214) over it.
// Here one block loads a tile of up to kTile lanes (40 KB of shared
// memory) and runs the network's passes over it with __syncthreads()
// between passes. Every pass follows the classic rule of `_cx3`: the pair
// (i, i + j) sorts ascending when (i & k) == 0, descending otherwise, and
// the compare is lexicographic on (a, b, pos).
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

__device__ __forceinline__ bool gt3(long long a1, long long b1, int p1,
                                    long long a2, long long b2, int p2) {
  return a1 > a2 || (a1 == a2 && (b1 > b2 || (b1 == b2 && p1 > p2)));
}

// One block per (row, tile) of t lanes: load the tile, sort it ascending
// with the whole network (k = 2, 4, ..., t; j from k / 2 down to 1), then
// write its first `keep` lanes to dst + (row * tiles + tile) * keep.
__global__ void __launch_bounds__(kThreads)
tile_kernel(const long long* a, const long long* b, const int* p,
            long long* oa, long long* ob, int* op, long long n, int t, int keep) {
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
  for (int k = 2; k <= t; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < (t >> 1); q += blockDim.x) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int m = i + j;
        const bool up = (i & k) == 0;
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

}  // namespace bitonic3
