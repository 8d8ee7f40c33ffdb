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
// it equals the plain form's exactly.
//
// Bound: bytes. Each lane is read once (20 B) and each output lane written
// once: 21 MB at [1, 2^20], 0.0063 ms at 3.35 TB/s.
//
// Design. A row of 2^20 lanes does not fit a block, so:
//   1. one block per 2048-lane tile sorts the tile in shared memory
//      (bitonic3.cuh) and writes its first C lanes: the tile's candidates;
//   2. fold launches: one block takes 2048 / C candidate sets of a row,
//      folds them pairwise in shared memory as the Pallas kernel does, and
//      writes one set; repeated until one set per row is left (3 fold
//      launches at 2^20 with C = 128).
// The row is read from device memory once; the candidate sets are 1/16 of
// it at C = 128. A C above the tile (k > 2048) sorts the rows whole with
// segmented_sort's merge sort (mergesort3.cuh) into scratch and keeps the
// first C lanes.
// Deterministic: no atomics.
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include "mergesort3.cuh"

namespace {

using bitonic3::gt3;
using bitonic3::kThreads;
using bitonic3::kTile;

// Input: sets [rows, sets, c], each set ascending. One block folds g
// consecutive sets of one row into the c smallest of their union,
// ascending, written to dst [rows, sets / g, c]. g * c <= kTile.
__global__ void __launch_bounds__(kThreads)
fold_kernel(const long long* a, const long long* b, const int* p,
            long long* oa, long long* ob, int* op, long long sets, int c, int g) {
  __shared__ long long sa[kTile];
  __shared__ long long sb[kTile];
  __shared__ int sp[kTile];
  const long long groups = sets / g;
  const long long row = blockIdx.x / groups;
  const long long grp = blockIdx.x % groups;
  const long long base = (row * sets + grp * g) * (long long)c;
  const int len = g * c;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    sa[i] = a[base + i];
    sb[i] = b[base + i];
    sp[i] = p[base + i];
  }
  __syncthreads();
  const int half = (c + 1) >> 1;
  for (int s = 1; s < g; s <<= 1) {
    // set x (a multiple of 2s) keeps min(x[i], (x+s)[c-1-i]) at each i: the
    // c smallest of the two, as one bitonic sequence
    const int pairs = g / (2 * s);
    for (int q = threadIdx.x; q < pairs * half; q += blockDim.x) {
      const int x = (q / half) * 2 * s * c;
      const int y = x + s * c;
      const int i = q % half;
      const int i2 = c - 1 - i;
      const long long xa = sa[x + i], xb = sb[x + i];
      const int xp = sp[x + i];
      const long long xa2 = sa[x + i2], xb2 = sb[x + i2];
      const int xp2 = sp[x + i2];
      const long long ya = sa[y + i], yb = sb[y + i];
      const int yp = sp[y + i];
      const long long ya2 = sa[y + i2], yb2 = sb[y + i2];
      const int yp2 = sp[y + i2];
      // lane i against the other set's lane c-1-i, and lane c-1-i against i
      if (gt3(xa, xb, xp, ya2, yb2, yp2)) {
        sa[x + i] = ya2; sb[x + i] = yb2; sp[x + i] = yp2;
      }
      if (i2 != i && gt3(xa2, xb2, xp2, ya, yb, yp)) {
        sa[x + i2] = ya; sb[x + i2] = yb; sp[x + i2] = yp;
      }
    }
    __syncthreads();
    // bitonic merge of every live set, ascending (`_cx3` with k = C)
    const int hc = c >> 1;
    for (int j = hc; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < pairs * hc; q += blockDim.x) {
        const int x = (q / hc) * 2 * s * c;
        const int qq = q % hc;
        const int i = x + (((qq & ~(j - 1)) << 1) | (qq & (j - 1)));
        const int m = i + j;
        if (gt3(sa[i], sb[i], sp[i], sa[m], sb[m], sp[m])) {
          const long long ta = sa[i], tb = sb[i];
          const int tp = sp[i];
          sa[i] = sa[m]; sb[i] = sb[m]; sp[i] = sp[m];
          sa[m] = ta; sb[m] = tb; sp[m] = tp;
        }
      }
      __syncthreads();
    }
  }
  const long long obase = (row * groups + grp) * (long long)c;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    oa[obase + i] = sa[i];
    ob[obase + i] = sb[i];
    op[obase + i] = sp[i];
  }
}

}  // namespace

// The tile the first pass sorts in shared memory (lanes).
extern "C" int tk_tile() { return kTile; }

// a, b i64 [P, N], pos i32 [P, N] in; oa, ob i64 and op i32 [P, C] out; two
// scratch triples s1 and s2 of P * (N / min(N, tile)) * C lanes each, or,
// when C > the tile, of P * N lanes each (the sort's output and its
// scratch). All contiguous; N and C powers of two with C <= N.
extern "C" int tk_launch(const long long* a, const long long* b, const int* pos,
                         long long* oa, long long* ob, int* op,
                         long long* s1a, long long* s1b, int* s1p,
                         long long* s2a, long long* s2b, int* s2p,
                         long long rows, long long n, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || c <= 0) return 0;
  if (c > kTile) {
    int err = mergesort3::sort_rows(a, b, pos, s1a, s1b, s1p, s2a, s2b, s2p, rows, n, s);
    if (err) return err;
    // the first C lanes of every row
    const size_t w8 = (size_t)c * 8, w4 = (size_t)c * 4;
    cudaMemcpy2DAsync(oa, w8, s1a, (size_t)n * 8, w8, (size_t)rows, cudaMemcpyDeviceToDevice, s);
    cudaMemcpy2DAsync(ob, w8, s1b, (size_t)n * 8, w8, (size_t)rows, cudaMemcpyDeviceToDevice, s);
    cudaMemcpy2DAsync(op, w4, s1p, (size_t)n * 4, w4, (size_t)rows, cudaMemcpyDeviceToDevice, s);
    return (int)cudaGetLastError();
  }
  const int t = n < kTile ? (int)n : kTile;
  long long sets = n / t;
  long long* ca = sets == 1 ? oa : s1a;
  long long* cb = sets == 1 ? ob : s1b;
  int* cp = sets == 1 ? op : s1p;
  bitonic3::tile_kernel<<<(unsigned)(rows * sets), kThreads, 0, s>>>(
      a, b, pos, ca, cb, cp, n, t, c);
  int err = (int)cudaGetLastError();
  if (err) return err;
  long long* na = s2a;
  long long* nb = s2b;
  int* np = s2p;
  while (sets > 1) {
    const long long g = (kTile / c) < sets ? (kTile / c) : sets;
    const long long groups = sets / g;
    long long* da = groups == 1 ? oa : na;
    long long* db = groups == 1 ? ob : nb;
    int* dp = groups == 1 ? op : np;
    fold_kernel<<<(unsigned)(rows * groups), kThreads, 0, s>>>(
        ca, cb, cp, da, db, dp, sets, c, (int)g);
    err = (int)cudaGetLastError();
    if (err) return err;
    na = ca; nb = cb; np = cp;  // ping-pong: the consumed sets become scratch
    ca = da; cb = db; cp = dp;
    sets = groups;
  }
  return 0;
}
