// segmented_sort for Hopper (sm_90a): a per-row ascending sort of [P, N]
// triples (i64 a, i64 b, i32 pos), N a power of two.
//
// Replaces the Pallas kernel `segmented_sort`
// (ballista_tpu/ops/tpu/pallas_kernels.py:284, pallas_call at :269, the
// network `_bitonic_sort3` :241 over `_cx3` :214), which runs the whole
// bitonic network over one VMEM-resident row per program.
//
// Contract (the Pallas function's): a, b i64 [P, N], pos i32 [P, N]; out
// the rows sorted ascending by (a, b, pos). The caller pads with (i64 max,
// i64 max) sentinels, which sort after every real row. The permutation is
// the pos output. The pos operand makes every real triple unique, so the
// output is the one sorted order, equal to the plain PyTorch form's.
//
// Bound: bytes. Each lane is read once (20 B) and written once (20 B):
// 41.9 MB at [1, 2^20], 0.0125 ms at 3.35 TB/s. A comparison sort needs
// at least N log2 N compares (2.1e7 at 2^20), each a few integer
// compares, far below the card's integer rate: what costs is the traffic
// of the passes over a row that does not fit a block.
//
// Design (mergesort3.cuh): one launch sorts every 2048-lane tile in shared
// memory, then log2(N / 2048) merge-path passes each merge pairs of runs,
// reading and writing the row once: 10 launches at 2^20. The 20 MB row
// and its scratch copy fit the 50 MB L2 together. Deterministic: no atomics, the same passes in
// the same order on every run.
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include "mergesort3.cuh"

// The lanes the tile pass sorts in shared memory.
extern "C" int ss_tile() { return mergesort3::kTile; }

// a, b i64 [P, N], pos i32 [P, N] in; oa, ob i64 and op i32 [P, N] out;
// sa, sb, sp a scratch triple of [P, N] (unused, may be null, when N <=
// ss_tile()); all contiguous. N a power of two.
extern "C" int ss_launch(const long long* a, const long long* b, const int* pos,
                         long long* oa, long long* ob, int* op, long long* sa,
                         long long* sb, int* sp, long long rows, long long n,
                         void* stream) {
  return mergesort3::sort_rows(a, b, pos, oa, ob, op, sa, sb, sp, rows, n,
                               static_cast<cudaStream_t>(stream));
}
