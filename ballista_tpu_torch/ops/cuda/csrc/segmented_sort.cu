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
// 41.9 MB at [1, 2^20], 0.0125 ms at 3.35 TB/s. The network does
// N/2 * log2(N) * (log2(N) + 1) / 2 compare-exchanges (1.1e8 at 2^20), each
// a few integer compares, far below the card's integer rate: what costs is
// the traffic of the passes that cannot stay in shared memory.
//
// Design (bitonic3.cuh): the row is split into 2048-lane tiles. One launch
// sorts every tile in shared memory; then for each merge size k above the
// tile, one global pass per partner distance j >= 2048 and one launch that
// finishes the passes j < 2048 in shared memory. 55 launches at 2^20, each
// over the 20 MB row, which the 50 MB L2 can hold. Deterministic: no
// atomics, the same passes in the same order on every run.
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include "bitonic3.cuh"

// a, b i64 [P, N], pos i32 [P, N] in; oa, ob i64 and op i32 [P, N] out, all
// contiguous. N a power of two.
extern "C" int ss_launch(const long long* a, const long long* b, const int* pos,
                         long long* oa, long long* ob, int* op, long long rows,
                         long long n, int num_sms, void* stream) {
  return bitonic3::sort_rows(a, b, pos, oa, ob, op, rows, n, num_sms,
                             static_cast<cudaStream_t>(stream));
}
