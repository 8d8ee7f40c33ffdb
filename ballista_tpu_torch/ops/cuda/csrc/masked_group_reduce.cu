// masked_group_reduce for Hopper (sm_90a): per-(partition, group) masked
// float sums and exact int counts over [P, N] lanes.
//
// Replaces the Pallas kernel `masked_group_reduce`
// (ballista_tpu/ops/tpu/pallas_kernels.py:125, pallas_call at :104), which
// builds a [block, 128] one-hot tile per 2048-row block and accumulates it
// with one MXU dot over a sequential grid (P, G/128, N/block).
//
// Bound: bytes. The function reads P*N*(4 + 4 + 1) bytes (f32 value, i32
// group id, bool mask) and writes P*G*(4 + 4); it does one add per row.
// At 3.35 TB/s that is the floor; the arithmetic is far below the f32 rate.
//
// Design. CUDA blocks run unordered and carry nothing between them, so the
// TPU kernel's in-place accumulation across row blocks becomes two passes:
//   pass 1: one block per (partition, 2048-row chunk). Each thread loads its
//           8 rows into registers once (coalesced), then for each tile of
//           16 groups accumulates the matching rows in registers; the block
//           reduces each group by a fixed warp-shuffle tree and a fixed
//           in-order sum over warps, and writes one partial per chunk.
//   pass 2: one thread per (partition, group) sums the chunk partials in
//           chunk order.
// No atomics: every float sum is taken in one fixed order, so two runs on
// the same inputs are bitwise identical (the engine's determinism rule).
// Counts are exact int32 (N < 2^31).
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kChunk = kThreads * kRowsPerThread;  // 2048 rows per block
constexpr int kTile = 16;                           // groups per register tile
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
mgr_partials(const float* __restrict__ vals, const int32_t* __restrict__ gid,
             const uint8_t* __restrict__ mask, float* __restrict__ part_sums,
             int32_t* __restrict__ part_cnts, long long n, int groups,
             int n_chunks) {
  const int chunk = blockIdx.x;
  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)p * n + (long long)chunk * kChunk;
  const long long rows_left = n - (long long)chunk * kChunk;

  float v[kRowsPerThread];
  int32_t g[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = k * kThreads + tid;
    const bool in = r < rows_left;
    const bool m = in && mask[base + r] != 0;
    v[k] = in ? vals[base + r] : 0.0f;
    g[k] = m ? gid[base + r] : -1;  // -1 never matches a group
  }

  __shared__ float red_s[kWarps][kTile];
  __shared__ int32_t red_c[kWarps][kTile];
  const long long out_base = ((long long)p * n_chunks + chunk) * groups;

  for (int g0 = 0; g0 < groups; g0 += kTile) {
    float acc_s[kTile];
    int32_t acc_c[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      acc_s[j] = 0.0f;
      acc_c[j] = 0;
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const bool hit = g[k] == g0 + j;
        acc_s[j] += hit ? v[k] : 0.0f;
        acc_c[j] += hit ? 1 : 0;
      }
    }
    // fixed-order reduction: a shuffle-down tree inside each warp
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc_s[j] += __shfl_down_sync(0xffffffffu, acc_s[j], off);
        acc_c[j] += __shfl_down_sync(0xffffffffu, acc_c[j], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        red_s[warp][j] = acc_s[j];
        red_c[warp][j] = acc_c[j];
      }
    }
    __syncthreads();
    if (tid < kTile && g0 + tid < groups) {
      float s = 0.0f;
      int32_t c = 0;
      for (int w = 0; w < kWarps; ++w) {  // warps summed in index order
        s += red_s[w][tid];
        c += red_c[w][tid];
      }
      part_sums[out_base + g0 + tid] = s;
      part_cnts[out_base + g0 + tid] = c;
    }
    __syncthreads();  // red_* are reused by the next tile
  }
}

__global__ void mgr_finish(const float* __restrict__ part_sums,
                           const int32_t* __restrict__ part_cnts,
                           float* __restrict__ sums, int32_t* __restrict__ cnts,
                           int parts, int groups, int n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)parts * groups) return;
  const long long p = i / groups;
  const long long g = i % groups;
  const float* ps = part_sums + p * n_chunks * groups + g;
  const int32_t* pc = part_cnts + p * n_chunks * groups + g;
  float s = 0.0f;
  int32_t c = 0;
  for (int k = 0; k < n_chunks; ++k) {  // chunks summed in row order
    s += ps[(long long)k * groups];
    c += pc[(long long)k * groups];
  }
  sums[i] = s;
  cnts[i] = c;
}

}  // namespace

extern "C" int mgr_chunk_rows() { return kChunk; }

// vals f32 [P, N], gid i32 [P, N], mask u8 [P, N] (0/1), all contiguous.
// part_sums f32 / part_cnts i32 [P, n_chunks, G] scratch; sums f32 /
// cnts i32 [P, G] out; n_chunks = ceil(N / mgr_chunk_rows()).
extern "C" int mgr_launch(const float* vals, const int32_t* gid,
                          const uint8_t* mask, float* part_sums,
                          int32_t* part_cnts, float* sums, int32_t* cnts,
                          int parts, long long n, int groups, int n_chunks,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid1(n_chunks, parts);
  mgr_partials<<<grid1, kThreads, 0, s>>>(vals, gid, mask, part_sums,
                                          part_cnts, n, groups, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)parts * groups;
  const int blocks2 = (int)((total + kThreads - 1) / kThreads);
  mgr_finish<<<blocks2, kThreads, 0, s>>>(part_sums, part_cnts, sums, cnts,
                                          parts, groups, n_chunks);
  return (int)cudaGetLastError();
}
