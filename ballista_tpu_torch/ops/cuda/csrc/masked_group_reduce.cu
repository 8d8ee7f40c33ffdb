// masked_group_reduce for Hopper (sm_90a): per-(partition, group) masked
// float sums and exact int counts over [P, N] lanes.
//
// Replaces the Pallas kernel `masked_group_reduce`
// (ballista_tpu/ops/tpu/pallas_kernels.py:125, pallas_call at :104), which
// builds a [block, 128] one-hot tile per 2048-row block and accumulates it
// with one MXU dot over a sequential grid (P, G/128, N/block). A row adds
// only into its own group here: the reference's dot also multiplies a NaN
// or inf value by the zeros of every other group, which leaks NaN into
// them (ROADMAP C4); the port follows both packages' CPU engines.
//
// Bound: bytes. The function reads P*N*(4 + 4 + 1) bytes (f32 value, i32
// group id, bool mask) and writes P*G*(4 + 4); it does one add per row.
// At 3.35 TB/s that is the floor; the arithmetic is far below the f32 rate.
//
// Design. A grid sized to the card: each block takes one contiguous span
// of one row and reads it once, 16 lanes a thread a step, as four float4
// values, four int4 ids and one 16-byte mask word, loaded unconditionally
// (the mask is applied after the load). The work per row does not grow
// with G:
//   G <= 32: every thread keeps register accumulators for all groups
//            (8, 16 or 32 of them) over its whole span; one shuffle tree
//            per group and one warp-order sum run once, at the block's end;
//   G > 32:  every warp has its own shared-memory bins (f32 sum, i32
//            count: 8 B x G, 32 KB at G = 4096, so fewer warps a block).
//            Lanes of one step that hit the same group are found with
//            __match_any_sync and added into the bin one rank at a time,
//            in lane order; the block then sums its warps' bins in warp
//            order.
// Each block writes one partial per group; a second small launch sums the
// partials of a row in block order. No float atomics: every sum is taken
// in an order fixed by the shapes alone, so two runs on the same inputs
// are bitwise identical (the engine's determinism rule). Counts are exact
// int32 (N < 2^31).
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 16;          // lanes a thread takes per step
constexpr int kSmallThreads = 256;  // block of the register path
constexpr int kMaxWarps = 8;
constexpr int kSmemBudget = 200 * 1024;  // bins of the shared-memory path
constexpr unsigned kFull = 0xffffffffu;

// The 16 lanes [16c, 16c + 16) of the flattened [P, N] arrays that fall
// in [lo, hi): their values, and their group ids with -1 wherever the lane
// is outside the span, masked out, or its id lies outside [0, groups).
__device__ __forceinline__ void load_chunk(const float* __restrict__ vals,
                                           const int32_t* __restrict__ gid,
                                           const uint8_t* __restrict__ mask,
                                           long long c, long long lo, long long hi,
                                           int groups, float (&v)[kItems],
                                           int (&g)[kItems]) {
  const long long l0 = c * kItems;
  if (l0 >= lo && l0 + kItems <= hi) {  // the whole chunk: vector loads
    const float4* v4 = reinterpret_cast<const float4*>(vals + l0);
    const int4* g4 = reinterpret_cast<const int4*>(gid + l0);
    const uint4 mw = *reinterpret_cast<const uint4*>(mask + l0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x = v4[q];
      const int4 y = g4[q];
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
      g[4 * q] = y.x; g[4 * q + 1] = y.y; g[4 * q + 2] = y.z; g[4 * q + 3] = y.w;
    }
    const unsigned w[4] = {mw.x, mw.y, mw.z, mw.w};
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool m = ((w[i >> 2] >> (8 * (i & 3))) & 0xffu) != 0;
      g[i] = (m && g[i] >= 0 && g[i] < groups) ? g[i] : -1;
    }
  } else {  // a chunk cut by the span's ends: lane by lane
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long l = l0 + i;
      const bool in = l >= lo && l < hi;
      v[i] = in ? vals[l] : 0.0f;
      const int gg = in && mask[l] != 0 ? gid[l] : -1;
      g[i] = (gg >= 0 && gg < groups) ? gg : -1;
    }
  }
}

// The span of block (b, p): lanes [lo, hi) of the flattened arrays, and
// the chunks that hold them.
struct Span {
  long long lo, hi, c0, c1;
  __device__ Span(long long n, long long span, int b, int p) {
    const long long s = (long long)b * span;
    const long long e = s + span < n ? s + span : n;
    lo = (long long)p * n + s;
    hi = (long long)p * n + (e > s ? e : s);
    c0 = lo / kItems;
    c1 = hi > lo ? (hi + kItems - 1) / kItems : c0;
  }
};

// G <= NG (8, 16 or 32): register accumulators for every group.
template <int NG>
__global__ void __launch_bounds__(kSmallThreads)
mgr_small(const float* __restrict__ vals, const int32_t* __restrict__ gid,
          const uint8_t* __restrict__ mask, float* __restrict__ part_sums,
          int32_t* __restrict__ part_cnts, long long n, long long span, int groups) {
  const Span sp(n, span, blockIdx.x, blockIdx.y);
  float acc_s[NG];
  int32_t acc_c[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    acc_s[j] = 0.0f;
    acc_c[j] = 0;
  }
  for (long long c = sp.c0 + threadIdx.x; c < sp.c1; c += kSmallThreads) {
    float v[kItems];
    int g[kItems];
    load_chunk(vals, gid, mask, c, sp.lo, sp.hi, groups, v, g);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const bool hit = g[i] == j;
        acc_s[j] += hit ? v[i] : 0.0f;
        acc_c[j] += hit ? 1 : 0;
      }
    }
  }
  // once per block: a fixed shuffle-down tree in each warp, then the warps
  // summed in index order
  __shared__ float red_s[kSmallThreads / 32][NG];
  __shared__ int32_t red_c[kSmallThreads / 32][NG];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc_s[j] += __shfl_down_sync(kFull, acc_s[j], off);
      acc_c[j] += __shfl_down_sync(kFull, acc_c[j], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      red_s[warp][j] = acc_s[j];
      red_c[warp][j] = acc_c[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < groups) {
    float s = 0.0f;
    int32_t k = 0;
    for (int w = 0; w < kSmallThreads / 32; ++w) {
      s += red_s[w][threadIdx.x];
      k += red_c[w][threadIdx.x];
    }
    const long long o = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * groups + threadIdx.x;
    part_sums[o] = s;
    part_cnts[o] = k;
  }
}

// G > 32: per-warp bins in shared memory, [warps][G] sums then counts.
__global__ void mgr_bins(const float* __restrict__ vals, const int32_t* __restrict__ gid,
                         const uint8_t* __restrict__ mask, float* __restrict__ part_sums,
                         int32_t* __restrict__ part_cnts, long long n, long long span,
                         int groups) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* bin_s = smem + (long long)warp * groups;
  int32_t* bin_c = reinterpret_cast<int32_t*>(smem + (long long)warps * groups) +
                   (long long)warp * groups;
  for (int i = threadIdx.x; i < 2 * warps * groups; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  const Span sp(n, span, blockIdx.x, blockIdx.y);
  const unsigned lt_mask = (1u << lane) - 1u;
  // every lane of a warp takes the same number of steps: chunks past the
  // span load as all -1
  const long long steps = (sp.c1 - sp.c0 + blockDim.x - 1) / blockDim.x;
  for (long long st = 0; st < steps; ++st) {
    const long long c = sp.c0 + st * blockDim.x + threadIdx.x;
    float v[kItems];
    int g[kItems];
    if (c < sp.c1) {
      load_chunk(vals, gid, mask, c, sp.lo, sp.hi, groups, v, g);
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        v[i] = 0.0f;
        g[i] = -1;
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned peers = __match_any_sync(kFull, g[i]);
      const int rank = g[i] >= 0 ? __popc(peers & lt_mask) : 0;
      const int rounds = __reduce_max_sync(kFull, (unsigned)rank) + 1;
      if (g[i] >= 0 && rank == 0) bin_c[g[i]] += __popc(peers);
      // one member of every group per round, lowest lane first
      for (int r = 0; r < rounds; ++r) {
        if (g[i] >= 0 && rank == r) bin_s[g[i]] += v[i];
        __syncwarp();
      }
    }
  }
  __syncthreads();
  const float* all_s = smem;
  const int32_t* all_c = reinterpret_cast<const int32_t*>(smem + (long long)warps * groups);
  const long long o = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * groups;
  for (int j = threadIdx.x; j < groups; j += blockDim.x) {
    float s = 0.0f;
    int32_t k = 0;
    for (int w = 0; w < warps; ++w) {  // warps summed in index order
      s += all_s[(long long)w * groups + j];
      k += all_c[(long long)w * groups + j];
    }
    part_sums[o + j] = s;
    part_cnts[o + j] = k;
  }
}

// One thread per (partition, group): the blocks' partials in block order.
__global__ void mgr_finish(const float* __restrict__ part_sums,
                           const int32_t* __restrict__ part_cnts,
                           float* __restrict__ sums, int32_t* __restrict__ cnts,
                           int parts, int groups, int blocks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)parts * groups) return;
  const long long p = i / groups;
  const long long g = i % groups;
  const float* ps = part_sums + p * blocks * groups + g;
  const int32_t* pc = part_cnts + p * blocks * groups + g;
  float s = 0.0f;
  int32_t c = 0;
  for (int k = 0; k < blocks; ++k) {
    s += ps[(long long)k * groups];
    c += pc[(long long)k * groups];
  }
  sums[i] = s;
  cnts[i] = c;
}

int bin_warps(int groups) {
  const int w = kSmemBudget / (8 * groups);
  return w < kMaxWarps ? w : kMaxWarps;
}

}  // namespace

// vals f32 [P, N], gid i32 [P, N], mask u8 [P, N] (0/1), all contiguous
// and 16-byte aligned. part_sums f32 / part_cnts i32 [P, blocks, G]
// scratch; sums f32 / cnts i32 [P, G] out. Block b of a row takes lanes
// [b * span, (b + 1) * span); blocks * span >= N, span a multiple of 16.
// G in [1, 4096].
extern "C" int mgr_launch(const float* vals, const int32_t* gid, const uint8_t* mask,
                          float* part_sums, int32_t* part_cnts, float* sums,
                          int32_t* cnts, int parts, long long n, int groups, int blocks,
                          long long span, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, parts);
  if (groups <= 8) {
    mgr_small<8><<<grid, kSmallThreads, 0, s>>>(vals, gid, mask, part_sums, part_cnts, n,
                                                span, groups);
  } else if (groups <= 16) {
    mgr_small<16><<<grid, kSmallThreads, 0, s>>>(vals, gid, mask, part_sums, part_cnts, n,
                                                 span, groups);
  } else if (groups <= 32) {
    mgr_small<32><<<grid, kSmallThreads, 0, s>>>(vals, gid, mask, part_sums, part_cnts, n,
                                                 span, groups);
  } else {
    const int warps = bin_warps(groups);
    const int smem = 8 * warps * groups;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(mgr_bins, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    mgr_bins<<<grid, 32 * warps, smem, s>>>(vals, gid, mask, part_sums, part_cnts, n, span,
                                           groups);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)parts * groups;
  mgr_finish<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(part_sums, part_cnts, sums, cnts,
                                                             parts, groups, blocks);
  return (int)cudaGetLastError();
}
