// hash_probe for Hopper (sm_90a): the direct-mode join probe,
// rows = table[keys] fused with the probe mask.
//
// Replaces the Pallas kernel `hash_probe`
// (ballista_tpu/ops/tpu/pallas_kernels.py:185, pallas_call at :164), which
// keeps the whole [T] key -> build-row table resident in VMEM (T up to
// 1<<18, 1 MB) and walks a (P, N/block) grid of 2048-row blocks.
//
// Contract (the same as the Pallas function's): keys i32 [P, N], table i32
// [T] with -1 where a key is absent, mask u8 [P, N] (0/1). Out: matched =
// mask & (table[k] >= 0), rows = matched ? table[k] : 0, so an unmatched
// probe's gather index is build row 0. Keys arrive clamped into [0, T);
// the kernel guards anyway with the engine's gather rule (a negative index
// wraps once, then every index clamps into [0, T)), so it agrees with the
// plain PyTorch form on any input.
//
// Bound: bytes. Per row it reads 4 B of key and 1 B of mask and writes 4 B
// of row and 1 B of matched; the table is read once (4T B). At 3.35 TB/s
// that is the floor; there is no arithmetic to speak of.
//
// Design. An H100 block has at most 227 KB of shared memory, not the
// megabytes of VMEM, so the table's placement is chosen by its size:
//   T * 4 <= 48 KB: every block stages the table into shared memory once
//     and then serves all its rows from there (the random lookups hit
//     shared memory, never device memory);
//   larger: lookups read the table through the read-only path (__ldg);
//     at most 1 MB under the engine's cap, it stays in the 50 MB L2.
// Each thread handles 4 consecutive rows per step with one 16-byte load of
// keys and one 4-byte load of mask, and the grid strides over the rows, so
// a block's staging is paid once for many rows. Rows past the last multiple
// of 4 are taken one at a time by one thread.
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMaxEntries = (48 * 1024) / 4;  // 12288 i32 entries

__device__ __forceinline__ int clamp_key(int k, int t) {
  if (k < 0) k += t;  // wrap once, as the engine's gathers do
  return k < 0 ? 0 : (k >= t ? t - 1 : k);
}

template <bool kShared>
__device__ __forceinline__ void probe_one(const int32_t* __restrict__ tab,
                                          int t, int k, uint8_t m,
                                          int32_t* row, uint8_t* hit) {
  const int kc = clamp_key(k, t);
  const int32_t r = kShared ? tab[kc] : __ldg(tab + kc);
  const bool matched = m != 0 && r >= 0;
  *row = matched ? r : 0;
  *hit = matched ? 1 : 0;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int32_t* __restrict__ keys,
                  const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ table, int t,
                  int32_t* __restrict__ rows, uint8_t* __restrict__ matched,
                  long long n) {
  extern __shared__ int32_t smem_table[];
  const int32_t* tab = table;
  if (kShared) {
    for (int i = threadIdx.x; i < t; i += blockDim.x) smem_table[i] = table[i];
    __syncthreads();
    tab = smem_table;
  }
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int4* keys4 = reinterpret_cast<const int4*>(keys);
  const uchar4* mask4 = reinterpret_cast<const uchar4*>(mask);
  int4* rows4 = reinterpret_cast<int4*>(rows);
  uchar4* matched4 = reinterpret_cast<uchar4*>(matched);
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n4;
       g += stride) {
    const int4 k = keys4[g];
    const uchar4 m = mask4[g];
    int4 r;
    uchar4 h;
    probe_one<kShared>(tab, t, k.x, m.x, &r.x, &h.x);
    probe_one<kShared>(tab, t, k.y, m.y, &r.y, &h.y);
    probe_one<kShared>(tab, t, k.z, m.z, &r.z, &h.z);
    probe_one<kShared>(tab, t, k.w, m.w, &r.w, &h.w);
    rows4[g] = r;
    matched4[g] = h;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (long long i = n4 << 2; i < n; ++i) {
      probe_one<kShared>(tab, t, keys[i], mask[i], rows + i, matched + i);
    }
  }
}

}  // namespace

extern "C" int hp_smem_max_entries() { return kSmemMaxEntries; }

// keys i32 [n], mask u8 [n], table i32 [t], rows i32 [n] out, matched u8
// [n] out, all contiguous; keys and rows 16-byte aligned, mask and matched
// 4-byte aligned (the wrapper ensures it). n = P * N, t >= 1.
extern "C" int hp_launch(const int32_t* keys, const uint8_t* mask,
                         const int32_t* table, int t, int32_t* rows,
                         uint8_t* matched, long long n, int num_sms,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = n >> 2;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = (long long)num_sms * 8;  // enough blocks in flight
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (t <= kSmemMaxEntries) {
    hash_probe_kernel<true><<<(int)blocks, kThreads, (size_t)t * 4, s>>>(
        keys, mask, table, t, rows, matched, n);
  } else {
    hash_probe_kernel<false><<<(int)blocks, kThreads, 0, s>>>(
        keys, mask, table, t, rows, matched, n);
  }
  return (int)cudaGetLastError();
}
