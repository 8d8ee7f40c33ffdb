// dict_filter for Hopper (sm_90a): a string predicate over dictionary
// codes, keep = mask & lut[codes].
//
// Replaces the Pallas kernel `dict_filter`
// (ballista_tpu/ops/tpu/pallas_kernels.py:467, pallas_call at :452), which
// keeps the whole boolean LUT resident in VMEM and walks a (P, N/block)
// grid of 2048-row blocks.
//
// Contract (the same as the Pallas function's): codes i32 [P, N], lut u8
// [T] (0/1, the host-compiled truth table of `=`, `<>` or LIKE per
// dictionary entry, pow2-padded), mask u8 [P, N] (0/1). Out: keep u8
// [P, N]. Codes arrive in [0, T); the kernel guards anyway with the
// engine's gather rule (a negative index wraps once, then every index
// clamps into [0, T)), so it agrees with the plain PyTorch form on any
// input.
//
// Bound: bytes. Per row it reads 4 B of code and 1 B of mask and writes
// 1 B of keep; the LUT is read once (T B). At 3.35 TB/s that is the floor.
//
// Design: as hash_probe.cu. A LUT of up to 48 KB (T <= 49152 entries) is
// staged into shared memory once per block; a larger one (LIKE over a wide
// dictionary) is read through the read-only path (__ldg) and stays in L2.
// Each thread takes 4 consecutive rows per step (one 16-byte load of codes,
// one 4-byte load of mask, one 4-byte store), and the grid strides over
// the rows.
//
// The C interface (no PyTorch headers) is loaded with ctypes; the launch
// function returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMaxEntries = 48 * 1024;  // u8 entries

__device__ __forceinline__ int clamp_code(int c, int t) {
  if (c < 0) c += t;  // wrap once, as the engine's gathers do
  return c < 0 ? 0 : (c >= t ? t - 1 : c);
}

template <bool kShared>
__device__ __forceinline__ uint8_t keep_one(const uint8_t* __restrict__ lut,
                                            int t, int c, uint8_t m) {
  const int cc = clamp_code(c, t);
  const uint8_t v = kShared ? lut[cc] : __ldg(lut + cc);
  return (m != 0 && v != 0) ? 1 : 0;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
dict_filter_kernel(const int32_t* __restrict__ codes,
                   const uint8_t* __restrict__ mask,
                   const uint8_t* __restrict__ lut, int t,
                   uint8_t* __restrict__ keep, long long n) {
  extern __shared__ uint8_t smem_lut[];
  const uint8_t* tab = lut;
  if (kShared) {
    for (int i = threadIdx.x; i < t; i += blockDim.x) smem_lut[i] = lut[i];
    __syncthreads();
    tab = smem_lut;
  }
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int4* codes4 = reinterpret_cast<const int4*>(codes);
  const uchar4* mask4 = reinterpret_cast<const uchar4*>(mask);
  uchar4* keep4 = reinterpret_cast<uchar4*>(keep);
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < n4;
       g += stride) {
    const int4 c = codes4[g];
    const uchar4 m = mask4[g];
    uchar4 o;
    o.x = keep_one<kShared>(tab, t, c.x, m.x);
    o.y = keep_one<kShared>(tab, t, c.y, m.y);
    o.z = keep_one<kShared>(tab, t, c.z, m.z);
    o.w = keep_one<kShared>(tab, t, c.w, m.w);
    keep4[g] = o;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (long long i = n4 << 2; i < n; ++i) {
      keep[i] = keep_one<kShared>(tab, t, codes[i], mask[i]);
    }
  }
}

}  // namespace

extern "C" int df_smem_max_entries() { return kSmemMaxEntries; }

// codes i32 [n], mask u8 [n], lut u8 [t], keep u8 [n] out, all contiguous;
// codes 16-byte aligned, mask and keep 4-byte aligned (the wrapper ensures
// it). n = P * N, t >= 1.
extern "C" int df_launch(const int32_t* codes, const uint8_t* mask,
                         const uint8_t* lut, int t, uint8_t* keep,
                         long long n, int num_sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = n >> 2;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = (long long)num_sms * 8;  // enough blocks in flight
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (t <= kSmemMaxEntries) {
    dict_filter_kernel<true><<<(int)blocks, kThreads, (size_t)t, s>>>(
        codes, mask, lut, t, keep, n);
  } else {
    dict_filter_kernel<false><<<(int)blocks, kThreads, 0, s>>>(
        codes, mask, lut, t, keep, n);
  }
  return (int)cudaGetLastError();
}
