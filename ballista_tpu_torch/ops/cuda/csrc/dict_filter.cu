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
// dictionary entry, pow2-padded), mask u8 [P, N] (0/1) or none, which
// keeps every row. Out: keep u8 [P, N]. Codes arrive in [0, T); the
// kernel guards anyway with the engine's gather rule (a negative index
// wraps once, then every index clamps into [0, T)), so it agrees with the
// plain PyTorch form on any input. Every output byte is a pure function
// of its row, so reruns are bitwise identical.
//
// Bound: bytes. Per row it reads 4 B of code and 1 B of mask (none without
// one) and writes 1 B of keep; the LUT is read once (T B). At 3.35 TB/s
// that is the floor; a lookup is a few integer operations.
//
// Design (the first kernel kept a byte LUT of up to 48 KB in shared memory,
// read a larger one byte by byte through __ldg, and had one 16-byte code
// load in flight a thread, in a grid of 8 blocks an SM):
// - The LUT as bits (entry e at bit e & 31 of word e >> 5), in one of three
//   regimes chosen from T before the launch
//   (cuda_kernels.dict_filter_regime):
//     register (T <= 32): every warp packs the LUT into one 32-bit word with
//       a ballot; a lookup is a shift;
//     shared (up to what a CTA's opt-in shared memory holds, 1,859,584
//       entries on an H100): every CTA packs the byte LUT into a bitmap in
//       shared memory as it stages it (16 entries a lane from one 16-byte
//       load, two lanes a word); past 16384 entries (cuda_kernels.DF_CTA_PACK_MAX) one small
//       launch packs it first and every CTA copies the bits, an eighth of
//       the bytes (at 2^17 the CTAs' own packing read 1056 x 128 KB through
//       L2 and cost more than the row stream's gain, PERF.md);
//     global (larger): one small launch of this library packs the bitmap
//       into device memory (T / 8 bytes: 2 MB at T = 2^24, where the byte
//       LUT is 16 MB), and lookups read it through L1 and L2.
// - The row stream: a persistent grid, as many CTAs as the card holds at
//   once at the CTA's shared memory (8 of 256 threads an SM without a
//   bitmap), every thread keeping kUnroll 16-byte code loads (and 4-byte
//   mask loads) in flight in registers and writing 4 keep bytes a load.
//   The rows past the last multiple of 4 are taken one a thread by the
//   first CTA. A ring of shared-memory stages filled by 1-D bulk copies
//   (cp.async.bulk on mbarriers, 4 stages of 4096 rows, one thread
//   refilling a stage after a CTA-wide barrier, 16-byte stores of 16 rows
//   a thread) was built and measured beside it on an H100: 10-15% slower
//   at every T and at every ring depth and CTA size tried (PERF.md). Its
//   82 KB ring left 2 CTAs (16 warps) an SM, and every tile waited on the
//   barrier and on the one thread that refilled it, where this stream
//   keeps 64 warps an SM loading with no barrier at all; the bytes it
//   moves are the same, so the memory is kept busier without the ring.
// - Without a mask (the negated forms and non-null columns) the mask's
//   bytes are never read: a null pointer goes through the C interface.
//
// The C interface (no PyTorch headers) is loaded with ctypes. The caller
// prepares the kernels once per card (df_prepare) and sizes the grid once
// per card, regime and LUT length (df_max_ctas); a launch makes no other
// runtime call. The launch function returns cudaGetLastError(), so a
// refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // threads of a CTA
constexpr int kUnroll = 4;       // 16-byte code loads in flight a thread
constexpr int kRegisterMax = 32;  // entries of the register regime

// the order of cuda_kernels._DF_REGIMES
enum Regime { kRegister = 0, kShared = 1, kGlobal = 2 };

__device__ __forceinline__ int clamp_code(int c, int t) {
  if (c < 0) c += t;  // wrap once, as the engine's gathers do
  return c < 0 ? 0 : (c >= t ? t - 1 : c);
}

// 0x01 in each byte of `m` that is not zero
__device__ __forceinline__ uint32_t mask_bytes(uint32_t m) {
  return __vcmpne4(m, 0u) & 0x01010101u;
}

// The LUT as bits, where the regime keeps it.
template <int kRegime>
struct Bits {
  uint32_t word;          // register: entries [0, 32)
  const uint32_t* words;  // shared: the CTA's bitmap; global: the packed one
  int t;

  __device__ __forceinline__ uint32_t bit(int c) const {
    const int cc = clamp_code(c, t);
    if constexpr (kRegime == kRegister) {
      return (word >> cc) & 1u;
    } else if constexpr (kRegime == kShared) {
      return (words[cc >> 5] >> (cc & 31)) & 1u;
    } else {
      return (__ldg(words + (cc >> 5)) >> (cc & 31)) & 1u;
    }
  }

  // the keep bytes (0 or 1 each) of 4 rows, before the mask
  __device__ __forceinline__ uint32_t bits4(int4 c) const {
    return bit(c.x) | (bit(c.y) << 8) | (bit(c.z) << 16) | (bit(c.w) << 24);
  }
};

// bits 0-3: which of the 4 bytes of `x` are not zero
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// The bits of LUT entries [16q, 16q + 16), 0 past t. The LUT is 16-byte
// aligned (the wrapper ensures it).
__device__ __forceinline__ uint32_t chunk_bits(const uint8_t* __restrict__ lut, int t, int q) {
  const int e = q * 16;
  if (e + 16 <= t) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(lut) + q);
    return nibble(v.x) | (nibble(v.y) << 4) | (nibble(v.z) << 8) | (nibble(v.w) << 12);
  }
  uint32_t b = 0;
  for (int j = 0; e + j < t; ++j) b |= (lut[e + j] != 0 ? 1u : 0u) << j;
  return b;
}

// Pack the byte LUT into words [0, ceil(t / 32)). A thread starts at chunk
// `first` and steps by `step` (a multiple of 32), with first & 31 its lane,
// so each even lane holds the low half of a word and takes the high half
// from its odd neighbour. The trip count is the warp's, so every lane is
// there for the shuffle.
__device__ __forceinline__ void pack_bits(const uint8_t* __restrict__ lut, int t,
                                          uint32_t* words, long long first, long long step) {
  const long long chunks = ((long long)t + 15) >> 4;
  const int lane = threadIdx.x & 31;
  for (long long q = first; q - lane < chunks; q += step) {
    const uint32_t b = q < chunks ? chunk_bits(lut, t, (int)q) : 0u;
    const uint32_t hi = __shfl_down_sync(0xffffffffu, b, 1);
    if ((lane & 1) == 0 && q < chunks) words[q >> 1] = b | (hi << 16);
  }
}

// Copy the packed bitmap's `words` words (16-byte aligned) into shared memory.
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* __restrict__ src,
                                           int words) {
  const int n4 = words >> 2;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = __ldg(s4 + i);
  for (int i = (n4 << 2) + threadIdx.x; i < words; i += blockDim.x) dst[i] = __ldg(src + i);
}

// Every thread of the CTA: the LUT's bits in the regime's place. `bitmap`
// is the CTA's shared bitmap (shared regime); `packed`, where not null,
// the bitmap df_pack wrote, which the shared regime copies instead of
// packing the byte LUT itself.
template <int kRegime>
__device__ __forceinline__ Bits<kRegime> stage_bits(const uint8_t* __restrict__ lut,
                                                    const uint32_t* __restrict__ packed, int t,
                                                    uint32_t* bitmap) {
  Bits<kRegime> b;
  b.t = t;
  b.word = 0;
  b.words = packed;
  if constexpr (kRegime == kRegister) {
    const int lane = threadIdx.x & 31;
    b.word = __ballot_sync(0xffffffffu, lane < t && lut[lane] != 0);
  } else if constexpr (kRegime == kShared) {
    if (packed != nullptr) {
      copy_words(bitmap, packed, (t + 31) >> 5);
    } else {
      pack_bits(lut, t, bitmap, threadIdx.x, blockDim.x);
    }
    __syncthreads();
    b.words = bitmap;
  }
  return b;
}

// One row past the last multiple of 4, taken by its own thread.
template <int kRegime>
__device__ __forceinline__ void keep_row(const int32_t* __restrict__ codes,
                                         const uint8_t* __restrict__ mask, const Bits<kRegime>& b,
                                         uint8_t* __restrict__ keep, long long i) {
  const uint32_t v = b.bit(codes[i]);
  keep[i] = (uint8_t)((mask == nullptr || mask[i] != 0) ? v : 0u);
}

// ---- the row stream

template <int kRegime>
__global__ void __launch_bounds__(kThreads)
df_filter(const int32_t* __restrict__ codes, const uint8_t* __restrict__ mask,
          const uint8_t* __restrict__ lut, const uint32_t* __restrict__ packed, int t,
          uint8_t* __restrict__ keep, long long n) {
  extern __shared__ __align__(128) uint8_t df_smem[];  // the bitmap (shared regime)
  const Bits<kRegime> b =
      stage_bits<kRegime>(lut, packed, t, reinterpret_cast<uint32_t*>(df_smem));
  const bool masked = mask != nullptr;
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int4* codes4 = reinterpret_cast<const int4*>(codes);
  const uint32_t* mask4 = reinterpret_cast<const uint32_t*>(mask);
  uint32_t* keep4 = reinterpret_cast<uint32_t*>(keep);
  for (long long g0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; g0 < n4;
       g0 += stride * kUnroll) {
    int4 c[kUnroll];
    uint32_t m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = g0 + u * stride;
      if (g < n4) {
        c[u] = __ldcs(codes4 + g);
        m[u] = masked ? __ldcs(mask4 + g) : 0x01010101u;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = g0 + u * stride;
      if (g < n4) keep4[g] = b.bits4(c[u]) & mask_bytes(m[u]);
    }
  }
  if (blockIdx.x == 0 && (long long)threadIdx.x < n - (n4 << 2)) {
    keep_row<kRegime>(codes, mask, b, keep, (n4 << 2) + threadIdx.x);
  }
}

// ---- the packed bitmap (global regime; shared past DF_CTA_PACK_MAX)

__global__ void __launch_bounds__(kThreads)
df_pack(const uint8_t* __restrict__ lut, int t, uint32_t* __restrict__ words) {
  pack_bits(lut, t, words, (long long)blockIdx.x * blockDim.x + threadIdx.x,
            (long long)gridDim.x * blockDim.x);
}

const void* kernel_of(int regime) {
  return regime == kRegister ? (const void*)df_filter<kRegister>
         : regime == kShared ? (const void*)df_filter<kShared>
                             : (const void*)df_filter<kGlobal>;
}

bool valid(int regime, int t) {
  return regime >= kRegister && regime <= kGlobal && t >= 1 &&
         (regime != kRegister || t <= kRegisterMax);
}

// The dynamic shared memory of one CTA: the shared regime's bitmap.
size_t smem_bytes(int regime, int t) {
  return regime == kShared ? (size_t)((t + 31) / 32) * 4 : 0;
}

}  // namespace

// Let the shared regime's kernel take `optin` bytes of shared memory on the
// current device. Once per device, before df_max_ctas and df_launch.
extern "C" int df_prepare(int optin) {
  return (int)cudaFuncSetAttribute(kernel_of(kShared),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

// The most CTAs of `regime` resident on the current device at once for a
// LUT of t entries: the persistent grid. A configuration no CTA of which
// fits returns cudaErrorInvalidConfiguration.
extern "C" int df_max_ctas(int regime, int t, int* ctas) {
  if (!valid(regime, t)) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(regime), kThreads,
                                                      smem_bytes(regime, t));
  }
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *ctas = per_sm * sms;
  return 0;
}

// codes i32 [n], mask u8 [n] or null (every row kept), lut u8 [t], keep u8
// [n] out, all contiguous and 16-byte aligned (the wrapper ensures it);
// packed: u32 [ceil(t / 32)] 16-byte aligned scratch, or null: where given,
// df_pack writes the bitmap there first (the global regime needs it; the
// shared regime then copies it instead of packing the byte LUT in every
// CTA). n = P * N, t >= 1. regime: 0 register, 1 shared, 2 global; ctas:
// df_max_ctas()'s grid, whose kernel df_prepare() readied.
extern "C" int df_launch(const int32_t* codes, const uint8_t* mask, const uint8_t* lut, int t,
                         uint32_t* packed, uint8_t* keep, long long n, int regime, int ctas,
                         void* stream) {
  if (!valid(regime, t) || (regime == kGlobal && packed == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed != nullptr) {
    const long long chunks = ((long long)t + 15) >> 4;
    long long blocks = (chunks + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    df_pack<<<(int)blocks, kThreads, 0, s>>>(lut, t, packed);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = ((n >> 2) + kThreads - 1) / kThreads;
  if (blocks > ctas) blocks = ctas;
  if (blocks < 1) blocks = 1;
  const size_t bytes = smem_bytes(regime, t);
  const int grid = (int)blocks;
  if (regime == kRegister) {
    df_filter<kRegister><<<grid, kThreads, bytes, s>>>(codes, mask, lut, packed, t, keep, n);
  } else if (regime == kShared) {
    df_filter<kShared><<<grid, kThreads, bytes, s>>>(codes, mask, lut, packed, t, keep, n);
  } else {
    df_filter<kGlobal><<<grid, kThreads, bytes, s>>>(codes, mask, lut, packed, t, keep, n);
  }
  return (int)cudaGetLastError();
}
