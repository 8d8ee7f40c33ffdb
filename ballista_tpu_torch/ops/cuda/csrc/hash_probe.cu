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
// plain PyTorch form on any input. Every output is a pure function of its
// row, so reruns are bitwise identical.
//
// Bound: bytes. Per row it reads 4 B of key and 1 B of mask and writes 4 B
// of row and 1 B of matched; the table is read once (4T B). At 3.35 TB/s
// that is the floor; there is no arithmetic to speak of.
//
// Design. The lookups are random 4-byte reads. Read through L2 (__ldg, or
// torch.take) each is one 32-byte sector and one pass of the L1TEX pipe,
// and at [8, 2^23] rows they, not the 671 MB stream, set the time: about
// 0.26 ms on top of the stream's 0.24 on an H100 (PERF.md). A lookup in the
// block's own shared memory costs next to nothing, so the table goes
// there wherever it fits, in one of five regimes chosen from T before the
// launch (cuda_kernels.hash_probe_regime; S = one block's opt-in shared
// memory in entries, 58,112 on an H100):
//   shared  (T <= 12288, 48 KB): every block of a grid of up to 8 blocks an
//           SM stages the table with plain loads and serves its rows from
//           it (the first kernel's design);
//   block   (T <= S): the same with the opt-in limit, in a persistent grid
//           of as many blocks as fit on each SM, each thread keeping
//           kUnroll 16-byte key loads in flight;
//   split   (S < T, up to where the cluster regime wins): every block holds
//           the table's first S entries and reads the rest through L2;
//   cluster (up to 8 S): a thread-block cluster of kCluster = 2 CTAs (the
//           two SMs of a TPC) holds 2 S entries, each CTA a contiguous
//           half, and reads the rest through L2. A CTA reads its own half
//           from shared memory and its peer's through distributed shared
//           memory (mapa + ld.shared::cluster). The cluster syncs after
//           staging and again before any CTA exits, so no half goes while
//           the peer may read it. A random read from the peer costs about
//           what one through L2 does, so the pair beats split only once
//           most of the table is past S (PERF.md);
//   global  (larger): lookups read the table through the read-only path
//           (__ldg) and L2 (the first kernel's design).
// In every regime a thread takes 4 consecutive rows per step with one
// 16-byte load of keys and one 4-byte load of mask, and the grid strides
// over the rows; the staged regimes (block, split, cluster) look up only
// the rows the mask keeps. Rows past the last multiple of 4 are taken one
// at a time by the grid's first thread.
//
// The C interface (no PyTorch headers) is loaded with ctypes. The caller
// prepares a staged kernel once per device (hp_prepare) and sizes its
// persistent grid once per table (hp_max_ctas); a launch makes no other
// runtime call. The launch function returns the launch's error, or
// cudaGetLastError(), so a refused launch (a cluster the card cannot
// schedule included) is reported.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                     // shared and global regimes
constexpr int kSmemMaxEntries = (48 * 1024) / 4;  // 12288 i32 entries
constexpr int kStagedThreads = 512;               // block, split and cluster regimes
constexpr int kUnroll = 4;                        // 16-byte key loads in flight a thread
constexpr int kGranule = 8;                       // entries of one 32-byte granule
constexpr int kCluster = 2;                       // CTAs of a cluster

// the order of cuda_kernels._HP_REGIMES
enum Regime { kRegimeShared = 0, kRegimeBlock = 1, kRegimeSplit = 2, kRegimeCluster = 3,
              kRegimeGlobal = 4 };

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

// ---- the staged regimes: block, split and cluster

// What a launch's blocks hold, for one launch.
struct Slices {
  int held;   // entries [0, held) sit in shared memory; the rest are read through L2
  int slice;  // cluster: entries a CTA holds (a multiple of kGranule)
};

// Read entry `off` of cluster CTA `rank`'s shared table through
// distributed shared memory.
__device__ __forceinline__ int32_t ld_cluster(uint32_t base, uint32_t off, uint32_t rank) {
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(base + off * 4), "r"(rank));
  int32_t v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(remote));
  return v;
}

template <bool kInCluster>
__device__ __forceinline__ int32_t lookup(const int32_t* smem, uint32_t base, uint32_t rank,
                                          const int32_t* __restrict__ table, int kc,
                                          const Slices& sl) {
  if (kc >= sl.held) return __ldg(table + kc);  // past what the blocks hold
  if constexpr (!kInCluster) {
    return smem[kc];
  } else {
    const uint32_t owner = kc >= sl.slice ? 1u : 0u;
    const uint32_t off = (uint32_t)kc - owner * (uint32_t)sl.slice;
    if (owner == rank) return smem[off];  // the CTA's own half
    return ld_cluster(base, off, owner);
  }
}

// Copy `cnt` entries from `src` (16-byte aligned) into shared `dst`.
__device__ __forceinline__ void copy_entries(int32_t* dst, const int32_t* __restrict__ src,
                                             int cnt) {
  const int n4 = cnt >> 2;
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
  for (int i = (n4 << 2) + threadIdx.x; i < cnt; i += blockDim.x) dst[i] = src[i];
}

template <bool kInCluster>
__device__ __forceinline__ void probe_row(const int32_t* smem, uint32_t base, uint32_t rank,
                                          const int32_t* __restrict__ table, const Slices& sl,
                                          int t, int k, uint8_t m, int32_t* row, uint8_t* hit) {
  // a masked-out row's entry is never read: it costs no lookup
  const int32_t r = m != 0 ? lookup<kInCluster>(smem, base, rank, table, clamp_key(k, t), sl)
                           : -1;
  const bool matched = r >= 0;
  *row = matched ? r : 0;
  *hit = matched ? 1 : 0;
}

template <bool kInCluster>
__global__ void __launch_bounds__(kStagedThreads)
hash_probe_staged(const int32_t* __restrict__ keys, const uint8_t* __restrict__ mask,
                  const int32_t* __restrict__ table, int t, Slices sl,
                  int32_t* __restrict__ rows, uint8_t* __restrict__ matched, long long n) {
  extern __shared__ __align__(16) int32_t staged_table[];
  uint32_t rank = 0;
  if constexpr (kInCluster) {
    rank = cg::this_cluster().block_rank();
    const int first = (int)rank * sl.slice;
    const int cnt = min(sl.slice, sl.held - first);
    if (cnt > 0) copy_entries(staged_table, table + first, cnt);
    cg::this_cluster().sync();  // both halves staged before any lookup
  } else {
    copy_entries(staged_table, table, sl.held);
    __syncthreads();
  }
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(staged_table);

  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int4* keys4 = reinterpret_cast<const int4*>(keys);
  const uchar4* mask4 = reinterpret_cast<const uchar4*>(mask);
  int4* rows4 = reinterpret_cast<int4*>(rows);
  uchar4* matched4 = reinterpret_cast<uchar4*>(matched);
  for (long long g0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; g0 < n4;
       g0 += stride * kUnroll) {
    int4 k[kUnroll];
    uchar4 m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = g0 + u * stride;
      if (g < n4) {
        k[u] = keys4[g];
        m[u] = mask4[g];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long g = g0 + u * stride;
      if (g < n4) {
        int4 r;
        uchar4 h;
        probe_row<kInCluster>(staged_table, base, rank, table, sl, t, k[u].x, m[u].x, &r.x, &h.x);
        probe_row<kInCluster>(staged_table, base, rank, table, sl, t, k[u].y, m[u].y, &r.y, &h.y);
        probe_row<kInCluster>(staged_table, base, rank, table, sl, t, k[u].z, m[u].z, &r.z, &h.z);
        probe_row<kInCluster>(staged_table, base, rank, table, sl, t, k[u].w, m[u].w, &r.w, &h.w);
        rows4[g] = r;
        matched4[g] = h;
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (long long i = n4 << 2; i < n; ++i) {
      probe_row<kInCluster>(staged_table, base, rank, table, sl, t, keys[i], mask[i], rows + i,
                            matched + i);
    }
  }
  if constexpr (kInCluster) cg::this_cluster().sync();  // no half leaves while the peer reads it
}

bool staged_regime(int regime) {
  return regime == kRegimeBlock || regime == kRegimeSplit || regime == kRegimeCluster;
}

const void* staged_kernel(int regime) {
  return regime == kRegimeCluster ? (const void*)hash_probe_staged<true>
                                  : (const void*)hash_probe_staged<false>;
}

// What a staged launch's blocks hold, and the dynamic shared memory of
// one CTA. S = the opt-in shared memory in whole 32-byte granules: a block
// holds the whole table up to S entries (block), the first S (split); a
// cluster holds up to 2 S, a contiguous half in each CTA. 0 bytes: the
// regime does not take a table of t entries.
Slices slices_of(int regime, int t, int optin, size_t* bytes) {
  Slices sl = {0, 0};
  const int s_max = optin / 32 * kGranule;
  *bytes = 0;
  if (regime == kRegimeCluster) {
    sl.held = t < kCluster * s_max ? t : kCluster * s_max;
    const int per = (sl.held + kCluster - 1) / kCluster;
    sl.slice = (per + kGranule - 1) / kGranule * kGranule;
    *bytes = (size_t)sl.slice * 4;
  } else if (regime == kRegimeSplit ? t > s_max : t <= s_max) {
    sl.held = min(t, s_max);
    *bytes = (size_t)((sl.held + 3) / 4) * 16;
  }
  return sl;
}

cudaLaunchConfig_t staged_config(int blocks, size_t bytes, cudaStream_t s,
                                 cudaLaunchAttribute* attr, bool in_cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kStagedThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  if (in_cluster) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = kCluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

}  // namespace

// The shared regime's ceiling (entries): the default 48 KB limit.
extern "C" int hp_smem_max_entries() { return kSmemMaxEntries; }

// The opt-in shared memory of one block on `device`, in bytes.
extern "C" int hp_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Let the staged kernel of `regime` (block, split or cluster) take `optin`
// bytes of shared memory on the current device, shared memory preferred
// over L1. Once per device and regime, before hp_max_ctas and hp_launch.
extern "C" int hp_prepare(int regime, int optin) {
  if (!staged_regime(regime)) return (int)cudaErrorInvalidValue;
  const void* fn = staged_kernel(regime);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
}

// The most CTAs of a staged regime that are resident on the current device
// at once, for a table of t entries: the persistent grid. A table the
// regime does not take returns cudaErrorInvalidValue; a configuration the
// card cannot schedule (no block, or no cluster, fits),
// cudaErrorInvalidConfiguration.
extern "C" int hp_max_ctas(int t, int regime, int optin, int* ctas) {
  if (!staged_regime(regime)) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  slices_of(regime, t, optin, &bytes);
  if (bytes == 0 || bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const void* fn = staged_kernel(regime);
  int n = 0;
  cudaError_t e;
  if (regime != kRegimeCluster) {
    int device = 0, sms = 0;
    e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fn, kStagedThreads, bytes);
    n *= sms;
  } else {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = staged_config(kCluster, bytes, 0, &attr, true);
    e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    n *= kCluster;
  }
  if (e != cudaSuccess) return (int)e;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;
  *ctas = n;
  return 0;
}

// keys i32 [n], mask u8 [n], table i32 [t], rows i32 [n] out, matched u8
// [n] out, all contiguous; keys, table and rows 16-byte aligned, mask and
// matched 4-byte aligned (the wrapper ensures it). n = P * N, t >= 1.
// regime: 0 shared, 1 block, 2 split, 3 cluster, 4 global; optin: the
// device's opt-in shared memory a block (hp_smem_optin); cap: the most
// blocks to launch (8 an SM for the shared and global regimes,
// hp_max_ctas() for the others, whose kernel hp_prepare() readied).
extern "C" int hp_launch(const int32_t* keys, const uint8_t* mask,
                         const int32_t* table, int t, int32_t* rows,
                         uint8_t* matched, long long n, int regime, int optin, int cap,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = n >> 2;
  const int threads = staged_regime(regime) ? kStagedThreads : kThreads;
  long long blocks = (n4 + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (regime == kRegimeShared) {
    if (t > kSmemMaxEntries) return (int)cudaErrorInvalidValue;
    hash_probe_kernel<true><<<(int)blocks, kThreads, (size_t)t * 4, s>>>(
        keys, mask, table, t, rows, matched, n);
    return (int)cudaGetLastError();
  }
  if (regime == kRegimeGlobal) {
    hash_probe_kernel<false><<<(int)blocks, kThreads, 0, s>>>(
        keys, mask, table, t, rows, matched, n);
    return (int)cudaGetLastError();
  }
  if (!staged_regime(regime)) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const Slices sl = slices_of(regime, t, optin, &bytes);
  if (bytes == 0 || bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const bool in_cluster = regime == kRegimeCluster;
  if (in_cluster) {
    blocks = blocks / kCluster * kCluster;  // whole clusters
    if (blocks < kCluster) blocks = kCluster;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = staged_config((int)blocks, bytes, s, &attr, in_cluster);
  const cudaError_t e =
      in_cluster ? cudaLaunchKernelEx(&cfg, hash_probe_staged<true>, keys, mask, table, t, sl,
                                      rows, matched, n)
                 : cudaLaunchKernelEx(&cfg, hash_probe_staged<false>, keys, mask, table, t, sl,
                                      rows, matched, n);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
