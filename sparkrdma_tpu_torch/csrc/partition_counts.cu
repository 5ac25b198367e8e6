// Per-destination record counts of a plan pass, for every stacked
// partition at once.
//
// Replaces: no Pallas kernel. The reference counts a plan pass with XLA
// ops (its partitioner, then a histogram). The port did the same with
// PyTorch ops, one partition at a time: ~15 ms of elementwise passes
// over int64 ids and two host syncs a partition (the range
// partitioner's [n, P-1] compares, the hash's 16-bit split multiplies,
// the histogram's masked compaction and bincount). This kernel computes
// the same [L, parts] table in one launch.
//
// Contract. `rec` holds L partitions of n records, columnar: record i of
// partition d has word w at rec[w*ld + (d*n + i)*cs]. Each key word is
// read as uint32. A record's id is partition_ids.cuh's, the one the
// read's bucketing scatter (bucket_scatter.cu) gives it:
//   hash:  h = ((h ^ k_w) * 2654435761) mod 2^32 over key words
//          0..kw-1, then h ^= h >> 16, id = h mod P;
//   mod:   id = k_first mod P;
//   range: id = #{j : key >= spl_j}, lexicographic unsigned order over
//          key words 0..kw-1, spl being [P-1, kw] uint32 rows sorted
//          lexicographically (the count does not depend on the rows'
//          order, so the host sorts them), found by a binary search;
// and with split_k > 1 it becomes id + stride * (i mod split_k). Ids of
// at least `parts` are dropped. The number of partition d's records of
// id b is added to table[d, b] (uint64 [L, parts], zeroed by the
// caller). The sums are integers, so the table is exact whatever the
// order of the atomics.
//
// Bound on this card: the key words, read once. TeraSort's pass reads
// 50,331,648 x 3 x 4 B = 604 MB (0.18 ms at 3.35 TB/s); WordCount's
// 67,108,864 x 2 x 4 B = 537 MB (0.16 ms). Per record it does a few
// integer operations and one shared-memory atomic.
//
// Design. A 2-D grid: blockIdx.y is the partition, blockIdx.x one of
// enough blocks to fill the card, each walking the partition's records
// in groups of 4 with a grid stride. Where a partition's rows start
// 16-byte aligned (rows a multiple of 4 words apart, unit column
// stride), a thread loads each key word of its 4 records as one
// 16-byte load, so a warp reads 512 contiguous bytes of each row; the
// up to 3 records before the first aligned group and after the last
// one are counted one by one. Otherwise every record is loaded alone
// (still coalesced). Counts go to a histogram in shared memory, one per
// warp where bins x warps fit (every plan of the benchmark's cells:
// 8-40 bins), else straight to the table; each block then adds its
// nonzero bins to the table with one 64-bit atomic each. The splitters
// live in shared memory where they fit. No id array is written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition_ids.cuh"

namespace {

using partition_ids::IdSpec;
using partition_ids::kRange;
using partition_ids::kHash;
using partition_ids::kMod;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes = 48 * 1024;   // shared memory without opt-in
constexpr int kSplSmemBytes = 16 * 1024;

struct Params {
  const uint32_t* rec;   // word `first` of record 0 of partition 0
  IdSpec ids;            // row and record strides, kind, P, kw, split
  long long n;           // records a partition
  const uint32_t* spl;   // range: [P-1, kw] rows, sorted
  unsigned long long* table;
  int parts;
  int per_warp;          // a histogram a warp, else the table itself
  int spl_smem;
  int vec;
};

// Count V records i0 .. i0+V-1 of one partition; `col` points at the
// first one's word `first` (V == 4 only with unit column stride).
template <int V>
__device__ __forceinline__ void count_group(
    const Params& p, const uint32_t* col, long long i0,
    const uint32_t* spl, uint32_t* hist, unsigned long long* gtab) {
  uint32_t id[V];
  partition_ids::key_ids<V>(p.ids, col, spl, id);
  uint32_t j = p.ids.split_k > 1 ? (uint32_t)(i0 % p.ids.split_k) : 0u;
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const unsigned long long b =
        id[r] + (unsigned long long)p.ids.stride * j;
    if (b < (unsigned long long)p.parts) {
      if (hist)
        atomicAdd(hist + b, 1u);
      else
        atomicAdd(gtab + b, 1ull);
    }
    if (++j == p.ids.split_k) j = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    partition_counts_kernel(Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int d = blockIdx.y;
  const int m = p.ids.kind == kRange ? (int)p.ids.P - 1 : 0;
  const int spl_words = p.spl_smem ? m * p.ids.kw : 0;
  const int spl_pad = (spl_words + 3) & ~3;
  uint32_t* hist_s = smem + spl_pad;
  const uint32_t* spl = p.spl;
  if (p.spl_smem) {
    for (int i = threadIdx.x; i < spl_words; i += kThreads)
      smem[i] = p.spl[i];
    spl = smem;
  }
  const int hist_words = p.per_warp ? kWarps * p.parts : 0;
  for (int i = threadIdx.x; i < hist_words; i += kThreads) hist_s[i] = 0u;
  __syncthreads();
  uint32_t* hist =
      p.per_warp ? hist_s + (threadIdx.x >> 5) * p.parts : nullptr;
  unsigned long long* gtab = p.table + (long long)d * p.parts;
  const uint32_t* base = p.rec + (long long)d * p.n * p.ids.cs;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nth = (long long)gridDim.x * kThreads;
  if (p.vec) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(base);
    long long head = (long long)(((16u - (unsigned)(a & 15u)) & 15u) >> 2);
    if (head > p.n) head = p.n;
    const long long groups = (p.n - head) >> 2;
    for (long long g = tid; g < groups; g += nth) {
      const long long i0 = head + 4 * g;
      count_group<4>(p, base + i0, i0, spl, hist, gtab);
    }
    // the up to 3 records before the first group and after the last
    if (blockIdx.x == 0 && threadIdx.x < 8) {
      const long long tail0 = head + 4 * groups;
      const long long t = threadIdx.x;
      const long long i = t < 4 ? t : tail0 + (t - 4);
      if ((t < 4 && i < head) || (t >= 4 && i < p.n))
        count_group<1>(p, base + i, i, spl, hist, gtab);
    }
  } else {
    for (long long i = tid; i < p.n; i += nth)
      count_group<1>(p, base + i * p.ids.cs, i, spl, hist, gtab);
  }
  if (!p.per_warp) return;
  __syncthreads();
  for (int b = threadIdx.x; b < p.parts; b += kThreads) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += hist_s[w * p.parts + b];
    if (s) atomicAdd(gtab + b, s);
  }
}

int g_sms[64];   // SMs of each device, read once

}  // namespace

extern "C" {

// The [L, parts] count table of one plan pass (see the contract above).
// `rec` points at word 0 of record 0 of partition 0; `first` is the
// first key word read (mod's key word; 0 for hash and range) and `kw`
// how many (1 for mod). `spl` is range's [P-1, kw] uint32 rows in
// non-decreasing lexicographic order (ignored otherwise). split_k = 1
// for no split. `table` is uint64 [L, parts], contiguous, and the
// counts are added to it. Returns a cudaError_t.
int sr_partition_counts(const void* rec, long long ld, long long cs,
                        long long n, int L, int kind, int P, int first,
                        int kw, const void* spl, int split_k,
                        int stride, void* table, int parts, void* stream) {
  if (L < 1 || L > 65535 || n < 0 || ld < 0 || cs < 1 || kind < kHash ||
      kind > kRange || P < 1 || kw < 1 || first < 0 || split_k < 1 ||
      stride < 0 || parts < 1 || !table || (n > 0 && !rec) ||
      (kind == kRange && P > 1 && !spl) || (kind == kMod && kw != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const long long spl_words = kind == kRange ? (long long)(P - 1) * kw : 0;
  const int spl_smem = spl_words * 4 <= kSplSmemBytes;
  const long long spl_bytes = spl_smem ? ((spl_words + 3) & ~3LL) * 4 : 0;
  const long long warp_bytes = (long long)kWarps * parts * 4;
  const int per_warp = spl_bytes + warp_bytes <= kSmemBytes;
  const long long hist_bytes = per_warp ? warp_bytes : 0;
  Params p;
  p.rec = (const uint32_t*)rec + (long long)first * ld;
  p.ids.ld = ld;
  p.ids.cs = cs;
  p.ids.kind = kind;
  p.ids.P = (uint32_t)P;
  p.ids.pm = partition_ids::mod_magic((uint32_t)P);
  p.ids.kw = kw;
  p.ids.split_k = (uint32_t)split_k;
  p.ids.stride = (uint32_t)stride;
  p.n = n;
  p.spl = (const uint32_t*)spl;
  p.table = (unsigned long long*)table;
  p.parts = parts;
  p.per_warp = per_warp;
  p.spl_smem = spl_smem;
  p.vec = cs == 1 && (kw == 1 || ld % 4 == 0);
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  int sms = dev < 64 ? g_sms[dev] : 0;
  if (sms == 0) {
    if ((err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if (dev < 64) g_sms[dev] = sms;
  }
  const size_t smem = (size_t)(spl_bytes + hist_bytes);
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, partition_counts_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // every block the card holds at once, shared by the partitions, and
  // no more blocks than a partition has threads' worth of work
  const long long work = p.vec ? n / 4 + 1 : n;
  long long bx = ((long long)sms * per_sm + L - 1) / L;
  const long long most = (work + kThreads - 1) / kThreads;
  if (bx > most) bx = most;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)L);
  partition_counts_kernel<<<grid, kThreads, smem,
                            (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
