// The read's map-side bucketing, for every stacked source partition at
// once, written straight into the chunks' gather source.
//
// Replaces: no Pallas kernel (the reference buckets with XLA ops). The
// port bucketed each source partition with PyTorch ops: the partitioner
// as int64 elementwise passes, a stable 64-bit radix sort of the ids, a
// histogram that syncs with the host, a columnar gather that fetches
// each record as W scattered words, then one `torch.cat` of the L
// bucketed sources into the gather source: 33-53 device ms a job in
// the benchmark's cells, against a bound of 1.3-3.2 ms. This computes
// the same bytes, counts and offsets in one call of three kernels.
//
// Contract. `rec` holds L partitions of n records, columnar: record i of
// partition d has word w at rec[w*ld + (d*n + i)*cs], W words. A
// record's id is partition_ids.cuh's, the one the plan's count kernel
// (partition_counts.cu) gives it; every id lies in [0, parts), which
// the caller guarantees by its description (P + stride*(split_k-1) <=
// parts, checked here). Partition d's records are written to columns
// d*n .. d*n+n-1 of `out` (row stride ldo), in the order of a stable
// sort by id: bin b's records from column d*n + offsets[d, b] on, in
// arrival order. counts[d, b] (uint64 [L, parts]) counts them;
// offsets[d, b] (int64 [L, parts]) is their exclusive sum over b. Both
// are written whole. Nothing else of `out` is written (the caller's zero
// column past the last partition stays as it is). `work` holds uint32
// [L, parts, tiles], tiles = ceil(n / kTile), then L*n bytes.
//
// Bound on this card: every word read once and written once, and the
// key words read once more for the tile histograms: TeraSort's
// 50,331,648 x (25 x 4 x 2 + 3 x 4) B = 10.67 GB (3.19 ms at 3.35
// TB/s); TPC-H Q18's 134,217,728 x (3 x 4 x 2 + 2 x 4) B = 4.29 GB
// (1.28 ms). The ids kept between the passes add 2 B a record.
//
// Design. Each partition is cut into tiles of kTile = 4096 records.
//   1. tile_hist: a block a tile computes its records' ids (16-byte key
//      loads where rows are 16-byte aligned, the splitters in shared
//      memory where they fit) and counts them in a histogram a warp in
//      shared memory; it writes the tile's count of every bin to `work`
//      and the ids, as bytes, after it.
//   2. tile_scan: a block a (partition, bin) scans the bin's tile counts
//      in place (each tile's records of the bin in the earlier tiles)
//      and writes the bin's count.
//   3. tile_scatter: a block a tile reads its ids back and ranks its
//      records stably inside the tile: each warp ranks 512 consecutive
//      records within their bins, 32 at a time (a lane's peers by one
//      ballot a bit of the id, cheaper here than __match_any_sync), then
//      an exclusive scan over the warps' per-bin counts and one over the
//      partition's bin counts (the offsets) give each record its column.
//      Then it moves the tile row by row: each row is loaded coalesced
//      (16-byte loads where aligned), stored into shared memory in
//      bucketed order and written out with streaming stores, so that
//      each bin's run of the tile lands contiguous in `out` (a warp
//      writes 32 consecutive columns except where a run ends). The next
//      row's loads are issued before the current row's writes.
// Ids are kept as bytes and a tile's positions as 16-bit words, so bins
// are limited to kMaxBins = 256 (the benchmark's plans have 32-72).
// Keeping the ids beats computing them again in tile_scatter, whose
// ranking is the costlier half of a narrow record's work: 3-7 % less
// time at the cells' shapes for 2 B a record more of HBM. Counts come
// from the scan, not from 64-bit atomics (72 bins x 4096 tiles a
// partition land on 72 addresses). A tile holds 41 KB of shared memory;
// records of up to kNarrowWords words (Q18's 3) take a register budget
// that fits three blocks an SM, wider ones (TeraSort's 25) two, which
// spills nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "partition_ids.cuh"

namespace {

using partition_ids::IdSpec;
using partition_ids::kHash;
using partition_ids::kMod;
using partition_ids::kRange;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                 // records a tile
constexpr int kPer = kTile / kThreads;      // records a thread: 16
constexpr int kWarpSpan = kTile / kWarps;   // records a warp ranks: 512
constexpr int kMaxBins = 256;               // ids kept as bytes
constexpr int kSplSmemBytes = 16 * 1024;
constexpr uint32_t kNone = 0x100u;          // no record: above every id
// Records of at most this many words count as narrow: the tile's
// ranking outweighs moving its rows, and more blocks an SM hide it.
constexpr int kNarrowWords = 8;

struct Params {
  const uint32_t* rec;   // word 0 of record 0 of partition 0
  const uint32_t* key;   // word `first` of the same
  IdSpec ids;            // row and record strides, kind, P, kw, split
  long long n;           // records a partition
  int W;                 // words a record
  const uint32_t* spl;   // range: [P-1, kw] rows, sorted
  int spl_words;         // splitter words copied to shared memory, or 0
  int parts;
  long long tiles;       // tiles a partition
  uint32_t* work;        // [L, parts, tiles]
  unsigned long long* counts;   // [L, parts]
  long long* offsets;           // [L, parts]
  uint32_t* out;         // [W, ldo]
  long long ldo;
  uint8_t* idbuf;        // [L, n]: each record's id, between the passes
};

// Record (in the tile) of a thread's k-th slot: groups of 4 consecutive
// records, a warp's 32 groups contiguous, when 16-byte loads are taken;
// else a record a thread, a block's 256 contiguous.
template <bool VEC>
__device__ __forceinline__ int slot(int k) {
  return VEC ? (k >> 2) * (4 * kThreads) + 4 * (int)threadIdx.x + (k & 3)
             : k * kThreads + (int)threadIdx.x;
}

// The splitters, copied to shared memory where they fit.
__device__ __forceinline__ const uint32_t* splitters(const Params& p,
                                                     uint32_t* spl_s) {
  if (!p.spl_words) return p.spl;
  for (int i = threadIdx.x; i < p.spl_words; i += kThreads)
    spl_s[i] = p.spl[i];
  return spl_s;
}

// The ids of this thread's records of a tile of `cnt` records starting
// at position i0 of its partition, whose first key word is at `key`;
// kNone past the tile's end. With VEC, cnt is a multiple of 4.
template <bool VEC>
__device__ __forceinline__ void tile_ids(const Params& p,
                                         const uint32_t* key, long long i0,
                                         int cnt, const uint32_t* spl,
                                         uint32_t (&id)[kPer]) {
  // the split's phase: one 64-bit remainder a tile, 32-bit ones after
  const uint32_t sk = p.ids.split_k;
  const uint32_t j0 = sk > 1 ? (uint32_t)(i0 % sk) : 0u;
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int r = slot<true>(4 * q);
      uint32_t g[4] = {kNone, kNone, kNone, kNone};
      if (r < cnt) {
        partition_ids::key_ids<4>(p.ids, key + r, spl, g);
        uint32_t j = sk > 1 ? (j0 + r) % sk : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          g[e] += p.ids.stride * j;
          if (++j == sk) j = 0;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) id[4 * q + e] = g[e];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = slot<false>(k);
      uint32_t g[1] = {kNone};
      if (r < cnt) {
        partition_ids::key_ids<1>(p.ids, key + r * p.ids.cs, spl, g);
        g[0] += p.ids.stride * (sk > 1 ? (j0 + r) % sk : 0u);
      }
      id[k] = g[0];
    }
  }
}

// One row of this thread's records of a tile (`row` at the tile's first
// record); words past the tile's end read as 0.
template <bool VEC>
__device__ __forceinline__ void load_row(const uint32_t* row, long long cs,
                                         int cnt, uint32_t (&v)[kPer]) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int r = slot<true>(4 * q);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < cnt) x = __ldg(reinterpret_cast<const uint4*>(row + r));
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = slot<false>(k);
      v[k] = r < cnt ? __ldg(row + r * cs) : 0u;
    }
  }
}

__device__ __forceinline__ int tile_records(const Params& p) {
  const long long left = p.n - (long long)blockIdx.x * kTile;
  return left < kTile ? (int)left : kTile;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    tile_hist_kernel(Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int d = blockIdx.y;
  const long long t = blockIdx.x;
  const long long i0 = t * kTile;
  const int cnt = tile_records(p);
  const uint32_t* spl = splitters(p, smem);
  uint32_t* hist = smem + ((p.spl_words + 3) & ~3);
  for (int i = threadIdx.x; i < kWarps * p.parts; i += kThreads)
    hist[i] = 0u;
  __syncthreads();
  uint32_t id[kPer];
  tile_ids<VEC>(p, p.key + ((long long)d * p.n + i0) * p.ids.cs, i0, cnt,
                spl, id);
  uint32_t* mine = hist + (threadIdx.x >> 5) * p.parts;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (id[k] != kNone) atomicAdd(mine + id[k], 1u);
  // the ids, kept as bytes for tile_scatter
  uint8_t* ib = p.idbuf + (long long)d * p.n + i0;
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int r = slot<true>(4 * q);
      if (r < cnt)
        *reinterpret_cast<uint32_t*>(ib + r) =
            id[4 * q] | (id[4 * q + 1] << 8) | (id[4 * q + 2] << 16) |
            (id[4 * q + 3] << 24);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (slot<false>(k) < cnt) ib[slot<false>(k)] = (uint8_t)id[k];
  }
  __syncthreads();
  for (int b = threadIdx.x; b < p.parts; b += kThreads) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += hist[w * p.parts + b];
    p.work[((long long)d * p.parts + b) * p.tiles + t] = s;
  }
}

// Exclusive sum over the block of one value a thread; `wsum` holds
// kWarps words and is free again when this returns.
__device__ __forceinline__ uint32_t block_exclusive(uint32_t v,
                                                    uint32_t* wsum,
                                                    uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += wsum[w];
    all += wsum[w];
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads) tile_scan_kernel(Params p) {
  __shared__ uint32_t wsum[kWarps];
  const int d = blockIdx.y, b = blockIdx.x;
  // each tile's records of the bin in the partition's earlier tiles (all
  // below n < 2^31), then the bin's count
  uint32_t carry = 0;
  uint32_t* row = p.work + ((long long)d * p.parts + b) * p.tiles;
  constexpr int kItems = 8;
  for (long long start = 0; start < p.tiles;
       start += (long long)kThreads * kItems) {
    const long long i0 = start + (long long)threadIdx.x * kItems;
    uint32_t v[kItems];
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      v[j] = i0 + j < p.tiles ? row[i0 + j] : 0u;
      sum += v[j];
    }
    uint32_t total;
    uint32_t run = carry + block_exclusive(sum, wsum, &total);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < p.tiles) row[i0 + j] = run;
      run += v[j];
    }
    carry += total;
  }
  if (threadIdx.x == 0)
    p.counts[(long long)d * p.parts + b] = (unsigned long long)carry;
}

// The lanes of the warp whose key equals this lane's (keys up to
// `parts`, which stands for no record).
__device__ __forceinline__ unsigned peers_of(uint32_t key, int parts) {
  unsigned peers = 0xffffffffu;
  const int bits = 32 - __clz(parts);
  for (int i = 0; i < bits; ++i) {
    const unsigned set = __ballot_sync(0xffffffffu, (key >> i) & 1u);
    peers &= (key >> i) & 1u ? set : ~set;
  }
  return peers;
}

template <bool VEC, bool NARROW>
__global__ void __launch_bounds__(kThreads, NARROW ? 3 : 2)
    tile_scatter_kernel(Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t wsum[kWarps];
  uint32_t* stage = smem;                                       // kTile
  uint16_t* dest = reinterpret_cast<uint16_t*>(stage + kTile);  // kTile
  uint8_t* bin_at = reinterpret_cast<uint8_t*>(dest + kTile);   // kTile
  uint8_t* id_of = bin_at + kTile;                              // kTile
  uint32_t* whist = reinterpret_cast<uint32_t*>(id_of + kTile);
  int* delta = reinterpret_cast<int*>(whist + kWarps * p.parts);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = blockIdx.y;
  const long long t = blockIdx.x;
  const long long i0 = t * kTile;
  const int cnt = tile_records(p);
  const long long cs = p.ids.cs;
  for (int i = tid; i < kWarps * p.parts; i += kThreads) whist[i] = 0u;
  // the ids tile_hist kept, by record
  const uint8_t* ib = p.idbuf + (long long)d * p.n + i0;
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const int r = slot<true>(4 * q);
      if (r < cnt)
        *reinterpret_cast<uint32_t*>(id_of + r) =
            __ldcs(reinterpret_cast<const unsigned int*>(ib + r));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (slot<false>(k) < cnt) id_of[slot<false>(k)] = ib[slot<false>(k)];
  }
  __syncthreads();

  // each warp ranks its 512 records within their bins, 32 at a time:
  // a record's rank among the warp's records of its bin before it
  const int w0 = warp * kWarpSpan;
  uint32_t* mine = whist + warp * p.parts;
  for (int c = 0; c < kWarpSpan && w0 + c < cnt; c += 32) {
    const int r = w0 + c + lane;
    const bool valid = r < cnt;
    const uint32_t key = valid ? id_of[r] : (uint32_t)p.parts;
    const unsigned peers = peers_of(key, p.parts);
    const uint32_t before = __popc(peers & ((1u << lane) - 1u));
    if (valid) dest[r] = (uint16_t)(mine[key] + before);
    __syncwarp();
    if (valid && before == 0) mine[key] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // bin b's first position in the tile, and each warp's within it; the
  // column in the partition of the tile's position 0 of bin b
  {
    const int b = tid;                      // parts <= kThreads
    uint32_t in_bin = 0;
    if (b < p.parts) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t v = whist[w * p.parts + b];
        whist[w * p.parts + b] = in_bin;
        in_bin += v;
      }
    }
    uint32_t total;
    const uint32_t start = block_exclusive(in_bin, wsum, &total);
    // the bin's offset in the partition: its lower bins' records
    const long long db = (long long)d * p.parts + b;
    const uint32_t off = block_exclusive(
        b < p.parts ? (uint32_t)p.counts[db] : 0u, wsum, &total);
    if (b < p.parts) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) whist[w * p.parts + b] += start;
      delta[b] = (int)(off + p.work[db * p.tiles + t] - start);
      if (t == 0) p.offsets[db] = (long long)off;
    }
  }
  __syncthreads();

  // each of this thread's records' position in the tile's bucketed
  // order (stable: by bin, then by warp, then by rank in the warp)
  uint32_t dst[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = slot<VEC>(k);
    dst[k] = 0u;
    if (r < cnt) {
      const uint32_t id = id_of[r];
      dst[k] = whist[(r / kWarpSpan) * p.parts + id] + dest[r];
      bin_at[dst[k]] = (uint8_t)id;
    }
  }
  __syncthreads();
  int col[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = k * kThreads + tid;
    col[k] = j < cnt ? delta[bin_at[j]] + j : 0;
  }

  // the rows: loaded coalesced, put in bucketed order, written by runs
  const uint32_t* in = p.rec + ((long long)d * p.n + i0) * cs;
  uint32_t* outp = p.out + (long long)d * p.n;
  uint32_t v[kPer];
  load_row<VEC>(in, cs, cnt, v);
  for (int w = 0; w < p.W; ++w) {
    __syncthreads();                        // the last row is written
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (slot<VEC>(k) < cnt) stage[dst[k]] = v[k];
    __syncthreads();
    if (w + 1 < p.W) load_row<VEC>(in + (w + 1) * p.ids.ld, cs, cnt, v);
    uint32_t* o = outp + (long long)w * p.ldo;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = k * kThreads + tid;
      // streaming stores: the source is read back long after L2 has
      // turned over
      if (j < cnt) __stcs(o + col[k], stage[j]);
    }
  }
}

template <bool VEC>
int launch(const Params& p, int L, cudaStream_t stream) {
  cudaError_t err;
  const size_t spl_bytes = (size_t)((p.spl_words + 3) & ~3) * 4;
  const size_t hist_bytes = (size_t)kWarps * p.parts * 4;
  const size_t hist_smem = spl_bytes + hist_bytes;
  const size_t scat_smem =
      (size_t)kTile * (4 + 2 + 1 + 1) + hist_bytes + (size_t)p.parts * 4;
  auto scatter = p.W <= kNarrowWords ? tile_scatter_kernel<VEC, true>
                                      : tile_scatter_kernel<VEC, false>;
  const dim3 tiles((unsigned)p.tiles, (unsigned)L);
  if (p.tiles > 0)
    tile_hist_kernel<VEC><<<tiles, kThreads, hist_smem, stream>>>(p);
  tile_scan_kernel<<<dim3((unsigned)p.parts, (unsigned)L), kThreads, 0,
                     stream>>>(p);
  if (p.tiles > 0)
    scatter<<<tiles, kThreads, scat_smem, stream>>>(p);
  else if ((err = cudaMemsetAsync(p.offsets, 0, sizeof(long long) * L *
                                  p.parts, stream)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bucket L stacked partitions into `out` (see the contract above).
// `rec` points at word 0 of record 0 of partition 0, W words a record;
// `first` is the first key word read (mod's key word; 0 for hash and
// range) and `kw` how many (1 for mod). `spl` is range's [P-1, kw]
// uint32 rows in non-decreasing lexicographic order (ignored
// otherwise). split_k = 1 for no split. `work` holds `work_words`
// uint32, at least L * parts * ceil(n / 4096) + ceil(L * n / 4).
// Returns a cudaError_t.
int sr_bucket_scatter(const void* rec, long long ld, long long cs,
                      long long n, int L, int W, int kind, int P, int first,
                      int kw, const void* spl, int split_k, int stride,
                      int parts, void* work, long long work_words,
                      void* counts, void* offsets, void* out, long long ldo,
                      void* stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (L < 1 || L > 65535 || n < 0 || n >= (1LL << 31) || W < 1 || ld < 0 ||
      cs < 1 || kind < kHash || kind > kRange || P < 1 || kw < 1 ||
      first < 0 || split_k < 1 || stride < 0 || parts < 1 ||
      parts > kMaxBins || (kind == kMod && kw != 1) ||
      (long long)P + (long long)stride * (split_k - 1) > parts ||
      (kind == kRange && P > 1 && !spl) || (n > 0 && !rec) || !counts ||
      !offsets || (n > 0 && !out) || ldo < (long long)L * n ||
      (tiles > 0 && !work) ||
      work_words < (long long)L * parts * tiles + ((long long)L * n + 3) / 4 ||
      tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.rec = (const uint32_t*)rec;
  p.key = (const uint32_t*)rec + (long long)first * ld;
  p.ids.ld = ld;
  p.ids.cs = cs;
  p.ids.kind = kind;
  p.ids.P = (uint32_t)P;
  p.ids.pm = partition_ids::mod_magic((uint32_t)P);
  p.ids.kw = kw;
  p.ids.split_k = (uint32_t)split_k;
  p.ids.stride = (uint32_t)stride;
  p.n = n;
  p.W = W;
  p.spl = (const uint32_t*)spl;
  const long long spl_words = kind == kRange ? (long long)(P - 1) * kw : 0;
  p.spl_words = spl_words * 4 <= kSplSmemBytes ? (int)spl_words : 0;
  p.parts = parts;
  p.tiles = tiles;
  p.work = (uint32_t*)work;
  p.counts = (unsigned long long*)counts;
  p.offsets = (long long*)offsets;
  p.out = (uint32_t*)out;
  p.ldo = ldo;
  p.idbuf = (uint8_t*)((uint32_t*)work + (long long)L * parts * tiles);
  // 16-byte loads: unit column stride, every row and every tile start
  // 16-byte aligned
  const bool vec = cs == 1 && (W == 1 || ld % 4 == 0) && n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(rec) & 15u) == 0;
  return vec ? launch<true>(p, L, (cudaStream_t)stream)
             : launch<false>(p, L, (cudaStream_t)stream);
}

}  // extern "C"
