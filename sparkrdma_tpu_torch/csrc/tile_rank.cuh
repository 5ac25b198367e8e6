// The stable tile scatter's shared steps, used by the read's bucketing
// (bucket_scatter.cu) and the reduce side's sort by key (lexsort.cu):
// a tile of kTile records, each with a small key (a bin id, a byte
// digit), is placed in key order, arrival order within a key, by
//   1. a count of each key in each tile (the caller's own kernel);
//   2. scan_tiles: each tile's records of a key in the earlier tiles;
//   3. rank_tile: each record's rank among the records of its key that
//      its warp saw before it, then the caller's exclusive sums over
//      warps and keys, and its move of the rows.
// Blocks are kThreads threads; a warp ranks kWarpSpan consecutive
// records of its tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_rank {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;                 // records a tile
constexpr int kPer = kTile / kThreads;      // records a thread: 16
constexpr int kWarpSpan = kTile / kWarps;   // records a warp ranks: 512

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

// Replaces each of `tiles` counts of one key (a row of the tile counts)
// by the sum of the counts before it, by one block; returns their total
// (every sum below 2^31).
__device__ __forceinline__ uint32_t scan_tiles(uint32_t* row,
                                               long long tiles,
                                               uint32_t* wsum) {
  uint32_t carry = 0;
  constexpr int kItems = 8;
  for (long long start = 0; start < tiles;
       start += (long long)kThreads * kItems) {
    const long long i0 = start + (long long)threadIdx.x * kItems;
    uint32_t v[kItems];
    uint32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      v[j] = i0 + j < tiles ? row[i0 + j] : 0u;
      sum += v[j];
    }
    uint32_t total;
    uint32_t run = carry + block_exclusive(sum, wsum, &total);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < tiles) row[i0 + j] = run;
      run += v[j];
    }
    carry += total;
  }
  return carry;
}

// The lanes of the warp whose key equals this lane's (keys up to
// `keys`, which stands for no record).
__device__ __forceinline__ unsigned peers_of(uint32_t key, int keys) {
  unsigned peers = 0xffffffffu;
  const int bits = 32 - __clz(keys);
  for (int i = 0; i < bits; ++i) {
    const unsigned set = __ballot_sync(0xffffffffu, (key >> i) & 1u);
    peers &= (key >> i) & 1u ? set : ~set;
  }
  return peers;
}

// Each warp ranks its kWarpSpan records of a tile of `cnt` within their
// keys, 32 at a time (a lane's peers by one ballot a bit of the key,
// cheaper here than __match_any_sync): dest[r] is record r's rank among
// the warp's records of its key before it, and the warp's row of
// `whist` (stride `keys` words, zeroed by the caller) ends holding the
// warp's count of each key. Keys are id_of[r], below `keys`.
__device__ __forceinline__ void rank_tile(const uint8_t* id_of, int cnt,
                                          int keys, uint32_t* whist,
                                          uint16_t* dest) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = warp * kWarpSpan;
  uint32_t* mine = whist + warp * keys;
  for (int c = 0; c < kWarpSpan && w0 + c < cnt; c += 32) {
    const int r = w0 + c + lane;
    const bool valid = r < cnt;
    const uint32_t key = valid ? id_of[r] : (uint32_t)keys;
    const unsigned peers = peers_of(key, keys);
    const uint32_t before = __popc(peers & ((1u << lane) - 1u));
    if (valid) dest[r] = (uint16_t)(mine[key] + before);
    __syncwarp();
    if (valid && before == 0) mine[key] += __popc(peers);
    __syncwarp();
  }
}

}  // namespace tile_rank
