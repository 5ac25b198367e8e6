// The sort by key of columnar records: a stable least-significant-first
// radix sort over byte digits, in one call.
//
// Replaces: no Pallas kernel (the reference sorts with one variadic
// lax.sort). The port sorted with PyTorch ops (kernels/sort.py's plain
// route): a chain of stable 64-bit torch.sort passes over int64 pair
// keys, each with int64 indices, a pass on the validity flag, then the
// columnar gather cols[:, perm] and the reduce side's copy of its result
// into the read's output: 50.7 device ms a job on an H100 80GB HBM3 in
// the benchmark's TeraSort sort cell (the tail, 87.6 busy), ~25 of Q18's
// 44.7-ms tail; this takes them to 21.0 and 27.0 (the tails, with what
// else they hold).
// Every digit of every key was sorted, whether it varies or not, and the
// padding past the received records with it.
//
// Contract. `cols` holds W words a record, columnar: word w of record i
// at cols[w*ld + i]. Records 0..n-1 are put in the order of a stable sort
// by (valid first, then key words 0..kw-1 as unsigned, most significant
// first): `mask` (n bytes, 1 = valid) is null where every record is
// valid. The sorted records go to out[w*ldo + j], j < n; nothing else of
// `out` is written, and `out` must not overlap `cols`. The order is the
// one the plain route's chain of stable sorts gives, so the two agree
// bit for bit.
//
// Digits. A key word gives 4 byte digits, the validity flag one of 2
// values, the flag's most significant. vary_kernel reads the key words
// (and the flag) once and ORs each record's word with the first
// record's: a digit that every record shares reads 0 there, and its pass
// does nothing. plan_kernel (one thread) turns that into each pass's
// source, destination and rows on the device, so the host never waits:
// which ping-pong buffer holds the order, and where the last pass or the
// placement reads from, are decided there. A pass is three kernels, as
// bucket_scatter.cu's (tile_rank.cuh): tile counts of the digit
// (hist_kernel, a count a warp in shared memory), a scan a value over
// the tiles (scan_kernel), and a stable tile scatter through shared
// memory (scatter_kernel, four blocks an SM: a record's place in the
// tile is kept in shared memory, not in registers); each returns at once
// where its pass does not run. Rows are read with 16-byte loads where
// every row the passes read is 16-byte aligned.
//
// Records are carried by shape (the wrapper's rule, kernels/sort.py
// `carries_whole_records`: W <= kw + 2):
// - narrow records (TPC-H Q18's 3-word lines, 2 key words; the map-side
//   combine's 5 words, 3 key) go whole through every pass that runs,
//   from `cols` to `out` and a scratch copy in turn, the last pass into
//   `out`: 2 x W x 4 B a record a pass, no index, no gather. Where no
//   digit varies, one pass copies.
// - wide records (TeraSort's 25 words, 3 key) are first copied whole
//   into a row-major scratch copy (transpose_kernel); the passes move
//   only the key words still to be sorted and a 32-bit index (a word
//   leaves once its digits are done), and gather_kernel places each
//   record once, straight into `out`: a warp reads 32 records, each as
//   one contiguous run (~4 32-byte sectors a 100-byte record, where a
//   columnar gather reads W), turns them in shared memory and writes 32
//   columns of each row.
// Narrow is cheaper wherever a whole record is at most one word wider
// than its key words and an index: wide pays the copy and the placement,
// 4 x W x 4 B a record, to save (W - kw - 1) x 8 B a pass.
//
// Bound on this card, TeraSort's tail (8 x 6,291,456 records of 25
// words, 10 of 12 key digits varying): every record read and written
// once (10.07 GB a job, 3.0 ms at 3.35 TB/s), its key words read once to
// find the varying digits (0.6 GB) and the ten passes' key words and
// index (~11 GB, 3.4 ms): ~7 ms. Here the record is read and written
// twice (the row-major copy, then the placement): ~10 ms of bytes.
// Q18's combine (8 x 16,777,216 lines of 3 words, ~4 of 8 digits
// varying): ~4 passes of 28 B a line, 15 GB, 4.5 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_rank.cuh"

namespace {

using tile_rank::kPer;
using tile_rank::kThreads;
using tile_rank::kTile;
using tile_rank::kWarps;
using tile_rank::kWarpSpan;

constexpr int kBins = 256;                  // a byte digit

// Rows of n records, columnar (row r at rows + r*ld), with the validity
// flag (bytes, 1 = valid) and each record's index where they are carried.
struct Src {
  const uint32_t* rows;
  long long ld;
  const uint8_t* flag;
  const uint32_t* idx;   // null: a record's own position
};

struct Dst {
  uint32_t* rows;
  long long ld;
  uint8_t* flag;         // null: not carried
  uint32_t* idx;         // null: not carried
};

// One digit's pass, as plan_kernel wrote it.
struct Pass {
  int run;               // 0: nothing to do
  int row;               // the digit's key word, or -1: the flag
  int shift;             // the byte's shift in its word
  int bins;              // 256, or 2 for the flag
  int words;             // word rows moved: 0..words-1
  int pad;
  Src src;
  Dst dst;
};

struct Params {
  long long n;
  int W, kw, D, narrow;
  const uint32_t* cols;
  long long ld;
  const uint8_t* mask;
  uint32_t* out;
  long long ldo;
  uint32_t* buf[2];       // narrow: buf[0] [W, n]; wide: [kw + 1, n] each
  uint8_t* fbuf[2];       // the flag, carried: n bytes each
  uint32_t* aos;          // wide: the records row-major, [n, W]
  uint32_t* work;         // [kBins, tiles]: a pass's tile counts
  uint32_t* counts;       // [kBins]: a pass's digit counts
  long long tiles;
  Pass* passes;           // [D]
  const uint32_t** gather_idx;  // wide: the placement's index, or null
  uint32_t* vary;         // [kw + 1]: each key word's (and the flag's)
                          // bits that differ from the first record's
};

__device__ __forceinline__ int tile_records(long long n) {
  const long long left = n - (long long)blockIdx.x * kTile;
  return left < kTile ? (int)left : kTile;
}

// A record's digit from the word that holds it (the flag as 0 or 1).
__device__ __forceinline__ uint32_t digit_of(const Pass& q, uint32_t v) {
  return q.row >= 0 ? (v >> q.shift) & 0xffu : 1u - v;   // valid first
}

// Record (in the tile) of a thread's k-th slot: groups of 4 consecutive
// records, a warp's 32 groups contiguous, when 16-byte loads are taken;
// else a record a thread, a block's 256 contiguous.
template <bool VEC>
__device__ __forceinline__ int slot(int k) {
  return VEC ? (k >> 2) * (4 * kThreads) + 4 * (int)threadIdx.x + (k & 3)
             : k * kThreads + (int)threadIdx.x;
}

// Four consecutive words of a row at 16-byte-aligned position i, or one.
template <bool VEC>
__device__ __forceinline__ void load4(const uint32_t* row, long long i,
                                      uint32_t* v) {
  if constexpr (VEC) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + i));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = __ldg(row + i);
  }
}

template <bool VEC>
__device__ __forceinline__ void load4(const uint8_t* row, long long i,
                                      uint32_t* v) {
  if constexpr (VEC) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(row + i);
    v[0] = x & 0xffu; v[1] = (x >> 8) & 0xffu;
    v[2] = (x >> 16) & 0xffu; v[3] = x >> 24;
  } else {
    v[0] = row[i];
  }
}

// This thread's records' digit words of a tile (0 past its end).
template <bool VEC>
__device__ __forceinline__ void digit_words(const Pass& q, long long i0,
                                            int cnt, uint32_t (&d)[kPer]) {
  constexpr int kStep = VEC ? 4 : 1;
#pragma unroll
  for (int k = 0; k < kPer; k += kStep) {
    const int r = slot<VEC>(k);
#pragma unroll
    for (int e = 0; e < kStep; ++e) d[k + e] = 0u;
    if (r < cnt) {
      if (q.row >= 0)
        load4<VEC>(q.src.rows + q.row * q.src.ld, i0 + r, d + k);
      else
        load4<VEC>(q.src.flag, i0 + r, d + k);
    }
  }
}

__global__ void __launch_bounds__(kThreads) vary_kernel(Params p) {
  const int k = blockIdx.y;
  uint32_t acc = 0;
  const long long step = (long long)gridDim.x * kThreads;
  if (k < p.kw) {
    const uint32_t* row = p.cols + k * p.ld;
    const uint32_t x0 = __ldg(row);
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < p.n; i += step)
      acc |= __ldg(row + i) ^ x0;
  } else {
    const uint32_t x0 = p.mask[0];
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < p.n; i += step)
      acc |= (uint32_t)p.mask[i] ^ x0;
  }
  acc = __reduce_or_sync(0xffffffffu, acc);
  if ((threadIdx.x & 31) == 0 && acc) atomicOr(p.vary + k, acc);
}

__device__ __forceinline__ bool digit_varies(const Params& p, int i) {
  if (i >= 4 * p.kw) return p.vary[p.kw] != 0;       // the flag
  return ((p.vary[p.kw - 1 - i / 4] >> (8 * (i % 4))) & 0xffu) != 0;
}

// Each digit's pass, least significant first: key word kw-1's bytes 0..3,
// ..., key word 0's, then the flag.
__global__ void plan_kernel(Params p) {
  if (threadIdx.x || blockIdx.x) return;
  int runs = 0;
  for (int i = 0; i < p.D; ++i) runs += digit_varies(p, i);
  // narrow records reach `out` only through a pass: a constant digit's
  // pass is a stable copy
  const bool copy = p.narrow && runs == 0;
  if (copy) runs = 1;
  const bool flag_runs = p.mask && p.vary[p.kw] != 0;
  Src src = {p.cols, p.ld, p.mask, nullptr};
  int j = 0;
  for (int i = 0; i < p.D; ++i) {
    Pass q = {};
    if (copy ? i == 0 : digit_varies(p, i)) {
      q.run = 1;
      if (i < 4 * p.kw) {
        q.row = p.kw - 1 - i / 4;
        q.shift = 8 * (i % 4);
        q.bins = kBins;
      } else {
        q.row = -1;
        q.bins = 2;
      }
      q.src = src;
      Dst d;
      // the flag goes along until its own pass
      d.flag = flag_runs && i < 4 * p.kw ? p.fbuf[j & 1] : nullptr;
      if (p.narrow) {
        q.words = p.W;
        // the passes end in `out`: the one before the last in the scratch
        // copy, and so on back
        const bool to_out = (runs - 1 - j) % 2 == 0;
        d.rows = to_out ? p.out : p.buf[0];
        d.ld = to_out ? p.ldo : p.n;
        d.idx = nullptr;
      } else {
        // the key words that the passes after this one read
        q.words = 0;
        for (int i2 = i + 1; i2 < 4 * p.kw; ++i2)
          if (digit_varies(p, i2)) {
            q.words = p.kw - i2 / 4;
            break;
          }
        d.rows = p.buf[j & 1];
        d.ld = p.n;
        d.idx = p.buf[j & 1] + (long long)p.kw * p.n;
      }
      q.dst = d;
      src = {d.rows, d.ld, d.flag, d.idx};
      ++j;
    }
    p.passes[i] = q;
  }
  if (!p.narrow) *p.gather_idx = j ? src.idx : nullptr;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) hist_kernel(Params p, int pi) {
  const Pass q = p.passes[pi];
  if (!q.run) return;
  __shared__ uint32_t h[kWarps * kBins];
  const long long t = blockIdx.x;
  const long long i0 = t * kTile;
  const int cnt = tile_records(p.n);
  for (int b = threadIdx.x; b < kWarps * kBins; b += kThreads) h[b] = 0u;
  uint32_t d[kPer];
  digit_words<VEC>(q, i0, cnt, d);
  __syncthreads();
  uint32_t* mine = h + (threadIdx.x >> 5) * kBins;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (slot<VEC>(k) < cnt) atomicAdd(mine + digit_of(q, d[k]), 1u);
  __syncthreads();
  for (int b = threadIdx.x; b < q.bins; b += kThreads) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += h[w * kBins + b];
    p.work[b * p.tiles + t] = s;
  }
}

__global__ void __launch_bounds__(kThreads) scan_kernel(Params p, int pi) {
  __shared__ uint32_t wsum[kWarps];
  const int b = blockIdx.x;
  const Pass& q = p.passes[pi];
  if (!q.run || b >= q.bins) return;
  const uint32_t total =
      tile_rank::scan_tiles(p.work + b * p.tiles, p.tiles, wsum);
  if (threadIdx.x == 0) p.counts[b] = total;
}

// Row x of what a pass moves, for this thread's records of the tile:
// word rows 0..words-1, then the index, then the flag.
template <bool VEC>
__device__ __forceinline__ void load_row(const Pass& q, int x, long long i0,
                                         int cnt, uint32_t (&v)[kPer]) {
  constexpr int kStep = VEC ? 4 : 1;
  const bool idx_row = x == q.words && q.dst.idx;
#pragma unroll
  for (int k = 0; k < kPer; k += kStep) {
    const int r = slot<VEC>(k);
    if (r < cnt) {
      const long long i = i0 + r;
      if (x < q.words) {
        load4<VEC>(q.src.rows + x * q.src.ld, i, v + k);
      } else if (idx_row) {
        if (q.src.idx) {
          load4<VEC>(q.src.idx, i, v + k);
        } else {
#pragma unroll
          for (int e = 0; e < kStep; ++e) v[k + e] = (uint32_t)(i + e);
        }
      } else {
        load4<VEC>(q.src.flag, i, v + k);
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
    scatter_kernel(Params p, int pi) {
  const Pass q = p.passes[pi];
  if (!q.run) return;
  __shared__ uint32_t stage[kTile];
  __shared__ uint16_t dest[kTile];
  __shared__ uint8_t bin_at[kTile];
  __shared__ uint8_t id_of[kTile];
  __shared__ uint32_t whist[kWarps * kBins];
  __shared__ int delta[kBins];
  __shared__ uint32_t wsum[kWarps];
  const int tid = threadIdx.x;
  const long long t = blockIdx.x;
  const long long i0 = t * kTile;
  const int cnt = tile_records(p.n);
  for (int i = tid; i < kWarps * kBins; i += kThreads) whist[i] = 0u;
  {
    uint32_t d[kPer];
    digit_words<VEC>(q, i0, cnt, d);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = slot<VEC>(k);
      if (r < cnt) id_of[r] = (uint8_t)digit_of(q, d[k]);
    }
  }
  __syncthreads();
  tile_rank::rank_tile(id_of, cnt, kBins, whist, dest);
  __syncthreads();

  // bin b's first position in the tile, and each warp's within it; the
  // column of the tile's position 0 of bin b
  {
    const int b = tid;                      // kBins == kThreads
    uint32_t in_bin = 0;
    if (b < q.bins) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t v = whist[w * kBins + b];
        whist[w * kBins + b] = in_bin;
        in_bin += v;
      }
    }
    uint32_t total;
    const uint32_t start = tile_rank::block_exclusive(in_bin, wsum, &total);
    const uint32_t off = tile_rank::block_exclusive(
        b < q.bins ? p.counts[b] : 0u, wsum, &total);
    if (b < q.bins) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) whist[w * kBins + b] += start;
      delta[b] = (int)(off + p.work[b * p.tiles + t] - start);
    }
  }
  __syncthreads();

  // each record's position in the tile's sorted order (stable: by digit,
  // then by warp, then by rank in the warp), kept in dest
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = k * kThreads + tid;
    if (r < cnt) {
      const uint32_t id = id_of[r];
      const uint32_t pos = whist[(r / kWarpSpan) * kBins + id] + dest[r];
      dest[r] = (uint16_t)pos;
      bin_at[pos] = (uint8_t)id;
    }
  }
  __syncthreads();

  // the rows: loaded coalesced, put in sorted order, written by runs of a
  // digit; the next row's loads are issued before this row's writes
  const int rows = q.words + (q.dst.idx != nullptr) + (q.dst.flag != nullptr);
  uint32_t v[kPer];
  if (rows) load_row<VEC>(q, 0, i0, cnt, v);
  for (int x = 0; x < rows; ++x) {
    __syncthreads();                        // the last row is written
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = slot<VEC>(k);
      if (r < cnt) stage[dest[r]] = v[k];
    }
    __syncthreads();
    if (x + 1 < rows) load_row<VEC>(q, x + 1, i0, cnt, v);
    const bool flag = !(x < q.words || (x == q.words && q.dst.idx));
    uint32_t* o = x < q.words ? q.dst.rows + x * q.dst.ld : q.dst.idx;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = k * kThreads + tid;
      if (j < cnt) {
        const int c = delta[bin_at[j]] + j;
        if (flag)
          q.dst.flag[c] = (uint8_t)stage[j];
        else
          o[c] = stage[j];
      }
    }
  }
}

// cols [W, n] -> aos [n, W], `cols_a` records a block through shared
// memory: rows read coalesced, the block's records written as one run.
__global__ void __launch_bounds__(kThreads)
    transpose_kernel(Params p, int cols_a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const long long c0 = (long long)blockIdx.x * cols_a;
  const long long left = p.n - c0;
  const int cnt = left < cols_a ? (int)left : cols_a;
  const int pitch = cols_a + 1;             // no bank conflicts either way
  for (int e = threadIdx.x; e < p.W * cols_a; e += kThreads) {
    const int w = e / cols_a, c = e - w * cols_a;
    if (c < cnt) smem[w * pitch + c] = __ldg(p.cols + w * p.ld + c0 + c);
  }
  __syncthreads();
  uint32_t* o = p.aos + c0 * p.W;
  for (int f = threadIdx.x; f < cnt * p.W; f += kThreads) {
    const int c = f / p.W, w = f - c * p.W;
    o[f] = smem[w * pitch + c];
  }
}

// out[:, j] = record idx[j] of the row-major copy: a warp takes 32
// records, reads each one's words at once (one contiguous run a record),
// turns them in shared memory and writes 32 columns of each row.
__global__ void __launch_bounds__(kThreads) gather_kernel(Params p) {
  __shared__ uint32_t sm[kWarps][32 * 33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long j0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  if (j0 >= p.n) return;
  const long long left = p.n - j0;
  const int cnt = left < 32 ? (int)left : 32;
  const uint32_t* idx = *p.gather_idx;
  const long long mine =
      lane < cnt ? (idx ? (long long)__ldg(idx + j0 + lane) : j0 + lane) : 0;
  uint32_t* s = sm[warp];
  for (int w0 = 0; w0 < p.W; w0 += 32) {
    const int ww = p.W - w0 < 32 ? p.W - w0 : 32;
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const long long i = __shfl_sync(0xffffffffu, mine, r);
      if (r < cnt && lane < ww) s[r * 33 + lane] = __ldg(p.aos + i * p.W + w0 + lane);
    }
    __syncwarp();
    for (int w = 0; w < ww; ++w)
      if (lane < cnt)
        __stcs(p.out + (w0 + w) * p.ldo + j0 + lane, s[lane * 33 + w]);
    __syncwarp();
  }
}

// Sizes, in 4-byte words.
long long meta_words(int kw, int has_flag) {
  const long long D = 4LL * kw + has_flag;
  return (D * (long long)sizeof(Pass) + 8 + 4 * (kw + 1) + 3) / 4;
}

long long scratch_words(long long n, int W, int kw, int has_flag,
                        int narrow) {
  const long long tiles = (n + kTile - 1) / kTile;
  long long words = kBins + kBins * tiles;
  words += narrow ? W * n : 2 * (kw + 1) * n + W * n;
  if (has_flag) words += 2 * ((n + 3) / 4);
  return words;
}

// Records a block of transpose_kernel, and its shared memory: wide
// records of up to 372 words.
int transpose_cols(int W) { return W <= 64 ? 128 : 32; }

long long transpose_smem(int W) {
  return (long long)W * (transpose_cols(W) + 1) * 4;
}

}  // namespace

extern "C" {

// Words of the two scratch areas sr_lexsort takes: `meta` (zeroed by the
// caller) and `scratch`.
int64_t sr_lexsort_meta_words(int kw, int has_flag) {
  return meta_words(kw, has_flag);
}

int64_t sr_lexsort_scratch_words(long long n, int W, int kw, int has_flag,
                                 int narrow) {
  return scratch_words(n, W, kw, has_flag, narrow);
}

// Sort records 0..n-1 of `cols` by their kw leading words, valid ones
// first where `mask` is given, into `out` (see the contract above).
// `narrow` picks how records are carried. Returns a cudaError_t.
int sr_lexsort(const void* cols, long long ld, long long n, int W, int kw,
               const void* mask, void* out, long long ldo, int narrow,
               void* meta, long long meta_len, void* scratch,
               long long scratch_len, void* stream) {
  const int has_flag = mask != nullptr;
  if (n < 0 || n >= (1LL << 31) || W < 1 || kw < 0 || kw > W ||
      kw + has_flag < 1 || (W > 1 && ld < n) || (W > 1 && ldo < n) ||
      (!narrow && transpose_smem(W) > 48 * 1024) ||
      (n > 0 && (!cols || !out || !meta || !scratch)) ||
      meta_len < meta_words(kw, has_flag) ||
      scratch_len < scratch_words(n, W, kw, has_flag, narrow))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  Params p;
  p.n = n;
  p.W = W;
  p.kw = kw;
  p.D = 4 * kw + has_flag;
  p.narrow = narrow;
  p.cols = (const uint32_t*)cols;
  p.ld = ld;
  p.mask = (const uint8_t*)mask;
  p.out = (uint32_t*)out;
  p.ldo = ldo;
  p.tiles = (n + kTile - 1) / kTile;
  p.passes = (Pass*)meta;
  p.gather_idx = (const uint32_t**)((char*)meta + p.D * sizeof(Pass));
  p.vary = (uint32_t*)((char*)meta + p.D * sizeof(Pass) + 8);
  uint32_t* w = (uint32_t*)scratch;
  p.counts = w;
  w += kBins;
  p.work = w;
  w += kBins * p.tiles;
  if (narrow) {
    p.buf[0] = w;
    p.buf[1] = nullptr;
    w += (long long)W * n;
    p.aos = nullptr;
  } else {
    p.buf[0] = w;
    p.buf[1] = w + (kw + 1) * n;
    w += 2 * (kw + 1) * n;
    p.aos = w;
    w += (long long)W * n;
  }
  p.fbuf[0] = has_flag ? (uint8_t*)w : nullptr;
  p.fbuf[1] = has_flag ? (uint8_t*)(w + (n + 3) / 4) : nullptr;

  const long long vary_blocks = p.tiles < 512 ? p.tiles * 4 : 2048;
  vary_kernel<<<dim3((unsigned)vary_blocks, (unsigned)(kw + has_flag)),
                kThreads, 0, s>>>(p);
  plan_kernel<<<1, 1, 0, s>>>(p);
  const unsigned tiles = (unsigned)p.tiles;
  if (!narrow) {
    const int ca = transpose_cols(W);
    transpose_kernel<<<(unsigned)((n + ca - 1) / ca), kThreads,
                       (size_t)transpose_smem(W), s>>>(p, ca);
  }
  // 16-byte loads: every row the passes read 16-byte aligned (the
  // scratch rows are, where n is a multiple of 4)
  const bool vec = n % 4 == 0 && (W == 1 || ld % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(cols) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 3u) == 0 &&
                   (!narrow || ((W == 1 || ldo % 4 == 0) &&
                                (reinterpret_cast<uintptr_t>(out) & 15u) == 0));
  for (int i = 0; i < p.D; ++i) {
    if (vec)
      hist_kernel<true><<<tiles, kThreads, 0, s>>>(p, i);
    else
      hist_kernel<false><<<tiles, kThreads, 0, s>>>(p, i);
    scan_kernel<<<kBins, kThreads, 0, s>>>(p, i);
    if (vec)
      scatter_kernel<true><<<tiles, kThreads, 0, s>>>(p, i);
    else
      scatter_kernel<false><<<tiles, kThreads, 0, s>>>(p, i);
  }
  if (!narrow)
    gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
