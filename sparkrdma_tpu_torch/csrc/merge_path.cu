// One merge stage of the merge-path sort over columnar uint32 records.
//
// Replaces: sparkrdma_tpu/kernels/merge_sort.py `_stage_kernel` (launched
// by `_merge_stage` through pl.pallas_call) together with its vectorised
// split pre-pass `_merge_path_offsets`.
//
// Contract. `in` holds n records of w words (record i's word k at
// in[k*ld_in + i]); its runs [j*run, (j+1)*run) (the last one cut at n)
// are sorted. Each adjacent pair of runs A, B is merged into one sorted
// run in `out` ([w][ld_out]). The last pair may have a short B run, or
// none, in which case A is copied through. Records compare in full-
// record lexicographic order over all w words; the order is total up to
// identical records, so the output is unique and equal, bit for bit, to
// the reference kernel's however ties are split.
//
// Bound on this card: a stage reads and writes w*n*4 bytes once each and
// does a few comparisons per record, so it is bound by memory bytes
// (w=25, n=2^24: 3.36 GB moved, ~1.0 ms at 3.35 TB/s).
//
// Design. Two kernels per stage.
//   1. merge_split_kernel, the split pass: one warp per output tile of
//      the stage finds the tile's start diagonal with a 32-way search
//      (each lane tests one candidate, a ballot narrows the interval
//      32-fold: ~5 dependent rounds for a run of 2^23, not ~23), and
//      writes it to a scratch array.
//   2. merge_stage_kernel: persistent CTAs, two per SM, each walking
//      over tiles t, t + gridDim.x, ... While tile t is merged and
//      written back, tile t+1's sources are staged with 16-byte
//      cp.async into the second of two shared-memory buffers (~50 KB in
//      flight per CTA at w=25). A window starts at an arbitrary record,
//      so each source is copied as whole aligned 16-byte chunks into a
//      region that keeps the source's alignment; the up to 3 words
//      before and after it land in padding that nothing reads. Each
//      thread finds its own sub-diagonal in shared memory, merges K =
//      tile/128 records and records each output's source slot; the CTA
//      then writes the tile back with 16-byte stores, each thread
//      reusing its 4 source slots across all w columns.
// Comparisons load word 0 alone (it decides almost every comparison of
// distinct records) and then the rest in batches of 8 whose loads issue
// together: a tie of two identical w=25 records costs 4 latencies, not
// 25. Ties go to A in the split pass and in the tile merge alike, so the
// two levels agree on every split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // merge CTA size; tiles are 128..512
constexpr int kSplitWarps = 8;     // warps (= tiles) per split-pass CTA
constexpr int kPad = 16;           // spare words per staged column
constexpr int kBatch = 8;          // words loaded together after word 0

// a <= b, lexicographic over w words with strides lda / ldb.
__device__ __forceinline__ bool rec_le(const uint32_t* a, long long lda,
                                       const uint32_t* b, long long ldb,
                                       int w) {
  uint32_t x0 = a[0], y0 = b[0];
  if (x0 != y0) return x0 < y0;
  for (int k0 = 1; k0 < w; k0 += kBatch) {
    uint32_t x[kBatch], y[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool live = k0 + j < w;
      x[j] = live ? a[(k0 + j) * lda] : 0u;
      y[j] = live ? b[(k0 + j) * ldb] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (x[j] != y[j]) return x[j] < y[j];
  }
  return true;
}

// Number of A records among the first d outputs of the merge of A[0:na]
// and B[0:nb], ties to A: the largest a in [lo, hi] with a == lo or
// A[a-1] <= B[d-a]. That predicate is monotone in a, so one warp tests
// 32 evenly spaced candidates per round and keeps the gap after the last
// one that holds.
__device__ long long warp_merge_path(const uint32_t* A, const uint32_t* B,
                                     long long ld, long long na,
                                     long long nb, long long d, int w,
                                     int lane) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long p = lo + (lane + 1) * step;
    const bool ok = p <= hi && rec_le(A + (p - 1), ld, B + (d - p), ld, w);
    const int k = __popc(__ballot_sync(0xffffffffu, ok));
    const long long top = lo + (k + 1) * step - 1;
    lo += k * step;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// The same search by one thread (binary), over shared memory.
__device__ __forceinline__ int merge_path(const uint32_t* a,
                                          const uint32_t* b, int ld, int na,
                                          int nb, int d, int w) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rec_le(a + mid, ld, b + (d - mid - 1), ld, w))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Where tile t of a stage lies: its pair, its two source windows, and
// how each window is staged (aligned 16-byte chunks, `pad` words of
// alignment slack in front).
struct Tile {
  long long g0;      // first output record of the tile
  long long a_src;   // aligned index of the first A word staged
  long long b_src;   // aligned index of the first B word staged
  int cnt;           // outputs in the tile (< tile only at the end)
  int na, nb;        // source records from A and from B
  int ca, cb;        // 16-byte chunks staged from A and from B
  int pad_a, pad_b;  // slot of A[a0] is pad_a; of B[b0], 4*ca + pad_b
};

__device__ __forceinline__ Tile tile_at(const int* __restrict__ split,
                                        long long t, long long n,
                                        long long run, int tile) {
  Tile g;
  g.g0 = t * tile;
  const long long base = g.g0 / (2 * run) * (2 * run);
  const long long d = g.g0 - base;
  const long long len = n - base < 2 * run ? n - base : 2 * run;
  const long long na_pair = len < run ? len : run;
  g.cnt = (int)(len - d < tile ? len - d : tile);
  const long long a0 = split[t];
  const long long a1 = d + tile < len ? (long long)split[t + 1] : na_pair;
  const long long b0 = d - a0;
  g.na = (int)(a1 - a0);
  g.nb = g.cnt - g.na;
  g.pad_a = (int)((base + a0) & 3);
  g.pad_b = (int)((base + run + b0) & 3);
  g.a_src = base + a0 - g.pad_a;
  g.b_src = base + run + b0 - g.pad_b;
  g.ca = g.na ? (g.pad_a + g.na + 3) >> 2 : 0;
  g.cb = g.nb ? (g.pad_b + g.nb + 3) >> 2 : 0;
  return g;
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of tile g's sources into buf ([w][S] words).
__device__ __forceinline__ void stage_tile(uint32_t* buf, int S,
                                           const uint32_t* __restrict__ in,
                                           long long ld, int w,
                                           const Tile& g) {
  const int c = g.ca + g.cb;
  for (int i = threadIdx.x; i < w * c; i += kThreads) {
    const int k = i / c;
    const int j = i - k * c;
    const uint32_t* col = in + k * ld;
    const uint32_t* src =
        j < g.ca ? col + g.a_src + 4 * j : col + g.b_src + 4 * (j - g.ca);
    cp_async16(buf + k * S + 4 * j, src);
  }
}

__global__ void __launch_bounds__(kSplitWarps * 32)
merge_split_kernel(const uint32_t* __restrict__ in, int* __restrict__ split,
                   int w, long long n, long long ld, long long run, int tile,
                   long long n_tiles) {
  const long long t =
      (long long)blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= n_tiles) return;                     // whole warps leave
  const long long g0 = t * tile;
  const long long base = g0 / (2 * run) * (2 * run);
  const long long len = n - base < 2 * run ? n - base : 2 * run;
  const long long na = len < run ? len : run;
  const long long a = warp_merge_path(in + base, in + base + run, ld, na,
                                      len - na, g0 - base, w, lane);
  if (lane == 0) split[t] = (int)a;
}

__global__ void __launch_bounds__(kThreads, 2)
merge_stage_kernel(const uint32_t* __restrict__ in,
                   uint32_t* __restrict__ out,
                   const int* __restrict__ split, int w, long long n,
                   long long ld_in, long long ld_out, long long run,
                   int tile, long long n_tiles) {
  extern __shared__ __align__(16) uint32_t smem[];  // 2 x [w][S], src
  const int S = tile + kPad;
  uint16_t* src = reinterpret_cast<uint16_t*>(smem + 2 * w * S);
  const int tid = threadIdx.x;

  long long t = blockIdx.x;
  if (t >= n_tiles) return;
  Tile g = tile_at(split, t, n, run, tile);
  stage_tile(smem, S, in, ld_in, w, g);
  cp_async_commit();

  // write-back mapping: thread -> one quad of outputs, every
  // (kThreads / quads)-th column, its 4 source slots kept in registers
  const int quads_full = tile >> 2;
  const int q = tid % quads_full;
  const int k_first = tid / quads_full;
  const int k_step = kThreads / quads_full;
  const int per = tile / kThreads;

  for (int cur = 0; t < n_tiles; t += gridDim.x, cur ^= 1) {
    const long long nt = t + gridDim.x;
    Tile ng = g;
    if (nt < n_tiles) {
      ng = tile_at(split, nt, n, run, tile);
      stage_tile(smem + (cur ^ 1) * w * S, S, in, ld_in, w, ng);
    }
    cp_async_commit();               // (empty on the last tile)
    cp_async_wait_prev();            // tile t's copies have landed
    __syncthreads();

    const uint32_t* buf = smem + cur * w * S;
    const int b_slot = 4 * g.ca + g.pad_b;
    const int di = tid * per;
    if (di < g.cnt) {
      const uint32_t* sa = buf + g.pad_a;
      const uint32_t* sb = buf + b_slot;
      int ai = merge_path(sa, sb, S, g.na, g.nb, di, w);
      int bi = di - ai;
      const int kmax = g.cnt - di < per ? g.cnt - di : per;
      for (int k = 0; k < kmax; ++k) {
        const bool take_a =
            bi >= g.nb || (ai < g.na && rec_le(sa + ai, S, sb + bi, S, w));
        src[di + k] =
            (uint16_t)(take_a ? g.pad_a + ai++ : b_slot + bi++);
      }
    }
    __syncthreads();

    if (4 * q < g.cnt) {             // cnt is a multiple of 4
      const ushort4 s = reinterpret_cast<const ushort4*>(src)[q];
      uint32_t* o = out + g.g0 + 4 * q;
      for (int k = k_first; k < w; k += k_step) {
        const uint32_t* sk = buf + k * S;
        *reinterpret_cast<uint4*>(o + k * ld_out) =
            make_uint4(sk[s.x], sk[s.y], sk[s.z], sk[s.w]);
      }
    }
    __syncthreads();                 // buf and src free for reuse
    g = ng;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Shared memory one merge CTA needs for (w, tile): two staging buffers
// of w columns of tile + 16 words, and the tile's source slots (the
// wrapper's `stage_smem` picks the tile by the same formula).
size_t stage_smem(int w, int tile) {
  return 2 * (size_t)w * (tile + kPad) * 4 + 2 * (size_t)tile;
}

}  // namespace

extern "C" {

// Split pass: split[t] = A records before tile t's first output, for
// every tile of the stage (int32[ceil(n / tile)]). Returns a cudaError_t.
int sr_merge_splits(const void* in, void* split, int w, long long n,
                    long long ld, long long run, int tile, void* stream) {
  if (w <= 0 || n <= 0 || ld < n || tile <= 0 || run <= 0 ||
      run % tile || run > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + tile - 1) / tile;
  const long long blocks = (n_tiles + kSplitWarps - 1) / kSplitWarps;
  merge_split_kernel<<<(unsigned)blocks, kSplitWarps * 32, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)in, (int*)split, w, n, ld, run, tile, n_tiles);
  return (int)cudaGetLastError();
}

// Merge stage over the splits of sr_merge_splits (same n, run, tile).
// Rows must start 16-byte aligned (ld_in, ld_out multiples of 4) and n
// must be a multiple of 4. Returns a cudaError_t; launches on `stream`.
int sr_merge_stage(const void* in, void* out, const void* split, int w,
                   long long n, long long ld_in, long long ld_out,
                   long long run, int tile, void* stream) {
  if (w <= 0 || n <= 0 || n % 4 || tile < kThreads || tile > 4 * kThreads ||
      tile % kThreads || run <= 0 || run % tile || run > (1LL << 30) ||
      ld_in < n || ld_out < n || ld_in % 4 || ld_out % 4 ||
      !aligned16(in) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const size_t smem = stage_smem(w, tile);
  cudaError_t err = cudaFuncSetAttribute(
      merge_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, merge_stage_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_tiles = (n + tile - 1) / tile;
  const long long slots = (long long)sms * per_sm;
  const long long blocks = n_tiles < slots ? n_tiles : slots;
  merge_stage_kernel<<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const int*)split, w, n, ld_in,
      ld_out, run, tile, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
