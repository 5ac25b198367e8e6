// One merge stage of the merge-path sort over columnar uint32 records.
//
// Replaces: sparkrdma_tpu/kernels/merge_sort.py `_stage_kernel` (launched
// by `_merge_stage` through pl.pallas_call). Contract: every adjacent
// pair of sorted runs of length `run` in `in` ([w][ld_in] words, record i
// of word k at in[k*ld_in + i]) is merged into one sorted run of 2*run in
// `out`, in full-record lexicographic order over all w words. The order
// is total up to identical records, so the output is unique and equal,
// bit for bit, to the reference kernel's however ties are split.
//
// Bound on this card: a stage reads and writes w*n*4 bytes once each;
// it does a few comparisons per record. It is bound by memory bytes
// (w=25, n=2^24: 3.36 GB moved, ~1.0 ms at 3.35 TB/s).
//
// Design. The TPU kernel DMAs 128-aligned windows, realigns them with
// rolls and runs a bitonic network over 2T candidates because Mosaic has
// no unaligned DMA and no scatter; none of that applies here. This is a
// classic GPU merge path:
//   1. each CTA owns `tile` output records of one pair; two threads
//      binary-search the start and end diagonals in device memory (no
//      separate offsets pass);
//   2. the CTA stages A[a0:a1] and B[b0:b1] (exactly `tile` records
//      together) word-column by word-column into shared memory, with
//      coalesced loads;
//   3. each thread finds its own sub-diagonal in shared memory and merges
//      its K = tile/blockDim records serially, recording the source slot
//      of each output;
//   4. the CTA writes the tile back word-column by word-column, coalesced.
// Ties go to A, in the global and the local search alike, so the two
// levels agree on every split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// a <= b, lexicographic over w words with strides lda / ldb.
__device__ __forceinline__ bool rec_le(const uint32_t* a, long long lda,
                                       const uint32_t* b, long long ldb,
                                       int w) {
  for (int k = 0; k < w; ++k) {
    uint32_t x = a[k * lda];
    uint32_t y = b[k * ldb];
    if (x != y) return x < y;
  }
  return true;
}

// Number of A records among the first d outputs of the merge of
// A[0:na] and B[0:nb] (ties to A).
__device__ __forceinline__ long long merge_path(const uint32_t* a,
                                                const uint32_t* b,
                                                long long ld, long long na,
                                                long long nb, long long d,
                                                int w) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (rec_le(a + mid, ld, b + (d - mid - 1), ld, w))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_stage_kernel(const uint32_t* __restrict__ in,
                   uint32_t* __restrict__ out, int w, long long ld_in,
                   long long ld_out, long long run, int tile) {
  extern __shared__ uint32_t smem[];          // [w][tile] words
  uint16_t* src = reinterpret_cast<uint16_t*>(smem + (size_t)w * tile);
  __shared__ long long s_a[2];

  const long long tiles_per_pair = 2 * run / tile;
  const long long t = blockIdx.x;
  const long long base = (t / tiles_per_pair) * 2 * run;
  const long long d0 = (t % tiles_per_pair) * tile;
  const uint32_t* A = in + base;
  const uint32_t* B = in + base + run;

  if (threadIdx.x < 2) {
    s_a[threadIdx.x] = merge_path(A, B, ld_in, run, run,
                                  d0 + threadIdx.x * tile, w);
  }
  __syncthreads();
  const long long a0 = s_a[0];
  const int na = (int)(s_a[1] - a0);
  const long long b0 = d0 - a0;

  // stage the tile's sources: slots [0, na) from A, [na, tile) from B
  for (int k = 0; k < w; ++k) {
    const uint32_t* ak = A + k * ld_in + a0;
    const uint32_t* bk = B + k * ld_in + b0 - na;
    uint32_t* sk = smem + (size_t)k * tile;
    for (int j = threadIdx.x; j < tile; j += kThreads)
      sk[j] = j < na ? ak[j] : bk[j];
  }
  __syncthreads();

  // per-thread merge of K outputs inside shared memory
  const int per = tile / kThreads;
  const int nb = tile - na;
  const uint32_t* sa = smem;
  const uint32_t* sb = smem + na;
  int di = threadIdx.x * per;
  int ai = (int)merge_path(sa, sb, tile, na, nb, di, w);
  int bi = di - ai;
  for (int k = 0; k < per; ++k) {
    bool take_a = bi >= nb ||
                  (ai < na && rec_le(sa + ai, tile, sb + bi, tile, w));
    src[di + k] = take_a ? (uint16_t)ai++ : (uint16_t)(na + bi++);
  }
  __syncthreads();

  for (int k = 0; k < w; ++k) {
    const uint32_t* sk = smem + (size_t)k * tile;
    uint32_t* ok = out + k * ld_out + base + d0;
    for (int j = threadIdx.x; j < tile; j += kThreads) ok[j] = sk[src[j]];
  }
}

}  // namespace

extern "C" {

// Shared memory the stage needs for (w, tile); the wrapper picks the
// tile against the card's 227 KB limit.
long long sr_merge_stage_smem(int w, int tile) {
  return (long long)w * tile * 4 + (long long)tile * 2;
}

// Returns a cudaError_t (0 on success); launches on `stream`.
int sr_merge_stage(const void* in, void* out, int w, long long n,
                   long long ld_in, long long ld_out, long long run,
                   int tile, void* stream) {
  if (w <= 0 || tile < kThreads || tile % kThreads || tile > 65536 ||
      run <= 0 || (2 * run) % tile || n % (2 * run))
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)sr_merge_stage_smem(w, tile);
  cudaError_t err = cudaFuncSetAttribute(
      merge_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = n / tile;
  merge_stage_kernel<<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, w, ld_in, ld_out, run, tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
