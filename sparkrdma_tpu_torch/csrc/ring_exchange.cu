// Stacked all-to-all exchange of every round in one launch.
//
// Replaces: sparkrdma_tpu/exchange/ring.py `_ring_exchange_kernel` (the
// fused multi-round kernel of make_ring_exchange) and, as its R = 1
// case, `_a2a_kernel` (make_ring_all_to_all).
//
// Contract. The D partitions of the mesh are stacked on one card. The
// send buffer is [D_src][R][D_dst][chunk] words and the receive buffer
// [D_dst][R][D_src][chunk]; the kernel computes
//     recv[d][r][s] = send[s][r][d]
// for every round r, which is what R calls of lax.all_to_all(split_axis
// =0, concat_axis=0, tiled=True) give on a D-device mesh, the prefix
// lane of round 0 included (it is just the first words of each chunk).
// Any D, R and chunk >= 0; send and recv need only 4-byte alignment
// (the streaming loop passes views send[f], recv[f]); every word is
// copied once, bit-exact.
//
// One launch covers all R rounds: that is the fused kernel's "one
// program" property. Its barrier handshake and parity-banked semaphores
// order one-sided DMAs between chips; within one card a kernel boundary
// already orders everything, so they have no counterpart here. They come
// back in the multi-card form as signal pads of symmetric memory.
//
// Bound on this card: every word is read once and written once, so
// 2 * D*R*D*chunk*4 bytes over 3.35 TB/s (leg B: ~3.4 GB of slots each
// way, ~2.0 ms; K-small's per-round all-to-all, 26 MB each way, 15.7 us).
//
// Design (the register route). The launch geometry comes from Python
// (exchange/ring.py::launch_plan, where a CPU test holds it): every
// chunk is cut into items of `item_words` (4096 words, 16 KB), one CTA
// of 256 threads per item, each thread loading kUnroll = 4 independent
// 16-byte vectors before it stores any. A small launch spreads over
// every SM (K-small's 26 MB per direction is 1,600 items) and a large one
// has so many short CTAs that the hardware's scheduler keeps every SM
// fed to the end.
//
// Little's law: 3.35 TB/s times ~1 us of loaded latency is ~3.4 MB that
// must be in flight. 63 registers a thread let 4 CTAs share an SM:
// 1,024 threads x 64 B = 64 KB per SM, ~8.4 MB over 132 SMs.
//
// Measured on an H100 (PERF.md): this reaches 88-90 % of the bound
// at the large shapes. A persistent grid (2 or 4 CTAs per SM walking the
// same items with a grid stride, 2-8 loads per thread) read 65-70 % at
// the misaligned large shapes and ~86 % at the aligned ones, below the
// old one-CTA-per-64-KB kernel, so it was dropped. Capping registers at
// 32 for 8 CTAs per SM with 4 loads a thread read ~75 %.
//
// Alignment. A chunk with the prefix lane holds W*(C+1) words, so most
// chunks start off 16-byte alignment, and source and destination
// disagree mod 16 bytes. Each item is copied as a scalar head up to the
// first 16-byte-aligned destination word, a body of 16-byte stores, and
// a scalar tail. When the body's source shares the destination's
// alignment, its loads are 16-byte loads of the body. Otherwise each
// thread loads the aligned 16-byte block under its output vector, takes
// the next block from its neighbour lane by a warp shuffle (lane 31
// loads it), and stores the four words at the shift: one 16-byte load
// per 16-byte store, where the old kernel took four scalar loads. The
// shuffle stands in for a __funnelshift_r realignment: a thread holds
// one aligned block, so the words of the next one come from the lane
// that loaded it, and the shift is a select of whole words. Those
// aligned blocks reach up to 3 words past the body at either end; where
// that would leave the send buffer, one vector moves to the scalar head
// or tail, so nothing outside send is read.
//
// The other route, TMA bulk copies through shared-memory stages with an
// mbarrier per stage, was not built. The register route already met the
// targets (88-90 % of bound at the large shapes, faster than the library
// copy at every shape the legs launch; only F's fused read stayed below
// 85 %, at 84.6-85.3 %), so no measurement compares the two routes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                     // 16-byte loads in flight
constexpr int kMinBlocks = 4;                  // resident CTAs per SM
constexpr int kBatch = kThreads * kUnroll;     // vectors per CTA pass
constexpr unsigned kFullMask = 0xffffffffu;

// Words s .. s+3 of the 8-word window (a, b), s in 1..3.
__device__ __forceinline__ uint4 shifted(uint4 a, uint4 b, int s) {
  if (s == 1) return make_uint4(a.y, a.z, a.w, b.x);
  if (s == 2) return make_uint4(a.z, a.w, b.x, b.y);
  return make_uint4(a.w, b.x, b.y, b.z);
}

// The CTA copies `len` words src -> dst. `before` and `after` count the
// words of send before src and after src + len.
__device__ __forceinline__ void copy_item(const uint32_t* __restrict__ src,
                                          uint32_t* __restrict__ dst,
                                          int len, long long before,
                                          long long after) {
  int head = (4 - (int)(((uintptr_t)dst >> 2) & 3)) & 3;
  if (head > len) head = len;
  const int shift = (int)(((uintptr_t)(src + head) >> 2) & 3);
  int nvec = (len - head) >> 2;
  if (shift && nvec) {
    // blocks src+head-shift .. src+head-shift+4*nvec+3 must lie in send
    if (before + head < shift) {
      head += 4;
      --nvec;
    }
    if (nvec && (len - head - 4 * nvec) + after < 4 - shift) --nvec;
  }
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];

  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  if (shift == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    for (int base = 0; base < nvec; base += kBatch) {
      uint4 v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        if (i < nvec) v[k] = s4[i];
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        if (i < nvec) d4[i] = v[k];
      }
    }
  } else {
    // aligned blocks 0 .. nvec; output vector i is words shift.. of
    // blocks i and i + 1
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head - shift);
    const int lane = threadIdx.x & 31;
    for (int base = 0; base < nvec; base += kBatch) {
      uint4 a[kUnroll], e[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        a[k] = make_uint4(0, 0, 0, 0);
        e[k] = a[k];
        if (i <= nvec) a[k] = s4[i];
        if (lane == 31 && i < nvec) e[k] = s4[i + 1];
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = base + k * kThreads + threadIdx.x;
        uint4 b = e[k];
        const uint32_t bx = __shfl_down_sync(kFullMask, a[k].x, 1);
        const uint32_t by = __shfl_down_sync(kFullMask, a[k].y, 1);
        const uint32_t bz = __shfl_down_sync(kFullMask, a[k].z, 1);
        if (lane != 31) b = make_uint4(bx, by, bz, 0);
        if (i < nvec) d4[i] = shifted(a[k], b, shift);
      }
    }
  }
  for (int i = head + 4 * nvec + threadIdx.x; i < len; i += kThreads)
    dst[i] = src[i];
}

// One CTA per item. Item indices and chunk numbers fit 32 bits (the
// entry point checks), so the decomposition takes 32-bit divisions; word
// offsets are 64-bit (leg L's buffer holds 1.54e9 words).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ring_exchange_kernel(const uint32_t* __restrict__ send,
                     uint32_t* __restrict__ recv, unsigned d, unsigned r,
                     long long chunk, unsigned item_words,
                     unsigned items_per_chunk) {
  const unsigned it = blockIdx.x;
  const unsigned c = it / items_per_chunk;        // chunk, send order
  const unsigned q = c / d;                       // (s, rr)
  const unsigned dd = c - q * d;
  const unsigned s = q / r;
  const unsigned rr = q - s * r;
  const long long total = (long long)gridDim.x / items_per_chunk * chunk;
  const long long lo = (long long)(it - c * items_per_chunk) * item_words;
  const long long src_off = (long long)c * chunk + lo;
  const long long dst_off = (long long)((dd * r + rr) * d + s) * chunk + lo;
  const int len = (int)(chunk - lo < item_words ? chunk - lo : item_words);
  copy_item(send + src_off, recv + dst_off, len, src_off,
            total - src_off - len);
}

}  // namespace

extern "C" {

// Launches on `stream` with the geometry of exchange/ring.py's
// launch_plan: `items_per_chunk` items of `item_words` words cover each
// chunk, `grid` items in all, one CTA per item. Returns a cudaError_t (0
// on success); refuses a geometry that does not cover each chunk once.
int sr_ring_exchange(const void* send, void* recv, int d, int r,
                     long long chunk, int item_words,
                     long long items_per_chunk, long long grid,
                     void* stream) {
  if (d <= 0 || r <= 0 || chunk < 0 || item_words <= 0)
    return (int)cudaErrorInvalidValue;
  if (chunk == 0) return (int)cudaSuccess;
  if (items_per_chunk <= 0 || (items_per_chunk - 1) * item_words >= chunk ||
      items_per_chunk * item_words < chunk ||
      grid != (long long)d * r * d * items_per_chunk || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ring_exchange_kernel<<<(unsigned)grid, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)send, (uint32_t*)recv, (unsigned)d, (unsigned)r,
      chunk, (unsigned)item_words, (unsigned)items_per_chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
