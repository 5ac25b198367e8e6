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
//
// One launch covers all R rounds: that is the fused kernel's "one
// program" property. Its barrier handshake and parity-banked semaphores
// order one-sided DMAs between chips; within one card a kernel boundary
// already orders everything, so they have no counterpart here. They come
// back in the multi-card form as signal pads of symmetric memory.
//
// Bound on this card: every word is read once and written once, so
// 2 * D*R*D*chunk*4 bytes over 3.35 TB/s (leg B: ~3.4 GB of slots each
// way, ~2.0 ms). Design: the grid is flat over (chunk, piece); each CTA
// copies one contiguous piece of one chunk. A chunk is ppd*W*(C+1)
// words, and the +1 prefix lane breaks 16-byte alignment, so each piece
// is copied as a scalar head up to the first 16-byte-aligned destination
// word, a body of 16-byte stores (16-byte loads too when the source
// shares the destination's alignment, four scalar loads otherwise) and a
// scalar tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kPieceWords = 1 << 14;   // 64 KB per CTA

__global__ void __launch_bounds__(kThreads)
ring_exchange_kernel(const uint32_t* __restrict__ send,
                     uint32_t* __restrict__ recv, int d, int r,
                     long long chunk, long long pieces) {
  const long long c = blockIdx.x / pieces;        // chunk, send order
  const long long piece = blockIdx.x % pieces;
  const long long s = c / ((long long)r * d);
  const long long rr = (c / d) % r;
  const long long dd = c % d;
  const long long src_off = c * chunk;
  const long long dst_off = ((dd * r + rr) * d + s) * chunk;

  const long long lo = piece * kPieceWords;
  const long long hi = lo + kPieceWords < chunk ? lo + kPieceWords : chunk;
  const uint32_t* src = send + src_off + lo;
  uint32_t* dst = recv + dst_off + lo;
  long long len = hi - lo;

  // scalar head: up to the first 16-byte-aligned destination word
  long long head = (4 - (long long)(((uintptr_t)dst >> 2) & 3)) & 3;
  if (head > len) head = len;
  if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  src += head;
  dst += head;
  len -= head;

  const long long nvec = len >> 2;
  uint4* dst4 = reinterpret_cast<uint4*>(dst);
  if ((((uintptr_t)src) & 15) == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    for (long long i = threadIdx.x; i < nvec; i += kThreads)
      dst4[i] = src4[i];
  } else {
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      const uint32_t* p = src + 4 * i;
      dst4[i] = make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
  // scalar tail
  for (long long i = 4 * nvec + threadIdx.x; i < len; i += kThreads)
    dst[i] = src[i];
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success); launches on `stream`.
int sr_ring_exchange(const void* send, void* recv, int d, int r,
                     long long chunk, void* stream) {
  if (d <= 0 || r <= 0 || chunk < 0) return (int)cudaErrorInvalidValue;
  if (chunk == 0) return (int)cudaSuccess;
  long long pieces = (chunk + kPieceWords - 1) / kPieceWords;
  long long blocks = (long long)d * r * d * pieces;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ring_exchange_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)send, (uint32_t*)recv, d, r, chunk, pieces);
  return (int)cudaGetLastError();
}

}  // extern "C"
