// A record's destination id from a partitioner's description, shared by
// the plan's count kernel (partition_counts.cu) and the read's bucketing
// scatter (bucket_scatter.cu), so that both give every record the same
// id.
//
// Key words are read as uint32 from a record's column: word w of the
// record whose first key word is at `col` lies at col[w * ld]. The id is
//   hash:  h = ((h ^ k_w) * 2654435761) mod 2^32 over key words
//          0..kw-1, then h ^= h >> 16, id = h mod P;
//   mod:   id = k_first mod P;
//   range: id = #{j : key >= spl_j}, lexicographic unsigned order over
//          key words 0..kw-1, spl being [P-1, kw] uint32 rows sorted
//          lexicographically, found by a binary search;
// and with split_k > 1 it becomes id + stride * (i mod split_k), i the
// record's position in its partition: each kernel adds that term itself
// (key_ids gives the id before it), in its own integer width.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace partition_ids {

constexpr int kRegWords = 4;            // key words held in registers
constexpr uint32_t kHashMul = 2654435761u;

enum Kind { kHash = 0, kMod = 1, kRange = 2 };

// What a record's id is computed from, besides its key words.
struct IdSpec {
  long long ld;          // words between rows
  long long cs;          // words between records
  int kind;
  uint32_t P;            // hash / mod modulus; range: splitters + 1
  unsigned long long pm; // mod_magic(P)
  int kw;                // key words read (mod: 1)
  uint32_t split_k;
  uint32_t stride;
};

// x mod d by one multiply-high (Lemire, Kaser and Kurz, "Faster
// remainder by direct computation", 2019): exact for every 32-bit x and
// d >= 1, given m = mod_magic(d).
__host__ __device__ __forceinline__ unsigned long long mod_magic(
    uint32_t d) {
  return ~0ULL / d + 1;
}

__device__ __forceinline__ uint32_t fast_mod(uint32_t x,
                                             unsigned long long m,
                                             uint32_t d) {
  return (uint32_t)__umul64hi(m * x, d);
}

template <int V>
__device__ __forceinline__ void load_word(const uint32_t* p,
                                          uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

// key >= s, lexicographic over kw words: the first kRegWords from
// registers, the rest from the record's column `kg` (row stride ld).
__device__ __forceinline__ bool key_ge(const uint32_t (&kr)[kRegWords],
                                       const uint32_t* kg, long long ld,
                                       const uint32_t* s, int kw) {
#pragma unroll
  for (int w = 0; w < kRegWords; ++w)
    if (w < kw && kr[w] != s[w]) return kr[w] > s[w];
  for (int w = kRegWords; w < kw; ++w) {
    const uint32_t a = __ldg(kg + w * ld);
    if (a != s[w]) return a > s[w];
  }
  return true;
}

// #{j : key >= spl_j} over m sorted rows: the first row above the key
__device__ __forceinline__ uint32_t range_id(
    const uint32_t (&kr)[kRegWords], const uint32_t* kg, long long ld,
    const uint32_t* spl, int m, int kw) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_ge(kr, kg, ld, spl + mid * kw, kw))
      lo = mid + 1;
    else
      hi = mid;
  }
  return (uint32_t)lo;
}

// The ids, before the split's term, of V consecutive records of one
// partition; `col` points at the first one's first key word (V == 4 only
// with unit column stride and `col` 16-byte aligned). Every key load is
// issued before any is used.
template <int V>
__device__ __forceinline__ void key_ids(const IdSpec& p, const uint32_t* col,
                                        const uint32_t* spl,
                                        uint32_t (&id)[V]) {
  uint32_t kr[V][kRegWords];
#pragma unroll
  for (int w = 0; w < kRegWords; ++w) {
    uint32_t x[V];
    if (w < p.kw) {
      load_word<V>(col + w * p.ld, x);
    } else {
#pragma unroll
      for (int r = 0; r < V; ++r) x[r] = 0u;
    }
#pragma unroll
    for (int r = 0; r < V; ++r) kr[r][w] = x[r];
  }
  if (p.kind == kHash) {
    uint32_t h[V];
#pragma unroll
    for (int r = 0; r < V; ++r) {
      h[r] = 0u;
#pragma unroll
      for (int w = 0; w < kRegWords; ++w)
        if (w < p.kw) h[r] = (h[r] ^ kr[r][w]) * kHashMul;
    }
    for (int w = kRegWords; w < p.kw; ++w) {
      uint32_t x[V];
      load_word<V>(col + w * p.ld, x);
#pragma unroll
      for (int r = 0; r < V; ++r) h[r] = (h[r] ^ x[r]) * kHashMul;
    }
#pragma unroll
    for (int r = 0; r < V; ++r) {
      const uint32_t f = h[r] ^ (h[r] >> 16);
      id[r] = fast_mod(f, p.pm, p.P);
    }
  } else if (p.kind == kMod) {
#pragma unroll
    for (int r = 0; r < V; ++r) id[r] = fast_mod(kr[r][0], p.pm, p.P);
  } else {
#pragma unroll
    for (int r = 0; r < V; ++r)
      id[r] = range_id(kr[r], col + r * p.cs, p.ld, spl, (int)p.P - 1,
                       p.kw);
  }
}

}  // namespace partition_ids
