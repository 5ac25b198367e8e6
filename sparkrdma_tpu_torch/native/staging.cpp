// Host staging library of the PyTorch port: an aligned, size-classed
// host buffer pool, whole-file IO, a background spill spooler and the
// two serde row codecs. Plain C ABI, loaded with ctypes by
// sparkrdma_tpu_torch/hbm/host_staging.py, which builds it with g++ at
// first use (sparkrdma_tpu_torch/_build.py). Host code only: it links no
// CUDA, and a page-locked pool registers its leases with the CUDA
// runtime from Python.
//
// The ABI, the pool's classes and every byte the codecs and the writers
// produce are those of the JAX package's native/staging.cpp, so files
// and rows are interchangeable between the two packages.
//
// Design notes:
// - 256-byte alignment, power-of-two classes: the rule of the device
//   SlotPool, so host and device pools agree on reuse.
// - The spooler is one writer thread behind a bounded queue. A
//   submission copies nothing: the caller keeps the buffer alive until
//   sr_spooler_drain returns.
// - ctypes releases the GIL for the whole of every call, so a codec
//   call's std::threads and Python threads run at once.

#include <atomic>
#include <condition_variable>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr size_t kAlignment = 256;

size_t size_class(size_t n) {
  size_t c = kAlignment;
  while (c < n) c <<= 1;
  return c;
}

struct Pool {
  std::mutex mu;
  // free stack per size class
  std::unordered_map<size_t, std::vector<void*>> free_lists;
  // live allocation -> its class, for put()
  std::unordered_map<void*, size_t> sizes;
  std::atomic<long> hits{0}, misses{0}, outstanding{0};
  std::atomic<long> bytes_allocated{0};
};

struct SpoolTask {
  std::string path;
  const void* buf;
  size_t len;
};

struct Spooler {
  std::mutex mu;
  std::condition_variable cv_submit, cv_done;
  std::deque<SpoolTask> queue;
  size_t depth;
  size_t in_flight = 0;
  long errors = 0;
  long completed = 0;
  bool stopping = false;
  std::thread worker;
};

long write_whole_file(const char* path, const void* buf, size_t len) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  const char* p = static_cast<const char*>(buf);
  size_t left = len;
  while (left > 0) {
    ssize_t n = ::write(fd, p, left);
    if (n < 0) {
      if (errno == EINTR) continue;
      int e = errno;
      ::close(fd);
      return -e;
    }
    p += n;
    left -= static_cast<size_t>(n);
  }
  if (::close(fd) != 0) return -errno;
  return static_cast<long>(len);
}

void spool_loop(Spooler* sp) {
  for (;;) {
    SpoolTask task;
    {
      std::unique_lock<std::mutex> lk(sp->mu);
      sp->cv_submit.wait(lk, [sp] { return sp->stopping || !sp->queue.empty(); });
      if (sp->queue.empty()) {
        if (sp->stopping) return;
        continue;
      }
      task = sp->queue.front();
      sp->queue.pop_front();
      sp->in_flight++;
    }
    long rc = write_whole_file(task.path.c_str(), task.buf, task.len);
    {
      std::lock_guard<std::mutex> lk(sp->mu);
      if (rc < 0) sp->errors++;
      sp->completed++;
      sp->in_flight--;
    }
    sp->cv_done.notify_all();
  }
}

// Run fn(lo, hi) over [0, n) sharded across up to `threads` std::threads
// (contiguous ranges, caller's thread takes the first shard). Each shard
// returns 0 or -(i+1) for the first offending row in its range; the
// combined result is the error for the SMALLEST offending row index so
// the native codec reports the same row the numpy codec does.
template <typename Fn>
long run_sharded(int64_t n, int64_t threads, Fn fn) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  if (n <= 0) return 0;
  if (threads == 1) return fn(0, n);
  std::vector<long> rcs(static_cast<size_t>(threads), 0);
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(threads - 1));
  for (int64_t t = 1; t < threads; t++) {
    int64_t lo = n * t / threads;
    int64_t hi = n * (t + 1) / threads;
    pool.emplace_back([&rcs, t, lo, hi, &fn] { rcs[t] = fn(lo, hi); });
  }
  rcs[0] = fn(0, n / threads);
  for (auto& th : pool) th.join();
  long best = 0;  // -(i+1): larger (closer to 0) means smaller row index
  for (long rc : rcs)
    if (rc < 0 && (best == 0 || rc > best)) best = rc;
  return best;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- alloc
void* sr_alloc(size_t bytes) {
  size_t padded = (bytes + kAlignment - 1) / kAlignment * kAlignment;
  return ::aligned_alloc(kAlignment, padded);
}

void sr_free(void* p) { ::free(p); }

// ----------------------------------------------------------------- pool
void* sr_pool_create() { return new Pool(); }

void sr_pool_destroy(void* pool) {
  Pool* p = static_cast<Pool*>(pool);
  {
    // scope the lock: the guard must release p->mu BEFORE delete, or its
    // destructor unlocks a destroyed mutex inside freed memory
    std::lock_guard<std::mutex> lk(p->mu);
    for (auto& kv : p->free_lists)
      for (void* buf : kv.second) ::free(buf);
    // leak any outstanding buffers deliberately: freeing memory the
    // caller still holds would be worse; outstanding() exposes the count
    p->free_lists.clear();
    p->sizes.clear();
  }
  delete p;
}

void* sr_pool_get(void* pool, size_t bytes) {
  Pool* p = static_cast<Pool*>(pool);
  size_t cls = size_class(bytes);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    auto it = p->free_lists.find(cls);
    if (it != p->free_lists.end() && !it->second.empty()) {
      void* buf = it->second.back();
      it->second.pop_back();
      p->hits++;
      p->outstanding++;
      p->sizes[buf] = cls;
      return buf;
    }
  }
  void* buf = ::aligned_alloc(kAlignment, cls);
  if (buf == nullptr) return nullptr;
  std::lock_guard<std::mutex> lk(p->mu);
  p->misses++;
  p->outstanding++;
  p->bytes_allocated += static_cast<long>(cls);
  p->sizes[buf] = cls;
  return buf;
}

int sr_pool_put(void* pool, void* buf) {
  Pool* p = static_cast<Pool*>(pool);
  std::lock_guard<std::mutex> lk(p->mu);
  auto it = p->sizes.find(buf);
  if (it == p->sizes.end()) return -1;  // not from this pool / double put
  size_t cls = it->second;
  p->sizes.erase(it);
  p->free_lists[cls].push_back(buf);
  p->outstanding--;
  return 0;
}

size_t sr_pool_class_of(size_t bytes) { return size_class(bytes); }

void sr_pool_stats(void* pool, long* hits, long* misses, long* outstanding,
                   long* bytes_allocated) {
  Pool* p = static_cast<Pool*>(pool);
  *hits = p->hits.load();
  *misses = p->misses.load();
  *outstanding = p->outstanding.load();
  *bytes_allocated = p->bytes_allocated.load();
}

// -------------------------------------------------------------- file IO
long sr_write_file(const char* path, const void* buf, size_t len) {
  return write_whole_file(path, buf, len);
}

long sr_read_file(const char* path, void* buf, size_t cap) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  char* p = static_cast<char*>(buf);
  size_t got = 0;
  while (got < cap) {
    ssize_t n = ::read(fd, p + got, cap - got);
    if (n < 0) {
      if (errno == EINTR) continue;
      int e = errno;
      ::close(fd);
      return -e;
    }
    if (n == 0) break;
    got += static_cast<size_t>(n);
  }
  ::close(fd);
  return static_cast<long>(got);
}

long sr_file_size(const char* path) {
  struct stat st;
  if (::stat(path, &st) != 0) return -errno;
  return static_cast<long>(st.st_size);
}

// ---------------------------------------------------------------- codec
// Byte-payload <-> fixed-width uint32 row codec (api/serde.py's padded
// slot scheme at memcpy speed). The wire format is little-endian words;
// these entry points write HOST-order words, so the Python layer
// refuses the native codec unless sr_codec_abi() confirms a
// little-endian host (the numpy codec byte-swaps explicitly).
// Rows are sharded across a small std::thread pool; ctypes releases the
// GIL for the whole call, so Python threads keep running too.

// Returns 1 on little-endian hosts (native rows == '<u4' wire format),
// 0 otherwise.
int sr_codec_abi(void) {
  const uint32_t probe = 1;
  uint8_t first;
  std::memcpy(&first, &probe, 1);
  return first == 1 ? 1 : 0;
}

// Encode n records into padded-slot rows, reading payload bytes straight
// out of CPython `bytes` objects — the join-free hot path. ctypes can
// turn a payload LIST into a C pointer array only at ~450 ns/row (worse
// than the copy it saves), but a numpy OBJECT array's storage *is* a
// contiguous PyObject* vector, so the Python layer passes its data
// pointer and this code walks the objects directly:
//   objs:       PyObject*[n] (a numpy object array's storage)
//   bytes_type: the `bytes` type object's address (id(bytes))
//   size_off:   byte offset of ob_size inside a bytes object (16)
//   data_off:   byte offset of the payload (bytes.__basicsize__ - 1)
// The offsets are COMPUTED AND CANARY-VERIFIED on the Python side every
// process (serde._layout_ok probes a known bytes object through ctypes
// with these exact offsets) — this file hardcodes nothing about CPython.
// Refcounts are never touched and objects are only read, so running
// GIL-free is safe as long as the caller keeps the array alive.
// Returns 0, or -(i+1) for the smallest row whose payload is not a
// bytes object or does not fit (the Python layer re-validates to raise
// the precise error, then retries with coerced payloads).
long sr_encode_rows(const void* const* objs, const void* bytes_type,
                    int64_t size_off, int64_t data_off,
                    const uint32_t* keys, int64_t n, int64_t key_words,
                    int64_t slot_words, int64_t max_payload_bytes,
                    uint32_t* out, int64_t threads) {
  const int64_t row_words = key_words + 1 + slot_words;
  const int64_t slot_bytes = slot_words * 4;
  return run_sharded(n, threads, [=](int64_t lo, int64_t hi) -> long {
    for (int64_t i = lo; i < hi; i++) {
      const char* obj = static_cast<const char*>(objs[i]);
      const void* tp;
      std::memcpy(&tp, obj + sizeof(void*), sizeof(tp));  // ob_type
      if (tp != bytes_type) return -(i + 1);
      int64_t len;
      std::memcpy(&len, obj + size_off, sizeof(len));     // ob_size
      if (len < 0 || len > max_payload_bytes || len > slot_bytes)
        return -(i + 1);
      uint32_t* row = out + i * row_words;
      std::memcpy(row, keys + i * key_words,
                  static_cast<size_t>(key_words) * 4);
      row[key_words] = static_cast<uint32_t>(len);
      uint8_t* dst = reinterpret_cast<uint8_t*>(row + key_words + 1);
      std::memcpy(dst, obj + data_off, static_cast<size_t>(len));
      std::memset(dst + len, 0, static_cast<size_t>(slot_bytes - len));
    }
    return 0;
  });
}

// Plan a decode: validate every length word and compute the pickle-item
// stream offset of each row (soff[i] = base + sum of earlier item
// sizes; an item is len + 2 bytes when len < 256 else len + 5). One
// serial pass at memory speed — cheaper than the numpy where/cumsum
// chain it replaces. Returns the total item-stream byte count, or
// -(i+1) for the first row whose length word exceeds the slot.
long sr_decode_plan(const uint32_t* rows, int64_t n, int64_t key_words,
                    int64_t slot_words, int64_t base, int64_t* soff) {
  const int64_t row_words = key_words + 1 + slot_words;
  const int64_t slot_bytes = slot_words * 4;
  int64_t off = base;
  for (int64_t i = 0; i < n; i++) {
    const int64_t len =
        static_cast<int64_t>(rows[i * row_words + key_words]);
    if (len > slot_bytes) return -(i + 1);
    soff[i] = off;
    off += len + (len < 256 ? 2 : 5);
  }
  return off - base;
}

// Decode padded-slot rows: keys land in keys_out (uint32[n * key_words]);
// payloads are emitted as a PICKLE PROTOCOL-3 ITEM STREAM (pure data
// opcodes: SHORT_BINBYTES 'C' for len < 256, BINBYTES 'B' + uint32-LE
// above) written at soff[i] inside stream_out. The Python layer wraps
// the stream with PROTO/MARK/LIST/STOP and ONE pickle.loads call
// materializes all n bytes objects inside the C unpickler — ~2x faster
// than per-row slicing under the GIL, and protocol-3 opcodes are a
// frozen format, so this is no less stable than the ctypes ABI itself.
// soff must leave exactly len + 2 (len < 256) or len + 5 bytes per row.
// Returns 0, or -(i+1) for the smallest row whose length word exceeds
// the slot (corruption).
long sr_decode_rows(const uint32_t* rows, int64_t n, int64_t key_words,
                    int64_t slot_words, uint32_t* keys_out,
                    const int64_t* soff, uint8_t* stream_out,
                    int64_t threads) {
  const int64_t row_words = key_words + 1 + slot_words;
  const int64_t slot_bytes = slot_words * 4;
  return run_sharded(n, threads, [=](int64_t lo, int64_t hi) -> long {
    for (int64_t i = lo; i < hi; i++) {
      const uint32_t* row = rows + i * row_words;
      const int64_t len = static_cast<int64_t>(row[key_words]);
      if (len > slot_bytes) return -(i + 1);
      std::memcpy(keys_out + i * key_words, row,
                  static_cast<size_t>(key_words) * 4);
      uint8_t* p = stream_out + soff[i];
      if (len < 256) {
        p[0] = 'C';  // SHORT_BINBYTES
        p[1] = static_cast<uint8_t>(len);
        p += 2;
      } else {
        p[0] = 'B';  // BINBYTES, uint32 little-endian length
        p[1] = static_cast<uint8_t>(len);
        p[2] = static_cast<uint8_t>(len >> 8);
        p[3] = static_cast<uint8_t>(len >> 16);
        p[4] = static_cast<uint8_t>(len >> 24);
        p += 5;
      }
      std::memcpy(p, row + key_words + 1, static_cast<size_t>(len));
    }
    return 0;
  });
}

// ------------------------------------------------- columnar codec (v2)
// Schema-aware layout (api/serde.py RowSchema): the payload region of a
// row is a declared sequence of fixed-width columns (uint32 = 1 word,
// int64/float64 = 2 words, lo|hi word-value encoding == the in-memory
// layout on the little-endian hosts this path is gated to) plus at most
// one trailing varlen-bytes column framed exactly like a v1 padded slot
// (length word + zero-padded bytes). Encode/decode are pure per-column
// memcpys sharded over run_sharded — no CPython object walking at all,
// which is what buys the v2 codec its headroom over sr_encode_rows.
// The Python layer validates schemas, lengths, and offsets BEFORE
// dispatching, so the length checks here are defensive; both return 0
// or -(i+1) for the smallest offending row (run_sharded's combine).

// Encode n rows: keys (uint32[n * key_words]) plus ncols fixed columns
// (srcs[c] = contiguous column storage, widths[c] words per element,
// dst_off[c] = word offset inside the payload region) plus an optional
// varlen column (var_len_word >= 0): var_off (int64[n + 1]) indexes
// var_heap, rows land as [len word | bytes, zero-padded].
long sr_encode_cols(const uint32_t* keys, int64_t n, int64_t key_words,
                    int64_t row_words, int64_t ncols,
                    const void* const* srcs, const int64_t* widths,
                    const int64_t* dst_off, int64_t var_len_word,
                    int64_t var_slot_words, int64_t var_max_bytes,
                    const int64_t* var_off, const uint8_t* var_heap,
                    uint32_t* out, int64_t threads) {
  const int64_t var_slot_bytes = var_slot_words * 4;
  return run_sharded(n, threads, [=](int64_t lo, int64_t hi) -> long {
    for (int64_t i = lo; i < hi; i++) {
      uint32_t* row = out + i * row_words;
      for (int64_t k = 0; k < key_words; k++)
        row[k] = keys[i * key_words + k];
      uint32_t* pay = row + key_words;
      for (int64_t c = 0; c < ncols; c++) {
        // fragments are 1 or 2 words: plain word stores beat a
        // runtime-size memcpy call per fragment by a wide margin
        if (widths[c] == 1) {
          pay[dst_off[c]] =
              static_cast<const uint32_t*>(srcs[c])[i];
        } else if (widths[c] == 2) {
          uint64_t v;
          std::memcpy(&v,
                      static_cast<const uint64_t*>(srcs[c]) + i,
                      sizeof(v));
          std::memcpy(pay + dst_off[c], &v, sizeof(v));
        } else {
          const int64_t wb = widths[c] * 4;
          std::memcpy(pay + dst_off[c],
                      static_cast<const uint8_t*>(srcs[c]) + i * wb,
                      static_cast<size_t>(wb));
        }
      }
      if (var_len_word >= 0) {
        const int64_t len = var_off[i + 1] - var_off[i];
        if (len < 0 || len > var_max_bytes || len > var_slot_bytes)
          return -(i + 1);
        pay[var_len_word] = static_cast<uint32_t>(len);
        uint8_t* dst = reinterpret_cast<uint8_t*>(pay + var_len_word + 1);
        std::memcpy(dst, var_heap + var_off[i], static_cast<size_t>(len));
        std::memset(dst + len, 0,
                    static_cast<size_t>(var_slot_bytes - len));
      }
    }
    return 0;
  });
}

// Decode: gather ncols fixed columns into contiguous dsts[c] (src_off[c]
// = word offset inside the payload region) and/or the varlen bytes into
// var_heap at var_off[i] (offsets precomputed by the Python layer from
// the validated length words; fixed-width-only decodes never come here
// at all — they are numpy VIEWS over the row buffer).
long sr_decode_cols(const uint32_t* rows, int64_t n, int64_t key_words,
                    int64_t row_words, int64_t ncols, void* const* dsts,
                    const int64_t* widths, const int64_t* src_off,
                    int64_t var_len_word, int64_t var_slot_words,
                    const int64_t* var_off, uint8_t* var_heap,
                    int64_t threads) {
  const int64_t var_slot_bytes = var_slot_words * 4;
  return run_sharded(n, threads, [=](int64_t lo, int64_t hi) -> long {
    for (int64_t i = lo; i < hi; i++) {
      const uint32_t* pay = rows + i * row_words + key_words;
      for (int64_t c = 0; c < ncols; c++) {
        const int64_t wb = widths[c] * 4;
        std::memcpy(static_cast<uint8_t*>(dsts[c]) + i * wb,
                    pay + src_off[c], static_cast<size_t>(wb));
      }
      if (var_len_word >= 0) {
        const int64_t len = var_off[i + 1] - var_off[i];
        if (len < 0 || len > var_slot_bytes) return -(i + 1);
        std::memcpy(var_heap + var_off[i], pay + var_len_word + 1,
                    static_cast<size_t>(len));
      }
    }
    return 0;
  });
}

// -------------------------------------------------------------- spooler
void* sr_spooler_create(size_t depth) {
  Spooler* sp = new Spooler();
  sp->depth = depth == 0 ? 8 : depth;
  sp->worker = std::thread(spool_loop, sp);
  return sp;
}

// Caller must keep `buf` alive until sr_spooler_drain returns.
int sr_spooler_submit(void* spooler, const char* path, const void* buf,
                      size_t len) {
  Spooler* sp = static_cast<Spooler*>(spooler);
  std::unique_lock<std::mutex> lk(sp->mu);
  if (sp->stopping) return -1;
  // bounded queue: block when full (the bytes-in-flight throttle)
  sp->cv_done.wait(lk, [sp] { return sp->queue.size() < sp->depth; });
  sp->queue.push_back(SpoolTask{path, buf, len});
  sp->cv_submit.notify_one();
  return 0;
}

// Wait until all submitted writes completed; returns the error count for
// THIS batch (the counter resets on drain, so a long-lived spooler reused
// after one failed batch does not report stale errors forever).
long sr_spooler_drain(void* spooler) {
  Spooler* sp = static_cast<Spooler*>(spooler);
  std::unique_lock<std::mutex> lk(sp->mu);
  sp->cv_done.wait(lk,
                   [sp] { return sp->queue.empty() && sp->in_flight == 0; });
  long batch_errors = sp->errors;
  sp->errors = 0;
  return batch_errors;
}

void sr_spooler_destroy(void* spooler) {
  Spooler* sp = static_cast<Spooler*>(spooler);
  {
    std::lock_guard<std::mutex> lk(sp->mu);
    sp->stopping = true;
  }
  sp->cv_submit.notify_all();
  sp->worker.join();
  delete sp;
}

}  // extern "C"
