"""Pipelined host -> device input feed for datasets larger than the card.

Counterpart of ``sparkrdma_tpu.hbm.input_stream``. The dataset lives on
the host (in memory, in spill files, or in the tiered store) as columnar
chunks ``uint32[W, chunk_records]``, and flows to the device a chunk at
a time:

- :class:`ArrayChunkSource` slices one host array;
- :class:`FileChunkSource` reads per-chunk spill files, reading the next
  file on a background thread while the current chunk is consumed;
- :class:`StoreChunkSource` gets chunks out of a
  :class:`~sparkrdma_tpu_torch.hbm.tiered_store.TieredStore`, queueing
  promotions of the next ``lookahead`` keys first;
- :class:`InputStreamer` yields each chunk as ``int32[W, C]`` on the
  runtime's device (the layout of ``MeshRuntime.shard_records``), with
  the copies of the next ``prefetch`` chunks already issued.

On a CUDA runtime a copy from pageable memory would hold the host until
it finished, so the streamer first copies each chunk into a page-locked
lease of its own :class:`~sparkrdma_tpu_torch.hbm.host_staging
.HostBufferPool`, then issues the copy to the card on a side stream and
records an event. The consuming stream waits on that event before the
chunk is used, and the lease goes back to the pool only once the event
has completed, so a later chunk never overwrites a copy in flight.
"""

from __future__ import annotations

import concurrent.futures
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.hbm.host_staging import HostBufferPool, read_array


class ArrayChunkSource:
    """Chunks sliced from one host-resident columnar array ``[W, N]``."""

    def __init__(self, cols: np.ndarray, chunk_records: int):
        if cols.shape[1] % chunk_records:
            raise ValueError(
                f"dataset length {cols.shape[1]} not divisible by "
                f"chunk_records {chunk_records}")
        self._cols = cols
        self._c = chunk_records

    def __len__(self) -> int:
        return self._cols.shape[1] // self._c

    def chunk(self, j: int) -> np.ndarray:
        return self._cols[:, j * self._c:(j + 1) * self._c]


class FileChunkSource:
    """Chunks read from per-chunk spill files, the next one read ahead
    on a background thread; the last chunk read is cached (the splitter
    sample reads chunk 0, then the stream reads it again)."""

    def __init__(self, paths: Sequence[str], record_words: int,
                 chunk_records: int):
        self._paths = list(paths)
        self._shape = (record_words, chunk_records)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._next: Optional[Tuple[int, concurrent.futures.Future]] = None
        self._last: Optional[Tuple[int, np.ndarray]] = None

    def __len__(self) -> int:
        return len(self._paths)

    def _read(self, j: int) -> np.ndarray:
        return read_array(self._paths[j], np.uint32, self._shape)

    def chunk(self, j: int) -> np.ndarray:
        if self._last is not None and self._last[0] == j:
            return self._last[1]
        fut = None
        if self._next is not None and self._next[0] == j:
            fut = self._next[1]
            self._next = None
        arr = fut.result() if fut is not None else self._read(j)
        if j + 1 < len(self._paths) and (self._next is None
                                         or self._next[0] != j + 1):
            self._next = (j + 1, self._pool.submit(self._read, j + 1))
        self._last = (j, arr)
        return arr

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class StoreChunkSource:
    """Chunks served out of a tiered store by key: ``chunk(j)`` queues
    promotions of the next ``lookahead`` keys, then gets key ``j`` (a
    miss shows as a ``store.sync_fetches`` tick)."""

    def __init__(self, store, keys: Sequence[str], lookahead: int = 2):
        self._store = store
        self._keys = list(keys)
        self._lookahead = max(0, lookahead)

    def __len__(self) -> int:
        return len(self._keys)

    def chunk(self, j: int) -> np.ndarray:
        if self._lookahead > 0:
            self._store.prefetch(
                self._keys[j + 1:j + 1 + self._lookahead])
        return self._store.get(self._keys[j])


class InputStreamer:
    """Double-buffered host -> device chunk feed: iterating yields each
    chunk on the device, the copies of the next ``prefetch`` chunks
    already in flight. On a CUDA runtime ``host_pool`` is the page-locked
    staging pool (None on the CPU)."""

    def __init__(self, runtime, source, prefetch: int = 1):
        self._rt = runtime
        self._src = source
        self._prefetch = max(0, prefetch)
        self._cuda = runtime.device.type == "cuda"
        self.host_pool = HostBufferPool(pinned=True) if self._cuda else None

    def __len__(self) -> int:
        return len(self._src)

    def _put(self, cols: np.ndarray):
        """Start one chunk's trip to the device: ``(tensor, lease,
        event)``, the last two None on the CPU."""
        cols = np.asarray(cols, dtype=np.uint32)
        if not self._cuda:
            return torch.from_numpy(
                np.array(cols, order="C").view(np.int32)), None, None
        lease = self.host_pool.get(cols.nbytes)
        lease.view(np.uint32, cols.shape)[...] = cols
        src = lease.tensor[:cols.nbytes].view(torch.int32).view(cols.shape)
        with torch.cuda.stream(self._stream):
            dev = torch.empty(cols.shape, dtype=torch.int32,
                              device=self._rt.device)
            dev.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return dev, lease, ev

    def __iter__(self) -> Iterator[torch.Tensor]:
        n = len(self._src)
        if self._cuda:
            self._stream = torch.cuda.Stream(device=self._rt.device)
        pending: list = []     # (tensor, lease, event) for [j, next_put)
        done: list = []        # consumed chunks' (lease, event)
        next_put = 0
        try:
            for j in range(n):
                # keep `prefetch` copies in flight beyond the current one
                while next_put < min(j + 1 + self._prefetch, n):
                    pending.append(self._put(self._src.chunk(next_put)))
                    next_put += 1
                dev, lease, ev = pending.pop(0)
                if ev is not None:
                    cur = torch.cuda.current_stream(self._rt.device)
                    cur.wait_event(ev)
                    dev.record_stream(cur)
                    done.append((lease, ev))
                yield dev
                del dev
                # leases of consumed chunks whose copies have landed
                while done and done[0][1].query():
                    done.pop(0)[0].release()
        finally:
            for lease, ev in done + [(p[1], p[2]) for p in pending
                                     if p[1] is not None]:
                ev.synchronize()
                lease.release()


__all__ = ["InputStreamer", "ArrayChunkSource", "FileChunkSource",
           "StoreChunkSource"]
