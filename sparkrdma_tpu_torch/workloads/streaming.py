"""TeraSort of a dataset larger than the card: chunked input, one
shuffle+sort per chunk, sorted runs spilled to the host, or chunks
published through the tiered store.

Counterpart of ``sparkrdma_tpu.workloads.streaming``. Device residency
is bounded by about one chunk whatever the dataset's size:

    host dataset (memory, spill files, or the tiered store)
      -> InputStreamer: the copy of chunk j+1 is issued before chunk j
         is used
        -> per chunk: range-partitioned exchange + key-ordered read
          -> spill mode: copy to the host and write each partition's
             sorted run through a SpillWriter (a k-way merge of
             partition d's runs is its final stream)
          -> fold mode: fold (count, per-word sums mod 2^32) into a
             small device accumulator

The splitters come from a host sample of chunk 0 drawn with
``np.random.default_rng(0)``, as the reference draws it, so both
packages give every partition the same records.

Across processes the fold mode runs, as in the reference: every process
holds the whole host chunk (so the same splitters, with no collective),
streams its own partitions' columns, folds its partitions' reads, and
all-reduces ``(count, per-word sums)`` on a CPU tensor at the end, so
``fold_sums`` is the global one on every process. The spill mode and
:func:`run_tiered_terasort` copy whole outputs to the host and refuse
there, as the reference fails (ROADMAP A.12).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import range_partitioner
from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan
from sparkrdma_tpu_torch.hbm.host_staging import SpillWriter, read_array
from sparkrdma_tpu_torch.hbm.input_stream import (InputStreamer,
                                                  StoreChunkSource)
from sparkrdma_tpu_torch.hbm.tiered_store import store_totals
from sparkrdma_tpu_torch.meta.sampling import compute_splitters
from sparkrdma_tpu_torch.obs import trace as _trace
from sparkrdma_tpu_torch.runtime.distributed import refuse_across_processes
from sparkrdma_tpu_torch.utils.stats import barrier
from sparkrdma_tpu_torch.workloads.terasort import device_verify_sort

_LOW = 0xFFFFFFFF


@dataclasses.dataclass
class StreamingSortResult:
    chunks: int
    records: int
    record_bytes: int
    stream_s: float
    verified: Optional[bool]
    run_paths: Sequence[str] = ()
    #: fold mode: ``uint32[1 + W]``, the record count then the per-word
    #: sums mod 2^32 over every chunk (a conservation proof against the
    #: host dataset)
    fold_sums: Optional[np.ndarray] = None
    #: the input streamer's page-locked staging pool (``stats()``; empty
    #: on the CPU)
    staging: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return self.records * self.record_bytes

    @property
    def gbps(self) -> float:
        return self.total_bytes / max(self.stream_s, 1e-9) / 1e9


def _splitter_partitioner(first: np.ndarray, mesh: int, kw: int,
                          samples_per_device: int):
    """Range partitioner from a with-replacement host sample of chunk 0
    (``uint32[W, C]``), drawn as the reference draws it."""
    idx = np.random.default_rng(0).integers(
        0, first.shape[1], size=mesh * samples_per_device)
    samples = np.ascontiguousarray(first[:kw, idx].T)
    return range_partitioner(compute_splitters(samples, mesh), kw)


def _staging_stats(streamer: InputStreamer) -> dict:
    return streamer.host_pool.stats() if streamer.host_pool else {}


def run_streaming_terasort(
    manager: ShuffleManager,
    source,
    spill_dir: Optional[str] = None,
    verify: bool = False,
    samples_per_device: int = 256,
    shuffle_id_base: int = 9000,
) -> StreamingSortResult:
    """Shuffle and sort a chunked host dataset of any size.

    ``source``: an ``ArrayChunkSource`` / ``FileChunkSource`` /
    ``StoreChunkSource`` of columnar chunks. ``spill_dir``: write each
    chunk's per-partition sorted run to ``run-<chunk>-dev<d>.bin``;
    None folds the conservation sums on the device instead. ``verify``
    (host, test scale) merges the spilled runs per partition and checks
    that the result is sorted and a permutation of the input; without
    ``spill_dir`` it does nothing, as in the reference."""
    if spill_dir:
        refuse_across_processes(manager.runtime,
                                "run_streaming_terasort with spill_dir",
                                "sparkrdma_tpu/workloads/streaming.py:139")
    rt = manager.runtime
    mesh = rt.num_partitions
    kw = manager.conf.key_words
    native = manager.conf.use_native_staging
    streamer = InputStreamer(rt, source, use_native=native)
    n_chunks = len(streamer)
    if n_chunks == 0:
        raise ValueError("empty chunk source")
    part = _splitter_partitioner(source.chunk(0), mesh, kw,
                                 samples_per_device)

    spiller = SpillWriter(use_native=native, codec=manager.conf.compression,
                          level=manager.conf.compression_level) \
        if spill_dir else None
    run_paths = []
    acc = None          # fold mode: int64 [1 + W], kept mod 2^32
    records = 0
    w = None

    t0 = time.perf_counter()
    try:
        for j, chunk in enumerate(streamer):
            w = chunk.shape[0]
            # the global chunk width: each process streams its share
            records += chunk.shape[1] * rt.process_count
            sid = shuffle_id_base + j
            handle = manager.register_shuffle(sid, mesh, part)
            try:
                manager.get_writer(handle).write(chunk).stop(True)
                out, totals = manager.get_reader(
                    handle, key_ordering=True).read(record_stats=False)
                if spiller is not None:
                    # to the host before unregister hands `out` back to
                    # the pool; the writer thread persists run j while
                    # chunk j+1 is already on its way to the card
                    host = out.cpu().numpy().view(np.uint32)
                    tot = totals.tolist()
                    cap = host.shape[1] // mesh
                    for d in range(mesh):
                        path = os.path.join(spill_dir, f"run-{j}-dev{d}.bin")
                        k = int(tot[d])
                        spiller.submit(path, host[:, d * cap:d * cap + k].T)
                        run_paths.append((path, k))
                else:
                    if acc is None:
                        acc = torch.zeros(w + 1, dtype=torch.int64,
                                          device=out.device)
                    acc = _fold(acc, out, totals)
            finally:
                manager.unregister_shuffle(sid)
        if spiller is not None:
            errors = spiller.drain()
            if errors:
                raise OSError(f"{errors} spill writes failed")
        elif rt.process_count > 1:
            acc = _fold_across_processes(acc, manager.collectives)
        else:
            barrier(acc)
    finally:
        if spiller is not None:
            spiller.close()
    stream_s = time.perf_counter() - t0

    verified = None
    if verify and spill_dir:
        verified = _verify_runs(source, run_paths, mesh, kw, w, native)
    return StreamingSortResult(
        chunks=n_chunks, records=records, record_bytes=4 * (w or 0),
        stream_s=stream_s, verified=verified,
        run_paths=tuple(p for p, _ in run_paths),
        fold_sums=(None if acc is None
                   else acc.cpu().numpy().astype(np.uint32)),
        staging=_staging_stats(streamer))


def _fold(acc: torch.Tensor, out: torch.Tensor,
          totals: torch.Tensor) -> torch.Tensor:
    """``acc + (count, per-word sums)`` mod 2^32. The reference sums the
    uint32 words with wraparound; a sum of their int32 bit views in int64
    is congruent mod 2^32 (each view differs from its word by 0 or 2^32),
    so masking gives the same bits."""
    total = totals.sum(dtype=torch.int64).reshape(1)
    sums = out.sum(dim=1, dtype=torch.int64)
    return (acc + torch.cat([total, sums])) & _LOW


def _fold_across_processes(acc: torch.Tensor, coll) -> torch.Tensor:
    """The group's sum of every process's fold, mod 2^32, on the CPU: an
    int64 SUM all-reduce of values below 2^32 (an int32 one would
    overflow) in the manager's collective scope ``coll``, masked as
    :func:`_fold` masks."""
    host = acc.cpu()
    coll.all_reduce(host)
    return host & _LOW


@dataclasses.dataclass
class TieredSortResult:
    """Outcome of :func:`run_tiered_terasort`."""

    chunks: int
    records: int
    record_bytes: int
    stream_s: float
    #: the globally sorted stream (full-record order), or None with
    #: ``collect=False``
    rows: Optional[np.ndarray]
    #: (spill_bytes, fetch_bytes, prefetch_hits, sync_fetches) of this run
    store_stats: tuple = (0, 0, 0, 0)
    #: the input streamer's page-locked staging pool (empty on the CPU)
    staging: dict = dataclasses.field(default_factory=dict)
    #: ``runs[d][j]``: partition d's rows of chunk j (``uint32[k, W]``) as
    #: the key-ordered read gave them, before any reordering; None with
    #: ``collect=False``
    runs: Optional[Sequence[Sequence[np.ndarray]]] = None
    #: ``device_verify``: every chunk's read passed
    #: :func:`~sparkrdma_tpu_torch.workloads.terasort.device_verify_sort`
    #: (None when not asked)
    verified: Optional[bool] = None

    @property
    def total_bytes(self) -> int:
        return self.records * self.record_bytes

    @property
    def gbps(self) -> float:
        return self.total_bytes / max(self.stream_s, 1e-9) / 1e9


def _canon(rows: np.ndarray) -> np.ndarray:
    """Full-record order of host rows ``uint32[n, W]``: the total order
    that makes a sorted output unique, however it was chunked, spilled
    or fetched. A row's big-endian bytes compare as its words do, most
    significant first, so one sort of whole rows (a byte-wise compare)
    gives the order of a lexsort over every word."""
    if rows.shape[0] == 0:
        return rows
    be = np.ascontiguousarray(rows, dtype=">u4")
    whole = np.sort(be.view(np.dtype((np.void, 4 * be.shape[1]))).ravel())
    return whole.view(">u4").reshape(rows.shape).astype(np.uint32)


def run_tiered_terasort(
    manager: ShuffleManager,
    cols: np.ndarray,
    chunk_records: int,
    samples_per_device: int = 256,
    shuffle_id_base: int = 9500,
    checkpoint: bool = False,
    collect: bool = True,
    resume: bool = False,
    device_verify: bool = False,
) -> TieredSortResult:
    """Out-of-core TeraSort through the manager's tiered store.

    The map output ``cols`` (``uint32[W, N]``) is published chunk by
    chunk into ``manager.tiered``, whose writer evicts cold chunks to disk
    under its host watermark; the chunks are then fed back through a
    :class:`StoreChunkSource` (the prefetcher promotes chunk j+2 while
    chunk j is sorted) into the per-chunk shuffle+sort, each consumed
    chunk deleted from the store.

    ``checkpoint=True`` also saves each chunk as a segment checkpoint
    under ``shuffle_id_base``; ``resume=True`` skips publication and
    adopts that checkpoint instead (only the segments the store lacks).
    ``collect=True`` returns the full-record-ordered global stream and
    each chunk's per-partition reads; ``collect=False`` runs for
    throughput only. ``device_verify`` checks each chunk's read on the
    device that holds it (conservation, order within each partition,
    ascending partition boundaries), at the cost of a few syncs a chunk.
    """
    refuse_across_processes(manager.runtime, "run_tiered_terasort",
                            "sparkrdma_tpu/workloads/streaming.py:331")
    rt = manager.runtime
    mesh = rt.num_partitions
    kw = manager.conf.key_words
    store = manager.tiered
    cols = np.asarray(cols, dtype=np.uint32)
    w, n = cols.shape
    if n % chunk_records:
        raise ValueError(f"dataset length {n} not divisible by "
                         f"chunk_records {chunk_records}")
    n_chunks = n // chunk_records
    keys = [f"ts{shuffle_id_base}.chunk{j}" for j in range(n_chunks)]

    base0 = store_totals()
    t0 = time.perf_counter()
    # the job-trace stages of this workload (no-ops outside a job):
    # publish, one chunk_sort per chunk, collect
    with _trace.stage("publish"):
        if resume:
            manager.resume_segments(shuffle_id_base)
        else:
            # the writer evicts past the watermark while later chunks
            # publish
            segs = []
            for j in range(n_chunks):
                chunk = cols[:, j * chunk_records:(j + 1) * chunk_records]
                # tenant-tagged (a service session's quota), not
                # shuffle-tagged: the staged chunks are this workload's
                # own working set, which unregister_shuffle must not drop
                store.put(keys[j], chunk, tenant=manager.tenant)
                if checkpoint:
                    segs.append((keys[j], chunk))
            if checkpoint:
                # segment checkpoints carry the chunks and a trivial plan
                plan = ShufflePlan(
                    counts=np.zeros((mesh, mesh), np.int64), num_rounds=1,
                    out_capacity=chunk_records // mesh,
                    capacity=chunk_records // mesh, split_factor=1)
                manager.checkpoint_segments(shuffle_id_base, segs, plan,
                                            mesh)
                del segs

        # splitters from chunk 0, riding a promotion rather than a sync
        # fetch
        store.prefetch(keys[:1])
        part = _splitter_partitioner(store.get(keys[0]), mesh, kw,
                                     samples_per_device)

    streamer = InputStreamer(rt, StoreChunkSource(
        store, keys, lookahead=manager.conf.spill_tier_prefetch),
        use_native=manager.conf.use_native_staging)
    device_rows: list = [[] for _ in range(mesh)]
    records = 0
    verified = None
    for j, chunk in enumerate(streamer):
        records += chunk.shape[1]
        # exchange ids start at base + 1: a resumed checkpoint's segments
        # are tagged with the base id itself
        sid = shuffle_id_base + 1 + j
        handle = manager.register_shuffle(sid, mesh, part)
        try:
            with _trace.stage("chunk_sort", attempt=j):
                # each chunk's span carries the store's spill and fetch
                # totals and its spill:* events: the evidence that tier
                # I/O overlapped the exchanges
                manager.get_writer(handle).write(chunk).stop(True)
                out, totals = manager.get_reader(handle,
                                                 key_ordering=True).read()
                if device_verify:
                    ok = device_verify_sort(manager, chunk, out, totals, kw,
                                            out.shape[1] // mesh)
                    verified = ok if verified is None else verified and ok
                if collect:
                    host = out.cpu().numpy().view(np.uint32)
                    tot = totals.tolist()
                    cap = host.shape[1] // mesh
                    for d in range(mesh):
                        k = int(tot[d])
                        device_rows[d].append(
                            np.array(host[:, d * cap:d * cap + k].T))
                else:
                    barrier(out)
        finally:
            manager.unregister_shuffle(sid)
            # the consumed chunk leaves the store, bounding occupancy
            store.delete(keys[j])
    stream_s = time.perf_counter() - t0

    rows = None
    if collect:
        with _trace.stage("collect"):
            rows = _canon(np.concatenate(
                [r for per_dev in device_rows for r in per_dev])
                if records else np.zeros((0, w), np.uint32))
    return TieredSortResult(
        chunks=n_chunks, records=records, record_bytes=4 * w,
        stream_s=stream_s, rows=rows,
        store_stats=tuple(b - a for a, b in zip(base0, store_totals())),
        staging=_staging_stats(streamer),
        runs=([tuple(r) for r in device_rows] if collect else None),
        verified=verified)


def _verify_runs(source, run_paths, mesh, kw, w,
                 native: bool = True) -> bool:
    """Host-side external-merge proof (test scale): each run is sorted,
    partition key ranges ascend, and the runs hold the input multiset."""
    all_rows = []
    prev_dev_max = None
    for d in range(mesh):
        runs = []
        for path, k in run_paths:
            if f"dev{d}.bin" not in os.path.basename(path):
                continue
            rows = read_array(path, np.uint32, (k, w), use_native=native)
            keys = rows[:, 0].astype(np.uint64)
            for i in range(1, kw):
                keys = (keys << np.uint64(32)) | rows[:, i]
            if np.any(keys[1:] < keys[:-1]):
                return False                      # run not sorted
            if k:
                runs.append((keys, rows))
        # the merge of sorted runs is sorted by construction; what is
        # left to prove is that partition key ranges ascend
        if runs:
            lo = min(int(keys[0]) for keys, _ in runs)
            if prev_dev_max is not None and lo < prev_dev_max:
                return False                      # partition boundary
            prev_dev_max = max(int(keys[-1]) for keys, _ in runs)
        all_rows.extend(rows for _, rows in runs)
    got = (np.concatenate(all_rows) if all_rows
           else np.zeros((0, w), np.uint32))
    ref = np.concatenate(
        [source.chunk(j).T for j in range(len(source))])
    if got.shape != ref.shape:
        return False
    return bool(np.array_equal(_canon(got), _canon(ref)))


__all__ = ["run_streaming_terasort", "StreamingSortResult",
           "run_tiered_terasort", "TieredSortResult"]
