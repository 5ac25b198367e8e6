"""Repartition microbenchmark — ``BASELINE.md`` config 1.

Counterpart of ``sparkrdma_tpu.workloads.repartition``: a
``repartition(num_parts)`` shuffle of random records with a 2-word
(64-bit) key, hashed to their destinations. Every byte crosses the
exchange once and nothing is computed on it: a pure transport
benchmark.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from sparkrdma_tpu_torch.api.shuffle_manager import (ShuffleManager,
                                                     _partition_windows)
from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan
from sparkrdma_tpu_torch.utils.stats import barrier
from sparkrdma_tpu_torch.workloads.terasort import _sums


@dataclasses.dataclass
class RepartitionResult:
    records: int
    record_bytes: int
    plan_s: float
    exchange_s: float
    verified: bool

    @property
    def total_bytes(self) -> int:
        return self.records * self.record_bytes

    @property
    def gbps(self) -> float:
        return self.total_bytes / max(self.exchange_s, 1e-9) / 1e9


def generate_records(manager: ShuffleManager, records_per_device: int,
                     seed: int = 0) -> torch.Tensor:
    """Random records as a columnar stacked batch (the map-stage input):
    the reference's rows for the same seed."""
    mesh = manager.runtime.num_partitions
    w = manager.conf.record_words
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=(mesh * records_per_device, w),
                     dtype=np.uint32)
    return manager.runtime.shard_records(x)


def device_verify_placement(manager: ShuffleManager, records: torch.Tensor,
                            out: torch.Tensor, totals: torch.Tensor,
                            plan: ShufflePlan, partitioner,
                            num_parts: int) -> bool:
    """Check a raw read on the device that holds it: conservation
    (count, per-word sums and a record-hash sum mod 2^32), and every
    received record inside the window of the partition its key hashes to
    (the windows ``read_partition`` cuts, skew-split plans included)."""
    mesh = manager.runtime.num_partitions
    cap = plan.out_capacity
    tot = [int(t) for t in totals.tolist()]
    if sum(tot) != records.shape[1]:
        return False
    pos = torch.arange(mesh * cap, device=out.device)
    keep = ((pos % cap)
            < totals.to(torch.int64).repeat_interleave(cap))
    if _sums(records, None) != _sums(out, keep.to(torch.int64)):
        return False
    spans = [[] for _ in range(mesh)]
    for p in range(num_parts):
        for d, start, length in _partition_windows(plan, mesh, num_parts, p):
            spans[d].append((start, length, p))
    for d in range(mesh):
        spans[d].sort()
        starts = [s for s, _, _ in spans[d]]
        lengths = [n for _, n, _ in spans[d]]
        if starts != list(np.cumsum([0] + lengths[:-1])) \
                or sum(lengths) != tot[d]:
            return False
        want = torch.tensor([p for _, _, p in spans[d]],
                            device=out.device).repeat_interleave(
            torch.tensor(lengths, device=out.device))
        got = partitioner(out[:, d * cap:d * cap + tot[d]])
        if not torch.equal(got.to(torch.int64), want):
            return False
    return True


def run_repartition(
    manager: ShuffleManager,
    records_per_device: int,
    num_parts: Optional[int] = None,
    seed: int = 0,
    shuffle_id: int = 0,
    verify: bool = True,
    warmup: bool = True,
    device_verify: bool = False,
) -> RepartitionResult:
    """End to end: generate, register, write and plan, read (one untimed
    warm-up read first when ``warmup``), verify the total.
    ``device_verify`` also checks the read on its device
    (:func:`device_verify_placement`), as TeraSort's option does."""
    num_parts = num_parts or manager.runtime.num_partitions
    part = hash_partitioner(num_parts, manager.conf.key_words)
    records = generate_records(manager, records_per_device, seed)

    handle = manager.register_shuffle(shuffle_id, num_parts, part)
    try:
        writer = manager.get_writer(handle).write(records)
        t0 = time.perf_counter()
        writer.stop(True)
        plan_s = time.perf_counter() - t0

        reader = manager.get_reader(handle)
        if warmup:
            barrier(reader.read(record_stats=False)[0])
        t0 = time.perf_counter()
        out, totals = reader.read()
        barrier(out)
        exchange_s = time.perf_counter() - t0

        verified = True
        if verify:
            verified = int(totals.sum()) == records.shape[1]
        if device_verify:
            verified = verified and device_verify_placement(
                manager, records, out, totals, writer.plan, part, num_parts)
        return RepartitionResult(
            records=records.shape[1], record_bytes=records.shape[0] * 4,
            plan_s=plan_s, exchange_s=exchange_s, verified=verified)
    finally:
        manager.unregister_shuffle(shuffle_id)


__all__ = ["run_repartition", "RepartitionResult", "generate_records",
           "device_verify_placement"]
