"""TeraSort — the main path of the system, on the stacked runtime.

sample -> range splitters -> range-partitioned slotted exchange ->
per-partition sort; the global output is the concatenation of the
sorted partitions in partition order. Counterpart of
``sparkrdma_tpu.workloads.terasort``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import (mul32,
                                                       range_partitioner)
from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan
from sparkrdma_tpu_torch.kernels.sort import as_unsigned
from sparkrdma_tpu_torch.meta.sampling import compute_splitters, make_sampler
from sparkrdma_tpu_torch.utils.stats import Timer, barrier

_LOW = 0xFFFFFFFF


@dataclasses.dataclass
class TeraSortResult:
    records: int
    record_bytes: int
    sample_s: float
    plan_s: float
    sort_exchange_s: float
    verified: bool
    plan: Optional[ShufflePlan] = None

    @property
    def total_bytes(self) -> int:
        return self.records * self.record_bytes

    @property
    def gbps(self) -> float:
        return self.total_bytes / max(self.sort_exchange_s, 1e-9) / 1e9


def _as_host_u32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().numpy().view(np.uint32)
    return np.asarray(a, dtype=np.uint32)


def validate_global_sort(out, totals, x_input: np.ndarray, key_words: int,
                         out_capacity: int) -> bool:
    """Sorted + permutation-of-input check (host side, test-sized data).

    ``out`` is the columnar read result ``[W, D*out_capacity]``;
    ``x_input`` host rows ``uint32[N, W]``."""
    out = _as_host_u32(out)
    totals = np.asarray(totals.cpu() if isinstance(totals, torch.Tensor)
                        else totals)
    prev_max = None
    collected = []
    for d in range(totals.shape[0]):
        k = int(totals[d])
        dev = out[:, d * out_capacity:d * out_capacity + k].T
        collected.append(dev)
        if k == 0:
            continue
        keys = dev[:, :key_words].astype(np.uint64)
        flat = keys[:, 0]
        for w in range(1, key_words):
            flat = (flat << np.uint64(32)) | keys[:, w]
        if np.any(flat[1:] < flat[:-1]):
            return False
        if prev_max is not None and flat[0] < prev_max:
            return False
        prev_max = flat[-1]
    got = np.concatenate(collected) if collected else np.zeros_like(x_input)
    if got.shape[0] != x_input.shape[0]:
        return False

    def canon(a):
        return a[np.lexsort(tuple(a[:, c]
                                  for c in range(a.shape[1] - 1, -1, -1)))]
    return bool(np.array_equal(canon(got), canon(x_input)))


def _rec_hash(cols: torch.Tensor) -> torch.Tensor:
    """Per-record word-mixing hash (uint32 values in int64)."""
    h = torch.full((cols.shape[1],), 0x9E3779B9, dtype=torch.int64,
                   device=cols.device)
    for i in range(cols.shape[0]):
        h = h ^ mul32(as_unsigned(cols[i]), 0x85EBCA6B)
        h = ((h << 13) | (h >> 19)) & _LOW
        h = mul32(h, 0xC2B2AE35)
    return h


def _sums(cols: torch.Tensor, keep: Optional[torch.Tensor]) -> list:
    """Per-word sums and the record-hash sum, each mod 2^32."""
    def s(v):
        if keep is not None:
            v = v * keep
        return int(v.sum()) & _LOW
    return [s(as_unsigned(cols[i])) for i in range(cols.shape[0])] \
        + [s(_rec_hash(cols))]


def device_verify_sort(manager: ShuffleManager, records: torch.Tensor,
                       out: torch.Tensor, totals: torch.Tensor,
                       key_words: int, out_capacity: int) -> bool:
    """Large-scale invariant check, on the device that holds the data:
    conservation (count, per-word sums and a per-record hash sum mod
    2^32), order within each partition's valid prefix, and ascending
    partition boundaries. Not a full permutation proof."""
    mesh = manager.runtime.num_partitions
    tot = [int(t) for t in totals.tolist()]
    if sum(tot) != records.shape[1]:
        return False
    pos = torch.arange(mesh * out_capacity, device=out.device)
    keep = ((pos % out_capacity)
            < totals.to(torch.int64).repeat_interleave(out_capacity))
    if _sums(records, None) != _sums(out, keep.to(torch.int64)):
        return False
    prev = None
    for d in range(mesh):
        if tot[d] == 0:
            continue
        part = out[:key_words, d * out_capacity:d * out_capacity + tot[d]]
        gt = torch.zeros(tot[d] - 1, dtype=torch.bool, device=out.device)
        eq = torch.ones_like(gt)
        for k in range(key_words):
            a = as_unsigned(part[k, :-1])
            b = as_unsigned(part[k, 1:])
            gt = gt | (eq & (a > b))
            eq = eq & (a == b)
        if bool(gt.any()):
            return False
        ends = as_unsigned(part[:, [0, tot[d] - 1]]).T.tolist()
        first = tuple(ends[0])
        if prev is not None and first < prev:
            return False
        prev = tuple(ends[1])
    return True


def random_records(num_records: int, words: int, seed: int,
                   device) -> torch.Tensor:
    """Uniform uint32 records ``int32[W, N]`` made on ``device`` from a
    seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 1 << 32, (words, num_records), generator=gen,
                      dtype=torch.int64, device=device)
    return (x - ((x >> 31) << 32)).to(torch.int32)


def run_terasort(manager: ShuffleManager, records_per_device: int,
                 seed: int = 0, shuffle_id: int = 1,
                 samples_per_device: int = 256, verify: bool = True,
                 warmup: bool = True,
                 input_records: Optional[torch.Tensor] = None,
                 repeats: int = 1, device_verify: bool = False
                 ) -> Tuple[TeraSortResult, torch.Tensor, torch.Tensor]:
    """Returns ``(result, sorted_records, totals)``; ``repeats > 1``
    times that many back-to-back exchange+sort reads. ``sorted_records``
    is a copy the caller owns, safe across later exchanges."""
    rt = manager.runtime
    mesh = rt.num_partitions
    kw = manager.conf.key_words
    if input_records is None:
        records = random_records(mesh * records_per_device,
                                 manager.conf.record_words, seed, rt.device)
    else:
        records = input_records
    rec_words, n_records = records.shape
    x = rt.host_rows(records) if verify else None

    with Timer() as t_sample:
        sampler = make_sampler(mesh, kw, samples_per_device, seed)
        splitters = compute_splitters(sampler(records), mesh)

    part = range_partitioner(splitters, kw)
    handle = manager.register_shuffle(shuffle_id, mesh, part)
    try:
        writer = manager.get_writer(handle).write(records)
        with Timer() as t_plan:
            plan = writer.stop(True)

        reader = manager.get_reader(handle, key_ordering=True)
        if warmup:
            barrier(*reader.read())
        t0 = time.perf_counter()
        for _ in range(repeats - 1):
            reader.read()
        out, totals = reader.read()
        barrier(out, totals)
        sort_exchange_s = (time.perf_counter() - t0) / max(repeats, 1)

        verified = True
        if verify:
            verified = validate_global_sort(out, totals, x, kw,
                                            plan.out_capacity)
        if device_verify:
            verified = verified and device_verify_sort(
                manager, records, out, totals, kw, plan.out_capacity)
        res = TeraSortResult(records=n_records, record_bytes=rec_words * 4,
                             sample_s=t_sample.elapsed,
                             plan_s=t_plan.elapsed,
                             sort_exchange_s=sort_exchange_s,
                             verified=verified, plan=plan)
        # detach from the exchange's recycled output buffer: the finally
        # block's unregister hands it back to the pool, and a later
        # same-shape exchange would overwrite it under the caller
        return res, out.clone(), totals
    finally:
        manager.unregister_shuffle(shuffle_id)


__all__ = ["run_terasort", "TeraSortResult", "validate_global_sort",
           "device_verify_sort", "random_records"]
