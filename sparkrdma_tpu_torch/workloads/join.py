"""Hash-join workload — the shuffle join of TPC-DS-style queries.

Counterpart of ``sparkrdma_tpu.workloads.join``. Both tables are
co-partitioned by key through two slotted exchanges with the same hash
partitioner; then each stacked partition runs a sort-merge join.
:func:`_local_join` gives the two standard reductions (match count and
the sum of payload products) without materializing pairs;
:func:`_local_join_rows` materializes the joined rows at a fixed
capacity with an overflow contract. Keys for :func:`run_hash_join` are
single-word (the low key word).

uint32 keys are compared as int64 (``as_unsigned``): torch sorts and
searches no uint32. Padding takes the sentinel key ``0xFFFFFFFF``,
which sorts last; a valid record may carry that key too, so validity,
never the position, decides what counts. Payload sums are float32 prefix
sums, as in the reference, so they carry its rounding: see ROADMAP §C
for their error at scale.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner
from sparkrdma_tpu_torch.kernels.sort import as_unsigned
from sparkrdma_tpu_torch.runtime.distributed import refuse_across_processes
from sparkrdma_tpu_torch.utils.stats import barrier

_SENTINEL = 0xFFFFFFFF
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class JoinResult:
    rows_a: int
    rows_b: int
    matches: int
    sum_products: float
    shuffle_s: float
    join_s: float
    verified: Optional[bool] = None


def _key_sort(keys: torch.Tensor, valid: torch.Tensor):
    """Stable ascending order of one uint32 key row, padding taking the
    sentinel key: ``(sorted unsigned keys int64, perm)``."""
    k = torch.where(valid, as_unsigned(keys), _SENTINEL)
    k_s, perm = torch.sort(k, stable=True)
    return k_s, perm


def _local_join(cols_a: torch.Tensor, total_a: int, cols_b: torch.Tensor,
                total_b: int, key_ix: int = 1, pay_ix: int = 2
                ) -> Tuple[int, torch.Tensor]:
    """One partition's sort-merge join -> ``(count, sum of payload
    products)`` (the sum a float32 0-d tensor).

    Both sides sort stably by the key word; for each A record the range
    of equal B keys comes from two ``searchsorted``, and B's per-key
    count and payload sum from validity-masked prefix sums over it (so
    padding inside a range adds zero)."""
    dev = cols_a.device
    va = torch.arange(cols_a.shape[1], device=dev) < total_a
    vb = torch.arange(cols_b.shape[1], device=dev) < total_b
    sa, pa_perm = _key_sort(cols_a[key_ix], va)
    sb, pb_perm = _key_sort(cols_b[key_ix], vb)
    pa = as_unsigned(cols_a[pay_ix][pa_perm]).to(torch.float32)
    pb = as_unsigned(cols_b[pay_ix][pb_perm]).to(torch.float32)
    va_s, vb_s = va[pa_perm], vb[pb_perm]

    zero_f = torch.zeros(1, dtype=torch.float32, device=dev)
    zero_i = torch.zeros(1, dtype=torch.int64, device=dev)
    csum = torch.cat([zero_f, torch.cumsum(pb * vb_s, 0)])
    ccnt = torch.cat([zero_i, torch.cumsum(vb_s.to(torch.int64), 0)])
    lo = torch.searchsorted(sb, sa, side="left")
    hi = torch.searchsorted(sb, sa, side="right")
    cnt_per_a = (ccnt[hi] - ccnt[lo]) * va_s
    sum_per_a = (csum[hi] - csum[lo]) * va_s
    return int(cnt_per_a.sum()), torch.sum(pa * sum_per_a)


def _local_join_rows(cols_a: torch.Tensor, total_a: int,
                     cols_b: torch.Tensor, total_b: int, out_capacity: int,
                     key_ix: int, kw: int, val_a: int, val_b: int
                     ) -> Tuple[torch.Tensor, int]:
    """One partition's sort-merge join MATERIALIZING the joined rows:
    ``(joined [kw + val_a + val_b, out_capacity], count)``, ``count`` the
    TRUE match count — ``count > out_capacity`` means the capacity was too
    small and rows past it are absent. A joined row is A's key words, A's
    payload words, then B's payload words; the tail is zero.

    Both sides sort stably by the key, full records riding: one
    permutation and one gather at any width, which gives the rows of
    every one of the reference's sort routes. Each A row's match range
    in B gives, by an exclusive prefix sum of
    match counts, its output offset; every output slot finds its A row
    by one ``searchsorted`` into those offsets and its B row by
    inverting B's validity prefix sum. A count past ``2**31 - 1``, where
    the reference's int32 prefix sum wraps, is pinned to ``2**31 - 1`` as
    the reference pins it, so the caller's overflow check fires."""
    dev = cols_a.device
    cap_a, cap_b = cols_a.shape[1], cols_b.shape[1]
    va = torch.arange(cap_a, device=dev) < total_a
    vb = torch.arange(cap_b, device=dev) < total_b
    ka_s, perm_a = _key_sort(cols_a[key_ix], va)
    kb_s, perm_b = _key_sort(cols_b[key_ix], vb)
    va_s, a_rows = va[perm_a], cols_a[:, perm_a]
    vb_s, b_rows = vb[perm_b], cols_b[:, perm_b]

    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    ccnt = torch.cat([zero, torch.cumsum(vb_s.to(torch.int64), 0)])
    lo = torch.searchsorted(kb_s, ka_s, side="left")
    hi = torch.searchsorted(kb_s, ka_s, side="right")
    cnt = (ccnt[hi] - ccnt[lo]) * va_s
    starts = torch.cat([zero, torch.cumsum(cnt, 0)])
    count = min(int(starts[-1]), _INT32_MAX)

    j = torch.arange(out_capacity, device=dev)
    a_ix = (torch.searchsorted(starts, j, side="right") - 1).clamp(
        0, cap_a - 1)
    off = j - starts[a_ix]
    b_rank = ccnt[lo[a_ix]] + off            # validity rank of the B row
    b_ix = torch.searchsorted(ccnt[1:], b_rank + 1, side="left").clamp(
        0, cap_b - 1)
    live = j < min(count, out_capacity)
    a_sel = a_rows[:, a_ix]
    b_sel = b_rows[kw:kw + val_b, b_ix]
    joined = torch.cat([a_sel[:kw + val_a], b_sel])
    return torch.where(live[None], joined, 0), count


def run_hash_join(
    manager: ShuffleManager,
    rows_per_device_a: int,
    rows_per_device_b: int,
    key_range: int = 1 << 12,
    seed: int = 0,
    shuffle_ids: Tuple[int, int] = (30, 31),
    verify: bool = True,
    key_offset_b: int = 0,
) -> JoinResult:
    """Generate both tables (the reference's rows for the same seed),
    shuffle each by the hash of its key, join every partition, and sum.
    ``key_offset_b`` shifts B's key range (by ``key_range``: disjoint
    sides, the zero-match path). The reference caches its compiled join
    program per manager; torch compiles nothing, so there is no cache."""
    refuse_across_processes(manager.runtime, "run_hash_join",
                            "sparkrdma_tpu/workloads/join.py:254")
    rt = manager.runtime
    mesh = rt.num_partitions
    conf = manager.conf
    w = conf.record_words
    if conf.val_words < 1:
        raise ValueError("hash join needs at least one payload word")
    key_ix = conf.key_words - 1
    pay_ix = conf.key_words
    rng = np.random.default_rng(seed)

    def gen(n, key_offset):
        x = np.zeros((mesh * n, w), dtype=np.uint32)
        x[:, key_ix] = rng.integers(0, key_range, size=mesh * n) + key_offset
        x[:, pay_ix] = rng.integers(1, 1000, size=mesh * n)
        return x

    xa = gen(rows_per_device_a, 0)
    xb = gen(rows_per_device_b, key_offset_b)
    part = hash_partitioner(mesh, conf.key_words)

    t0 = time.perf_counter()
    outs = []
    # both shuffles stay registered until the join has consumed their
    # outputs: unregister hands a read's buffer back to the pool
    for sid, x in zip(shuffle_ids, (xa, xb)):
        handle = manager.register_shuffle(sid, mesh, part)
        writer = manager.get_writer(handle).write(rt.shard_records(x))
        writer.stop(True)
        out, totals = manager.get_reader(handle).read()
        outs.append((out, totals, writer.plan.out_capacity))
    barrier(outs[-1][0])
    shuffle_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    (oa, ta, ca), (ob, tb, cb) = outs
    ta, tb = ta.tolist(), tb.tolist()
    count = 0
    sums = []
    for d in range(mesh):
        c, s = _local_join(oa[:, d * ca:(d + 1) * ca], ta[d],
                           ob[:, d * cb:(d + 1) * cb], tb[d],
                           key_ix=key_ix, pay_ix=pay_ix)
        count += c
        sums.append(s)
    prods = float(torch.stack(sums).sum())
    join_s = time.perf_counter() - t0

    for sid in shuffle_ids:
        manager.unregister_shuffle(sid)

    verified = None
    if verify:
        ref_count, ref_sum = _numpy_reference_join(xa, xb, key_ix, pay_ix)
        verified = (count == ref_count
                    and abs(prods - ref_sum) <= 1e-6 * max(1.0, abs(ref_sum)))
    return JoinResult(
        rows_a=xa.shape[0], rows_b=xb.shape[0], matches=count,
        sum_products=prods, shuffle_s=shuffle_s, join_s=join_s,
        verified=verified)


def _numpy_reference_join(xa: np.ndarray, xb: np.ndarray, key_ix: int = 1,
                          pay_ix: int = 2) -> Tuple[int, float]:
    """Match count and float64 sum of payload products, in numpy, as the
    reference's dictionary loop computes them, by key: each key's A
    count times its B count, and its A payload sum times its B payload
    sum. Keys index the counts directly when they are small, else their
    ``np.unique`` ranks do."""
    ka, pa = xa[:, key_ix], xa[:, pay_ix].astype(np.float64)
    kb, pb = xb[:, key_ix], xb[:, pay_ix].astype(np.float64)
    keys = np.concatenate([ka, kb]).astype(np.int64)
    if keys.size and keys.max() < 4 * keys.size:
        ids, n = keys, int(keys.max()) + 1
    else:
        uniq, ids = np.unique(keys, return_inverse=True)
        n = len(uniq)
    ia, ib = ids[:len(ka)], ids[len(ka):]
    count = int(np.dot(np.bincount(ia, minlength=n),
                       np.bincount(ib, minlength=n)))
    total = float(np.dot(np.bincount(ia, weights=pa, minlength=n),
                         np.bincount(ib, weights=pb, minlength=n)))
    return count, total


__all__ = ["run_hash_join", "JoinResult"]
