"""Splitter computation for range partitioning — sortByKey's sampler.

Each stacked partition draws ``samples_per_device`` uniform indices with
replacement from its own records; the reference draws them with
``jax.random``, which torch cannot reproduce, so the indices come from a
``torch.Generator`` seeded per partition. ``compute_splitters`` is equal
to the reference's on the same samples.

Across processes (a ``runtime`` spanning a ``torch.distributed`` group)
each process samples its own partitions, each with the generator the
one-process sampler gives that partition, and the samples are
all-gathered on CPU tensors (in the caller's collective scope), so every
process computes the same splitters (the reference's ``all_gather`` of
its samples).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from sparkrdma_tpu_torch.kernels.sort import lexsort_records
from sparkrdma_tpu_torch.runtime.distributed import WORLD


def make_sampler(num_partitions: int, key_words: int,
                 samples_per_device: int, seed: int = 0,
                 runtime=None, collectives=WORLD) -> Callable:
    """``records [W, D*n] -> uint32[D * samples_per_device, key_words]``
    (host array, partition-major). With a ``runtime`` that spans
    processes, ``records`` is the local batch ``[W, L*n]`` and the
    result is still every partition's sample, gathered in the
    ``collectives`` scope (a manager's ``collectives``)."""
    local = range(num_partitions)
    procs = 1
    if runtime is not None:
        if runtime.num_partitions != num_partitions:
            raise ValueError(f"sampler for {num_partitions} partitions, "
                             f"runtime has {runtime.num_partitions}")
        local = runtime.local_device_indices()
        procs = runtime.process_count

    def sample(records: torch.Tensor) -> np.ndarray:
        n = records.shape[1] // len(local)
        parts = []
        for r, d in enumerate(local):
            gen = torch.Generator().manual_seed(seed * 1_000_003 + d)
            idx = torch.randint(0, max(n, 1), (samples_per_device,),
                                generator=gen) + r * n
            parts.append(records[:key_words, idx.to(records.device)].T)
        rows = torch.cat(parts).cpu().contiguous()
        if procs > 1:
            gathered = [torch.empty_like(rows) for _ in range(procs)]
            collectives.all_gather(gathered, rows)
            rows = torch.cat(gathered)
        return rows.numpy().view(np.uint32)

    return sample


def compute_splitters(samples: np.ndarray, num_parts: int) -> np.ndarray:
    """Quantile boundaries ``uint32[num_parts - 1, key_words]``, ascending."""
    samples = np.asarray(samples, dtype=np.uint32)
    if samples.ndim != 2:
        raise ValueError("samples must be [n, key_words]")
    n, kw = samples.shape
    if n == 0 or num_parts < 2:
        return np.zeros((max(0, num_parts - 1), kw), dtype=np.uint32)
    rows = torch.from_numpy(np.ascontiguousarray(samples).view(np.int32))
    srt = lexsort_records(rows, kw).numpy().view(np.uint32)
    idx = (np.arange(1, num_parts) * n) // num_parts
    return srt[idx].astype(np.uint32)


__all__ = ["make_sampler", "compute_splitters"]
