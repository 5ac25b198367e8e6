"""Splitter computation for range partitioning — sortByKey's sampler.

Each stacked partition draws ``samples_per_device`` uniform indices with
replacement from its own records; the reference draws them with
``jax.random``, which torch cannot reproduce, so the indices come from a
``torch.Generator`` seeded per partition. ``compute_splitters`` is equal
to the reference's on the same samples.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from sparkrdma_tpu_torch.kernels.sort import lexsort_records


def make_sampler(num_partitions: int, key_words: int,
                 samples_per_device: int, seed: int = 0) -> Callable:
    """``records [W, D*n] -> uint32[D * samples_per_device, key_words]``
    (host array, partition-major)."""

    def sample(records: torch.Tensor) -> np.ndarray:
        n = records.shape[1] // num_partitions
        parts = []
        for d in range(num_partitions):
            gen = torch.Generator().manual_seed(seed * 1_000_003 + d)
            idx = torch.randint(0, max(n, 1), (samples_per_device,),
                                generator=gen) + d * n
            parts.append(records[:key_words, idx.to(records.device)].T)
        rows = torch.cat(parts).cpu().contiguous().numpy()
        return rows.view(np.uint32)

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
