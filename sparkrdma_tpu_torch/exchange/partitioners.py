"""Destination-partition functions over columnar ``int32[W, n]`` batches.

Each returns ``int64[n]`` partition ids, equal to the reference's
``sparkrdma_tpu.exchange.partitioners`` on the same records, and carries
a ``cache_key`` like the reference's. uint32 arithmetic (the hash's
multiply wraps modulo 2^32) is done in int64 with explicit masks.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from sparkrdma_tpu_torch.kernels.sort import as_unsigned

_LOW = 0xFFFFFFFF


def _tag(fn: Callable, key) -> Callable:
    fn.cache_key = key
    return fn


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for uint32 values ``a`` held in int64, split
    into 16-bit halves so no product leaves the int64 range."""
    hi = ((a >> 16) * c) & 0xFFFF
    return ((hi << 16) + (a & 0xFFFF) * c) & _LOW


def hash_partitioner(num_parts: int, key_words: int = 2) -> Callable:
    """Multiplicative hash of the key words mod ``num_parts``."""

    def part(records: torch.Tensor) -> torch.Tensor:
        h = torch.zeros(records.shape[1], dtype=torch.int64,
                        device=records.device)
        for w in range(key_words):
            h = mul32(h ^ as_unsigned(records[w]), 2654435761)
        h = h ^ (h >> 16)
        return h % num_parts

    return _tag(part, ("hash", num_parts, key_words))


def modulo_partitioner(num_parts: int, key_word: int = 0) -> Callable:
    """``key % num_parts`` on one key word."""

    def part(records: torch.Tensor) -> torch.Tensor:
        return as_unsigned(records[key_word]) % num_parts

    return _tag(part, ("mod", num_parts, key_word))


def range_partitioner(splitters: np.ndarray, key_words: int = 2) -> Callable:
    """Partition ``p`` gets keys in ``[splitters[p-1], splitters[p])``
    under lexicographic unsigned order: ``pid = #{j: key >= spl_j}``."""
    spl_np = np.asarray(splitters, dtype=np.uint32)
    if spl_np.ndim != 2 or spl_np.shape[1] < key_words:
        raise ValueError("splitters must be [num_parts-1, >=key_words] uint32")
    num_parts = int(spl_np.shape[0]) + 1
    spl_host = torch.from_numpy(spl_np[:, :key_words].astype(np.int64))
    on_device = {}

    def part(records: torch.Tensor) -> torch.Tensor:
        n = records.shape[1]
        spl = on_device.get(records.device)
        if spl is None:
            spl = on_device[records.device] = spl_host.to(records.device)
        gt = torch.zeros((n, num_parts - 1), dtype=torch.bool,
                         device=records.device)
        eq = torch.ones_like(gt)
        for w in range(key_words):
            rw = as_unsigned(records[w])[:, None]
            sw = spl[None, :, w]
            gt = gt | (eq & (rw > sw))
            eq = eq & (rw == sw)
        return (gt | eq).sum(dim=1)

    key = ("range", num_parts, key_words, hash(spl_np.tobytes()))
    return _tag(part, key)


__all__ = ["hash_partitioner", "modulo_partitioner", "range_partitioner",
           "mul32"]
