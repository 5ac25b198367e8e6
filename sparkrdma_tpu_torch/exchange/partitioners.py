"""Destination-partition functions over columnar ``int32[W, n]`` batches.

Each returns ``int64[n]`` partition ids, equal to the reference's
``sparkrdma_tpu.exchange.partitioners`` on the same records, and carries
a ``cache_key`` like the reference's. uint32 arithmetic (the hash's
multiply wraps modulo 2^32) is done in int64 with explicit masks.

Each also carries ``device_spec``, a :class:`DeviceSpec` describing the
function, from which a plan pass counts ids with one kernel launch
(``kernels/partition_counts.py``) instead of calling the function. A
partitioner without one is counted by calling it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from sparkrdma_tpu_torch.kernels.sort import as_unsigned

_LOW = 0xFFFFFFFF

#: the ``Kind`` codes of ``csrc/partition_counts.cu``
KERNEL_KINDS = {"hash": 0, "mod": 1, "range": 2}


@dataclass(frozen=True, eq=False)
class DeviceSpec:
    """A built-in partitioner, described for ``partition_counts``.

    ``kind`` is ``"hash"``, ``"mod"`` or ``"range"``; ids lie in ``[0,
    num_parts)``; key words ``first .. first + key_words - 1`` are read.
    ``rows`` are range's splitter rows, ``uint32[num_parts - 1,
    key_words]`` in lexicographic order: an id counts the rows at or
    below its key, which does not depend on their order. ``split_k > 1``
    describes ``split_partitioner``'s wrapper: the id becomes ``id +
    stride * (i mod split_k)``, ``i`` the record's position in its
    partition."""

    kind: str
    num_parts: int
    key_words: int
    first: int = 0
    rows: Optional[np.ndarray] = None
    split_k: int = 1
    stride: int = 0
    #: ``rows`` per device, shared by the plain callable, the kernel and
    #: every split of this description
    on_device: dict = field(default_factory=dict, repr=False)

    def split(self, k: int, num_parts: int) -> Optional[DeviceSpec]:
        """This partitioner spread over ``k`` sub-partitions
        ``num_parts`` apart; ``None`` for a split of a split, which the
        kernel does not compute."""
        if self.split_k > 1:
            return None
        return replace(self, split_k=k, stride=num_parts)

    def rows_on(self, device) -> torch.Tensor:
        """``rows`` on ``device`` as int32 bit views, copied once."""
        rows = self.on_device.get(device)
        if rows is None:
            rows = self.on_device[device] = torch.from_numpy(
                self.rows.view(np.int32)).to(device)
        return rows

    def kernel_args(self, device) -> tuple:
        """``sr_partition_counts``' ``kind, P, first, kw, spl, split_k,
        stride``."""
        spl = self.rows_on(device).data_ptr() if self.kind == "range" \
            and self.num_parts > 1 else 0
        return (KERNEL_KINDS[self.kind], self.num_parts, self.first,
                self.key_words, spl, self.split_k, self.stride)


def _tag(fn: Callable, key, spec: DeviceSpec) -> Callable:
    fn.cache_key = key
    fn.device_spec = spec
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

    return _tag(part, ("hash", num_parts, key_words),
                DeviceSpec("hash", num_parts, key_words))


def modulo_partitioner(num_parts: int, key_word: int = 0) -> Callable:
    """``key % num_parts`` on one key word."""

    def part(records: torch.Tensor) -> torch.Tensor:
        return as_unsigned(records[key_word]) % num_parts

    return _tag(part, ("mod", num_parts, key_word),
                DeviceSpec("mod", num_parts, 1, first=key_word))


def range_partitioner(splitters: np.ndarray, key_words: int = 2) -> Callable:
    """Partition ``p`` gets keys in ``[splitters[p-1], splitters[p])``
    under lexicographic unsigned order: ``pid = #{j: key >= spl_j}``."""
    spl_np = np.asarray(splitters, dtype=np.uint32)
    if spl_np.ndim != 2 or spl_np.shape[1] < key_words:
        raise ValueError("splitters must be [num_parts-1, >=key_words] uint32")
    num_parts = int(spl_np.shape[0]) + 1
    rows = spl_np[:, :key_words]
    spec = DeviceSpec("range", num_parts, key_words,
                      rows=rows[np.lexsort(rows.T[::-1])])

    def part(records: torch.Tensor) -> torch.Tensor:
        n = records.shape[1]
        spl = as_unsigned(spec.rows_on(records.device))
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
    return _tag(part, key, spec)


__all__ = ["hash_partitioner", "modulo_partitioner", "range_partitioner",
           "mul32", "DeviceSpec", "KERNEL_KINDS"]
