"""The plain reference's arithmetic, shared by the checks
(``checks/<check>.py``, one per kind of read a mix names): the hash
partitioner's hash and the unsigned key order written out again.

Plain PyTorch on whatever device the tensors are on. The reference
imports nothing of the program and takes nothing the program derived
(no splitters, no plan, no hash of its own).

Records are ``int32[W, n]`` columns whose words are uint32 bit patterns;
the key is words ``0 .. key_words - 1``, most significant first.
"""

from typing import List

import torch

_MASK = 0xFFFFFFFF
_HASH_MUL = 2654435761


def u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values of int32 words, in int64."""
    return x.to(torch.int64) & _MASK


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for uint32 ``a`` in int64, by 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def hash_pids(keys: torch.Tensor, parts: int) -> torch.Tensor:
    """Partition of each key ``int32[kw, n]``: ``h = (h ^ w) * 2654435761
    mod 2^32`` over the key words, then ``(h ^ h >> 16) mod parts``."""
    h = torch.zeros(keys.shape[1], dtype=torch.int64, device=keys.device)
    for w in range(keys.shape[0]):
        h = _mul32(h ^ u32(keys[w]), _HASH_MUL)
    return (h ^ (h >> 16)) % parts


def sort_words(rows: torch.Tensor, words: int) -> List[torch.Tensor]:
    """Sort keys for the first ``words`` words, most significant first:
    two uint32 words packed into one int64 whose signed order is their
    unsigned order."""
    keys = []
    for w in range(0, words, 2):
        hi = u32(rows[w]) - (1 << 31)
        if w + 1 < words:
            keys.append((hi << 32) | u32(rows[w + 1]))
        else:
            keys.append(hi)
    return keys


def lexsort(rows: torch.Tensor, words: int) -> torch.Tensor:
    """Stable permutation that orders the columns of ``rows`` by their
    first ``words`` words as unsigned integers (least significant pass
    first)."""
    perm = torch.arange(rows.shape[1], device=rows.device)
    for key in reversed(sort_words(rows, words)):
        order = torch.sort(key[perm], stable=True).indices
        perm = perm[order]
    return perm


def descents(keys: List[torch.Tensor]) -> torch.Tensor:
    """``bool[n-1]``: column ``i+1`` orders strictly before column ``i``."""
    n = keys[0].numel()
    less = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=keys[0].device)
    eq = torch.ones_like(less)
    for k in keys:
        a, b = k[:-1], k[1:]
        less |= eq & (b < a)
        eq &= b == a
    return less


def rows_mismatched(got: torch.Tensor, want: torch.Tensor) -> int:
    """Columns that differ in any word, plus the difference in count."""
    m = min(got.shape[1], want.shape[1])
    diff = (got[:, :m] != want[:, :m]).any(dim=0).sum()
    return int(diff) + abs(got.shape[1] - want.shape[1])


def canonical(rows: torch.Tensor) -> torch.Tensor:
    """The multiset of records as one ordering: every word a sort key."""
    return rows[:, lexsort(rows, rows.shape[0])]


__all__ = ["u32", "hash_pids", "lexsort", "sort_words", "descents",
           "rows_mismatched", "canonical"]
