"""Multi-word lexicographic sorts over int32 bit-views of uint32 words.

Every sort here is one stable sort of its keys (key words, or one lead
row), giving a permutation, plus one gather that places the full
records. The reference sorts with one variadic ``lax.sort``, which has
no torch primitive. Here the key sort is a least-significant-first
chain of stable ``torch.sort`` passes. Two words ride one pass: the pair
``(hi, lo)`` packs into the int64 ``((hi ^ 0x80000000) << 32) | lo``,
whose signed order is the unsigned lexicographic order of the pair, so
W key words cost ``ceil(W/2)`` passes. Rows with ``valid == False`` are
led to the tail by a last pass on the validity flag.

The reference's three ways of moving a sort's records
(``ShuffleExchange.sort_mode``: pack, wide, plain) are costs of XLA's
variadic sort and have no counterpart here. Each gives the bytes of the
one stable sort here, and where the reference's pack sort is unstable,
equal keys here keep arrival order, one of the orders it may give.

Every function here works on the CPU and on the card alike: it is plain
tensor code, and no Pallas kernel stands behind it in the reference.
"""

from __future__ import annotations

from typing import List, Optional

import torch

_SIGN = -(1 << 31)          # int32 0x80000000
_LOW = 0xFFFFFFFF


def as_unsigned(x: torch.Tensor) -> torch.Tensor:
    """int32 bit-view -> its uint32 value, widened to int64."""
    return x.to(torch.int64) & _LOW


def _pair_key(hi: torch.Tensor, lo: Optional[torch.Tensor]) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of (hi, lo)."""
    key = (hi ^ _SIGN).to(torch.int64)
    if lo is None:
        return key
    return (key << 32) | as_unsigned(lo)


def _lex_perm(words: List[torch.Tensor],
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable permutation along the last dim ordering rows by ``words``
    (most significant first), invalid rows last."""
    perm = None

    def current(x):
        return x if perm is None or x is None else x.gather(-1, perm)

    def apply(key):
        nonlocal perm
        idx = torch.sort(key, dim=-1, stable=True).indices
        perm = idx if perm is None else perm.gather(-1, idx)

    pairs = [(words[i], words[i + 1] if i + 1 < len(words) else None)
             for i in range(0, len(words), 2)]
    for hi, lo in reversed(pairs):
        apply(_pair_key(current(hi), current(lo)))
    if valid is not None:
        apply(current((~valid).to(torch.int8)))
    return perm


def lexsort_cols(cols: torch.Tensor, key_words: int,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sort columnar ``[W, N]`` by its leading ``key_words`` words,
    stable; ``valid == False`` rows go to the tail."""
    if key_words <= 0 and valid is None:
        return cols
    perm = _lex_perm([cols[i] for i in range(key_words)], valid)
    return cols[:, perm]


def lexsort_records(records: torch.Tensor, key_words: int,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-major ``[N, W]`` convenience form of :func:`lexsort_cols`."""
    return lexsort_cols(records.T, key_words, valid).T.contiguous()


def _lead_perm(lead: torch.Tensor) -> torch.Tensor:
    """Stable ascending permutation of one uint32 row held in any integer
    dtype (int32 bit-views read unsigned)."""
    key = as_unsigned(lead) if lead.dtype == torch.int32 \
        else lead.to(torch.int64)
    return torch.sort(key, stable=True).indices


def sort_by_lead_cols(cols: torch.Tensor, lead: torch.Tensor
                      ) -> torch.Tensor:
    """Order full records ``[W, N]`` stably by one uint32 ``lead`` row (a
    validity flag, a partition rank...): one stable sort of the lead and
    one gather."""
    return cols[:, _lead_perm(lead)]


def chunk_sort_cols(cols: torch.Tensor, run: int) -> torch.Tensor:
    """Full-record sort of each contiguous ``run``-sized chunk — one
    batched chain over ``[W, N/run, run]`` (the merge sort's run
    formation)."""
    w, n = cols.shape
    x = cols.reshape(w, n // run, run)
    perm = _lex_perm([x[i] for i in range(w)])
    return x.gather(2, perm.unsqueeze(0).expand(w, -1, -1)).reshape(w, n)


__all__ = ["as_unsigned", "lexsort_cols", "lexsort_records",
           "sort_by_lead_cols", "chunk_sort_cols"]
