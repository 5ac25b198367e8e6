"""Wide-record sort: key+index sort, then payload placement.

Counterpart of ``sparkrdma_tpu.kernels.wide_sort``. The reference sorts
the key words with a row index and then moves each payload word once by
applying the permutation, because riding 23 payload words through XLA's
variadic sort network costs superlinearly. That is how every sort of the
port already works (``kernels/sort.py``), so these functions are thin
names over it and give the same bytes as the plain sort: stable, with
invalid rows (``valid == False``) at the tail.

``ride_words`` (payload words the reference lets ride the sort instead
of placing them by the gather) picks a cost trade-off of XLA's network
and cannot change a result; it is accepted and ignored.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sparkrdma_tpu_torch.kernels.sort import _lex_perm, lexsort_cols


def sort_perm(cols: torch.Tensor, key_words: int,
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort the key rows of ``cols [W, N]``; returns ``(sorted_keys
    [key_words, N], perm int64[N])`` with ``perm[j]`` the source column of
    output position ``j``. Stable; invalid rows go to the tail."""
    perm = _lex_perm([cols[i] for i in range(key_words)], valid)
    return cols[:key_words, perm], perm


def apply_perm(rows: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[j] = rows[perm[j]]`` along axis 0, as one gather. The
    reference splits the index into 2^20-row chunks only because one flat
    16M-row gather aborted the TPU compiler; a torch gather has no such
    limit."""
    return rows[perm]


def sort_wide_cols(cols: torch.Tensor, key_words: int,
                   valid: Optional[torch.Tensor] = None,
                   ride_words: int = 0) -> torch.Tensor:
    """Sort ``cols [W, N]`` by its leading ``key_words`` rows: the same
    contract and bytes as :func:`~sparkrdma_tpu_torch.kernels.sort
    .lexsort_cols` (``ride_words`` is ignored; module docstring)."""
    return lexsort_cols(cols, key_words, valid)


__all__ = ["sort_wide_cols", "sort_perm", "apply_perm"]
