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
tensor code, and no Pallas kernel stands behind it in the reference. The
one exception is :func:`lexsort_cols` on a CUDA tensor, which launches
``csrc/lexsort.cu``: one stable radix sort over byte digits that skips
the digits every key shares and places the records once, straight into
``out`` (the source note gives the design). Its plain version,
:func:`lexsort_cols_plain`, is the chain above, which the CPU takes.
"""

from __future__ import annotations

import ctypes
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


def lexsort_cols_plain(cols: torch.Tensor, key_words: int,
                       valid: Optional[torch.Tensor] = None,
                       n: Optional[int] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`lexsort_cols` by the chain of stable ``torch.sort`` passes,
    on any device."""
    total = cols.shape[1]
    n = total if n is None else n
    if not 0 <= n <= total:
        raise ValueError(f"n={n} outside [0, {total}]")
    head = cols if n == total else cols[:, :n]
    if key_words <= 0 and valid is None:
        srt = head
    else:
        perm = _lex_perm([head[i] for i in range(key_words)],
                         None if valid is None else valid[:n])
        srt = head[:, perm]
    if out is not None:
        out[:, :n] = srt
        return out
    if n == total:
        return srt
    res = torch.empty_like(cols)
    res[:, :n] = srt
    res[:, n:] = cols[:, n:]
    return res


def carries_whole_records(w: int, key_words: int) -> bool:
    """Whether the kernel carries whole records through its passes (a
    record at most one word wider than its key words and a 32-bit index),
    else the key words and an index, placing the records once after."""
    return w <= key_words + 2


def lexsort_cols(cols: torch.Tensor, key_words: int,
                 valid: Optional[torch.Tensor] = None,
                 n: Optional[int] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sort columnar ``[W, N]`` by its leading ``key_words`` words,
    stable; ``valid == False`` rows go to the tail.

    Only the columns ``[0, n)`` are sorted (all by default); the rest
    keep their place. With ``out`` (``[W, N]``, not overlapping ``cols``)
    the sorted columns are written into ``out[:, :n]``, the rest of
    ``out`` is left as it is, and ``out`` is returned.

    CUDA tensors launch ``csrc/lexsort.cu`` (int32 words, fewer than 2^31
    columns sorted, records of at most 372 words where they are not
    carried whole, else a ``ValueError``); CPU tensors take
    :func:`lexsort_cols_plain`. Both give the same bytes."""
    if not cols.is_cuda:
        return lexsort_cols_plain(cols, key_words, valid, n, out)
    return _lexsort_kernel(cols, key_words, valid, n, out)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory spans of two tensors meet."""
    def span(x):
        lo = x.data_ptr()
        return lo, lo + x.element_size() * (1 + sum(
            (d - 1) * st for d, st in zip(x.shape, x.stride()) if d))
    (a0, a1), (b0, b1) = span(a), span(b)
    return a.numel() > 0 and b.numel() > 0 and a0 < b1 and b0 < a1


def _lexsort_kernel(cols, key_words, valid, n, out):
    """One call of ``sr_lexsort`` on the current stream of ``cols``'s
    card."""
    from sparkrdma_tpu_torch import _build

    w, total = cols.shape
    n = total if n is None else n
    if not 0 <= n <= total:
        raise ValueError(f"n={n} outside [0, {total}]")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32 word views, got {cols.dtype}")
    if out is not None and (out.shape != cols.shape
                            or out.dtype != torch.int32):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not "
                         f"match cols {tuple(cols.shape)}")
    key_words = max(key_words, 0)
    if key_words > w:
        raise ValueError(f"{key_words} key words of a {w}-word record")
    if n >= 2 ** 31:
        raise ValueError(f"{n} columns: the kernel sorts fewer than 2^31")
    if key_words == 0 and valid is None:
        return lexsort_cols_plain(cols, 0, None, n, out)
    narrow = carries_whole_records(w, key_words)
    if not narrow and w > 372:
        raise ValueError(f"{w}-word records: the kernel places at most 372")
    if out is not None and _overlap(out, cols):
        raise ValueError("out overlaps cols")
    src = cols if cols.stride(1) == 1 else cols[:, :n].contiguous()
    dst = out if out is not None else torch.empty_like(cols)
    into = dst if dst.stride(1) == 1 else torch.empty_like(cols)
    mask = None if valid is None else valid[:n].contiguous()
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {mask.dtype}")
    has_flag = int(mask is not None)
    lib = _build.library("lexsort")
    if n:
        # the plan's words, zeroed: the PyTorch launch before the call, by
        # which ``shufflebench/layers.py`` places the kernels (their
        # library's CUDA runtime is static, so the profiler sees no launch
        # of theirs)
        meta = torch.zeros((lib.sr_lexsort_meta_words(key_words, has_flag),),
                           dtype=torch.int32, device=cols.device)
        scratch = torch.empty(
            (lib.sr_lexsort_scratch_words(n, w, key_words, has_flag,
                                          int(narrow)),),
            dtype=torch.int32, device=cols.device)
        _build.count_launch(lexsort_cols)
        err = lib.sr_lexsort(
            ctypes.c_void_p(src.data_ptr()), src.stride(0), n, w, key_words,
            ctypes.c_void_p(mask.data_ptr() if mask is not None else 0),
            ctypes.c_void_p(into.data_ptr()), into.stride(0), int(narrow),
            ctypes.c_void_p(meta.data_ptr()), meta.numel(),
            ctypes.c_void_p(scratch.data_ptr()), scratch.numel(),
            ctypes.c_void_p(_build.stream_ptr(cols.get_device())))
        _build.check(err, "lexsort launch")
        # and the one after it
        meta[:1] = 0
    if into is not dst:
        dst[:, :n] = into[:, :n]
    if out is None and n < total:
        dst[:, n:] = cols[:, n:]
    return dst


lexsort_cols.launches = 0


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


__all__ = ["as_unsigned", "lexsort_cols", "lexsort_cols_plain",
           "carries_whole_records", "lexsort_records",
           "sort_by_lead_cols", "chunk_sort_cols"]
