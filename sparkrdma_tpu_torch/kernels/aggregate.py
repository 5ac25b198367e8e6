"""Combine-by-key — Spark's Aggregator stage, on columnar records.

Counterpart of ``sparkrdma_tpu.kernels.aggregate`` in its plain mode,
bit-equal to it. The reference has no Pallas kernel here: it sorts the
batch by key, runs a segmented ``lax.associative_scan`` that leaves each
run's reduction in the run's last row, and compacts those rows to the
front. The port keeps the sort, compacts by gathering the last rows, and
reduces as follows:

- float32 payloads (``float_payload``): :func:`_segmented_scan` mirrors
  the reference's scan recursion level by level. The value left in a
  run's last row depends on that tree (float adds do not associate), and
  the tree depends only on row positions, so the same tree gives the
  same bits on the CPU and on the card.
- uint32 payloads: sums, minima and maxima do not depend on the order,
  so closed forms give the same bits in a few launches: an int64 cumsum
  differenced at run ends (sums, mod 2^32), and one ``scatter_reduce``
  over run ids on sign-biased words (min/max in unsigned order).

Only the valid prefix is reduced: each row of a scan depends only on the
rows before it, through a tree fixed by its position, and the
reference's padding rows sort to the tail, where they only continue the
last run.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparkrdma_tpu_torch.kernels.sort import as_unsigned, lexsort_cols

_SIGN = -(1 << 31)          # int32 0x80000000
_LOW = 0xFFFFFFFF
OPS = ("sum", "min", "max")


def _word(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit-views."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _scan_op(op: str, floating: bool):
    if op == "sum":
        return torch.add                 # int32 adds wrap as uint32 ones
    pick = torch.minimum if op == "min" else torch.maximum
    if floating:
        return pick
    return lambda a, b: pick(a ^ _SIGN, b ^ _SIGN) ^ _SIGN


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``[e0, o0, e1, o1, ...]`` along the last dim. The reference
    interleaves by zero-padding both and adding, which turns a float
    -0.0 into +0.0; the ``+ 0`` here does the same."""
    out = even.new_empty(even.shape[:-1]
                         + (even.shape[-1] + odd.shape[-1],))
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out + 0 if out.is_floating_point() else out


def _segmented_scan(vals: torch.Tensor, first: torch.Tensor,
                    op: str) -> torch.Tensor:
    """Inclusive scan of ``op`` along the last dim of ``vals [P, N]``,
    restarting where ``first: bool[N]`` is True.

    The reference's ``lax.associative_scan`` recursion, mirrored: combine
    the pairs ``[0:-1:2] ⊕ [1::2]``, scan those, combine the odd results
    with ``[2::2]``, interleave. The pair operator is the segmented one,
    ``(va, fa) ⊕ (vb, fb) = (fb ? vb : op(va, vb), fa | fb)``. ``vals``
    are float32, or uint32 words as int32 (compared unsigned)."""
    fn = _scan_op(op, vals.is_floating_point())

    def combine(va, fa, vb, fb):
        return torch.where(fb, vb, fn(va, vb)), fa | fb

    def scan(v, f):
        n = v.shape[-1]
        if n < 2:
            return v, f
        ov, of = scan(*combine(v[..., 0:n - 1:2], f[0:n - 1:2],
                               v[..., 1::2], f[1::2]))
        t = (n - 1) // 2                 # rows in [2::2]
        ev, ef = combine(ov[..., :t], of[:t], v[..., 2::2], f[2::2])
        ev = torch.cat([v[..., :1], ev], dim=-1)
        ef = torch.cat([f[:1], ef])
        return _interleave(ev, ov), _interleave(ef, of)

    return scan(vals, first)[0]


def _run_bounds(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs of equal columns of sorted ``keys [K, m]``: ``(head bool[m],
    ends)``, ``head[i]`` where row ``i`` starts a run and ``ends`` each
    run's last row, ascending."""
    head = torch.ones(keys.shape[1], dtype=torch.bool, device=keys.device)
    head[1:] = (keys[:, 1:] != keys[:, :-1]).any(dim=0)
    last = torch.ones_like(head)
    last[:-1] = head[1:]
    return head, last.nonzero().squeeze(1)


def _run_sums(payload: torch.Tensor, head: torch.Tensor,
              ends: torch.Tensor) -> torch.Tensor:
    """uint32 run sums mod 2^32: an int64 cumsum differenced at the runs'
    first and last rows. The payload rows are scanned as one flat row (a
    run's difference cancels the rows before it): torch scans a 1-D
    tensor with one device-wide scan, but a ``[P, m]`` one with a
    row-by-row kernel that is far slower on the card."""
    v = as_unsigned(payload)
    cs = torch.cumsum(v.reshape(-1), 0).reshape(v.shape)
    starts = head.nonzero().squeeze(1)
    return _word((cs[:, ends] - cs[:, starts] + v[:, starts]) & _LOW)


def _run_extremes(payload: torch.Tensor, head: torch.Tensor, runs: int,
                  op: str) -> torch.Tensor:
    """uint32 run minima or maxima: one ``scatter_reduce`` over run ids
    of sign-biased words, whose signed order is the unsigned one."""
    rid = (torch.cumsum(head, 0) - 1).expand_as(payload)
    biased = payload ^ _SIGN
    res = biased.new_empty((payload.shape[0], runs))
    res.scatter_reduce_(1, rid, biased, "amin" if op == "min" else "amax",
                        include_self=False)
    return res ^ _SIGN


def combine_by_key_cols(cols: torch.Tensor, valid: torch.Tensor,
                        key_words: int, op: str = "sum",
                        float_payload: bool = False
                        ) -> Tuple[torch.Tensor, int]:
    """Reduce the payloads of equal keys: ``(combined [W, N], unique)``.

    ``cols: int32[W, N]`` (uint32 words) with ``key_words`` leading key
    rows; rows with ``valid == False`` are ignored. The first ``unique``
    columns of the output are the unique keys, ascending, with their
    reduced payloads; the rest is zero. ``float_payload`` reads the
    payload words as float32. The key sort is stable, as the reference's
    is in every one of its sort modes."""
    if op not in OPS:
        raise ValueError(f"unsupported op {op!r}")
    n = cols.shape[1]
    srt = lexsort_cols(cols, key_words, valid)
    m = int(valid.sum())
    keys, payload = srt[:key_words, :m], srt[key_words:, :m]
    head, ends = _run_bounds(keys)
    unique = int(ends.numel())
    if float_payload:
        red = _segmented_scan(payload.view(torch.float32), head, op)[:, ends]
        if n > 1:
            # the reference scans all N rows, whose last interleave turns
            # -0.0 into +0.0 even where the valid prefix is one row
            red = red + 0
        red = red.view(torch.int32)
    elif op == "sum":
        red = _run_sums(payload, head, ends)
    else:
        red = _run_extremes(payload, head, unique, op)
    out = torch.zeros_like(cols)
    out[:key_words, :unique] = keys[:, ends]
    out[key_words:, :unique] = red
    return out, unique


def map_side_combine_cols(records: torch.Tensor, part_ids: torch.Tensor,
                          num_parts: int, key_words: int, op: str = "sum",
                          float_payload: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Collapse duplicate (partition, key) pairs before the exchange.

    The destination partition id rides as an extra leading key word, so
    one :func:`combine_by_key_cols` both orders the batch by (partition,
    key) and reduces equal keys. Ids outside ``[0, num_parts)`` (rows a
    predicate pushdown dropped) are invalid and never reach the output.

    Returns ``(combined [W, N], new_pids int64[N], unique)``: the first
    ``unique`` columns are the surviving rows; ``new_pids`` carries their
    partition ids, ascending, with the sentinel ``num_parts`` on the
    tail — the form :func:`~sparkrdma_tpu_torch.kernels.bucketing
    .bucket_sorted_counts` takes."""
    n = records.shape[1]
    pids = part_ids.to(torch.int64)
    cols = torch.cat([pids.to(torch.int32)[None], records])
    valid = (pids >= 0) & (pids < num_parts)
    combined, unique = combine_by_key_cols(cols, valid, 1 + key_words, op,
                                           float_payload)
    live = torch.arange(n, device=records.device) < unique
    new_pids = torch.where(live, combined[0].to(torch.int64), num_parts)
    return combined[1:], new_pids, unique


def combine_by_key(records: torch.Tensor, valid: torch.Tensor,
                   key_words: int, op: str = "sum",
                   float_payload: bool = False
                   ) -> Tuple[torch.Tensor, int]:
    """Row-major wrapper: ``records int32[N, W]`` -> ``([N, W], unique)``."""
    out, unique = combine_by_key_cols(records.T, valid, key_words, op,
                                      float_payload)
    return out.T, unique


def count_by_key(records: torch.Tensor, valid: torch.Tensor,
                 key_words: int) -> Tuple[torch.Tensor, int]:
    """Records per unique key: ``(rows [N, key_words+1], unique)``."""
    ones = records.new_ones((records.shape[0], 1))
    return combine_by_key(torch.cat([records[:, :key_words], ones], dim=1),
                          valid, key_words, op="sum")


__all__ = ["combine_by_key", "combine_by_key_cols", "map_side_combine_cols",
           "count_by_key", "OPS"]
