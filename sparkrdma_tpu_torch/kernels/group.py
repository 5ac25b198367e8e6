"""Grouped-values tables — Spark's groupByKey/cogroup, on the device.

Counterpart of ``sparkrdma_tpu.kernels.group``, bit-equal to it. A
group-by materializes, per key, the list of its values as the CSR pair:

- a VALUES buffer: the records key-sorted, so each key's values are one
  contiguous run;
- a GROUPS table: one row per unique key holding ``(key words, count,
  offset)``, ``offset`` pointing at the run's start in the values buffer.

As in the reference: run boundaries come from adjacent equality, the run
starts are compacted to the front by one single-operand sort (positions,
with the sentinel ``N`` for non-starts), counts are adjacent differences
of the compacted starts, and keys are gathered at the start positions.
The reference has no Pallas kernel here; these are plain tensor ops, on
the CPU and on the card alike. Words are int32 bit-views of uint32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparkrdma_tpu_torch.kernels.sort import _lex_perm, lexsort_cols


def _run_heads(keys: torch.Tensor, total: int) -> torch.Tensor:
    """``bool[N]``: row ``i`` of sorted ``keys [K, N]`` starts a run of
    equal keys inside the valid prefix ``[0, total)``."""
    n = keys.shape[1]
    in_valid = torch.arange(n, device=keys.device) < total
    same = torch.zeros(n, dtype=torch.bool, device=keys.device)
    same[1:] = (keys[:, 1:] == keys[:, :-1]).all(dim=0)
    return ~same & in_valid


def group_runs_cols(cols: torch.Tensor, valid: torch.Tensor, key_words: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Key-sort ``cols: int32[W, N]`` and emit its CSR group table.

    Returns ``(values, groups, n_groups, total)``:

    - ``values: [W, N]`` — records sorted by key (stable), invalid rows
      zeroed at the tail;
    - ``groups: [key_words + 2, N]`` — per unique key ``(key words...,
      count, offset)``, ascending, zero tail; ``offset`` indexes into
      ``values``;
    - ``n_groups``: unique keys; ``total``: valid records.

    Unique keys never outnumber valid records, so ``groups`` always fits.
    The key sort is stable, as the reference's is in every one of its
    sort modes."""
    n = cols.shape[1]
    values = lexsort_cols(cols, key_words, valid)
    total = int(valid.sum())
    pos = torch.arange(n, device=cols.device)
    keys = values[:key_words]
    first = _run_heads(keys, total)
    n_groups = int(first.sum())
    starts = torch.sort(torch.where(first, pos, n)).values
    ends = torch.full_like(starts, n)
    ends[:-1] = starts[1:]
    counts = (torch.minimum(ends, torch.full_like(ends, total))
              - starts).clamp_min(0)
    live = pos < n_groups
    gkeys = keys[:, starts.clamp_max(n - 1)]
    offsets = torch.where(live, starts, 0)
    groups = torch.cat([gkeys, counts.to(torch.int32)[None],
                        offsets.to(torch.int32)[None]])
    groups = torch.where(live[None], groups, 0)
    values = torch.where((pos < total)[None], values, 0)
    return values, groups, n_groups, total


def cogroup_tables(groups_a: torch.Tensor, n_a: int,
                   groups_b: torch.Tensor, n_b: int, key_words: int
                   ) -> Tuple[torch.Tensor, int]:
    """Merge two group tables over the UNION of their keys.

    Inputs are :func:`group_runs_cols` tables ``[key_words + 2, Na/Nb]``
    (unique keys ascending, ``n_a``/``n_b`` live). Returns ``(cotable,
    n_union)``: ``cotable: [key_words + 4, Na + Nb]`` rows are ``(key
    words..., count_a, offset_a, count_b, offset_b)`` for every key on
    EITHER side (absent side: count 0), ascending, zero tail.

    As in the reference: concatenate both tables, one stable sort by
    (validity, key) brings equal keys together with the A row first;
    each side's keys are unique, so a run is 1-2 rows with disjoint
    fields, and the first row absorbs its successor's by one shifted
    add; a last stable sort moves the run heads to the front."""
    kw = key_words
    na, nb = groups_a.shape[1], groups_b.shape[1]
    n = na + nb
    dev = groups_a.device
    pos = torch.arange(n, device=dev)

    def fields(g, at, live):
        quad = torch.zeros((4, g.shape[1]), dtype=torch.int32, device=dev)
        quad[at:at + 2] = g[kw:kw + 2]
        return torch.where(live[None], quad, 0)

    live_a = torch.arange(na, device=dev) < n_a
    live_b = torch.arange(nb, device=dev) < n_b
    keys = torch.cat([groups_a[:kw], groups_b[:kw]], dim=1)
    quad = torch.cat([fields(groups_a, 0, live_a),
                      fields(groups_b, 2, live_b)], dim=1)
    valid = torch.cat([live_a, live_b])
    perm = _lex_perm([keys[i] for i in range(kw)], valid)
    skeys, squad = keys[:, perm], quad[:, perm]
    total = int(valid.sum())
    first = _run_heads(skeys, total)
    same = ~first & (pos < total)
    n_union = int(first.sum())
    nxt = torch.zeros_like(squad)
    nxt[:, :-1] = torch.where(same[1:][None], squad[:, 1:], 0)
    merged = squad + nxt
    head = torch.sort((~first).to(torch.int8), stable=True).indices
    cotable = torch.cat([skeys, merged])[:, head]
    return torch.where((pos < n_union)[None], cotable, 0), n_union


__all__ = ["group_runs_cols", "cogroup_tables"]
