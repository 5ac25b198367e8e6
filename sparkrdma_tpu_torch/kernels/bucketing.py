"""Map-side bucketing, slot packing and reduce-side compaction.

Counterparts of ``sparkrdma_tpu.kernels.bucketing`` on columnar
``int32[W, n]`` batches, bit-equal to them. None of these reaches a
Pallas kernel in the reference, so they stay tensor code here.

The reference sizes its windows with device scalars (``dynamic_slice``);
here the counts come to the host once per call and each window is a
plain slice copy, which is what an all-contiguous layout wants.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def histogram_pids(part_ids: torch.Tensor, num_parts: int) -> torch.Tensor:
    """Per-partition record counts ``int64[num_parts]``. Ids outside
    ``[0, num_parts)`` are dropped, as in the reference."""
    ids = part_ids.to(torch.int64)
    ids = ids[(ids >= 0) & (ids < num_parts)]
    return torch.bincount(ids, minlength=num_parts)[:num_parts]


def _exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0) - counts


def bucket_records(records: torch.Tensor, part_ids: torch.Tensor,
                   num_parts: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort of ``[W, n]`` by destination partition: one sort of
    the ids and one gather (``kernels/sort.py``). Returns ``(bucketed,
    counts, offsets)``."""
    w, n = records.shape
    if num_parts == 1:
        dev = records.device
        return (records, torch.full((1,), n, dtype=torch.int64, device=dev),
                torch.zeros((1,), dtype=torch.int64, device=dev))
    ids = part_ids.to(torch.int64)
    perm = torch.sort(ids, stable=True).indices
    counts = histogram_pids(ids, num_parts)
    return records[:, perm], counts, _exclusive_cumsum(counts)


def bucket_sorted_counts(sorted_pids: torch.Tensor, num_parts: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(counts, offsets)`` of a batch already sorted ascending by
    partition (the map-side combine's output). Rows carrying the
    sentinel pid ``num_parts`` fall outside ``[0, num_parts)`` and are
    dropped from every count, so they never occupy a slot."""
    counts = histogram_pids(sorted_pids, num_parts)
    return counts, _exclusive_cumsum(counts)


def _windows(bucketed, counts, offsets, capacity, round_idx, order):
    """``(p, start, length)`` of round ``round_idx``'s window of each
    partition in ``order`` — one host transfer of the counts."""
    cnt = counts.tolist()
    off = offsets.tolist()
    r0 = round_idx * capacity
    return [(p, off[p] + r0, max(0, min(cnt[p] - r0, capacity)))
            for p in order]


def fill_round_slots(bucketed: torch.Tensor, counts: torch.Tensor,
                     offsets: torch.Tensor, num_parts: int, capacity: int,
                     round_idx: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round ``round_idx``'s window of each bucket: ``(slots [W, P, C],
    send_counts [P])``; tails past ``send_counts[p]`` are zero."""
    w = bucketed.shape[0]
    slots = bucketed.new_zeros((w, num_parts, capacity))
    for p, start, ln in _windows(bucketed, counts, offsets, capacity,
                                 round_idx, range(num_parts)):
        if ln:
            slots[:, p, :ln] = bucketed[:, start:start + ln]
    send = torch.clamp(counts - round_idx * capacity, 0, capacity)
    return slots, send


def fill_round_slots_dest_major(bucketed: torch.Tensor,
                                counts: torch.Tensor,
                                offsets: torch.Tensor, num_parts: int,
                                mesh_size: int, capacity: int,
                                round_idx: int,
                                out: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fill_round_slots` in the transport layout ``[mesh, ppd, W,
    C]``: ``slots[d, q]`` is partition ``q * mesh + d``'s window.

    ``out``, when given, is a zero-filled ``[mesh, ppd, W, C]`` view
    (e.g. the payload lanes of the exchange's send buffer) written in
    place; only the valid windows are copied into it."""
    w = bucketed.shape[0]
    ppd = num_parts // mesh_size
    if out is None:
        out = bucketed.new_zeros((mesh_size, ppd, w, capacity))
    order = [q * mesh_size + d for d in range(mesh_size) for q in range(ppd)]
    for t, (p, start, ln) in enumerate(_windows(
            bucketed, counts, offsets, capacity, round_idx, order)):
        if ln:
            out[t // ppd, t % ppd, :, :ln] = bucketed[:, start:start + ln]
    send = torch.clamp(counts - round_idx * capacity, 0, capacity)
    return out, send


def compact_segments(stream: torch.Tensor, seg_counts: torch.Tensor,
                     out_capacity: int) -> Tuple[torch.Tensor, int]:
    """Concatenate the valid prefixes of the fixed-stride segments of
    ``stream [W, S*C]``. Returns ``(packed [W, out_capacity], total)``;
    ``total`` may exceed ``out_capacity`` (the caller's overflow
    contract), in which case the copies clamp exactly as the
    reference's chained ``dynamic_update_slice`` does."""
    w, sc = stream.shape
    lens = [int(x) for x in seg_counts.tolist()]
    c = sc // len(lens)
    out = stream.new_zeros((w, out_capacity + c))
    pos = 0
    for i, ln in enumerate(lens):
        dst = min(pos, out_capacity)
        # copy only the valid prefix: the reference copies the whole
        # segment and lets the next one repair the zero tail, which
        # leaves the same bytes
        take = min(ln, c)
        if take:
            out[:, dst:dst + take] = stream[:, i * c:i * c + take]
        pos += ln
    total = pos
    packed = out[:, :out_capacity]
    if total < out_capacity:
        packed[:, total:] = 0
    return packed, total


__all__ = ["histogram_pids", "bucket_records", "bucket_sorted_counts",
           "fill_round_slots",
           "fill_round_slots_dest_major", "compact_segments"]
