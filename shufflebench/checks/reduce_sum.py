"""A ``reduceByKey(sum)`` read (``aggregator="sum"``) under the hash
partitioner.

What it must return: each partition's distinct keys, ascending as
unsigned words, each with the uint32 sum (mod 2^32) of every payload
word over all its input records.

Numbers (limit 0): ``count_mismatch`` (distinct keys too many or too
few, over every partition), ``rows_mismatched`` (the whole read against
the reference's, row by row).
"""

import torch

from shufflebench.reference import (hash_pids, lexsort, rows_mismatched,
                                    sort_words, u32)

_MASK = 0xFFFFFFFF


def read(records, parts, key_words, key_used):
    """Each partition's distinct keys and sums, keyed on the first
    ``key_used`` key words (the others then come out zero)."""
    w = records.shape[0]
    srt = records[:, lexsort(records, key_used)]
    same = torch.ones(max(srt.shape[1] - 1, 0), dtype=torch.bool,
                      device=srt.device)
    for k in sort_words(srt, key_used):
        same &= k[1:] == k[:-1]
    new = torch.ones(srt.shape[1], dtype=torch.bool, device=srt.device)
    new[1:] = ~same
    seg = torch.cumsum(new.to(torch.int64), 0) - 1
    out = torch.zeros((w, int(new.sum())), dtype=torch.int64,
                      device=srt.device)
    out[:key_used] = u32(srt[:key_used, new])
    for v in range(key_words, w):
        out[v].index_add_(0, seg, u32(srt[v]))
    out = out & _MASK
    out = (out - ((out >> 31) << 32)).to(torch.int32)
    pid = hash_pids(out[:key_words], parts)
    order = torch.sort(pid, stable=True).indices
    return out[:, order], torch.bincount(pid, minlength=parts).tolist()


def compare(records, rows, totals, parts, key_words):
    want, want_tot = read(records, parts, key_words, key_words)
    return {"count_mismatch": sum(abs(int(a) - b)
                                  for a, b in zip(totals, want_tot)),
            "rows_mismatched": rows_mismatched(rows, want)}
