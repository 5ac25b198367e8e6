"""A read under the hash partitioner with no key ordering and no
aggregator (``partitionBy``, ``repartition``).

What it must return: each partition ``d`` holds exactly the input
records whose whole key hashes to ``d``, in an order the check leaves
open.

Numbers (limit 0): ``count_mismatch`` (over every partition's count),
``misplaced`` (records whose key hashes to another partition than the
one that holds them), ``rows_mismatched`` (the whole read against the
input, as multisets; with nothing misplaced, each partition against its
input records).
"""

import torch

from shufflebench.reference import canonical, hash_pids, rows_mismatched


def read(records, parts, key_words, key_used):
    """Each partition's records, hashed on the first ``key_used`` key
    words."""
    where = hash_pids(records[:key_used], parts)
    order = torch.sort(where, stable=True).indices
    return records[:, order], torch.bincount(where,
                                             minlength=parts).tolist()


def compare(records, rows, totals, parts, key_words):
    want = torch.bincount(hash_pids(records[:key_words], parts),
                          minlength=parts).tolist()
    holder = torch.repeat_interleave(
        torch.arange(parts, device=rows.device),
        torch.tensor([int(t) for t in totals], device=rows.device))
    return {"count_mismatch": sum(abs(int(a) - b)
                                  for a, b in zip(totals, want)),
            "misplaced": int((hash_pids(rows[:key_words], parts)
                              != holder).sum()),
            "rows_mismatched": rows_mismatched(canonical(rows),
                                               canonical(records))}
