"""A key-ordered read under a range partitioner (``sortByKey``).

What it must return: the input in key order, cut into the partitions in
order. Where the cuts fall is the sampler's choice, which the check
leaves open: the partitions read one after another are the input's
records in key order, so each record's partition and its place in it
follow.

Numbers (each counts records that break the guarantee; limit 0):
``count_mismatch`` (records too many or too few over all partitions),
``rows_mismatched`` (the whole read against the input, as multisets),
``misordered`` (adjacent records of the whole read, across partition
cuts too, whose keys descend).
"""

from shufflebench.reference import (canonical, descents, lexsort,
                                    rows_mismatched, sort_words)


def read(records, parts, key_words, key_used):
    """The input as one run in key order (``key_used`` words of it, input
    order within equal cut keys), all in the first partition."""
    rows = records[:, lexsort(records, key_used)]
    return rows, [rows.shape[1]] + [0] * (parts - 1)


def compare(records, rows, totals, parts, key_words):
    return {"count_mismatch": abs(sum(int(t) for t in totals)
                                  - records.shape[1]),
            "misordered": int(descents(sort_words(rows, key_words)).sum()),
            "rows_mismatched": rows_mismatched(canonical(rows),
                                               canonical(records))}
