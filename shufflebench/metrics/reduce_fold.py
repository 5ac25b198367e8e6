"""Reduce-side combine (``exchange/protocol.py::_fuse_tail``,
``kernels/aggregate.py::combine_by_key_cols``): lines into the combine
over keys out of it (``ShuffleExchange.wire_stats()``'s
``reduce_in_records / reduce_out_records``), median over the window's
jobs. Nothing to read where the program does not report them."""

import statistics


def read(run):
    folds = [j["wire"]["reduce_in_records"] / j["wire"]["reduce_out_records"]
             for j in run["jobs"] if j["wire"].get("reduce_out_records")]
    return statistics.median(folds) if folds else None
