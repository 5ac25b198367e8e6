"""Map-side combine (``exchange/protocol.py::plan_combine``,
``kernels/aggregate.py``): bytes into the combine over bytes out of it
(``ShuffleExchange.wire_stats()``), 1 where the gate declined; median
over the window's jobs. Nothing to read without an aggregator."""

import statistics


def read(run):
    ratios = []
    for j in run["jobs"]:
        wire = j["wire"]
        if "combine_dup_ratio" not in wire:
            continue            # not an aggregator read
        if wire.get("combine_out_bytes"):
            ratios.append(wire["combine_in_bytes"] / wire["combine_out_bytes"])
        else:
            ratios.append(1.0)
    return statistics.median(ratios) if ratios else None
