"""Streaming loop (``exchange/protocol.py::_exchange_streaming``,
``hbm/slot_pool.py``): records the exchange carried over the record
slots it moved, in %, over the window's jobs (``_common.slots_moved``:
from the plan ``stop()`` returned; records after the map-side combine
where it ran). Useful work over attempted work."""

from shufflebench.metrics._common import carried, slots_moved


def read(run):
    jobs = run["jobs"]
    slots = sum(slots_moved(j) for j in jobs)
    if not slots:
        return None
    return 100.0 * sum(carried(j)[0] for j in jobs) / slots
