"""Transport kernel (``exchange/ring.py`` -> ``csrc/ring_exchange.cu``):
the least time the traced jobs' exchanges could take over the device
time of the ring kernel in the trace, in %.

The least time counts the records each exchange carried (as
``slot_fill`` does: after the map-side combine where it ran), each read
once and written once, over the card's HBM bandwidth (``peaks.py``).
It reads the plan and the wire accounting, not the kernel's shapes, so
it counts the same work whatever moves it; empty slots count for
nothing. Nothing to read without the kernel in the trace or a known
card."""

from shufflebench.metrics._common import carried
from shufflebench.peaks import peak

KERNEL = "ring_exchange_kernel"


def read(run):
    trace = run.get("trace")
    bw = peak(run["device_kind"], "hbm_bytes_per_s")
    if not trace or not bw:
        return None
    kernel_s = sum(s for name, s in trace["ops_s"].items() if KERNEL in name)
    if kernel_s <= 0:
        return None
    least_s = sum(2 * n * b for n, b in map(carried, run["traced_jobs"])) / bw
    return 100.0 * least_s / kernel_s
