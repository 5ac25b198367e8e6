"""SPI read (the reader of ``api/shuffle_manager.py``: map side, exchange
and reduce side): median host ms of the span around ``read()`` through
``torch.cuda.synchronize()``, over the window's jobs."""

from shufflebench.metrics._common import median_span_ms


def read(run):
    return median_span_ms(run["jobs"], "read")
