"""SPI write and plan (the writer of ``api/shuffle_manager.py`` and
``exchange/protocol.py::plan``): median host ms of the span around
``get_writer(h).write(records).stop()``, over the window's jobs."""

from shufflebench.metrics._common import median_span_ms


def read(run):
    return median_span_ms(run["jobs"], "write_plan")
