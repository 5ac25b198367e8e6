"""Sampling (``meta/sampling.py``): median host ms of the benchmark's span
around ``make_sampler`` and ``compute_splitters``, over the window's
jobs. Nothing to read where the mix does not sample."""

from shufflebench.metrics._common import median_span_ms


def read(run):
    return median_span_ms(run["jobs"], "sample")
