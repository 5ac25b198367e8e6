"""Shuffle read statistics and timing utilities.

``ExchangeRecord`` / ``ShuffleReadStats`` (the ``RdmaShuffleReaderStats``
analogue) live in :mod:`sparkrdma_tpu_torch.obs.stats` and are
re-exported here, as the reference's ``utils/stats.py`` does; ``Timer``
and ``barrier`` are timing utilities.
"""

from __future__ import annotations

import time

import torch

from sparkrdma_tpu_torch.obs.stats import ExchangeRecord, ShuffleReadStats


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0


def barrier(*tensors) -> None:
    """Wait until the card has finished every queued kernel.

    Kernels launch asynchronously, so a host clock read without this
    measures the enqueue. On CPU tensors work is synchronous and this is
    a no-op.
    """
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


__all__ = ["ExchangeRecord", "ShuffleReadStats", "Timer", "barrier"]
