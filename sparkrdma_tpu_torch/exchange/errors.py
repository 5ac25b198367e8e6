"""Failure types of the exchange data plane — the port's copy of
``sparkrdma_tpu.exchange.errors``, with the same messages.

An exchange that fails raises :class:`FetchFailedError` and the reader
retries from the still-published (or host-checkpointed) map output, as
Spark retries a stage on ``FetchFailedException``. A read that cannot
make progress raises :class:`UnrecoverableShuffleError` once.
"""

from __future__ import annotations


class FetchFailedError(RuntimeError):
    """An exchange failed; the map output is intact, so the fetch can be
    retried (``org.apache.spark.shuffle.FetchFailedException``). The
    shuffle stays registered; the reader retries up to
    ``max_retry_attempts``."""

    def __init__(self, shuffle_id: int, message: str = "", attempt: int = 0):
        self.shuffle_id = shuffle_id
        self.attempt = attempt
        super().__init__(
            f"shuffle {shuffle_id} fetch failed"
            + (f" (attempt {attempt})" if attempt else "")
            + (f": {message}" if message else "")
        )


class UnrecoverableShuffleError(RuntimeError):
    """The shuffle cannot make progress and a retry will not help: the
    live map output is gone and the host checkpoint fails its CRC check
    (a retry would read the same bytes). One clean terminal error, never
    a retry loop around detected corruption."""

    def __init__(self, shuffle_id: int, message: str = ""):
        self.shuffle_id = shuffle_id
        super().__init__(
            f"shuffle {shuffle_id} unrecoverable"
            + (f": {message}" if message else ""))


__all__ = ["FetchFailedError", "UnrecoverableShuffleError"]
