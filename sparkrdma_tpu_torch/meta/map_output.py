"""Shuffle-registry errors — the port's copy of what
``sparkrdma_tpu.meta.map_output`` defines for the manager's registry.

The reference's ``MapOutputStore`` (the whole-shuffle map-output table
behind ``checkpoint_shuffle``) waits for a later slice; the segment
checkpoints the port has live in ``meta/checkpoint.py``.
"""

from __future__ import annotations


class DuplicateShuffleIdError(ValueError):
    """A shuffle id is already registered on this manager.

    A distinct type, so that callers which draw ids themselves (the
    ``Dataset`` layer) retry on exactly this condition without
    swallowing any other registry validation error; a ``ValueError``,
    so that callers catching that still do.
    """


__all__ = ["DuplicateShuffleIdError"]
