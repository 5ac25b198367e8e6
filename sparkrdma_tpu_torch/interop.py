"""Carry the reference's state across: numpy in, tensors out, and back.

The shuffle has no weights. What both packages must share to be held
against each other is the input records, the range splitters and a
plan's counts — all of which the reference exposes as numpy ``uint32``
/ ``int64`` arrays. This module imports nothing of the reference; it
takes plain arrays (or any object with a plan's attributes).
"""

from __future__ import annotations

import numpy as np
import torch

from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan


def records_to_torch(cols, device="cuda") -> torch.Tensor:
    """Columnar ``uint32[W, N]`` (numpy, or anything ``np.asarray``
    takes) -> the port's ``int32[W, N]`` bit-view on ``device``."""
    arr = np.array(cols, dtype=np.uint32, order="C")   # owned, writable
    return torch.from_numpy(arr.view(np.int32)).to(device)


def records_from_torch(cols: torch.Tensor) -> np.ndarray:
    """The port's ``int32[W, N]`` -> host ``uint32[W, N]``."""
    return cols.detach().cpu().contiguous().numpy().view(np.uint32)


def splitters_from_numpy(splitters) -> np.ndarray:
    """Reference splitters -> the ``uint32[P-1, key_words]`` array the
    port's ``range_partitioner`` takes (a checked copy)."""
    spl = np.array(np.asarray(splitters), dtype=np.uint32)
    if spl.ndim != 2:
        raise ValueError(f"splitters must be 2-D, got {spl.shape}")
    return spl


def plan_from_reference(plan) -> ShufflePlan:
    """A reference ``ShufflePlan`` (duck-typed) -> the port's."""
    return ShufflePlan(counts=np.asarray(plan.counts, dtype=np.int64).copy(),
                       num_rounds=int(plan.num_rounds),
                       out_capacity=int(plan.out_capacity),
                       capacity=int(plan.capacity),
                       split_factor=int(plan.split_factor))


__all__ = ["records_to_torch", "records_from_torch", "splitters_from_numpy",
           "plan_from_reference"]
