"""Merge-path sort over columnar records ``int32[W, N]`` (uint32 words).

Counterpart of ``sparkrdma_tpu.kernels.merge_sort``:

1. **Run formation** — :func:`chunk_sort_cols`, a batched LSD chain of
   ``torch.sort`` over ``[W, N/run, run]``. The reference does this in
   XLA, not Pallas, so it stays tensor code.
2. **Merge stages** — ``log2(N/run)`` launches of :func:`merge_stage`,
   the hand-written CUDA kernel in ``csrc/merge_path.cu`` (it replaces
   the reference's Pallas ``_stage_kernel``; the source note there gives
   its bound and design).

Records compare lexicographically over ALL ``W`` words, so the order is
total up to identical records and the output is bit-equal to the
reference's. Rows with ``valid == False`` are lifted to all-ones, sort
to the tail, and are zeroed afterwards.

On a CPU tensor :func:`merge_stage` runs its plain version (a full
sort of each pair's concatenation); on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sparkrdma_tpu_torch.kernels.sort import chunk_sort_cols

_FULL = -1            # int32 bit-view of 0xFFFFFFFF
_THREADS = 128        # the kernel's CTA size; tiles are multiples of it
_MAX_TILE = 512
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper CTA may use


def supports_fast_sort(n: int, run: int = 1 << 15) -> bool:
    """Fast path needs a power-of-two N with at least two runs."""
    return n >= 2 * run and (n & (n - 1)) == 0


def pick_tile(w: int, run: int) -> int:
    """Largest tile (<= 512, <= run, a multiple of 128) whose staged
    records fit one CTA's shared memory."""
    tile = min(_MAX_TILE, run)
    while tile > _THREADS and w * tile * 4 + tile * 2 > _SMEM_LIMIT:
        tile //= 2
    if w * tile * 4 + tile * 2 > _SMEM_LIMIT:
        raise ValueError(f"records of {w} words are too wide for the "
                         "merge kernel's shared-memory tile")
    return tile


def merge_stage_plain(cols: torch.Tensor, run: int) -> torch.Tensor:
    """Plain version of one stage: full-record sort of each pair of
    runs (a pair's merge is its sorted concatenation)."""
    return chunk_sort_cols(cols, 2 * run)


def merge_stage(cols: torch.Tensor, run: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merge each adjacent pair of sorted ``run``-length runs of
    ``cols [W, N]`` into a sorted run of ``2*run``.

    CUDA tensors launch ``csrc/merge_path.cu`` (into ``out`` when given);
    CPU tensors take :func:`merge_stage_plain`."""
    w, n = cols.shape
    if cols.dtype != torch.int32:
        raise TypeError(f"merge_stage takes int32 word views, got "
                        f"{cols.dtype}")
    if run < _THREADS or run & (run - 1) or n % (2 * run):
        raise ValueError(f"run {run} must be a power of two >= {_THREADS} "
                         f"dividing N/2 (N={n})")
    if not cols.is_cuda:
        return merge_stage_plain(cols, run)
    from sparkrdma_tpu_torch import _build

    if not cols.is_contiguous():
        raise ValueError("merge_stage needs a contiguous [W, N] tensor")
    if out is None:
        out = torch.empty_like(cols)
    elif (out.shape != cols.shape or out.dtype != cols.dtype
          or out.device != cols.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like cols")
    tile = pick_tile(w, run)
    lib = _build.library("merge_path")
    merge_stage.launches += 1
    err = lib.sr_merge_stage(
        ctypes.c_void_p(cols.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        w, n, n, n, run, tile,
        ctypes.c_void_p(_build.stream_ptr(cols.device)))
    _build.check(err, "merge_stage launch")
    return out


merge_stage.launches = 0


def merge_sort_cols(cols: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    run: int = 1 << 15) -> torch.Tensor:
    """Sort ``[W, N]`` ascending by full-record lexicographic order.

    ``valid``: bool[N]; invalid rows sort to the tail and are zeroed.
    ``run``: run length of the formation pass (a power of two >= 128).
    """
    w, n = cols.shape
    if run < _THREADS or run & (run - 1):
        raise ValueError(f"run must be a power of two >= {_THREADS}, "
                         f"got {run}")
    if not supports_fast_sort(n, run):
        raise ValueError(
            f"merge_sort_cols needs power-of-two N >= {2 * run}, got {n}")
    if valid is not None:
        cols = torch.where(valid[None, :], cols,
                           torch.full_like(cols[:1], _FULL))
    cur = chunk_sort_cols(cols, run)
    spare = torch.empty_like(cur) if cur.is_cuda else None
    r = run
    while r < n:
        nxt = merge_stage(cur, r, out=spare)
        spare, cur = cur, nxt
        r *= 2
    if valid is not None:
        total = int(valid.sum())
        cur[:, total:] = 0
    return cur


__all__ = ["merge_sort_cols", "merge_stage", "merge_stage_plain",
           "chunk_sort_cols", "supports_fast_sort", "pick_tile"]
