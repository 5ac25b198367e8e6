"""Merge-path sort over columnar records ``int32[W, N]`` (uint32 words).

Counterpart of ``sparkrdma_tpu.kernels.merge_sort``:

1. **Run formation** — :func:`chunk_sort_cols`, a batched LSD chain of
   ``torch.sort`` over ``[W, N/run, run]``. The reference does this in
   XLA, not Pallas, so it stays tensor code.
2. **Merge stages** — ``ceil(log2(N/run))`` calls of :func:`merge_stage`,
   two hand-written CUDA kernels in ``csrc/merge_path.cu`` that together
   replace the reference's Pallas ``_stage_kernel`` and its split
   pre-pass ``_merge_path_offsets``: :func:`merge_splits` finds where
   every output tile's sources start, and the stage kernel merges the
   tiles (the source note there gives the bound and the design).

Records compare lexicographically over ALL ``W`` words, so the order is
total up to identical records and the output is bit-equal to the
reference's. Rows with ``valid == False`` are lifted to all-ones, sort
to the tail, and are zeroed afterwards. When the valid rows are a
prefix ``[0, n_valid)`` — what the exchange's tail always gives —
:func:`merge_sort_cols` sorts only ``ceil(n_valid / run)`` runs, so the
stages may be ragged: the last pair of runs can have a short B run, or
none.

On a CPU tensor :func:`merge_stage` and :func:`merge_splits` run their
plain versions; on a CUDA tensor they launch their kernels or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sparkrdma_tpu_torch.kernels.sort import as_unsigned, chunk_sort_cols

_FULL = -1            # int32 bit-view of 0xFFFFFFFF
_THREADS = 128        # the merge kernel's CTA size; tiles are 128..512
_TILES = (512, 256, 128)
_PAD = 16             # spare words per staged column (csrc kPad)
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper CTA may use
_SMEM_SM = 233472     # bytes of shared memory on one SM
_SMEM_RESERVED = 1024  # per CTA, taken by the runtime


def supports_fast_sort(n: int, run: int = 1 << 15) -> bool:
    """Fast path needs a power-of-two N with at least two runs."""
    return n >= 2 * run and (n & (n - 1)) == 0


def stage_smem(w: int, tile: int) -> int:
    """Shared memory of one merge CTA: two staging buffers of ``w``
    columns of ``tile + 16`` words, and the tile's source slots."""
    return 2 * w * (tile + _PAD) * 4 + 2 * tile


def pick_tile(w: int, run: int) -> int:
    """Largest tile (512, 256 or 128, at most ``run``) at which two
    double-buffered CTAs fit on one SM; else 128 with one CTA."""
    two = _SMEM_SM // 2 - _SMEM_RESERVED
    for tile in _TILES:
        if tile <= run and stage_smem(w, tile) <= two:
            return tile
    if stage_smem(w, _THREADS) <= _SMEM_LIMIT:
        return _THREADS
    raise ValueError(f"records of {w} words are too wide for the merge "
                     "kernel's shared-memory tile")


def _check_run(cols: torch.Tensor, run: int) -> None:
    if cols.dtype != torch.int32:
        raise TypeError(f"merge stages take int32 word views, got "
                        f"{cols.dtype}")
    if cols.dim() != 2 or cols.shape[1] < 1:
        raise ValueError(f"expected a non-empty [W, N] tensor, got "
                         f"{tuple(cols.shape)}")
    if run < _THREADS or run & (run - 1):
        raise ValueError(f"run {run} must be a power of two >= {_THREADS}")


def _check_rows(x: torch.Tensor, name: str) -> None:
    """The kernels read and write whole 16-byte chunks of each row."""
    n = x.shape[1]
    ld = _ld(x)
    if x.stride(1) != 1 or ld < n or ld % 4 or n % 4 or x.data_ptr() % 16:
        raise ValueError(
            f"{name} must be a [W, N] tensor of unit column stride whose "
            f"rows start 16-byte aligned, with N a multiple of 4 (shape "
            f"{tuple(x.shape)}, strides {x.stride()})")


def _check_tile(tile: int, run: int) -> None:
    if tile not in _TILES or tile > run:
        raise ValueError(f"tile {tile} must be one of {_TILES} and at "
                         f"most run {run}")


def _ld(x: torch.Tensor) -> int:
    return x.stride(0) if x.shape[0] > 1 else x.shape[1]


def _pair_bounds(n: int, run: int, g0: torch.Tensor):
    """For output positions ``g0``: the start of their pair and the
    pair's A and B run lengths (the last pair may be short)."""
    base = g0 // (2 * run) * (2 * run)
    length = torch.clamp(n - base, max=2 * run)
    na = torch.clamp(length, max=run)
    return base, na, length - na


def _lex_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Columnwise ``a <= b`` over uint32 words ``[W, T]`` (int64)."""
    le = torch.ones(a.shape[1], dtype=torch.bool, device=a.device)
    for k in range(a.shape[0] - 1, -1, -1):
        le = (a[k] < b[k]) | ((a[k] == b[k]) & le)
    return le


def merge_splits_plain(cols: torch.Tensor, run: int,
                       tile: int) -> torch.Tensor:
    """Plain version of the split pass: for every output tile of the
    stage, how many of its pair's A records precede the tile's first
    output (ties to A) — int32[ceil(N / tile)]. A vectorised binary
    search, the counterpart of the reference's ``_merge_path_offsets``."""
    w, n = cols.shape
    dev = cols.device
    g0 = torch.arange(0, n, tile, device=dev, dtype=torch.int64)
    base, na, nb = _pair_bounds(n, run, g0)
    d = g0 - base
    lo = torch.clamp(d - nb, min=0)
    hi = torch.minimum(d, na)
    words = as_unsigned(cols)
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi + 1) // 2             # a candidate in (lo, hi]
        ia = torch.clamp(base + mid - 1, 0, n - 1)
        ib = torch.clamp(base + run + d - mid, 0, n - 1)
        ok = _lex_le(words[:, ia], words[:, ib])   # A[mid-1] <= B[d-mid]
        lo = torch.where(active & ok, mid, lo)
        hi = torch.where(active & ~ok, mid - 1, hi)
    return lo.to(torch.int32)


def merge_splits(cols: torch.Tensor, run: int, tile: int) -> torch.Tensor:
    """The split pass of one merge stage: int32[ceil(N / tile)], entry
    ``t`` the number of A records before tile ``t``'s first output.

    CUDA tensors launch ``merge_split_kernel`` (one warp per tile, a
    32-way search); CPU tensors take :func:`merge_splits_plain`."""
    _check_run(cols, run)
    _check_tile(tile, run)
    if not cols.is_cuda:
        return merge_splits_plain(cols, run, tile)
    from sparkrdma_tpu_torch import _build

    _check_rows(cols, "cols")
    w, n = cols.shape
    splits = torch.empty(-(-n // tile), dtype=torch.int32,
                         device=cols.device)
    lib = _build.library("merge_path")
    _build.count_launch(merge_splits)
    err = lib.sr_merge_splits(
        ctypes.c_void_p(cols.data_ptr()), ctypes.c_void_p(splits.data_ptr()),
        w, n, _ld(cols), run, tile,
        ctypes.c_void_p(_build.stream_ptr(cols.get_device())))
    _build.check(err, "merge_splits launch")
    return splits


merge_splits.launches = 0


def merge_stage_plain(cols: torch.Tensor, run: int) -> torch.Tensor:
    """Plain version of one stage: full-record sort of each pair of
    runs (a pair's merge is its sorted concatenation); the last pair may
    be short."""
    w, n = cols.shape
    full = n // (2 * run) * (2 * run)
    parts = []
    if full:
        parts.append(chunk_sort_cols(cols[:, :full], 2 * run))
    if n > full:
        parts.append(chunk_sort_cols(cols[:, full:], n - full))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def merge_stage(cols: torch.Tensor, run: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merge each adjacent pair of sorted ``run``-length runs of
    ``cols [W, N]`` into a sorted run of ``2*run`` (the last pair may
    have a short B run, or none).

    CUDA tensors run the split pass (:func:`merge_splits`) and launch
    the stage kernel of ``csrc/merge_path.cu``; CPU tensors take
    :func:`merge_stage_plain`. The result goes into ``out`` when given
    (row-strided views are taken, e.g. a column slice)."""
    _check_run(cols, run)
    if not cols.is_cuda:
        res = merge_stage_plain(cols, run)
        return res if out is None else out.copy_(res)
    from sparkrdma_tpu_torch import _build

    w, n = cols.shape
    _check_rows(cols, "cols")
    if out is None:
        out = torch.empty((w, n), dtype=cols.dtype, device=cols.device)
    elif (out.shape != cols.shape or out.dtype != cols.dtype
          or out.device != cols.device):
        raise ValueError("out must be a tensor like cols")
    _check_rows(out, "out")
    if (out.untyped_storage().data_ptr()
            == cols.untyped_storage().data_ptr()):
        raise ValueError("merge_stage cannot write into its input's storage")
    tile = pick_tile(w, run)
    splits = merge_splits(cols, run, tile)
    lib = _build.library("merge_path")
    _build.count_launch(merge_stage)
    err = lib.sr_merge_stage(
        ctypes.c_void_p(cols.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(splits.data_ptr()), w, n, _ld(cols), _ld(out), run,
        tile, ctypes.c_void_p(_build.stream_ptr(cols.get_device())))
    _build.check(err, "merge_stage launch")
    return out


merge_stage.launches = 0


def _merge_runs(cur: torch.Tensor, run: int, dest: torch.Tensor) -> None:
    """Merge the sorted ``run``-length runs of ``cur`` into ``dest``:
    the stages ping-pong between ``cur`` and one spare, and the last
    one writes ``dest``."""
    m = cur.shape[1]
    if m <= run:
        dest.copy_(cur)
        return
    spare = None
    r = run
    while 2 * r < m:
        if spare is None:
            spare = torch.empty_like(cur)
        spare, cur = cur, merge_stage(cur, r, out=spare)
        r *= 2
    merge_stage(cur, r, out=dest)


def merge_sort_cols(cols: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    run: int = 1 << 15,
                    n_valid: Optional[int] = None) -> torch.Tensor:
    """Sort ``[W, N]`` ascending by full-record lexicographic order.

    ``valid``: bool[N]; invalid rows sort to the tail and are zeroed.
    ``n_valid``: rows ``[0, n_valid)`` are valid and the rest padding
    (instead of ``valid``); only ``ceil(n_valid / run) * run`` rows are
    sorted, the at most ``run - 1`` of them past ``n_valid`` lifted to
    all-ones, and ``[n_valid, N)`` is zeroed. Same output as the
    equivalent ``valid`` mask.
    ``run``: run length of the formation pass (a power of two >= 128).
    """
    w, n = cols.shape
    if run < _THREADS or run & (run - 1):
        raise ValueError(f"run must be a power of two >= {_THREADS}, "
                         f"got {run}")
    if not supports_fast_sort(n, run):
        raise ValueError(
            f"merge_sort_cols needs power-of-two N >= {2 * run}, got {n}")
    if n_valid is None:
        m = n
        x = cols if valid is None else torch.where(
            valid[None, :], cols, torch.full_like(cols[:1], _FULL))
        keep = n if valid is None else int(valid.sum())
    else:
        if valid is not None:
            raise ValueError("pass valid or n_valid, not both")
        keep = min(max(int(n_valid), 0), n)
        m = -(-keep // run) * run
        x = cols[:, :m]
        if keep < m:
            lift = torch.arange(m, device=cols.device) < keep
            x = torch.where(lift[None, :], x, torch.full_like(x[:1], _FULL))
    res = torch.empty((w, n), dtype=cols.dtype, device=cols.device)
    if m:
        _merge_runs(chunk_sort_cols(x, run), run, res[:, :m])
    res[:, keep:] = 0
    return res


def merge_sort_cols_plain(cols: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Plain version of :func:`merge_sort_cols` with ``n_valid``: one
    full-record sort of the valid prefix, the rest zeroed."""
    keep = min(max(int(n_valid), 0), cols.shape[1])
    res = torch.zeros_like(cols)
    if keep:
        res[:, :keep] = chunk_sort_cols(cols[:, :keep], keep)
    return res


__all__ = ["merge_sort_cols", "merge_sort_cols_plain", "merge_stage",
           "merge_stage_plain", "merge_splits", "merge_splits_plain",
           "chunk_sort_cols", "supports_fast_sort", "pick_tile",
           "stage_smem"]
