"""The read's map-side bucketing of every stacked source partition, into
the streaming regime's gather source.

:meth:`ShuffleExchange._exchange_streaming <sparkrdma_tpu_torch.exchange
.protocol.ShuffleExchange._exchange_streaming>` buckets each of the ``L``
stacked source partitions of a batch by destination (a stable sort by
the partitioner's id) and lays them side by side, followed by one zero
column, in ``src [W, L*n + 1]``, the source the chunks gather from. The
plain version, :func:`bucket_scatter_plain`, calls the partitioner and
:func:`~sparkrdma_tpu_torch.kernels.bucketing.bucket_records` on one
partition at a time, then concatenates. :func:`bucket_scatter` computes
the same bytes, counts and offsets from the partitioner's
``device_spec`` (``exchange/partitioners.py``) with one call of
``csrc/bucket_scatter.cu`` over all partitions, whose ids are those of
the plan's count kernel (``csrc/partition_ids.cuh``). That kernel
replaces no Pallas kernel (the reference buckets with XLA ops); it is
bound by moving every word once (the source note gives the design).

On a CPU tensor :func:`bucket_scatter` runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from sparkrdma_tpu_torch.kernels.bucketing import bucket_records
from sparkrdma_tpu_torch.kernels.partition_counts import kernel_args

#: the most bins the kernel buckets into (it keeps ids as bytes)
BIN_LIMIT = 256
#: records a tile of the kernel (``kTile`` in the source)
TILE = 4096


def bucket_scatter_plain(records: torch.Tensor, part_fn: Callable,
                         parts: int, local_partitions: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(src [W, L*n + 1], counts int64[L, parts], offsets int64[L,
    parts])``: each stacked partition (the columns ``[d*n, (d+1)*n)``, ``n
    = N // L``) through ``bucket_records`` over its partitioner's ids, the
    results side by side, then one zero column."""
    n = records.shape[1] // local_partitions
    srs, cnts, offs = [], [], []
    for d in range(local_partitions):
        x = records[:, d * n:(d + 1) * n]
        sr, c, o = bucket_records(x, part_fn(x), parts)
        srs.append(sr)
        cnts.append(c)
        offs.append(o)
    src = torch.cat(srs + [records.new_zeros((records.shape[0], 1))], dim=1)
    return src, torch.stack(cnts), torch.stack(offs)


def bucket_scatter(records: torch.Tensor, part_fn: Callable, parts: int,
                   local_partitions: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`bucket_scatter_plain`'s ``(src, counts, offsets)``.

    CUDA tensors launch ``csrc/bucket_scatter.cu`` on
    ``part_fn.device_spec``; a ``ValueError`` if there is none, if
    ``parts`` is past :data:`BIN_LIMIT` or if the description's ids can
    reach ``parts``. CPU tensors take :func:`bucket_scatter_plain`."""
    if not records.is_cuda:
        return bucket_scatter_plain(records, part_fn, parts,
                                    local_partitions)
    from sparkrdma_tpu_torch import _build

    spec = getattr(part_fn, "device_spec", None)
    if spec is None:
        raise ValueError("the partitioner has no device_spec: bucket it "
                         "with bucket_scatter_plain")
    if not 1 <= parts <= BIN_LIMIT:
        raise ValueError(f"{parts} bins: the kernel buckets into 1 to "
                         f"{BIN_LIMIT}")
    if spec.num_parts + spec.stride * (spec.split_k - 1) > parts:
        raise ValueError(f"the {spec.kind} partitioner's ids reach past "
                         f"{parts} bins")
    if records.shape[1] > 1 and records.stride(1) == 0:
        records = records.contiguous()     # an expanded batch
    args = kernel_args(records, spec, parts, local_partitions)
    w = records.shape[0]
    n = records.shape[1] // local_partitions
    if n >= 2 ** 31:
        raise ValueError(f"{n} records a partition: the kernel takes "
                         "fewer than 2^31")
    dev = records.device
    src = torch.empty((w, local_partitions * n + 1), dtype=torch.int32,
                      device=dev)
    # each tile's count of each bin, then each record's id as a byte
    work = torch.empty((local_partitions * parts * -(-n // TILE)
                        + (local_partitions * n + 3) // 4,),
                       dtype=torch.int32, device=dev)
    offsets = torch.empty((local_partitions, parts), dtype=torch.int64,
                          device=dev)
    # the kernel writes every count; the zeroing and the zero column after
    # the kernel are the PyTorch launches beside it: the profiler sees no
    # launch from the kernel's library (its CUDA runtime is static), and
    # ``shufflebench/layers.py`` places the kernel by the launches next to
    # it on the stream
    counts = torch.zeros((local_partitions, parts), dtype=torch.int64,
                         device=dev)
    lib = _build.library("bucket_scatter")
    _build.count_launch(bucket_scatter)
    # kernel_args: pointer, ld, cs, n, L, then the description's kind,
    # P, first, kw, spl, split_k and stride
    err = lib.sr_bucket_scatter(
        *args[:5], w, *args[5:], parts, ctypes.c_void_p(work.data_ptr()),
        work.numel(), ctypes.c_void_p(counts.data_ptr()),
        ctypes.c_void_p(offsets.data_ptr()), ctypes.c_void_p(src.data_ptr()),
        src.stride(0),
        ctypes.c_void_p(_build.stream_ptr(records.get_device())))
    _build.check(err, "bucket_scatter launch")
    src[:, -1] = 0
    return src, counts, offsets


bucket_scatter.launches = 0


__all__ = ["bucket_scatter", "bucket_scatter_plain", "BIN_LIMIT", "TILE"]
