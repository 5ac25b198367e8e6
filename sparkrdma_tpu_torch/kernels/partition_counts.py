"""Per-destination record counts of a plan pass: ``int64[L, parts]``.

:meth:`ShuffleExchange.plan <sparkrdma_tpu_torch.exchange.protocol
.ShuffleExchange.plan>` counts, for each of the ``L`` stacked partitions
of a batch, how many of its records go to each destination. The plain
version, :func:`partition_counts_plain`, calls the partitioner and
:func:`~sparkrdma_tpu_torch.kernels.bucketing.histogram_pids` on one
partition at a time. :func:`partition_counts` computes the same table
from the partitioner's ``device_spec`` (``exchange/partitioners.py``,
``split_partitioner``) with one launch of ``csrc/partition_counts.cu``
over all partitions. That kernel replaces no Pallas kernel (the
reference counts with XLA ops); it is bound by reading the key words
once (the source note gives the design).

On a CPU tensor :func:`partition_counts` runs the plain version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from sparkrdma_tpu_torch.exchange.partitioners import DeviceSpec
from sparkrdma_tpu_torch.kernels.bucketing import histogram_pids

def partition_counts_plain(records: torch.Tensor, part_fn: Callable,
                           parts: int, local_partitions: int
                           ) -> torch.Tensor:
    """The partitioner's ids of each stacked partition (the columns
    ``[d*n, (d+1)*n)``, ``n = N // L``), counted by ``histogram_pids``:
    ``int64[L, parts]`` on the batch's device."""
    n = records.shape[1] // local_partitions
    return torch.stack([
        histogram_pids(part_fn(records[:, d * n:(d + 1) * n]), parts)
        for d in range(local_partitions)])


def kernel_args(records: torch.Tensor, spec: DeviceSpec, parts: int,
                local_partitions: int) -> tuple:
    """The C entry's arguments before ``table`` and the stream; raises
    ``ValueError`` on what the kernel does not take. The batch is read
    in place through its strides."""
    if records.dtype != torch.int32 or records.dim() != 2:
        raise ValueError(f"expected an int32 [W, N] batch, got "
                         f"{records.dtype} {tuple(records.shape)}")
    if not 1 <= local_partitions <= 65535 or not 1 <= parts < 2 ** 31:
        raise ValueError(f"{local_partitions} partitions of {parts} bins "
                         "out of the kernel's range")
    last = spec.first + spec.key_words - 1
    if last >= records.shape[0]:
        raise ValueError(f"{spec.kind} partitioner reads key words "
                         f"{spec.first}..{last} of a "
                         f"{records.shape[0]}-word batch")
    n = records.shape[1] // local_partitions
    cs = records.stride(1) if records.shape[1] > 1 else 1
    if cs < 1:
        raise ValueError("the kernel reads records at a column stride "
                         "of at least 1")
    ld = records.stride(0) if records.shape[0] > 1 else 0
    return (ctypes.c_void_p(records.data_ptr()), ld, cs, n,
            local_partitions, *spec.kernel_args(records.device))


def partition_counts(records: torch.Tensor, part_fn: Callable, parts: int,
                     local_partitions: int) -> torch.Tensor:
    """``int64[L, parts]``: row ``d`` counts stacked partition ``d``'s
    records by the id ``part_fn`` gives them; ids outside ``[0, parts)``
    are not counted.

    CUDA tensors launch ``partition_counts_kernel`` on
    ``part_fn.device_spec`` (a ``ValueError`` if it has none); CPU
    tensors take :func:`partition_counts_plain`."""
    if not records.is_cuda:
        return partition_counts_plain(records, part_fn, parts,
                                      local_partitions)
    from sparkrdma_tpu_torch import _build

    spec = getattr(part_fn, "device_spec", None)
    if spec is None:
        raise ValueError("the partitioner has no device_spec: count it "
                         "with partition_counts_plain")
    if records.shape[1] > 1 and records.stride(1) == 0:
        records = records.contiguous()     # an expanded batch
    args = kernel_args(records, spec, parts, local_partitions)
    # zeroed by a PyTorch launch: besides, the profiler sees no launch
    # from the kernel's library (its CUDA runtime is static), and
    # ``shufflebench/layers.py`` places the kernel by the launches next
    # to it on the stream
    table = torch.zeros((local_partitions, parts), dtype=torch.int64,
                        device=records.device)
    lib = _build.library("partition_counts")
    _build.count_launch(partition_counts)
    err = lib.sr_partition_counts(
        *args, ctypes.c_void_p(table.data_ptr()), parts,
        ctypes.c_void_p(_build.stream_ptr(records.get_device())))
    _build.check(err, "partition_counts launch")
    return table


partition_counts.launches = 0


__all__ = ["partition_counts", "partition_counts_plain", "kernel_args"]
