"""Stacked ring all-to-all — the kernel-level transport.

The reference's ``exchange/ring.py`` posts one-sided remote DMAs between
TPU chips from inside a Pallas kernel. Here the D partitions are stacked
on one card, so the exchange is a permutation of device memory:

    send [D_src, R, D_dst, ...]  ->  recv [D_dst, R, D_src, ...]
    recv[d, r, s] = send[s, r, d]

which is exactly R calls of ``lax.all_to_all(split_axis=0,
concat_axis=0, tiled=True)`` on a D-device mesh. The hand-written kernel
is ``csrc/ring_exchange.cu`` (its source note gives the bound and the
design); one launch carries every round. ``make_ring_all_to_all`` is its
R = 1 case, the counterpart of the reference's single-round kernel.
:func:`launch_plan` gives each launch's geometry (work items of a chunk,
one CTA each), so the decomposition is held on the CPU too.

On a CPU tensor :func:`ring_exchange` runs its plain version (indexing);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import zlib
from typing import Callable, NamedTuple, Optional

import torch

from sparkrdma_tpu_torch import _build
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry


def derive_collective_id(key) -> int:
    """Stable per-plan id in 1..63 from an exec-cache key — the
    reference's barrier-semaphore id. Within one card it names nothing
    yet; the multi-card transport keys its signal pads on it."""
    return 1 + zlib.crc32(repr(key).encode("utf-8")) % 63


def ring_exchange_plain(send: torch.Tensor) -> torch.Tensor:
    """Plain version: the permutation as indexing."""
    return send.transpose(0, 2).contiguous()


def _check_send(send: torch.Tensor, what: str) -> None:
    if send.dtype != torch.int32:
        raise TypeError(f"{what} takes int32 word views, got {send.dtype}")
    if send.is_cuda and not send.is_contiguous():
        raise ValueError(f"{what} needs a contiguous send buffer")


#: words per work item: 16 KB, one pass of a CTA's 256 threads x 4
#: vectors (``csrc/ring_exchange.cu``'s source note says why)
ITEM_WORDS = 1 << 12


class RingPlan(NamedTuple):
    """One launch's geometry: each of the ``D*R*D`` chunks is cut into
    ``items_per_chunk`` items of ``item_words`` words (the last one
    shorter), ``grid`` in all, one CTA each."""

    item_words: int
    items_per_chunk: int
    grid: int


def launch_plan(d: int, r: int, chunk: int) -> RingPlan:
    """The kernel's geometry for ``send [D, R, D, chunk words]``."""
    per = -(-chunk // ITEM_WORDS)
    return RingPlan(ITEM_WORDS, per, d * r * d * per)


_kernel = None      # sr_ring_exchange, bound at the first launch


def _launch(send: torch.Tensor, out: Optional[torch.Tensor],
            round_axis: bool = True) -> torch.Tensor:
    """Launch ``csrc/ring_exchange.cu`` on ``send [D, R, D, ...]``, or on
    ``send [D, D, ...]`` as R = 1 when it has no ``round_axis``."""
    global _kernel
    if out is None:
        out = torch.empty_like(send)
    elif (out.shape != send.shape or out.dtype != send.dtype
          or out.device != send.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like send")
    words = send.numel()
    if words == 0:
        return out
    d = send.shape[0]
    r = send.shape[1] if round_axis else 1
    chunk = words // (d * r * d)
    if _kernel is None:
        _kernel = _build.library("ring_exchange").sr_ring_exchange
    plan = launch_plan(d, r, chunk)
    err = _kernel(send.data_ptr(), out.data_ptr(), d, r, chunk,
                  plan.item_words, plan.items_per_chunk, plan.grid,
                  _build.stream_ptr(send.get_device()))
    if err:
        _build.check(err, "ring_exchange launch")
    return out


def ring_exchange(send: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``recv[d, r, s] = send[s, r, d]`` for ``send [D, R, D, ...]``,
    into ``out`` when given."""
    if send.dim() < 3 or send.shape[0] != send.shape[2]:
        raise ValueError(f"send must be [D, R, D, ...], got "
                         f"{tuple(send.shape)}")
    _check_send(send, "ring_exchange")
    if not send.is_cuda:
        recv = ring_exchange_plain(send)
        return recv if out is None else out.copy_(recv)
    if send.numel():
        _build.count_launch(ring_exchange)
    return _launch(send, out)


ring_exchange.launches = 0


def make_ring_exchange(num_partitions: int, num_rounds: int,
                       metrics: Optional[MetricsRegistry] = None
                       ) -> Callable:
    """The fused multi-round exchange: ``send [D, R, D, ...] -> recv``,
    into ``out`` when given (a contiguous tensor like ``send``)."""
    if metrics is None:
        metrics = MetricsRegistry(enabled=False)

    def exchange(send: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if send.shape[1] != num_rounds:
            raise ValueError(
                f"fused exchange built for {num_rounds} rounds, "
                f"got send with round dim {send.shape[1]}")
        if send.shape[0] != num_partitions:
            raise ValueError(f"send holds {send.shape[0]} sources, "
                             f"exchange built for {num_partitions}")
        if num_partitions == 1:
            return send if out is None else out.copy_(send)
        metrics.counter("transport.ring.fused_kernels").inc()
        metrics.counter("transport.ring.fused_rounds").inc(num_rounds)
        metrics.counter("transport.ring.overlap_rounds").inc(
            max(num_rounds - 1, 0))
        return ring_exchange(send, out)

    return exchange


def ring_all_to_all(send: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single round: ``recv[d, s] = send[s, d]`` for ``send [D, D, ...]``
    — the R = 1 launch of the same kernel — into ``out`` when given."""
    if send.dim() < 2 or send.shape[0] != send.shape[1]:
        raise ValueError(f"send must be [D, D, ...], got "
                         f"{tuple(send.shape)}")
    _check_send(send, "ring_all_to_all")
    if not send.is_cuda:
        recv = send.transpose(0, 1).contiguous()
        return recv if out is None else out.copy_(recv)
    if send.numel():
        _build.count_launch(ring_all_to_all)
    return _launch(send, out, round_axis=False)


ring_all_to_all.launches = 0


def make_ring_all_to_all(num_partitions: int,
                         metrics: Optional[MetricsRegistry] = None
                         ) -> Callable:
    """Per-round all-to-all of dest-major slots ``[D, D, ...]``."""
    if metrics is None:
        metrics = MetricsRegistry(enabled=False)

    def a2a(send: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if num_partitions == 1:
            return send if out is None else out.copy_(send)
        metrics.counter("transport.ring.kernels").inc()
        return ring_all_to_all(send, out)

    return a2a


__all__ = ["make_ring_exchange", "make_ring_all_to_all",
           "derive_collective_id", "ring_exchange", "ring_exchange_plain",
           "ring_all_to_all", "launch_plan", "RingPlan", "ITEM_WORDS"]
