"""The ring all-to-all — the kernel-level transport.

The reference's ``exchange/ring.py`` posts one-sided remote DMAs between
TPU chips from inside a Pallas kernel. In one process the D partitions
are stacked on one card, so the exchange is a permutation of device
memory:

    send [D_src, R, D_dst, ...]  ->  recv [D_dst, R, D_src, ...]
    recv[d, r, s] = send[s, r, d]

which is exactly R calls of ``lax.all_to_all(split_axis=0,
concat_axis=0, tiled=True)`` on a D-device mesh. The hand-written kernel
is ``csrc/ring_exchange.cu`` (its source note gives the bound and the
design); one launch carries every round. ``make_ring_all_to_all`` is its
R = 1 case, the counterpart of the reference's single-round kernel.
:func:`launch_plan` gives each launch's geometry (work items of a chunk,
one CTA each), so the decomposition is held on the CPU too.

Across the P processes of a ``torch.distributed`` group (a runtime whose
``process_count`` is above 1; each process stacks ``L = D / P``
partitions) the same kernel moves process ``p``'s send
``[L_src, R, D_dst, ...]`` into every process's registered receive window
(``exchange/windows.py``), so that process ``q`` holds

    recv_q[l', r, s] = send_p[l, r, q*L + l']     (s = p*L + l)

which is what ``hierarchical.make_flat_all_to_all`` gives for each round
and what R calls of ``lax.all_to_all`` give on the reference's mesh:
chunk ``(l, r, d)`` goes to the window of ``d // L`` at chunk index
``((d mod L)*R + r)*D + p*L + l`` (:func:`push_targets`). One launch
carries every local source and all R rounds (:func:`ring_push`; its R = 1
form :func:`ring_push_all_to_all` is the single-round kernel's
counterpart). The stacked form is its P = 1 case, with the receive
buffer as the one window. The handshake around it runs on the host
(:meth:`~sparkrdma_tpu_torch.exchange.windows.RingWindow.ready` /
``done``). On the card the windows are mapped by CUDA IPC, so the form
runs where the processes share a card or their cards are peers on one
host.

On a CPU tensor each wrapper runs its plain version (indexing; across
processes, indexing copies into the shared-memory windows); on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import zlib
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from sparkrdma_tpu_torch import _build
from sparkrdma_tpu_torch.exchange import windows
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
from sparkrdma_tpu_torch.runtime.distributed import WORLD


def derive_collective_id(key) -> int:
    """Stable per-plan id in 1..63 from an exec-cache key — the
    reference's barrier-semaphore id. It names nothing in the port:
    across processes each collective scope has its own windows
    (``exchange/windows.py``), which is the part it plays there."""
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
    """One launch's geometry: each of the ``L*R*D`` chunks (``D*R*D`` in
    one process) is cut into ``items_per_chunk`` items of ``item_words``
    words (the last one shorter), ``grid`` in all, one CTA each."""

    item_words: int
    items_per_chunk: int
    grid: int


def launch_plan(d: int, r: int, chunk: int,
                local: Optional[int] = None) -> RingPlan:
    """The kernel's geometry for ``send [L, R, D, chunk words]`` (``L``
    the ``local`` sources, ``D`` when None: the stacked form)."""
    per = -(-chunk // ITEM_WORDS)
    return RingPlan(ITEM_WORDS, per, (d if local is None else local)
                    * r * d * per)


@functools.lru_cache(maxsize=None)
def push_targets(rank: int, procs: int, local: int,
                 rounds: int) -> tuple:
    """Where process ``rank``'s push sends each chunk of its ``[L, R, D,
    chunk]`` send, in send order: ``(peer, index)`` int64 arrays, the
    process whose window takes it and its chunk index there, the same
    arithmetic as ``csrc/ring_exchange.cu``'s kernel."""
    d = local * procs
    c = np.arange(local * rounds * d, dtype=np.int64)
    dd, r, l = c % d, (c // d) % rounds, c // (rounds * d)
    peer = dd // local
    index = ((dd % local) * rounds + r) * d + rank * local + l
    peer.setflags(write=False)        # cached: every caller shares them
    index.setflags(write=False)
    return peer, index


def ring_push_plain(send: torch.Tensor, views: List[torch.Tensor],
                    rank: int, rounds: int = 0) -> None:
    """Plain version of the push: ``send [L, R, D, ...]`` (``[L, D,
    ...]`` when ``rounds`` is 1 and the round axis is absent: pass it)
    into the flat int32 ``views`` of every process's window, one
    indexing copy a peer."""
    procs = len(views)
    local = send.shape[0]
    r = rounds or send.shape[1]
    d = local * procs
    rows = send.reshape(local * r * d, -1)
    peer, index = push_targets(rank, procs, local, r)
    peer_t, index_t = torch.tensor(peer), torch.tensor(index)
    for q, view in enumerate(views):
        mine = (peer_t == q).nonzero().squeeze(1)
        dst = view[:local * r * d * rows.shape[1]].view(local * r * d, -1)
        dst.index_copy_(0, index_t[mine].to(dst.device),
                        rows.index_select(0, mine.to(rows.device)))


_kernel = None      # sr_ring_push, bound at the first launch


@functools.lru_cache(maxsize=256)
def _table(bases: tuple) -> _build.PeerTable:
    """The kernel's window table for ``bases`` (cached: a launch path
    whose buffers come from a pool meets the same few; no table is
    written after it is made)."""
    return _build.PeerTable(bases)


def _launch(send: torch.Tensor, bases: tuple, rank: int,
            round_axis: bool = True) -> None:
    """Launch ``csrc/ring_exchange.cu`` on ``send [L, R, D, ...]``
    (``[L, D, ...]`` as R = 1 without a ``round_axis``) into the windows
    at ``bases``, every process's by rank (``L = D / len(bases)``; in
    one process the one window is the receive buffer)."""
    global _kernel
    words = send.numel()
    if words == 0:
        return
    local = send.shape[0]
    r = send.shape[1] if round_axis else 1
    d = send.shape[2] if round_axis else send.shape[1]
    chunk = words // (local * r * d)
    if _kernel is None:
        _kernel = _build.library("ring_exchange").sr_ring_push
    plan = launch_plan(d, r, chunk, local)
    dev = send.get_device()
    err = _kernel(send.data_ptr(), _table(bases),
                  len(bases), local, r, d, chunk, rank, plan.item_words,
                  plan.items_per_chunk, plan.grid, dev,
                  _build.stream_ptr(dev))
    if err:
        _build.check(err, "ring_exchange launch")


def _stacked(send: torch.Tensor, out: Optional[torch.Tensor],
             round_axis: bool = True) -> torch.Tensor:
    """The one-process form: ``send [D, R, D, ...]`` (``[D, D, ...]``
    without a ``round_axis``) into ``out``, the one window."""
    if out is None:
        out = torch.empty_like(send)
    elif (out.shape != send.shape or out.dtype != send.dtype
          or out.device != send.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like send")
    _launch(send, (out.data_ptr(),), 0, round_axis)
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
    return _stacked(send, out)


ring_exchange.launches = 0


def _check_push(send: torch.Tensor, window, round_axis: bool) -> None:
    _check_send(send, "ring_push")
    d = send.shape[2] if round_axis else send.shape[1]
    if send.dim() < (3 if round_axis else 2) or \
            d != send.shape[0] * window.procs:
        raise ValueError(f"send must be [L, {'R, ' if round_axis else ''}"
                         f"L*{window.procs}, ...], got {tuple(send.shape)}")
    if send.numel() * 4 > window.nbytes:
        raise ValueError(f"the windows hold {window.nbytes} bytes, the "
                         f"push needs {send.numel() * 4}")


def ring_push(send: torch.Tensor, window) -> None:
    """Push ``send [L, R, D, ...]`` into the windows of ``window``'s scope
    (every process's, ``exchange/windows.py``): this process's share of
    the fused exchange. The caller runs the handshake around it."""
    _check_push(send, window, True)
    if not send.is_cuda:
        if send.numel():
            ring_push_plain(send, window.views(), window.rank)
        return
    if send.numel():
        _build.count_launch(ring_push)
    _launch(send, tuple(window.bases()), window.rank, True)


ring_push.launches = 0


def ring_push_all_to_all(send: torch.Tensor, window) -> None:
    """Single round: push ``send [L, D, ...]`` (the R = 1 launch)."""
    _check_push(send, window, False)
    if not send.is_cuda:
        if send.numel():
            ring_push_plain(send, window.views(), window.rank, rounds=1)
        return
    if send.numel():
        _build.count_launch(ring_push_all_to_all)
    _launch(send, tuple(window.bases()), window.rank, False)


ring_push_all_to_all.launches = 0


class _CrossMove:
    """One move across processes: the handshake around a push into the
    scope's windows. Calling it returns this process's window as the
    receive ``[L, R, D, ...]`` (valid until the scope's next move; call
    :meth:`release` once its last read is queued), or copies it into
    ``out`` and releases it."""

    def __init__(self, runtime, coll, push):
        self.runtime, self.coll, self.push = runtime, coll, push
        self.window = None

    def __call__(self, send: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        rt = self.runtime
        win = self.window = windows.window_for(
            self.coll, send.device, rt.process_index, rt.process_count)
        win.ready()
        win.ensure(max(send.numel() * 4, 4))
        self.push(send, win)
        win.done()
        view = win.view(send.shape)
        if out is None:
            return view
        out.copy_(view)
        win.release()
        return out

    def release(self) -> None:
        if self.window is not None:
            self.window.release()


def _as_words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous ``[L, D, ...]`` tensor of 4- or 8-byte items as int32
    words ``[L, D, w]`` (a view)."""
    return t.reshape(-1).view(torch.int32).view(t.shape[0], t.shape[1], -1)


def _no_release() -> None:
    """The stacked forms' output is their own: nothing to release."""


def _spans(runtime) -> bool:
    return runtime is not None and runtime.process_count > 1


def make_ring_exchange(num_partitions: int, num_rounds: int,
                       metrics: Optional[MetricsRegistry] = None,
                       runtime=None, coll=WORLD) -> Callable:
    """The fused multi-round exchange: ``send [D, R, D, ...] -> recv``,
    into ``out`` when given (a contiguous tensor like ``send``).

    Given a ``runtime`` that spans processes, the cross-process form in
    the collective scope ``coll``: ``send [L, R, D, ...]`` pushed into
    the windows (one launch), and the receive ``[L, R, D, ...]`` is this
    process's window unless ``out`` is given; the caller then calls the
    returned function's ``release()`` once its reads are queued. The
    stacked form's ``release`` does nothing."""
    if metrics is None:
        metrics = MetricsRegistry(enabled=False)
    local = runtime.local_partitions if _spans(runtime) else num_partitions
    move = _CrossMove(runtime, coll, ring_push) if _spans(runtime) else None

    def exchange(send: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if send.shape[1] != num_rounds:
            raise ValueError(
                f"fused exchange built for {num_rounds} rounds, "
                f"got send with round dim {send.shape[1]}")
        if send.shape[0] != local or send.shape[2] != num_partitions:
            raise ValueError(f"send holds {send.shape[0]} sources for "
                             f"{send.shape[2]} destinations, exchange "
                             f"built for {local} and {num_partitions}")
        if num_partitions == 1:
            return send if out is None else out.copy_(send)
        metrics.counter("transport.ring.fused_kernels").inc()
        metrics.counter("transport.ring.fused_rounds").inc(num_rounds)
        metrics.counter("transport.ring.overlap_rounds").inc(
            max(num_rounds - 1, 0))
        if move is not None:
            return move(send, out)
        return ring_exchange(send, out)

    exchange.release = move.release if move is not None else _no_release
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
    return _stacked(send, out, round_axis=False)


ring_all_to_all.launches = 0


def make_ring_all_to_all(num_partitions: int,
                         metrics: Optional[MetricsRegistry] = None,
                         runtime=None, coll=WORLD) -> Callable:
    """Per-round all-to-all of dest-major slots ``[D, D, ...]``.

    Given a ``runtime`` that spans processes, the cross-process form in
    the collective scope ``coll``: ``send [L, D, ...]`` of any 4- or
    8-byte type (the counts ride it as int64) pushed into the windows
    (the R = 1 launch), returned as a tensor of its own (``out`` when
    given), as ``all_to_all_single`` returns one."""
    if metrics is None:
        metrics = MetricsRegistry(enabled=False)
    move = (_CrossMove(runtime, coll, ring_push_all_to_all)
            if _spans(runtime) else None)

    def a2a(send: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if num_partitions == 1:
            return send if out is None else out.copy_(send)
        metrics.counter("transport.ring.kernels").inc()
        if move is None:
            return ring_all_to_all(send, out)
        words = _as_words(send.contiguous())
        got = move(words, _as_words(out) if out is not None
                   else torch.empty_like(words))
        return out if out is not None else \
            got.reshape(-1).view(send.dtype).view(send.shape)

    return a2a


__all__ = ["make_ring_exchange", "make_ring_all_to_all",
           "derive_collective_id", "ring_exchange", "ring_exchange_plain",
           "ring_all_to_all", "ring_push", "ring_push_all_to_all",
           "ring_push_plain", "push_targets", "launch_plan", "RingPlan",
           "ITEM_WORDS"]
