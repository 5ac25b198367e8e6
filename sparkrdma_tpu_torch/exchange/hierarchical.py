"""Hierarchical (two-stage) all-to-all, and the moves between processes.

Counterpart of ``sparkrdma_tpu.exchange.hierarchical``. A flat
all-to-all over ``D`` partitions on ``H`` hosts of ``L' = D / H``
partitions each sends ``L' x L'`` small messages between every pair of
hosts; staged like NCCL's hierarchical alltoall it sends ``L'`` large
ones:

1. **intra-host**: the partitions of one host exchange, so that local
   rank ``l`` gathers every block its host holds for remote rank ``l``;
2. **inter-host**: same-rank partitions across hosts exchange those
   bundles.

Derivation (partition ``(h, l)``, dest-major block ``X[d']`` with
``d' = h' L' + l'``), as in the reference:

- stage 1 over intra-host groups, splitting ``l'``: partition
  ``(h, l')`` ends with ``Y[h', src_l] = X@(h, src_l)[h' L' + l']``;
- stage 2 over same-``l`` groups, splitting ``h'``: partition
  ``(h', l')`` ends with ``Z[src_h, src_l] = X@(src_h, src_l)[h' L' +
  l']``, the flat all-to-all's source-major result.

Here the partitions of a process are stacked on its device
(``runtime/mesh.py``), so a move takes the process's ``[L_src, D_dst,
...]`` send (block ``i`` of local partition ``r`` bound for partition
``i``) and returns ``[L_dst, D_src, ...]``; in one process that is the
stacked ``[D_src, D_dst, ...] -> [D_dst, D_src, ...]`` of the flat
transport. Each stage is a routing of blocks between partitions:

- a stage whose blocks all stay inside their process is one gather on
  the device (a materialised permute);
- a stage whose groups span processes is one ``all_to_all_single`` over
  the default group, each process's send ordered by peer and by
  destination slot, zero split sizes for peers outside its groups, and
  one gather that places what came in.

Any ``H`` that divides ``D`` works: below the process count stage 1
crosses processes; equal to it, stage 1 stays on each card and stage 2
is all across processes; above it, the hosts are virtual groups inside
each process (what the single-process tests use). The flat transport
across processes is the same machinery with the one routing ``(src,
slot i) -> (partition i, slot src)`` (:func:`make_flat_all_to_all`).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry
from sparkrdma_tpu_torch.runtime.distributed import WORLD


def hierarchy_for(runtime, hosts: int = 0) -> int:
    """Resolve the host-group count (0 = the process count)."""
    size = runtime.num_partitions
    if hosts == 0:
        hosts = runtime.process_count
    if hosts <= 0 or size % hosts:
        raise ValueError(
            f"hierarchy hosts {hosts} must divide mesh size {size}")
    return hosts


class _Route:
    """One stage's routing for this process: where each local block goes
    and where each block that comes in lands (numpy, built once)."""

    def __init__(self, size: int, procs: int, me: int, dest):
        local = size // procs
        a = np.repeat(np.arange(size), size)          # holder partition
        i = np.tile(np.arange(size), size)            # slot in its send
        b, j = dest(a, i)                             # partition, slot
        src_p, dst_p = a // local, b // local
        #: does any block of any process change process? (a global
        #: fact: every process takes the same branch)
        self.crosses = bool((src_p != dst_p).any())
        # each sender orders its blocks by (peer, destination slot); a
        # receiver lists, peer by peer, the blocks that peer sends it in
        # that same order
        order = np.lexsort((j, b, dst_p))
        mine = order[src_p[order] == me]
        self.send_idx = torch.from_numpy((a[mine] - me * local) * size
                                         + i[mine])
        self.send_splits = np.bincount(dst_p[mine],
                                       minlength=procs).tolist()
        incoming = np.lexsort((j, b, src_p))
        incoming = incoming[dst_p[incoming] == me]
        self.recv_splits = np.bincount(src_p[incoming],
                                       minlength=procs).tolist()
        land = (b[incoming] - me * local) * size + j[incoming]
        #: out[k] = arrived[place[k]]
        self.place = torch.from_numpy(np.argsort(land))
        if not self.crosses:
            # everything stays here: one gather straight from the send
            self.local_idx = self.send_idx[self.place]

    def __call__(self, x: torch.Tensor, coll=WORLD) -> torch.Tensor:
        """Route ``x``; a move across processes goes through the
        :class:`~sparkrdma_tpu_torch.runtime.distributed.Collectives`
        scope ``coll``."""
        shape = x.shape
        flat = x.reshape((shape[0] * shape[1],) + tuple(shape[2:]))
        dev = x.device
        if not self.crosses:
            return flat.index_select(0, self.local_idx.to(dev)).reshape(
                shape)
        send = flat.index_select(0, self.send_idx.to(dev))
        recv = send.new_empty((sum(self.recv_splits),) + send.shape[1:])
        coll.all_to_all_single(recv, send, self.recv_splits,
                               self.send_splits)
        return recv.index_select(0, self.place.to(dev)).reshape(shape)


@functools.lru_cache(maxsize=None)
def _route(size: int, procs: int, me: int, hosts: int, stage: int) -> _Route:
    """Stage 1 or 2 of the hierarchy (``stage`` 0: the flat routing)."""
    lh = size // hosts

    def dest(a, i):
        ha, la, hi, li = a // lh, a % lh, i // lh, i % lh
        if stage == 1:          # split l' inside host ha
            return ha * lh + li, hi * lh + la
        if stage == 2:          # split h' among rank la's
            return hi * lh + la, ha * lh + li
        return i, a
    return _Route(size, procs, me, dest)


def make_flat_all_to_all(runtime, coll=WORLD) -> Callable:
    """The flat move ``[L_src, D_dst, ...] -> [L_dst, D_src, ...]``
    across the group's processes: one ``all_to_all_single`` in the
    collective scope ``coll``."""
    route = _route(runtime.num_partitions, runtime.process_count,
                   runtime.process_index, 1, 0)
    return lambda send: route(send, coll)


def make_hierarchical_all_to_all(runtime, hosts: int = 0,
                                 metrics=None, coll=WORLD) -> Callable:
    """The two-stage move with the flat transport's contract: this
    process's dest-major ``[L, D, ...]`` in, source-major ``[L, D, ...]``
    out, its moves across processes in the collective scope ``coll``.
    Counts ``transport.hier.staged_exchanges`` per call, or
    ``transport.hier.flat_fallbacks`` where the hierarchy is degenerate
    (one host, or one partition a host), which runs the flat move."""
    if metrics is None:
        metrics = MetricsRegistry(enabled=False)
    size = runtime.num_partitions
    h = hierarchy_for(runtime, hosts)
    procs, me = runtime.process_count, runtime.process_index
    if h == 1 or size // h == 1:
        # degenerate hierarchy: the flat exchange IS the algorithm
        flat = (make_flat_all_to_all(runtime, coll) if procs > 1
                else lambda send: send.transpose(0, 1).contiguous())

        def flat_a2a(send: torch.Tensor) -> torch.Tensor:
            metrics.counter("transport.hier.flat_fallbacks").inc()
            return flat(send)
        return flat_a2a
    stage1 = _route(size, procs, me, h, 1)
    stage2 = _route(size, procs, me, h, 2)

    def a2a(send: torch.Tensor) -> torch.Tensor:
        metrics.counter("transport.hier.staged_exchanges").inc()
        return stage2(stage1(send, coll), coll)
    return a2a


__all__ = ["hierarchy_for", "make_hierarchical_all_to_all",
           "make_flat_all_to_all"]
