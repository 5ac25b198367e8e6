"""Multi-process bootstrap — the ``librdmacm`` / connection-manager analogue.

SparkRDMA dials its peers lazily, with connect retries. Here the whole
connection layer is one call to ``torch.distributed.init_process_group``
that joins this process to the job's group; ``MeshRuntime`` then spans
every process of the group (``runtime/mesh.py``). Counterpart of
``sparkrdma_tpu.runtime.distributed``, whose ``jax.distributed``
coordinator becomes torch's rendezvous: ``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` as torchrun sets them, or the arguments.

Backends are named, never picked by trying one: ``"cpu:gloo,cuda:nccl"``
when each process has a card of its own (the host-side metadata, plan
counts and samples, goes over gloo on CPU tensors, the data over NCCL);
``"gloo"`` when processes share one card or run on the CPU (NCCL refuses
two ranks on one card).

Collectives go through a :class:`Collectives` scope: :data:`WORLD`, the
default group, or a scope keyed by a name (:func:`collective_scope`), which
the service gives each tenant session so that two sessions' collectives,
issued at once from two threads of each process, never meet in one op.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger("sparkrdma_tpu_torch.runtime")

#: the backend of a process that has a card of its own
CARD_PER_PROCESS = "cpu:gloo,cuda:nccl"

#: the timeout ``initialize_distributed`` gave the group (None: torch's),
#: which the scopes' own groups take too
_TIMEOUT: Optional[datetime.timedelta] = None


def group_rank() -> Tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    max_attempts: int = 3,
    retry_delay_s: float = 2.0,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """Join the process group, with connect retries.

    Returns True if a group is up after the call: at once if one already
    is (the launcher's). With no coordinator anywhere (no argument, no
    ``init_method``, no ``MASTER_ADDR``) it logs and returns False: one
    process, as a one-executor SparkRDMA cluster. Otherwise it makes
    ``max_attempts`` tries, ``retry_delay_s`` apart (RdmaNode's
    ``maxConnectionAttempts`` loop), then raises ``RuntimeError`` from
    the last error.

    ``coordinator_address`` is ``host:port`` (``tcp://`` rendezvous);
    ``init_method`` any torch rendezvous URL (``file://...`` lets tests
    meet without a port). ``num_processes`` and ``process_id`` default
    to ``WORLD_SIZE`` and ``RANK``. ``backend`` None is ``"gloo"`` where
    torch has no CUDA and ``"cpu:gloo,cuda:nccl"`` where it has;
    ``timeout_s`` bounds each try (torch's default when None)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        address = coordinator_address
        if address is None and env.get("MASTER_ADDR"):
            address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        if address is None:
            log.info("no coordinator configured; single-process mode")
            return False
        init_method = f"tcp://{address}"
    world = (int(num_processes) if num_processes is not None
             else int(env["WORLD_SIZE"]))
    rank = int(process_id) if process_id is not None else int(env["RANK"])
    if backend is None:
        backend = CARD_PER_PROCESS if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        global _TIMEOUT
        _TIMEOUT = kw["timeout"]
    last_err: Optional[Exception] = None
    for attempt in range(1, max_attempts + 1):
        try:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world, rank=rank, **kw)
            log.info("joined process group: process %d/%d over %s",
                     dist.get_rank(), dist.get_world_size(), backend)
            return True
        except Exception as e:
            last_err = e
            log.warning("distributed init attempt %d/%d failed: %s",
                        attempt, max_attempts, e)
            time.sleep(retry_delay_s)
    raise RuntimeError(
        f"could not join the process group after {max_attempts} attempts"
    ) from last_err


def refuse_across_processes(runtime, what: str, reference: str,
                            why: str = "reads a global array on the host"
                            ) -> None:
    """Raise ``NotImplementedError`` for an entry point that runs in one
    process only, when ``runtime`` spans several (ROADMAP A.12).

    ``reference`` is the ``file:line`` where the JAX package fails on
    the same call across processes, and ``why`` what it does there
    (most often it reads an array that spans other processes' devices
    on the host): the limit is the reference's own. A ``runtime`` of
    None stands for the process group (an entry point that is given no
    runtime)."""
    procs = runtime.process_count if runtime is not None else group_rank()[1]
    if procs <= 1:
        return
    raise NotImplementedError(
        f"{what} runs in one process only; across {procs} processes it "
        f"is refused, as the reference: `{reference}` {why} "
        "(ROADMAP A.12)")


class Collectives:
    """The collectives of one scope: the default group's (``name`` None,
    :data:`WORLD`: ``torch.distributed``'s calls, looked up at each
    call) or a group of their own, keyed by ``name``.

    A keyed scope's group is a ``ProcessGroupGloo`` over a
    ``PrefixStore`` of the default group's store, with the name as the
    prefix: its members meet under keys that only the name fixes, so
    the processes may create their scopes in any order, from any
    thread. ``dist.new_group`` does not serve: it names its store
    prefix by a counter of the groups made so far, so every process
    must call it in the same order, and it is collective over the
    default group. The constructors of ``ProcessGroupGloo`` and
    ``ProcessGroupNCCL`` over a store are public in torch 2.x; such a
    group is not registered with ``torch.distributed``, so its
    collectives are called on the group itself (``allgather``,
    ``broadcast``, ``allreduce``, ``alltoall_base``, each waited on).
    Where the default group's backend carries NCCL
    (:data:`CARD_PER_PROCESS`), CUDA tensors go over a
    ``ProcessGroupNCCL`` of the same prefix and CPU tensors over gloo.

    A group connects at its first collective, which blocks until every
    process has reached the same scope's first collective: creating the
    scope never blocks, so two processes may open scopes in different
    orders."""

    def __init__(self, name: Optional[str] = None):
        self.name = name
        self._lock = threading.Lock()
        self._groups = {}            # guarded-by: _lock

    def _group(self, t: torch.Tensor):
        """The scope's group for ``t``'s device (None: the default)."""
        if self.name is None:
            return None
        nccl = t.is_cuda and "nccl" in str(dist.get_backend())
        kind = "nccl" if nccl else "gloo"
        with self._lock:
            pg = self._groups.get(kind)
            if pg is None:
                from torch.distributed import distributed_c10d as c10d

                store = dist.PrefixStore(f"sparkrdma/scope/{self.name}/{kind}",
                                         c10d._get_default_store())
                rank, world = group_rank()
                timeout = _TIMEOUT or dist.default_pg_timeout
                if nccl:
                    opts = dist.ProcessGroupNCCL.Options()
                    opts._timeout = timeout
                    pg = dist.ProcessGroupNCCL(store, rank, world, opts)
                else:
                    pg = dist.ProcessGroupGloo(store, rank, world, timeout)
                self._groups[kind] = pg
        return pg

    def all_gather(self, outs: List[torch.Tensor], t: torch.Tensor) -> None:
        pg = self._group(t)
        if pg is None:
            dist.all_gather(outs, t)
        else:
            pg.allgather([outs], [t]).wait()

    def broadcast(self, t: torch.Tensor, src: int = 0) -> None:
        pg = self._group(t)
        if pg is None:
            dist.broadcast(t, src)
        else:
            opts = dist.BroadcastOptions()
            opts.rootRank = src
            pg.broadcast([t], opts).wait()

    def all_reduce(self, t: torch.Tensor) -> None:
        """A SUM all-reduce of ``t`` in place."""
        pg = self._group(t)
        if pg is None:
            dist.all_reduce(t)
        else:
            pg.allreduce([t]).wait()

    def all_to_all_single(self, out: torch.Tensor, t: torch.Tensor,
                          out_splits: List[int],
                          in_splits: List[int]) -> None:
        pg = self._group(t)
        if pg is None:
            dist.all_to_all_single(out, t, out_splits, in_splits)
        else:
            pg.alltoall_base(out, t, out_splits, in_splits,
                             dist.AllToAllOptions()).wait()

    def barrier(self) -> None:
        """Return once every process of the scope has called it: the
        default group's ``dist.barrier`` (a one-word all-reduce on the
        CPU where the group also carries NCCL), or a one-word all-reduce
        on the scope's own gloo group."""
        word = torch.zeros(1)
        pg = self._group(word)
        if pg is not None:
            pg.allreduce([word]).wait()
        elif dist.get_backend() == "gloo":
            dist.barrier()
        else:
            dist.all_reduce(word)

    def close(self) -> None:
        """Drop the scope's groups (a closed session's)."""
        with self._lock:
            self._groups.clear()

    def __repr__(self) -> str:
        return f"Collectives({self.name!r})"


#: the default group's scope: what a manager uses unless it is given one
WORLD = Collectives()

_SCOPE_LOCK = threading.Lock()
#: scopes made in this process, by key: a name's store keys serve one
#: group, so each ask gets a name of its own
_SCOPES_MADE: dict = {}            # guarded-by: _SCOPE_LOCK


def collective_scope(key: str) -> Collectives:
    """The next scope of ``key`` in this process, named ``<key>#<n>``
    for the n-th ask here (from 1). The scopes of one name form one
    group, so processes that ask for one key's scopes in the same order
    pair them up, whatever they ask for other keys in between."""
    with _SCOPE_LOCK:
        n = _SCOPES_MADE.get(key, 0) + 1
        _SCOPES_MADE[key] = n
    return Collectives(f"{key}#{n}")


__all__ = ["initialize_distributed", "group_rank", "refuse_across_processes",
           "CARD_PER_PROCESS", "Collectives", "WORLD", "collective_scope"]
