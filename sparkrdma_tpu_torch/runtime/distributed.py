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
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger("sparkrdma_tpu_torch.runtime")

#: the backend of a process that has a card of its own
CARD_PER_PROCESS = "cpu:gloo,cuda:nccl"


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


def refuse_across_processes(runtime, what: str,
                            reference: Optional[str] = None) -> None:
    """Raise ``NotImplementedError`` for an entry point that runs in one
    process only, when ``runtime`` spans several (ROADMAP A.12).

    ``reference`` is the ``file:line`` where the JAX package fails on
    the same call across processes (it reads an array that spans other
    processes' devices on the host): the limit is the reference's own.
    None marks an entry point the reference runs there and the port has
    not ported yet. A ``runtime`` of None stands for the process group
    (an entry point that is given no runtime)."""
    procs = runtime.process_count if runtime is not None else group_rank()[1]
    if procs <= 1:
        return
    why = (f"as the reference: `{reference}` reads a global array on "
           "the host" if reference else "it is not ported yet")
    raise NotImplementedError(
        f"{what} runs in one process only; across {procs} processes it "
        f"is refused, {why} (ROADMAP A.12)")


__all__ = ["initialize_distributed", "group_rank", "refuse_across_processes",
           "CARD_PER_PROCESS"]
