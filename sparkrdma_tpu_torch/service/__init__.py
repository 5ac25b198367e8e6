"""Multi-tenant shuffle service — the port's copy of
``sparkrdma_tpu.service`` (the external-shuffle-service analogue).

One long-lived :class:`~sparkrdma_tpu_torch.service.daemon.ShuffleService`
owns the process singletons — the runtime on the card with its slot
pool, the tiered store, the journal — and admits many concurrent tenant
clients, each holding a tenant-scoped ShuffleManager. Per-tenant quotas
span all three storage tiers (:mod:`~sparkrdma_tpu_torch.service.tenant`),
and a deficit-round-robin admission controller
(:mod:`~sparkrdma_tpu_torch.service.admission`) keeps one tenant's large
TeraSort from starving another's small join.

Out-of-process callers reach the same session surface over the wire:
:class:`~sparkrdma_tpu_torch.service.rpc.RpcServer` (started when
``conf.rpc_port >= 0``) serves the length-prefixed-JSON protocol of
:mod:`~sparkrdma_tpu_torch.service.wire` under per-client leases, and
:class:`~sparkrdma_tpu_torch.service.client.RpcClient` is the retrying,
idempotent client half. Both speak the reference's protocol byte for
byte, so either package's client talks to either package's server.
"""

from sparkrdma_tpu_torch.service.admission import AdmissionController
from sparkrdma_tpu_torch.service.client import RpcCallError, RpcClient
from sparkrdma_tpu_torch.service.daemon import ShuffleService
from sparkrdma_tpu_torch.service.rpc import RpcError, RpcServer
from sparkrdma_tpu_torch.service.tenant import (QuotaExceededError,
                                                TenantAccount, TenantQuota,
                                                TenantRegistry)

__all__ = ["ShuffleService", "AdmissionController", "TenantAccount",
           "TenantQuota", "TenantRegistry", "QuotaExceededError",
           "RpcServer", "RpcClient", "RpcError", "RpcCallError"]
