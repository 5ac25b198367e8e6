"""The long-lived shuffle-service daemon — the port's copy of
``sparkrdma_tpu.service.daemon``: process singletons and tenant sessions.

SparkRDMA runs ``RdmaShuffleManager`` in two roles: per-application
instances in the executors, and the external shuffle service, ONE
long-lived process serving blocks to many applications across executor
restarts. :class:`ShuffleService` is that second role on one card: one
daemon owns what no two tenants can each have —

- the :class:`~sparkrdma_tpu_torch.runtime.mesh.MeshRuntime` (the card,
  its stacked partitions and its :class:`~sparkrdma_tpu_torch.hbm
  .slot_pool.SlotPool`), on ``"cuda"`` unless the caller passes a CPU
  runtime or ``device="cpu"``;
- the :class:`~sparkrdma_tpu_torch.hbm.tiered_store.TieredStore` (the
  host budget and the spill directory are the machine's);
- the journal (one ``metrics_sink`` writer per process), the telemetry
  store, the heartbeat with its per-tenant usage probe, the alert
  evaluator, the probe and the RPC server,

and admits many concurrent tenants. ``open_session(tenant)`` returns a
tenant-scoped :class:`~sparkrdma_tpu_torch.api.shuffle_manager.ShuffleManager`
— the full SPI, unchanged for its callers — wired to the shared
singletons, to that tenant's
:class:`~sparkrdma_tpu_torch.service.tenant.TenantAccount` (three-tier
quotas) and to the shared deficit-round-robin
:class:`~sparkrdma_tpu_torch.service.admission.AdmissionController`.

Isolation: a tenant's fault schedule and retry state live in its
session's plane, which reaches the module-level fault sites only through
thread-local scoping (:func:`sparkrdma_tpu_torch.faults.scoped_plane`),
so one tenant's faults never fire inside another's shuffle; spans,
rollups and heartbeats carry the tenant name. Sessions share the pool
from their own threads: the pool orders a buffer's next holder after
its last one on the card (``hbm/slot_pool.py``, stream order).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.config import ShuffleConf
from sparkrdma_tpu_torch.hbm.tiered_store import TieredStore
from sparkrdma_tpu_torch.obs.alerts import AlertEvaluator
from sparkrdma_tpu_torch.obs.baseline import BaselineStore
from sparkrdma_tpu_torch.obs.journal import ExchangeJournal
from sparkrdma_tpu_torch.obs.metrics import MetricsRegistry, global_registry
from sparkrdma_tpu_torch.obs.probe import ProbeServer
from sparkrdma_tpu_torch.obs.rollup import HeartbeatEmitter
from sparkrdma_tpu_torch.obs.tsdb import NULL_TELEMETRY, TelemetryStore
from sparkrdma_tpu_torch.runtime.mesh import MeshRuntime
from sparkrdma_tpu_torch.service.admission import AdmissionController
from sparkrdma_tpu_torch.service.rpc import RpcServer
from sparkrdma_tpu_torch.service.tenant import (TenantAccount, TenantQuota,
                                          TenantRegistry)

log = logging.getLogger("sparkrdma_tpu_torch.service")


class ShuffleService:
    """One per host — owns the singletons, hands out tenant sessions."""

    def __init__(self, runtime: Optional[MeshRuntime] = None,
                 conf: Optional[ShuffleConf] = None, *,
                 num_partitions: int = 8, device="cuda"):
        self.runtime = runtime or MeshRuntime(
            conf, num_partitions=num_partitions, device=device)
        self.conf = conf or self.runtime.conf
        # the reference's gate: the daemon's registry, and with it the
        # telemetry store and the alerts, is on with either knob
        self.metrics = MetricsRegistry(
            enabled=(self.conf.collect_shuffle_read_stats
                     or bool(self.conf.metrics_sink)))
        sink = self.conf.metrics_sink
        if "{process}" in sink:
            sink = sink.replace("{process}",
                                str(self.runtime.process_index))
        self.journal = ExchangeJournal(
            sink, metrics=self.metrics,
            max_bytes=self.conf.journal_max_bytes)
        self._sink_path = sink
        # ONE tiered store for the host: the pinned-host budget and the
        # spill directory are per-machine resources; tenants share them
        # under their accounts' quotas rather than racing blind.
        self.tiered = TieredStore(self.conf, pool=self.runtime.pool)
        self.tenants = TenantRegistry(metrics=self.metrics,
                                      wait_s=self.conf.admission_wait_s)
        self.admission = AdmissionController(
            quantum=self.conf.admission_quantum,
            max_concurrent=self.conf.admission_slots,
            wait_s=self.conf.admission_wait_s,
            journal=self.journal, metrics=self.metrics)
        self.runtime.pool.metrics = self.metrics
        self._lock = threading.Lock()
        self._sessions: List[ShuffleManager] = []   # guarded-by: _lock
        self._closed = False                        # guarded-by: _lock
        # the daemon owns THE heartbeat; its per-tenant usage probe is
        # what shuffle_top's tenant view reads back out of the journal
        self.heartbeat = None
        if self.journal.enabled and self.conf.heartbeat_s > 0:
            pool = self.runtime.pool
            self.heartbeat = HeartbeatEmitter(
                self.journal, self.conf.heartbeat_s,
                identity=self.runtime.process_identity(),
                probes={
                    "in_flight": self._reads_in_flight,
                    "pool_outstanding": lambda: pool.outstanding,
                    "host_tier_mb": (
                        lambda: self.tiered.occupancy()["host_bytes"]
                        // (1 << 20)),
                    "disk_tier_mb": (
                        lambda: self.tiered.occupancy()["disk_bytes"]
                        // (1 << 20)),
                    "tenants": self.tenants.usage_by_tenant,
                })
            self.heartbeat.start()
        # the daemon owns THE telemetry store and probe endpoint:
        # sessions share them (ShuffleManager telemetry=), so one ring
        # and one port cover every tenant. A rollup aggregator lives
        # per session, so the probe's live-rollup view sums session
        # peeks on demand.
        if self.metrics.enabled and self.conf.telemetry_window_s > 0:
            # fold the process-global registry in (store.*, staging.*,
            # faults.* live there) so alert rules can watch them here
            self.telemetry = TelemetryStore(
                self.metrics, window_s=self.conf.telemetry_window_s,
                history=self.conf.telemetry_history,
                extra_sources=(lambda: global_registry().snapshot(),))
            self.telemetry.start()
        else:
            self.telemetry = NULL_TELEMETRY
        # persisted baselines + the alert evaluator: the daemon owns
        # THE rule engine (per-tenant rules read the shared usage
        # rings); sessions never start their own. Baselines are keyed
        # by mesh geometry so a topology change never reads as an
        # anomaly.
        self.baselines = (BaselineStore(self.conf.baseline_dir)
                          if self.conf.baseline_dir else None)
        self.alerts = None
        if self.telemetry.enabled and self.conf.alert_eval_s > 0:
            self.alerts = AlertEvaluator(
                telemetry=self.telemetry,
                metrics=self.metrics,
                journal=self.journal,
                baselines=self.baselines,
                heartbeat=self.heartbeat,
                tenants=self.tenants.usage_by_tenant,
                interval_s=self.conf.alert_eval_s,
                fire_after=self.conf.alert_fire_breaches,
                resolve_after=self.conf.alert_resolve_windows,
                geometry=f"w{self.runtime.num_partitions}")
            self.alerts.start()
        # the network front door on 127.0.0.1: out-of-process clients
        # reach the session surface over the wire protocol
        # (service/rpc.py) under per-client leases. Like the probe, a
        # bind failure never takes the daemon down — the in-process
        # surface and the data plane are intact without it.
        self.rpc = None
        if self.conf.rpc_port >= 0:
            try:
                self.rpc = RpcServer(self, port=self.conf.rpc_port)
                self.rpc.start()
            except OSError:
                log.warning("rpc endpoint failed to bind port %d",
                            self.conf.rpc_port, exc_info=True)
        self.probe = None
        if self.conf.probe_port >= 0:
            try:
                self.probe = ProbeServer(
                    self.conf.probe_port,
                    metrics=self.metrics,
                    telemetry=self.telemetry,
                    identity=self.runtime.process_identity(),
                    journal_path=self._sink_path,
                    rollups=self._live_rollups,
                    tenants=self.tenants.usage_by_tenant,
                    alerts=(self.alerts.active
                            if self.alerts is not None else None),
                    health=(self.alerts.health
                            if self.alerts is not None else None),
                    jobs=self.telemetry.job_lines)
                self.probe.start()
            except OSError:
                # the probe must never take the daemon down with it
                log.warning("probe endpoint failed to bind port %d",
                            self.conf.probe_port, exc_info=True)

    # --- tenant lifecycle ---------------------------------------------
    def register_tenant(self, name: str,
                        quota: Optional[TenantQuota] = None
                        ) -> TenantAccount:
        """Create (or re-scope) a tenant; idempotent.

        ``quota=None`` takes the service defaults from the conf
        (``tenant_hbm_slots`` / ``tenant_host_bytes`` /
        ``tenant_disk_bytes``; 0 = unlimited in that tier).
        """
        if quota is None:
            quota = TenantQuota(
                hbm_slots=self.conf.tenant_hbm_slots,
                host_bytes=self.conf.tenant_host_bytes,
                disk_bytes=self.conf.tenant_disk_bytes)
        acct = self.tenants.register(name, quota)
        # the store enforces host/disk charges by tenant tag, so it
        # needs the account installed under the tenant's name
        self.tiered.register_account(name, acct)
        self.metrics.gauge("service.tenants").set(
            len(self.tenants.names()))
        return acct

    def open_session(self, tenant: str,
                     conf: Optional[ShuffleConf] = None) -> ShuffleManager:
        """Admit ``tenant`` and return its SPI handle.

        The returned manager IS a :class:`ShuffleManager` — the five SPI
        methods behave identically — but scoped: shared runtime/store/
        journal (never closed by its ``stop()``), tenant-tagged spans
        and store segments, quota-enforced tier allocations, admission-
        controlled reads. ``conf`` lets a tenant bring its own knobs
        (fault schedule, transport, sort options); the partition count
        and the card come from the shared runtime regardless.
        """
        acct = self.tenants.get(tenant)
        if acct is None:
            acct = self.register_tenant(tenant)
        else:
            # a prior session's stop() tore the tenant's store state
            # down (delete_tenant pops the account) — re-install
            self.tiered.register_account(tenant, acct)
        with self._lock:
            if self._closed:
                raise RuntimeError("ShuffleService is stopped")
        m = ShuffleManager(self.runtime, conf or self.conf,
                           tenant=tenant, tiered=self.tiered,
                           journal=self.journal,
                           admission=self.admission, account=acct,
                           telemetry=self.telemetry)
        with self._lock:
            self._sessions.append(m)
        self.metrics.counter("service.sessions_opened").inc()
        return m

    def close_session(self, manager: ShuffleManager) -> None:
        """Tear down one tenant session (drops its store segments)."""
        with self._lock:
            try:
                self._sessions.remove(manager)
            except ValueError:
                pass
        manager.stop()
        self.metrics.counter("service.sessions_closed").inc()

    # --- observability -------------------------------------------------
    def _reads_in_flight(self) -> int:
        with self._lock:
            sessions = list(self._sessions)
        return sum(m._reads_in_flight for m in sessions)

    def _live_rollups(self) -> List[Dict]:
        """Open (un-emitted) rollup cells across every live session —
        the probe's live view of in-window activity."""
        with self._lock:
            sessions = list(self._sessions)
        cells: List[Dict] = []
        for m in sessions:
            if m.rollup is not None:
                cells.extend(m.rollup.peek())
        return cells

    def usage_by_tenant(self) -> Dict[str, Dict[str, int]]:
        return self.tenants.usage_by_tenant()

    def stats(self) -> dict:
        with self._lock:
            open_sessions = len(self._sessions)
        return {
            "tenants": self.tenants.names(),
            "sessions": open_sessions,
            "admission": self.admission.stats(),
            "store": self.tiered.occupancy_by_tenant(),
            # per-tenant job traces closed against the shared telemetry
            # store (tenant sessions pass it to their JobTraces), newest
            # last — the daemon-side mirror of the probe's /jobs route
            "jobs": self.jobs_by_tenant(),
        }

    def jobs_by_tenant(self) -> Dict[str, List[Dict]]:
        """Retained ``{"kind": "job"}`` lines grouped per tenant."""
        out: Dict[str, List[Dict]] = {}
        for line in self.telemetry.job_lines():
            out.setdefault(str(line.get("tenant", "") or ""),
                           []).append(line)
        return out

    # --- lifecycle ------------------------------------------------------
    def stop(self) -> None:
        """Stop the daemon: close straggler sessions, then singletons."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            stragglers = list(self._sessions)
            self._sessions.clear()
        for m in stragglers:
            m.stop()
        if self.heartbeat is not None:
            self.heartbeat.stop()       # emits one final beat
        if self.alerts is not None:
            self.alerts.stop()          # persists dirty baselines
            self.alerts = None
        if self.rpc is not None:
            self.rpc.stop()
            self.rpc = None
        if self.probe is not None:
            self.probe.stop()
            self.probe = None
        self.telemetry.stop()
        self.journal.close()
        self.tiered.close()
        self.runtime.stop()

    def __enter__(self) -> "ShuffleService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = ["ShuffleService"]
