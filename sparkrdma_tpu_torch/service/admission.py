"""Admission control + deficit-round-robin fairness across tenants — the
port's copy of ``sparkrdma_tpu.service.admission``.

Every exchange read through a service session asks the controller for a
ticket before dispatching; the cost of a read is its planned ROUND
count, so one tenant's 64-round oversubscribed terasort and another's
single-round join are weighed by the device time they will actually
occupy, not by call count.

Scheduling is classic deficit round robin: tenants with queued reads
sit on a ring; each sweep that cannot grant anything refills every
waiting tenant's deficit by ``quantum`` rounds (capped at its head
read's cost, so an idle-then-bursty tenant cannot hoard credit); a read
is granted when its tenant's deficit covers its cost and a concurrency
slot (``max_concurrent``; 0 = unlimited) is free. A tenant whose queue
empties forfeits its deficit — fairness is over *contending* tenants.

Waits are observable: a read that had to queue increments
``service.admission_waits``, journals an ``{"kind": "admission",
"event": "wait"}`` line, and stamps an ``admission:wait`` event into
the calling tenant's span timeline. An unadmitted read past ``wait_s``
raises :class:`AdmissionTimeout` rather than waiting forever.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Tuple


class AdmissionTimeout(RuntimeError):
    """A queued read outlived ``wait_s`` without being admitted."""

    def __init__(self, tenant: str, cost: int, waited_s: float):
        self.tenant = tenant
        super().__init__(
            f"tenant {tenant!r} read (cost {cost} rounds) not admitted "
            f"after {waited_s:.1f}s")


class _Ticket:
    """Held for the duration of one admitted read; context manager."""

    def __init__(self, controller: "AdmissionController", tenant: str):
        self._controller = controller
        self.tenant = tenant
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._controller._release()

    def __enter__(self) -> "_Ticket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class AdmissionController:
    def __init__(self, quantum: float = 1.0, max_concurrent: int = 0,
                 wait_s: float = 300.0, journal=None, metrics=None):
        self.quantum = quantum
        self.max_concurrent = max_concurrent
        self.wait_s = wait_s
        self.journal = journal
        self.metrics = metrics
        self._cv = threading.Condition()
        # all guarded by _cv
        self._queues: Dict[str, Deque[Tuple[int, dict]]] = {}
        self._ring: List[str] = []          # arrival order of tenants
        self._rr = 0                        # next-sweep start position
        self._deficit: Dict[str, float] = {}
        self._active = 0

    # ------------------------------------------------------------------
    def admit(self, tenant: str, cost: int = 1) -> _Ticket:
        """Block until this read is admitted; returns the held ticket."""
        cost = max(1, int(cost))
        entry = {"granted": False}
        start = time.monotonic()
        deadline = start + self.wait_s if self.wait_s > 0 else None
        with self._cv:
            q = self._queues.setdefault(tenant, deque())
            if tenant not in self._ring:
                self._ring.append(tenant)
            q.append((cost, entry))
            self._pump_locked()
            while not entry["granted"]:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self._abandon_locked(tenant, entry)
                        raise AdmissionTimeout(
                            tenant, cost, time.monotonic() - start)
                    self._cv.wait(timeout=min(remaining, 0.2))
                else:
                    self._cv.wait(timeout=0.2)
        waited_s = time.monotonic() - start
        ticket = _Ticket(self, tenant)
        try:
            self._note_admit(tenant, cost, waited_s)
        except BaseException:
            # the grant already bumped _active; a metrics/journal
            # failure here must hand the slot back or the controller
            # permanently loses concurrency
            ticket.release()
            raise
        return ticket

    def _release(self) -> None:
        with self._cv:
            self._active = max(0, self._active - 1)
            self._pump_locked()
            self._cv.notify_all()

    # ------------------------------------------------------------------
    def _abandon_locked(self, tenant: str, entry: dict) -> None:
        q = self._queues.get(tenant)
        if q is not None:
            for item in list(q):
                if item[1] is entry:
                    q.remove(item)
                    break

    def _pump_locked(self) -> None:
        """Grant every read the DRR state allows right now."""
        while True:
            if not any(self._queues.get(t) for t in self._ring):
                for t in self._ring:
                    self._deficit[t] = 0.0
                return
            if self.max_concurrent > 0 and \
                    self._active >= self.max_concurrent:
                return
            n = len(self._ring)
            granted = False
            for k in range(n):
                i = (self._rr + k) % n
                t = self._ring[i]
                q = self._queues.get(t)
                if not q:
                    # queue drained: forfeit accumulated credit
                    self._deficit[t] = 0.0
                    continue
                cost, entry = q[0]
                if self._deficit.get(t, 0.0) >= cost:
                    q.popleft()
                    self._deficit[t] -= cost
                    entry["granted"] = True
                    self._active += 1
                    self._rr = (i + 1) % n
                    self._cv.notify_all()
                    granted = True
                    break   # restart: re-check capacity before the next
            if granted:
                continue
            # nothing grantable at current deficits: refill one quantum,
            # capped at each head read's cost (no hoarding), then retry —
            # terminates because some deficit strictly approaches its cap
            for t in self._ring:
                q = self._queues.get(t)
                if q:
                    self._deficit[t] = min(
                        self._deficit.get(t, 0.0) + self.quantum,
                        float(q[0][0]))

    # ------------------------------------------------------------------
    def _note_admit(self, tenant: str, cost: int, waited_s: float) -> None:
        """Post-admission bookkeeping — runs OUTSIDE the condition."""
        if self.metrics is not None:
            self.metrics.counter("service.admits").inc()
        if waited_s < 0.001:
            return
        if self.metrics is not None:
            self.metrics.counter("service.admission_waits").inc()
        from sparkrdma_tpu_torch.obs.timeline import record_active
        from sparkrdma_tpu_torch.obs.trace import current_trace

        record_active("admission:wait", tenant=tenant, cost=cost,
                      ms=round(waited_s * 1e3, 3))
        if self.journal is not None and self.journal.enabled:
            # schema v12: admission waits carry the job-trace
            # coordinates of the read they delayed, so a job's verdict
            # can point at quota pressure, not just data-path phases
            tctx = current_trace()
            self.journal.emit_raw({
                "kind": "admission", "event": "wait", "tenant": tenant,
                "cost": cost, "wait_ms": round(waited_s * 1e3, 3),
                "trace_id": tctx.trace_id if tctx else "",
                "job": tctx.job if tctx else "",
                "stage": tctx.stage if tctx else "",
                "stage_attempt": tctx.stage_attempt if tctx else 0,
                "ts": time.time()})

    def stats(self) -> dict:
        with self._cv:
            return {
                "active": self._active,
                "queued": {t: len(q) for t, q in self._queues.items()
                           if q},
                "deficit": dict(self._deficit),
            }


__all__ = ["AdmissionController", "AdmissionTimeout"]
