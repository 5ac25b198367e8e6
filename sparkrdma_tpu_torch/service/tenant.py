"""Per-tenant resource accounting across the three storage tiers — the
port's copy of ``sparkrdma_tpu.service.tenant``.

A :class:`TenantQuota` bounds what one tenant of the shuffle service may
hold concurrently in each tier — slot-pool buffers on the card ("hbm"),
host-tier bytes, disk-segment bytes — and a :class:`TenantAccount` is the live
counter enforcing it. Enforcement happens INSIDE the tiers
(``hbm/slot_pool.py`` acquisition, ``hbm/tiered_store.py`` put/evict
accounting), not at the SPI surface, so every allocation path is
covered, including eviction-driven demotions the tenant never asked
for.

Semantics: a tenant at its quota BLOCKS (bounded by ``wait_s``, the
``admission_wait_s`` conf knob) until one of its OWN holdings is
released — it never steals from, and can never be starved by, another
tenant's usage. A limit of 0 means unlimited (accounting still runs, so
gauges and the usage-vs-pool invariant stay exact).

Lock order: the account condition is a LEAF lock — tier code may take
it while holding a tier lock for the non-blocking ``try_charge`` /
``release`` paths, but the blocking ``charge`` must be entered with no
tier lock held (both tiers stage their blocking charges before taking
their own locks).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

#: the three accounted tiers: HBM pool buffers (count), pinned host
#: bytes, disk-segment bytes
TIERS = ("hbm", "host", "disk")


class QuotaExceededError(RuntimeError):
    """A tenant's quota wait exceeded its deadline (or waiting was
    disabled) — the operation fails cleanly instead of blocking forever."""

    def __init__(self, tenant: str, tier: str, need: int, used: int,
                 limit: int, waited_s: float = 0.0):
        self.tenant = tenant
        self.tier = tier
        super().__init__(
            f"tenant {tenant!r} over {tier} quota: need {need} on top of "
            f"{used} used (limit {limit}) after {waited_s:.1f}s wait")


@dataclass(frozen=True)
class TenantQuota:
    """Per-tier ceilings for one tenant; 0 = unlimited in that tier."""

    hbm_slots: int = 0    # concurrent slot-pool buffers
    host_bytes: int = 0   # pinned host-tier bytes
    disk_bytes: int = 0   # disk-segment bytes

    def limit(self, tier: str) -> int:
        return {"hbm": self.hbm_slots, "host": self.host_bytes,
                "disk": self.disk_bytes}[tier]


class TenantAccount:
    """Live usage counters + blocking admission against one quota.

    Thread-safe; the internal condition is a leaf lock (see module
    docstring for the ordering contract with the tier locks).
    """

    def __init__(self, name: str, quota: Optional[TenantQuota] = None,
                 metrics=None, wait_s: float = 300.0):
        self.name = name
        self.quota = quota or TenantQuota()
        self.wait_s = wait_s
        self._metrics = metrics
        self._cv = threading.Condition()
        # guarded by _cv
        self._used: Dict[str, int] = {t: 0 for t in TIERS}
        self._waits = 0

    # --- blocking admission (entered lock-free by the tiers) ----------
    def charge(self, tier: str, amount: int,
               poke: Optional[Callable[[], None]] = None) -> None:
        """Reserve ``amount`` in ``tier``, blocking while over quota.

        ``poke`` (optional) is invoked on each wait iteration so the
        caller can nudge background machinery that frees this tenant's
        holdings (e.g. the tiered store's eviction writer). Raises
        :class:`QuotaExceededError` after ``wait_s`` (immediately when
        ``wait_s`` is 0 and the quota is exceeded).
        """
        if amount <= 0:
            return
        limit = self.quota.limit(tier)
        waited = False
        start = time.monotonic()
        deadline = start + self.wait_s if self.wait_s > 0 else start
        with self._cv:
            if limit > 0 and amount > limit:
                # can never fit: fail fast instead of waiting out the clock
                raise QuotaExceededError(self.name, tier, amount,
                                         self._used[tier], limit)
            while limit > 0 and self._used[tier] + amount > limit:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise QuotaExceededError(
                        self.name, tier, amount, self._used[tier], limit,
                        waited_s=time.monotonic() - start)
                if not waited:
                    waited = True
                    self._waits += 1
                if poke is not None:
                    poke()
                # bounded slices so a missed notify (poke-driven frees
                # bypass this account) re-checks promptly
                self._cv.wait(timeout=min(remaining, 0.2))
            self._used[tier] += amount
        if waited and self._metrics is not None:
            self._metrics.counter(
                f"tenant.{self.name}.quota_waits").inc()
        self._publish_gauges()

    # --- non-blocking paths (safe under tier locks) -------------------
    def try_charge(self, tier: str, amount: int) -> bool:
        """Reserve without blocking; False when it would exceed quota."""
        if amount <= 0:
            return True
        limit = self.quota.limit(tier)
        with self._cv:
            if limit > 0 and self._used[tier] + amount > limit:
                return False
            self._used[tier] += amount
        self._publish_gauges()
        return True

    def release(self, tier: str, amount: int) -> None:
        if amount <= 0:
            return
        with self._cv:
            # defensive clamp: an unbalanced release must not open the
            # quota wider than the tenant's real holdings
            self._used[tier] = max(0, self._used[tier] - amount)
            self._cv.notify_all()
        self._publish_gauges()

    # --- observability ------------------------------------------------
    def usage(self) -> Dict[str, int]:
        with self._cv:
            return dict(self._used)

    def wait_count(self) -> int:
        with self._cv:
            return self._waits

    def _publish_gauges(self) -> None:
        if self._metrics is None:
            return
        with self._cv:
            hbm = self._used["hbm"]
            host = self._used["host"]
            disk = self._used["disk"]
        m = self._metrics
        m.gauge(f"tenant.{self.name}.hbm_slots").set(hbm)
        m.gauge(f"tenant.{self.name}.host_bytes").set(host)
        m.gauge(f"tenant.{self.name}.disk_bytes").set(disk)


class TenantRegistry:
    """Name -> :class:`TenantAccount` table owned by the service."""

    def __init__(self, metrics=None, wait_s: float = 300.0):
        self._metrics = metrics
        self._wait_s = wait_s
        self._lock = threading.Lock()
        self._accounts: Dict[str, TenantAccount] = {}

    def register(self, name: str,
                 quota: Optional[TenantQuota] = None) -> TenantAccount:
        """Idempotent: re-registering an existing tenant returns its
        live account (an explicit new quota replaces the old ceilings
        without resetting usage)."""
        if not name:
            raise ValueError("tenant name must be non-empty")
        with self._lock:
            acct = self._accounts.get(name)
            if acct is None:
                acct = TenantAccount(name, quota, metrics=self._metrics,
                                     wait_s=self._wait_s)
                self._accounts[name] = acct
            elif quota is not None:
                acct.quota = quota
            return acct

    def get(self, name: str) -> Optional[TenantAccount]:
        with self._lock:
            return self._accounts.get(name)

    def remove(self, name: str) -> None:
        with self._lock:
            self._accounts.pop(name, None)

    def names(self):
        with self._lock:
            return sorted(self._accounts)

    def usage_by_tenant(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            accounts = list(self._accounts.items())
        return {name: acct.usage() for name, acct in accounts}


__all__ = ["TenantQuota", "TenantAccount", "TenantRegistry",
           "QuotaExceededError", "TIERS"]
