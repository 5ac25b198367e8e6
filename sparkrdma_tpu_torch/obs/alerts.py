"""Declarative alerting — the port's copy of ``sparkrdma_tpu.obs.alerts``:
the same nine rules, hysteresis and ``{"kind": "alert"}`` lines.

A registry of declarative rules (:data:`ALERT_RULES`) is evaluated on
the telemetry cadence by :class:`AlertEvaluator`, a thread owned by the
service or by a standalone manager. Condition families:

- **threshold** — a windowed counter delta crosses a fixed line
  (journal write errors, admission waits);
- **window_rate** — a windowed rate is abnormal (spill storms,
  synchronous-fetch storms);
- **burn_rate** — a budget-consuming counter family is burning
  (``degrade.*``: the planner's two degradation rungs,
  ``degrade.broadcast_join`` and ``degrade.plan_overlap``, written by
  ``faults.note_degradation``);
- **baseline_anomaly** — a live rate scores as an outlier against the
  persisted baseline (``obs/baseline.py``, robust z-score);
- **derived** — heartbeat staleness, one shuffle's straggler spread from
  its rollup latency histogram, and per-tenant quota-wait pileups.

Hysteresis, not edge triggering: a rule must breach ``fire_after``
consecutive evaluations to fire and then see ``resolve_after``
consecutive clean ones to resolve; active alerts are deduplicated by
``rule_id[:breach-key]``. Firing and resolving each write one journal
line (:data:`ALERT_FIELDS`) and move the ``alerts.fired`` /
``alerts.resolved`` counters and the ``alerts.active`` gauge. The probe
serves the live view at ``/alerts`` and a worst-severity verdict at
``/health``. Evaluation never raises into the caller (a crashing rule
is counted and the others still run), lines are written outside the
evaluator's lock, and every input is host data from the telemetry store.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.obs.journal import SCHEMA_VERSION

log = logging.getLogger("sparkrdma_tpu_torch.alerts")

#: every key a ``{"kind": "alert"}`` line carries (the reference's set,
#: which its CLIs read)
ALERT_FIELDS = frozenset({
    "kind", "schema", "ts", "event", "rule", "severity", "subsystem",
    "condition", "dedup", "tenant", "value", "threshold", "breaches",
    "message",
})

#: severity ladder, mildest first (health verdicts take the worst)
SEVERITIES = ("info", "warn", "crit")

#: condition families a rule may declare
CONDITIONS = ("threshold", "window_rate", "burn_rate",
              "baseline_anomaly", "derived")

#: health score penalty per active alert, by severity
_HEALTH_PENALTY = {"info": 5, "warn": 25, "crit": 60}


@dataclasses.dataclass
class Breach:
    """One rule violation observed during a single evaluation."""

    dedup: str = ""        #: sub-key (tenant, shuffle, rung) — "" = global
    tenant: str = ""       #: owning tenant ("" outside the service)
    value: float = 0.0     #: the observed signal
    threshold: float = 0.0  #: the line it crossed
    message: str = ""      #: human-readable one-liner


@dataclasses.dataclass
class EvalContext:
    """Everything a rule may look at — assembled per evaluation."""

    now: float
    window_s: float                 #: evaluation window (trailing)
    telemetry: object               #: TelemetryStore (or null store)
    baselines: Optional[object] = None   #: BaselineStore, if configured
    geometry: str = ""              #: baseline geometry key
    heartbeat_age_s: Optional[float] = None
    heartbeat_interval_s: float = 0.0
    tenant_usage: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    prev_tenant_usage: Dict[str, Dict] = \
        dataclasses.field(default_factory=dict)
    rollup_tails: List[Dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One registered rule: identity + condition + the check itself."""

    id: str
    severity: str
    subsystem: str
    condition: str
    metrics: Tuple[str, ...]        #: registry names consumed
    description: str
    check: Callable[[EvalContext], List[Breach]]

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")
        if self.condition not in CONDITIONS:
            raise ValueError(f"unknown condition {self.condition!r}")


#: the registry — rule id -> AlertRule; module-level like names.py so
#: operators can extend it before the evaluator starts
ALERT_RULES: Dict[str, AlertRule] = {}


def register_rule(rule: AlertRule) -> AlertRule:
    if rule.id in ALERT_RULES:
        raise ValueError(f"duplicate alert rule id {rule.id!r}")
    ALERT_RULES[rule.id] = rule
    return rule


def alert_rule(id: str, *, severity: str, subsystem: str,
               condition: str, metrics: Tuple[str, ...] = (),
               description: str = ""):
    """Decorator form of :func:`register_rule`."""
    def wrap(fn: Callable[[EvalContext], List[Breach]]):
        register_rule(AlertRule(id=id, severity=severity,
                                subsystem=subsystem, condition=condition,
                                metrics=tuple(metrics),
                                description=description, check=fn))
        return fn
    return wrap


# ---------------------------------------------------------------------
# built-in rules
# ---------------------------------------------------------------------

@alert_rule("spill_storm", severity="warn", subsystem="store",
            condition="window_rate", metrics=("store.spill_bytes",),
            description="host-staging tier is spilling to disk")
def _spill_storm(ctx: EvalContext) -> List[Breach]:
    d = ctx.telemetry.delta("store.spill_bytes", span_s=ctx.window_s)
    if d.value > 0:
        return [Breach(value=d.value,
                       message=f"{int(d.value)} bytes spilled in the "
                               f"last {d.effective_s:.1f}s")]
    return []


@alert_rule("sync_fetch_storm", severity="warn", subsystem="store",
            condition="window_rate", metrics=("store.sync_fetches",),
            description="reads are blocking on un-prefetched segments")
def _sync_fetch_storm(ctx: EvalContext) -> List[Breach]:
    d = ctx.telemetry.delta("store.sync_fetches", span_s=ctx.window_s)
    if d.value >= 3:
        return [Breach(value=d.value, threshold=3.0,
                       message=f"{int(d.value)} synchronous fetches in "
                               f"the last {d.effective_s:.1f}s")]
    return []


@alert_rule("admission_pileup", severity="warn", subsystem="service",
            condition="threshold", metrics=("service.admission_waits",),
            description="reads are queueing at the admission controller")
def _admission_pileup(ctx: EvalContext) -> List[Breach]:
    d = ctx.telemetry.delta("service.admission_waits",
                            span_s=ctx.window_s)
    if d.value > 0:
        return [Breach(value=d.value,
                       message=f"{int(d.value)} admission waits in the "
                               f"last {d.effective_s:.1f}s")]
    return []


@alert_rule("journal_errors", severity="crit", subsystem="journal",
            condition="threshold", metrics=("journal.write_errors",),
            description="the journal sink is failing writes")
def _journal_errors(ctx: EvalContext) -> List[Breach]:
    d = ctx.telemetry.delta("journal.write_errors", span_s=ctx.window_s)
    if d.value > 0:
        return [Breach(value=d.value,
                       message=f"{int(d.value)} journal write errors in "
                               f"the last {d.effective_s:.1f}s")]
    return []


@alert_rule("degrade_rung", severity="warn", subsystem="faults",
            condition="burn_rate", metrics=("degrade.*",),
            description="the degradation ladder took a rung")
def _degrade_rung(ctx: EvalContext) -> List[Breach]:
    stats = ctx.telemetry.stats()
    names = (stats.get("last", {}) if stats else {})
    out: List[Breach] = []
    for name in sorted(names):
        if not name.startswith("degrade."):
            continue
        d = ctx.telemetry.delta(name, span_s=ctx.window_s)
        if d.value > 0:
            rung = name.split(".", 1)[1]
            out.append(Breach(dedup=rung, value=d.value,
                              message=f"degradation rung {rung!r} "
                                      f"entered {int(d.value)}x"))
    return out


@alert_rule("heartbeat_stale", severity="crit", subsystem="journal",
            condition="derived",
            description="the liveness heartbeat went quiet")
def _heartbeat_stale(ctx: EvalContext) -> List[Breach]:
    age = ctx.heartbeat_age_s
    interval = ctx.heartbeat_interval_s
    if age is None or interval <= 0:
        return []
    limit = 3.0 * interval
    if age > limit:
        return [Breach(value=age, threshold=limit,
                       message=f"last heartbeat {age:.1f}s ago "
                               f"(interval {interval:.1f}s)")]
    return []


@alert_rule("straggler_spread", severity="warn", subsystem="exchange",
            condition="derived",
            description="one shuffle's slowest read dwarfs its median")
def _straggler_spread(ctx: EvalContext) -> List[Breach]:
    out: List[Breach] = []
    for rb in ctx.rollup_tails:
        reads = rb.get("reads", 0)
        if reads < 4 or rb.get("ts", 0.0) < ctx.now - 2 * ctx.window_s:
            continue
        mean_ms = rb.get("lat_sum_ms", 0.0) / reads
        floor = max(rb.get("p50_ms", 0.0), mean_ms, 0.1)
        spread = rb.get("lat_max_ms", 0.0) / floor
        if spread > 4.0:
            tenant = str(rb.get("tenant", "") or "")
            sid = rb.get("shuffle_id", 0)
            out.append(Breach(dedup=f"{tenant}/{sid}", tenant=tenant,
                              value=spread, threshold=4.0,
                              message=f"shuffle {sid} max read latency "
                                      f"{spread:.1f}x its median"))
    return out


@alert_rule("tenant_quota_pileup", severity="warn", subsystem="service",
            condition="derived", metrics=("tenant.*.quota_waits",),
            description="a tenant is blocking on its quota")
def _tenant_quota_pileup(ctx: EvalContext) -> List[Breach]:
    out: List[Breach] = []
    for tenant in sorted(ctx.tenant_usage):
        usage = ctx.tenant_usage[tenant] or {}
        waits = usage.get("quota_waits", 0)
        prev = (ctx.prev_tenant_usage.get(tenant) or {}) \
            .get("quota_waits", 0)
        if waits > prev:
            out.append(Breach(dedup=tenant, tenant=tenant,
                              value=waits - prev,
                              message=f"tenant {tenant!r} hit "
                                      f"{waits - prev} quota waits"))
    return out


@alert_rule("throughput_anomaly", severity="info", subsystem="exchange",
            condition="baseline_anomaly", metrics=("shuffle.bytes",),
            description="shuffle byte rate is an outlier vs baseline")
def _throughput_anomaly(ctx: EvalContext) -> List[Breach]:
    if ctx.baselines is None:
        return []
    r = ctx.telemetry.rate("shuffle.bytes", span_s=ctx.window_s)
    if r.effective_s <= 0:
        return []
    z = ctx.baselines.zscore("shuffle.bytes", r.value,
                             geometry=ctx.geometry)
    if z is not None and z < -3.5:
        return [Breach(value=z, threshold=-3.5,
                       message=f"shuffle.bytes rate {r.value:.0f}/s "
                               f"scores {z:.1f} sigma below baseline")]
    return []


# ---------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------

class _KeyState:
    """Hysteresis state of one dedup key (guarded by the evaluator)."""

    __slots__ = ("breaches", "clean", "active", "last")

    def __init__(self):
        self.breaches = 0       #: consecutive breaching evaluations
        self.clean = 0          #: consecutive clean evaluations
        self.active = False     #: currently fired
        self.last: Optional[Breach] = None


class AlertEvaluator:
    """Evaluates :data:`ALERT_RULES` on a cadence with hysteresis.

    ``fire_after`` (K) consecutive breaches fire an alert; ``resolve_
    after`` (M) consecutive clean evaluations resolve it. Call
    :meth:`evaluate_once` directly for deterministic tests; ``start()``
    runs it on ``interval_s`` from a daemon thread.
    """

    def __init__(self, *, telemetry, metrics, journal=None,
                 baselines=None, heartbeat=None,
                 tenants: Optional[Callable[[], Dict]] = None,
                 rules: Optional[Dict[str, AlertRule]] = None,
                 interval_s: float = 1.0, fire_after: int = 3,
                 resolve_after: int = 2, geometry: str = "",
                 clock: Callable[[], float] = time.time):
        if interval_s < 0:
            raise ValueError("alert interval_s must be >= 0")
        if fire_after < 1 or resolve_after < 1:
            raise ValueError("alert hysteresis counts must be >= 1")
        self._telemetry = telemetry
        self._metrics = metrics
        self._journal = journal
        self._baselines = baselines
        self._heartbeat = heartbeat
        self._tenants = tenants
        self._rules = dict(rules if rules is not None else ALERT_RULES)
        self.interval_s = float(interval_s)
        self.fire_after = int(fire_after)
        self.resolve_after = int(resolve_after)
        self.geometry = geometry
        self._clock = clock
        self._lock = threading.Lock()
        self._state: Dict[str, _KeyState] = {}      # guarded-by: _lock
        self._prev_tenant_usage: Dict = {}          # guarded-by: _lock
        self.evals = 0                              # guarded-by: _lock
        self.eval_errors = 0                        # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        self._thread = threading.Thread(
            target=self._run, name="sparkrdma-alerts", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.evaluate_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, self.interval_s))
            self._thread = None
        if self._baselines is not None and self._baselines.dirty:
            self._baselines.save()

    # -- evaluation ---------------------------------------------------
    def _context(self, now: float) -> EvalContext:
        hb_age = None
        hb_interval = 0.0
        hb = self._heartbeat
        if hb is not None:
            hb_age = hb.age_s(now)
            hb_interval = hb.interval_s
        usage = dict(self._tenants()) if self._tenants is not None else {}
        with self._lock:
            prev = self._prev_tenant_usage
            self._prev_tenant_usage = usage
        # newest rollup line of every (tenant, shuffle) series the
        # store has seen — the straggler rule's input
        tails: List[Dict] = []
        stats = self._telemetry.stats()
        for key in (stats.get("rollup_series", []) if stats else []):
            tenant, _, sid = key.rpartition("/")
            try:
                hist = self._telemetry.rollup_history(int(sid),
                                                      tenant=tenant)
            except (TypeError, ValueError):
                continue
            if hist:
                tails.append(hist[-1])
        return EvalContext(
            now=now,
            window_s=max(2.0 * self.interval_s, 1.0),
            telemetry=self._telemetry,
            baselines=self._baselines,
            geometry=self.geometry,
            heartbeat_age_s=hb_age,
            heartbeat_interval_s=hb_interval,
            tenant_usage=usage,
            prev_tenant_usage=prev,
            rollup_tails=tails,
        )

    def evaluate_once(self, now: Optional[float] = None) -> List[Dict]:
        """One evaluation pass. Returns the journal lines it emitted
        (fired + resolved) — handy for tests. Never raises."""
        try:
            return self._evaluate(now)
        except Exception:
            with self._lock:
                self.eval_errors += 1
                first = self.eval_errors == 1
            if first:
                log.exception("alert evaluation failed")
            return []

    def _evaluate(self, now: Optional[float]) -> List[Dict]:
        now = self._clock() if now is None else now
        ctx = self._context(now)
        # run every rule, collecting breaches per dedup key; a single
        # crashing rule is counted and skipped, the rest still run
        breaches: Dict[str, Tuple[AlertRule, Breach]] = {}
        for rid in sorted(self._rules):
            rule = self._rules[rid]
            try:
                found = rule.check(ctx)
            except Exception:
                with self._lock:
                    self.eval_errors += 1
                    first = self.eval_errors == 1
                if first:
                    log.exception("alert rule %r crashed", rid)
                continue
            for b in found or ():
                key = f"{rid}:{b.dedup}" if b.dedup else rid
                breaches[key] = (rule, b)
        pending: List[Dict] = []
        with self._lock:
            self.evals += 1
            for key, (rule, b) in breaches.items():
                st = self._state.get(key)
                if st is None:
                    st = self._state[key] = _KeyState()
                st.breaches += 1
                st.clean = 0
                st.last = b
                if not st.active and st.breaches >= self.fire_after:
                    st.active = True
                    pending.append(self._line(now, "fired", rule, b,
                                              st.breaches))
            for key, st in list(self._state.items()):
                if key in breaches:
                    continue
                st.breaches = 0
                st.clean += 1
                if st.active and st.clean >= self.resolve_after:
                    st.active = False
                    rule = self._rules.get(key.split(":", 1)[0])
                    if rule is not None and st.last is not None:
                        pending.append(self._line(now, "resolved", rule,
                                                  st.last, st.clean))
                if not st.active and st.clean >= self.resolve_after:
                    del self._state[key]     # fully quiesced: forget it
            active_n = sum(1 for s in self._state.values() if s.active)
        # emission and metrics OUTSIDE the lock (journal I/O must never
        # extend the evaluator's critical section)
        for d in pending:
            if self._journal is not None:
                self._journal.emit_raw(d)
            if d["event"] == "fired":
                self._metrics.counter("alerts.fired").inc()
            else:
                self._metrics.counter("alerts.resolved").inc()
        self._metrics.gauge("alerts.active").set(active_n)
        if self._baselines is not None:
            self._baselines.update_from_telemetry(
                self._telemetry, geometry=self.geometry)
        return pending

    def _line(self, now: float, event: str, rule: AlertRule,
              b: Breach, count: int) -> Dict:
        d = {
            "kind": "alert",
            "schema": SCHEMA_VERSION,
            "ts": now,
            "event": event,
            "rule": rule.id,
            "severity": rule.severity,
            "subsystem": rule.subsystem,
            "condition": rule.condition,
            "dedup": b.dedup,
            "tenant": b.tenant,
            "value": round(float(b.value), 6),
            "threshold": round(float(b.threshold), 6),
            "breaches": count,
            "message": b.message,
        }
        if set(d) != ALERT_FIELDS:
            # must survive python -O: the CLIs key on these fields
            raise RuntimeError("alert line drifted from ALERT_FIELDS: "
                               f"{sorted(set(d) ^ ALERT_FIELDS)}")
        return d

    # -- live views (probe /alerts and /health) -----------------------
    def active(self) -> List[Dict]:
        """The currently-active alerts as alert-line dicts (ts = the
        call time; event is always "fired")."""
        now = self._clock()
        with self._lock:
            snap = [(key, st.last, st.breaches)
                    for key, st in sorted(self._state.items())
                    if st.active and st.last is not None]
        out = []
        for key, b, count in snap:
            rule = self._rules.get(key.split(":", 1)[0])
            if rule is not None:
                out.append(self._line(now, "fired", rule, b, count))
        return out

    def health(self) -> Dict:
        """Worst-active-severity verdict + per-subsystem breakdown."""
        active = self.active()
        subsystems: Dict[str, str] = {
            r.subsystem: "ok" for r in self._rules.values()}
        worst = "ok"
        score = 100
        for al in active:
            sev = al["severity"]
            score -= _HEALTH_PENALTY.get(sev, 0)
            sub = al["subsystem"]
            if _sev_rank(sev) > _sev_rank(subsystems.get(sub, "ok")):
                subsystems[sub] = sev
            if _sev_rank(sev) > _sev_rank(worst):
                worst = sev
        return {
            "status": worst,
            "score": max(0, score),
            "active": len(active),
            "subsystems": subsystems,
        }

    def stats(self) -> Dict:
        with self._lock:
            return {
                "rules": len(self._rules),
                "evals": self.evals,
                "eval_errors": self.eval_errors,
                "active": sum(1 for s in self._state.values()
                              if s.active),
            }


def _sev_rank(sev: str) -> int:
    return SEVERITIES.index(sev) + 1 if sev in SEVERITIES else 0


__all__ = ["ALERT_FIELDS", "ALERT_RULES", "SEVERITIES", "CONDITIONS",
           "AlertRule", "AlertEvaluator", "Breach", "EvalContext",
           "alert_rule", "register_rule"]
