"""The fault plane — named injection sites across the shuffle's layers.

The port's copy of ``sparkrdma_tpu.faults``: the same ten sites, the
same ``fault_spec`` grammar and errors, and the same deterministic
schedule, so a spec means the same faults in both packages. Where each
site fires in the port:

==========================  =================================================
site                        where it fires
==========================  =================================================
``exchange.dispatch``       ``ShuffleExchange.exchange``, before any work
``exchange.stream_round``   the streaming regime, top of each chunk
``pool.acquire``            ``SlotPool.get`` / ``get_shaped``
``spill.write``             ``host_staging.write_array`` / ``SpillWriter
                            .submit``
``spill.read``              ``host_staging.read_array``, before the CRC check
``checkpoint.read``         ``MapOutputStore`` records and shard reads
``serde.encode``            ``api/serde.py``: the native branches of
                            ``encode_bytes_rows`` and ``encode_cols``, once
                            per call (never on the numpy codec)
``serde.decode``            the native branches of ``decode_bytes_rows``
                            and ``decode_cols``, as ``serde.encode``
``rpc.send``                ``service/wire.py send_frame``, before a frame
                            is written (``corrupt`` after its CRC)
``rpc.recv``                ``service/wire.py recv_frame``, after a frame
                            is read, before its CRC check
==========================  =================================================

An injected failure at an ``rpc.*`` site is retried by the RPC client
(``service.rpc.retries``). An injected failure at a ``serde.*`` site is overcome by
running the native call again (the ``serde_native`` recovery, where the
reference falls back to numpy for the rest of the process); a second
one raises ``RuntimeError``.

``ShuffleConf.fault_spec`` is a ``;``-joined list of
``site:action[@predicate]`` rules::

    exchange.dispatch:fail@attempt<2;spill.read:corrupt@0.01;pool.acquire:delay=50ms@0.05

- **actions**: ``fail`` (the site raises its contract error:
  ``FetchFailedError`` at the exchange and pool sites, ``OSError`` at
  the storage sites), ``corrupt`` (flip a bit of the data, so that the
  CRC trailer catches it; storage and wire sites only), ``delay=<N>ms``
  (sleep, then go on);
- **predicates**: ``attempt<N`` fires on the site's first ``N`` hits; a
  rate in ``(0, 1]`` fires when splitmix64 of (seed, site, hit index)
  falls below it, the same hits in every run; none fires on every hit.

Injections are tallied on the plane; recoveries (a re-read after a CRC
mismatch, a re-write after a failed spill, a native codec call run
again) and degradations in this module's books. All three go to the
process-wide registry (``obs/metrics.py``) as ``faults.<site>``,
``recover.<name>`` and ``degrade.<name>`` counters. The port's two
degradation rungs are the planner's (``plan/executor.py``): a broadcast
join whose dim side has duplicate keys runs as the shuffle join
(``broadcast_join``), and a failed overlap prefetch encodes the source
again in the query's thread (``plan_overlap``). Both only change the
plan: the joins and the encodes still run on the card. So every hard
injection (``fail`` or ``corrupt``) is retried by the reader, recovered
in place or degraded: injections == retries + recoveries +
degradations. Each injection also records ``fault:injected``
(``site``, ``action``, ``hit``), each recovery ``fault:recovered``
(``path``) and each degradation ``fault:degraded`` (``path``,
``reason``) on the active timeline (``obs/timeline.py``); a journal
span's ``degraded`` lists the degradations taken so far.

A standalone ``ShuffleManager`` installs its plane process-wide, so
module-level sites (host staging, the checkpoint store) reach it without
a handle; a service session's plane is installed for the calling thread
only, for each SPI call (:func:`scoped_plane`), so one tenant's schedule
never fires in another tenant's thread. ``fire`` on the null plane is a
no-op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.obs.metrics import global_registry
from sparkrdma_tpu_torch.obs.timeline import record_active

#: every legal site name, as in the reference
SITES: Tuple[str, ...] = (
    "exchange.dispatch",
    "exchange.stream_round",
    "pool.acquire",
    "spill.write",
    "spill.read",
    "serde.encode",
    "serde.decode",
    "checkpoint.read",
    "rpc.send",
    "rpc.recv",
)

#: sites whose payload a ``corrupt`` action can mangle (``checkpoint
#: .read`` is not one: checkpoint files are read through ``spill.read``)
CORRUPTIBLE: Tuple[str, ...] = ("spill.write", "spill.read",
                                "rpc.send", "rpc.recv")

_DELAY_RE = re.compile(r"^delay=(\d+(?:\.\d+)?)ms$")
_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: the rate predicate and the backoff jitter
    are pure functions of their inputs."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & _MASK64


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One parsed ``site:action[@predicate]`` clause."""

    site: str
    action: str                 # "fail" | "corrupt" | "delay"
    delay_ms: float = 0.0       # for action == "delay"
    max_attempts: int = -1      # attempt<N predicate; -1 = not set
    rate: float = -1.0          # rate predicate; -1 = not set

    def matches(self, hit: int, seed: int) -> bool:
        """Does this rule fire on the site's ``hit``-th visit (0-based)?"""
        if self.max_attempts >= 0:
            return hit < self.max_attempts
        if self.rate >= 0:
            h = _mix64(seed ^ zlib.crc32(self.site.encode()) ^ hit)
            return (h / float(1 << 64)) < self.rate
        return True


def parse_fault_spec(spec: str) -> List[FaultRule]:
    """Parse a ``fault_spec`` into ordered rules; ``ValueError`` on an
    unknown site, a malformed action or predicate, or ``corrupt`` at a
    site that carries no data."""
    rules: List[FaultRule] = []
    spec = (spec or "").strip()
    if not spec:
        return rules
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        site, sep, rest = clause.partition(":")
        site = site.strip()
        if not sep:
            raise ValueError(f"fault_spec clause {clause!r}: expected "
                             "'site:action[@predicate]'")
        if site not in SITES:
            raise ValueError(
                f"fault_spec: unknown site {site!r} (known: "
                f"{', '.join(SITES)})")
        action_s, _, pred_s = rest.partition("@")
        action_s = action_s.strip()
        delay_ms = 0.0
        m = _DELAY_RE.match(action_s)
        if m:
            action = "delay"
            delay_ms = float(m.group(1))
        elif action_s in ("fail", "corrupt"):
            action = action_s
        else:
            raise ValueError(
                f"fault_spec clause {clause!r}: unknown action "
                f"{action_s!r} (use fail, corrupt, or delay=<N>ms)")
        if action == "corrupt" and site not in CORRUPTIBLE:
            raise ValueError(
                f"fault_spec: 'corrupt' is only meaningful at data-"
                f"carrying sites {CORRUPTIBLE}, not {site!r}")
        max_attempts, rate = -1, -1.0
        pred_s = pred_s.strip()
        if pred_s:
            am = re.match(r"^attempt<(\d+)$", pred_s)
            if am:
                max_attempts = int(am.group(1))
            else:
                try:
                    rate = float(pred_s)
                except ValueError:
                    raise ValueError(
                        f"fault_spec clause {clause!r}: bad predicate "
                        f"{pred_s!r} (use attempt<N or a rate in (0,1])"
                    ) from None
                if not 0.0 < rate <= 1.0:
                    raise ValueError(
                        f"fault_spec clause {clause!r}: rate must be in "
                        f"(0, 1], got {rate}")
        rules.append(FaultRule(site, action, delay_ms, max_attempts, rate))
    return rules


class FaultPlane:
    """A parsed schedule, per-site hit counters and injection tallies.

    ``check(site)`` advances the site's hit counter, takes the first
    rule that matches, sleeps for a ``delay`` itself (returning None)
    and returns ``"fail"`` or ``"corrupt"`` for the site to act on.
    Thread-safe; a plane without rules returns at once."""

    def __init__(self, spec: str = "", seed: int = 0xFA17):
        self.rules = parse_fault_spec(spec)
        self.spec = spec
        self.seed = seed
        self.enabled = bool(self.rules)
        self._by_site: Dict[str, List[FaultRule]] = {}
        for r in self.rules:
            self._by_site.setdefault(r.site, []).append(r)
        self._hits: Dict[str, int] = {}                # guarded-by: _lock
        self._injected: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock
        #: recoveries and degradations noted while this plane is scoped
        #: to a thread (a tenant's books)
        self._recov: Dict[str, int] = {}               # guarded-by: _lock
        self._degr: Dict[str, int] = {}                # guarded-by: _lock
        self._lock = threading.Lock()

    def check(self, site: str) -> Optional[str]:
        if not self.enabled:
            return None
        if site not in SITES:
            raise ValueError(f"unregistered fault site {site!r}")
        with self._lock:
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            fired: Optional[FaultRule] = None
            for r in self._by_site.get(site, ()):
                if r.matches(hit, self.seed):
                    fired = r
                    break
            if fired is not None:
                per = self._injected.setdefault(site, {})
                per[fired.action] = per.get(fired.action, 0) + 1
        if fired is None:
            return None
        global_registry().counter(f"faults.{site}").inc()
        record_active("fault:injected", site=site, action=fired.action,
                      hit=hit)
        if fired.action == "delay":
            time.sleep(fired.delay_ms / 1e3)
            return None
        return fired.action

    def injected_counts(self) -> Dict[str, Dict[str, int]]:
        """``{site: {action: n}}`` injections so far (a copy)."""
        with self._lock:
            return {s: dict(a) for s, a in self._injected.items()}

    def injected_total(self, actions: Tuple[str, ...] = ("fail", "corrupt")
                       ) -> int:
        """Injections of the given actions over all sites."""
        with self._lock:
            return sum(a.get(k, 0) for a in self._injected.values()
                       for k in actions)

    def sites_hit(self) -> List[str]:
        """Sites with at least one injection, sorted."""
        with self._lock:
            return sorted(s for s, a in self._injected.items()
                          if sum(a.values()) > 0)


#: a plane that never fires
NULL_PLANE = FaultPlane("")

_active: FaultPlane = NULL_PLANE
_active_lock = threading.Lock()
_tls = threading.local()


def set_active_plane(plane: Optional[FaultPlane]) -> FaultPlane:
    """Install the process-wide plane (None: the null plane); returns the
    one it replaced."""
    global _active
    with _active_lock:
        prev, _active = _active, (plane or NULL_PLANE)
    return prev


@contextlib.contextmanager
def scoped_plane(plane: Optional[FaultPlane]):
    """Install ``plane`` for the current thread only, until the block
    ends: ``fire`` consults it instead of the process-wide plane, and
    recoveries land in its books too. ``scoped_plane(None)`` changes
    nothing."""
    if plane is None:
        yield
        return
    prev = getattr(_tls, "plane", None)
    _tls.plane = plane
    try:
        yield
    finally:
        _tls.plane = prev


def active_plane() -> FaultPlane:
    p = getattr(_tls, "plane", None)
    return p if p is not None else _active


def fire(site: str) -> Optional[str]:
    """Consult the active plane at ``site``: None (go on, perhaps after an
    injected delay), ``"fail"`` (raise the site's contract error) or
    ``"corrupt"`` (mangle the payload)."""
    p = getattr(_tls, "plane", None)
    if p is None:
        p = _active
    if not p.enabled:
        return None
    return p.check(site)


def mangle(data: bytes) -> bytes:
    """Flip the lowest bit of the first byte: the injected corruption."""
    if not data:
        return data
    b = bytearray(data)
    b[0] ^= 0x01
    return bytes(b)


# --- degradation and recovery accounting (process-wide) ------------------

_acct_lock = threading.Lock()
_degradations: Dict[str, int] = {}   # guarded-by: _acct_lock
_recoveries: Dict[str, int] = {}     # guarded-by: _acct_lock


def note_degradation(name: str, reason: str = "") -> None:
    """Record one degradation (``broadcast_join``, ``plan_overlap``).
    Under a thread-scoped (tenant) plane it lands in that plane's books
    too, so a noisy tenant's degradations never show in a clean
    tenant's spans; the process-wide books always count it."""
    p = getattr(_tls, "plane", None)
    if p is not None:
        with p._lock:
            p._degr[name] = p._degr.get(name, 0) + 1
    with _acct_lock:
        _degradations[name] = _degradations.get(name, 0) + 1
    global_registry().counter(f"degrade.{name}").inc()
    record_active("fault:degraded", path=name, reason=reason[:120])


def note_recovery(name: str) -> None:
    """Record one failure overcome in place (a re-read after a CRC
    mismatch, a re-write after a failed spill)."""
    p = getattr(_tls, "plane", None)
    if p is not None:
        with p._lock:
            p._recov[name] = p._recov.get(name, 0) + 1
    with _acct_lock:
        _recoveries[name] = _recoveries.get(name, 0) + 1
    global_registry().counter(f"recover.{name}").inc()
    record_active("fault:recovered", path=name)


def active_degradations() -> List[str]:
    """Sorted names of the degradations taken so far, in the current
    scope: a thread-scoped plane's own, else the process-wide books."""
    p = getattr(_tls, "plane", None)
    if p is not None:
        with p._lock:
            return sorted(p._degr)
    with _acct_lock:
        return sorted(_degradations)


def degradation_total() -> int:
    p = getattr(_tls, "plane", None)
    if p is not None:
        with p._lock:
            return sum(p._degr.values())
    with _acct_lock:
        return sum(_degradations.values())


def recovery_total() -> int:
    p = getattr(_tls, "plane", None)
    if p is not None:
        with p._lock:
            return sum(p._recov.values())
    with _acct_lock:
        return sum(_recoveries.values())


def recovery_counts() -> Dict[str, int]:
    p = getattr(_tls, "plane", None)
    if p is not None:
        with p._lock:
            return dict(p._recov)
    with _acct_lock:
        return dict(_recoveries)


def reset_accounting() -> None:
    """Clear the degradation and recovery tallies (tests, smoke legs,
    soak passes)."""
    with _acct_lock:
        _degradations.clear()
        _recoveries.clear()


# --- retry backoff --------------------------------------------------------

def backoff_ms(attempt: int, base_ms: float, span_id: int = 0,
               cap_ms: float = 10_000.0) -> float:
    """Sleep before retry ``attempt`` (1-based): ``base * 2^(attempt-1)``,
    capped at ``cap_ms``, jittered into ``[0.5x, 1.0x)`` by splitmix64 of
    (span_id, attempt), so every host computes the same schedule."""
    if base_ms <= 0:
        return 0.0
    raw = min(base_ms * (2.0 ** max(attempt - 1, 0)), cap_ms)
    frac = _mix64((span_id << 8) ^ attempt) / float(1 << 64)
    return raw * (0.5 + 0.5 * frac)


__all__ = ["SITES", "CORRUPTIBLE", "FaultRule", "FaultPlane", "NULL_PLANE",
           "parse_fault_spec", "set_active_plane", "scoped_plane",
           "active_plane", "fire", "mangle", "note_degradation",
           "note_recovery", "active_degradations", "degradation_total",
           "recovery_total", "recovery_counts", "reset_accounting",
           "backoff_ms"]
