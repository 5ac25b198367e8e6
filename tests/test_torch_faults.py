"""The fault plane, port vs reference.

``sparkrdma_tpu_torch.faults`` must mean what ``sparkrdma_tpu.faults``
means: every spec that ``tests/test_chaos.py::TestFaultSpecParsing``
parses gives equal rules in both packages, every spec it rejects is
rejected by both with the same message, the ``attempt<N`` and rate
predicates fire on the same hits over thousands of (seed, site, hit)
triples, a plane's hit sequence and tallies are the same, ``backoff_ms``
agrees to the last bit, ``mangle`` returns the same bytes, and the null
plane does nothing. Every comparison is exact (tolerance 0). The
reference is imported inside fixtures (it imports no JAX here).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

from sparkrdma_tpu_torch import ShuffleConf, faults
from sparkrdma_tpu_torch.obs.metrics import global_registry

GRAMMAR = ("exchange.dispatch:fail@attempt<2;spill.read:corrupt@0.01;"
           "pool.acquire:delay=50ms@0.05;serde.encode:fail")
SPECS = [
    GRAMMAR,
    "",
    "  ;  ",
    "exchange.stream_round:fail@0.25",
    "spill.write:corrupt@attempt<1; checkpoint.read:fail",
    "rpc.send:corrupt@attempt<2;rpc.recv:fail@attempt<2",
    "pool.acquire:delay=1.5ms@attempt<3;serde.decode:fail@1",
    "exchange.dispatch:fail@attempt<0",
]
BAD = [
    "nonsite:fail",                      # unregistered site
    "exchange.dispatch:explode",         # unknown action
    "exchange.dispatch:fail@attempt<",   # malformed predicate
    "spill.write:corrupt@1.5",           # rate out of range
    "serde.encode:corrupt",              # not a corruptible site
    "pool.acquire:delay=xms",            # malformed delay
    "exchange.dispatch",                 # no action
    "spill.read:corrupt@0",              # rate 0 is out of (0, 1]
]
SEEDS = [0, 1, 0xFA17, 2**32 + 5, 2**63 - 1]


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu import faults as ref_faults

    return ref_faults


def _tuples(rules):
    return [dataclasses.astuple(r) for r in rules]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_gives_equal_rules(ref, spec):
    got = faults.parse_fault_spec(spec)
    assert _tuples(got) == _tuples(ref.parse_fault_spec(spec))
    assert faults.SITES == ref.SITES
    assert faults.CORRUPTIBLE == ref.CORRUPTIBLE


def test_parse_full_grammar():
    rules = faults.parse_fault_spec(GRAMMAR)
    assert [r.site for r in rules] == [
        "exchange.dispatch", "spill.read", "pool.acquire", "serde.encode"]
    assert rules[0].max_attempts == 2
    assert rules[1].rate == pytest.approx(0.01)
    assert rules[2].delay_ms == pytest.approx(50.0)
    assert rules[3].rate < 0 and rules[3].max_attempts < 0


@pytest.mark.parametrize("bad", BAD)
def test_parse_rejects_like_the_reference(ref, bad):
    with pytest.raises(ValueError) as ours:
        faults.parse_fault_spec(bad)
    with pytest.raises(ValueError) as theirs:
        ref.parse_fault_spec(bad)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("bad", BAD[:3])
def test_conf_validates_eagerly(bad):
    with pytest.raises(ValueError):
        ShuffleConf(fault_spec=bad)
    assert ShuffleConf(fault_spec=GRAMMAR).fault_rules()[0].max_attempts == 2


@pytest.mark.parametrize("kw", [dict(max_retry_attempts=0),
                                dict(fault_injection_rate=1.5),
                                dict(retry_backoff_ms=-1.0),
                                dict(retry_deadline_s=-0.1)])
def test_conf_refuses_bad_retry_knobs(ref, kw):
    """The reference's validation of the retry knobs."""
    from sparkrdma_tpu import ShuffleConf as RefConf

    with pytest.raises(ValueError):
        ShuffleConf(**kw)
    with pytest.raises(ValueError):
        RefConf(**kw)


def test_conf_defaults_match(ref):
    from sparkrdma_tpu import ShuffleConf as RefConf

    names = ("max_retry_attempts", "fault_injection_rate", "fault_spec",
             "retry_backoff_ms", "retry_deadline_s", "spill_to_host")
    assert {n: getattr(ShuffleConf(), n) for n in names} == \
        {n: getattr(RefConf(), n) for n in names}


@pytest.mark.parametrize("rate", [0.001, 0.05, 0.3, 0.5, 0.97, 1.0])
def test_rate_predicate_fires_on_the_same_hits(ref, rate):
    """5 seeds × 10 sites × 200 hits = 10,000 triples per rate."""
    for site in faults.SITES:
        ours = faults.FaultRule(site, "fail", rate=rate)
        theirs = ref.FaultRule(site, "fail", rate=rate)
        for seed in SEEDS:
            got = [ours.matches(h, seed) for h in range(200)]
            assert got == [theirs.matches(h, seed) for h in range(200)]


@pytest.mark.parametrize("n", [0, 1, 3, 50])
def test_attempt_predicate_fires_first_n(ref, n):
    for site in faults.SITES:
        ours = faults.FaultRule(site, "fail", max_attempts=n)
        theirs = ref.FaultRule(site, "fail", max_attempts=n)
        for seed in SEEDS[:2]:
            got = [ours.matches(h, seed) for h in range(100)]
            assert got == [theirs.matches(h, seed) for h in range(100)]
            assert got == [h < n for h in range(100)]


@pytest.mark.parametrize("spec", [
    "exchange.dispatch:fail@attempt<2;exchange.dispatch:fail@0.3",
    "spill.read:corrupt@0.2;spill.write:fail@attempt<3;checkpoint.read:fail"
    "@0.5",
    "serde.decode:fail@0.3",
    "pool.acquire:delay=0ms@0.4;exchange.stream_round:fail@0.1"])
def test_plane_schedule_and_tallies_match(ref, spec):
    ours, theirs = faults.FaultPlane(spec), ref.FaultPlane(spec)
    sites = sorted({r.site for r in ours.rules}) + ["exchange.dispatch"]
    for i in range(300):
        site = sites[i % len(sites)]
        assert ours.check(site) == theirs.check(site), (i, site)
    assert ours.injected_counts() == theirs.injected_counts()
    assert ours.injected_total() == theirs.injected_total()
    assert ours.sites_hit() == theirs.sites_hit()


def test_attempt_plane_fires_first_n():
    p = faults.FaultPlane("serde.encode:fail@attempt<2")
    assert [p.check("serde.encode") for _ in range(4)] == [
        "fail", "fail", None, None]
    assert p.injected_counts() == {"serde.encode": {"fail": 2}}
    assert p.sites_hit() == ["serde.encode"]
    with pytest.raises(ValueError, match="unregistered"):
        p.check("nonsite")


def test_injection_counts_in_the_global_registry():
    c = global_registry().counter("faults.checkpoint.read")
    before = c.value
    p = faults.FaultPlane("checkpoint.read:fail@attempt<3")
    for _ in range(5):
        p.check("checkpoint.read")
    assert c.value - before == 3


def test_delay_action_sleeps_and_proceeds():
    p = faults.FaultPlane("pool.acquire:delay=20ms@attempt<1")
    t0 = time.perf_counter()
    assert p.check("pool.acquire") is None
    assert time.perf_counter() - t0 >= 0.019
    assert p.injected_counts() == {"pool.acquire": {"delay": 1}}
    assert p.injected_total() == 0          # a delay is not a hard fault


@pytest.mark.parametrize("base", [0.0, 0.1, 1.0, 4.0, 20.0, 5000.0])
def test_backoff_ms_agrees_to_the_last_bit(ref, base):
    for attempt in range(0, 40):
        for span_id in (0, 1, 99, 2**40 + 3):
            assert faults.backoff_ms(attempt, base, span_id) == \
                ref.backoff_ms(attempt, base, span_id)
        assert faults.backoff_ms(attempt, base, 7, cap_ms=50.0) == \
            ref.backoff_ms(attempt, base, 7, cap_ms=50.0)


def test_backoff_ms_deterministic_and_bounded():
    for attempt in (1, 2, 3, 7):
        a = faults.backoff_ms(attempt, 4.0, span_id=99)
        assert a == faults.backoff_ms(attempt, 4.0, span_id=99)
        lo = 4.0 * 2 ** (attempt - 1) * 0.5
        hi = 4.0 * 2 ** (attempt - 1)
        assert lo <= a <= min(hi, 10_000.0)
    assert faults.backoff_ms(5, 0.0) == 0.0
    assert faults.backoff_ms(30, 1.0) <= 10_000.0


@pytest.mark.parametrize("data", [b"", b"\x00", bytes(range(16)),
                                  b"\xff" * 9])
def test_mangle_returns_the_same_bytes(ref, data):
    bad = faults.mangle(data)
    assert bad == ref.mangle(data)
    if data:
        assert bad[0] == data[0] ^ 0x01 and bad[1:] == data[1:]


def test_null_plane_is_inert():
    prev = faults.set_active_plane(None)
    try:
        assert faults.fire("exchange.dispatch") is None
        assert faults.active_plane() is faults.NULL_PLANE
        assert not faults.active_plane().enabled
        assert faults.NULL_PLANE.injected_counts() == {}
    finally:
        faults.set_active_plane(prev)


def test_active_plane_fires_and_is_restored():
    plane = faults.FaultPlane("spill.read:fail@attempt<1")
    prev = faults.set_active_plane(plane)
    try:
        assert faults.fire("spill.read") == "fail"
        assert faults.fire("spill.read") is None
    finally:
        assert faults.set_active_plane(prev) is plane


def test_scoped_plane_is_per_thread_and_keeps_its_books():
    faults.reset_accounting()
    plane = faults.FaultPlane("spill.write:fail")
    seen = {}

    def other():
        seen["other"] = faults.fire("spill.write")

    with faults.scoped_plane(plane):
        assert faults.fire("spill.write") == "fail"
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        faults.note_recovery("spill_rewrite")
        assert faults.recovery_counts() == {"spill_rewrite": 1}
    assert seen["other"] is None        # another thread: the null plane
    assert faults.recovery_counts() == {"spill_rewrite": 1}
    assert faults.recovery_total() == 1
    with faults.scoped_plane(None):
        assert faults.active_plane() is faults.NULL_PLANE
    faults.reset_accounting()
    assert faults.recovery_total() == 0


def test_note_recovery_counts_in_the_global_registry():
    c = global_registry().counter("recover.checkpoint_reread")
    before = c.value
    faults.note_recovery("checkpoint_reread")
    assert c.value - before == 1
    faults.reset_accounting()


def test_no_degradation_books(ref):
    """The degradation books start empty and are emptied by
    ``reset_accounting``, as the reference's; between, each
    ``note_degradation`` counts once in them, in the process-wide
    ``degrade.<name>`` counter and, under a thread-scoped plane, in that
    plane's own books only for that thread."""
    faults.reset_accounting()
    ref.reset_accounting()
    assert faults.active_degradations() == ref.active_degradations() == []
    assert faults.degradation_total() == ref.degradation_total() == 0
    c = global_registry().counter("degrade.broadcast_join")
    before = c.value
    faults.note_degradation("broadcast_join", reason="dup keys")
    faults.note_degradation("broadcast_join")
    assert c.value - before == 2
    plane = faults.FaultPlane("spill.write:fail@attempt<1")
    seen = {}
    with faults.scoped_plane(plane):
        assert faults.active_degradations() == []
        faults.note_degradation("plan_overlap")
        t = threading.Thread(target=lambda: seen.update(
            other=faults.active_degradations()))
        t.start()
        t.join(10)
        assert faults.active_degradations() == ["plan_overlap"]
        assert faults.degradation_total() == 1
    assert seen["other"] == ["broadcast_join", "plan_overlap"]
    assert faults.active_degradations() == ["broadcast_join",
                                            "plan_overlap"]
    assert faults.degradation_total() == 3
    faults.reset_accounting()
    assert faults.active_degradations() == []
    assert faults.degradation_total() == 0


def test_splitmix_matches_reference_on_random_inputs(ref):
    xs = np.random.default_rng(4).integers(0, 2**63, size=2000,
                                           dtype=np.int64).tolist()
    assert [faults._mix64(x) for x in xs] == [ref._mix64(x) for x in xs]
