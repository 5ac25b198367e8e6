"""Fault injection, the reader's retry loop and checkpoint/resume of the
map stage, port vs reference.

A port of every case of ``tests/test_fault_recovery.py`` and of
``tests/test_chaos.py::test_chaos_smoke_accounting_identity``, each held
against the reference: the same input rows (made from a seed with
numpy) and the same ``fault_spec`` or hook give the same ``out`` and
``totals`` bits (tolerance 0), or the same error type and ``attempt``.
The retries are counted from the reader's warning log records
(``caplog``), which need no journal (``tests/test_torch_obs.py`` holds
the journal span's ``retry_count``). Then the port's own cases:
a ``torch.AcceleratorError`` or ``KernelLaunchError`` out of the
exchange is retried; a plain ``RuntimeError``, a ``ValueError`` and the
build's "nvcc not found" error propagate on the first attempt; a failed
streaming attempt gives every pooled buffer back.

The reference runs on the forced 8-device CPU mesh and is imported
inside fixtures.
"""

import logging

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf, faults
from sparkrdma_tpu_torch._build import KernelLaunchError
from sparkrdma_tpu_torch.api import shuffle_manager as sm
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.errors import (FetchFailedError,
                                                 UnrecoverableShuffleError)
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.meta.checkpoint import MapOutputStore

D = 8
LOGGER = "sparkrdma_tpu_torch.api"


@pytest.fixture(scope="module")
def ref():
    """The reference's names this module drives."""
    import types

    from sparkrdma_tpu import MeshRuntime as RefRuntime
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu import faults as ref_faults
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefMgr
    from sparkrdma_tpu.exchange import errors as ref_errors
    from sparkrdma_tpu.exchange.partitioners import modulo_partitioner as rm
    from sparkrdma_tpu.meta.checkpoint import MapOutputStore as RefStore

    return types.SimpleNamespace(
        Runtime=RefRuntime, Conf=RefConf, faults=ref_faults, Mgr=RefMgr,
        errors=ref_errors, modulo=rm, Store=RefStore)


def _rows(seed, n_per_dev=16, num_parts=D):
    """``tests/test_fault_recovery.py``'s ``_write`` rows."""
    rng = np.random.default_rng(seed)
    x = np.zeros((D * n_per_dev, 4), dtype=np.uint32)
    x[:, 1] = rng.integers(0, num_parts, size=D * n_per_dev)
    x[:, 2] = rng.integers(0, 2**32, size=D * n_per_dev, dtype=np.uint32)
    return x


def _skew_rows(seed):
    x = np.random.default_rng(seed).integers(1, 2**32, size=(D * 64, 4),
                                             dtype=np.uint32)
    x[:, 0] = 0                          # everything to partition 0
    return x


class Pair:
    """One scenario in both packages: ``conf`` kwargs, ``rows``, the
    shuffle id and the partitioner's key word."""

    def __init__(self, ref, kw, rows, sid, key_word=1):
        self.ref, self.kw, self.rows, self.sid = ref, kw, rows, sid
        self.key_word = key_word

    def ref_manager(self, **extra):
        conf = self.ref.Conf(**dict(self.kw, **extra))
        return self.ref.Mgr(self.ref.Runtime(conf), conf)

    def port_manager(self, **extra):
        conf = ShuffleConf(**dict(self.kw, **extra))
        return ShuffleManager(MeshRuntime(conf, D, device="cpu"))

    def ref_write(self, m, sid=None):
        h = m.register_shuffle(self.sid if sid is None else sid, D,
                               self.ref.modulo(D, key_word=self.key_word))
        plan = m.get_writer(h).write(m.runtime.shard_records(
            self.rows)).stop(True)
        return h, plan

    def port_write(self, m, sid=None):
        h = m.register_shuffle(self.sid if sid is None else sid, D,
                               modulo_partitioner(D, key_word=self.key_word))
        plan = m.get_writer(h).write(m.runtime.shard_records(
            self.rows)).stop(True)
        return h, plan


def _np(out, totals):
    if isinstance(out, torch.Tensor):
        return records_from_torch(out), totals.numpy()
    return np.asarray(out), np.asarray(totals)


def _same(a, b):
    a, b = _np(*a), _np(*b)
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _retries(caplog):
    return sum(1 for r in caplog.records
               if r.name == LOGGER and r.levelno == logging.WARNING
               and "fetch failed" in r.getMessage()
               and "retrying" in r.getMessage())


@pytest.fixture
def caplog_port(caplog):
    caplog.set_level(logging.WARNING, logger=LOGGER)
    return caplog


def _hooked(m, seq):
    fails = iter(seq)
    m._exchange.fault_hook = lambda: next(fails, False)


def test_transient_fault_retried(ref, caplog_port):
    """Two injected failures, then success: the data arrives intact and
    equal to the reference's."""
    p = Pair(ref, dict(slot_records=64, max_retry_attempts=5), _rows(0), 0)
    with p.ref_manager() as rm:
        h, _ = p.ref_write(rm)
        _hooked(rm, [True, True, False])
        want = rm.get_reader(h).read()
        want = _np(*want)
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        _hooked(pm, [True, True, False])
        got = pm.get_reader(h).read()
        assert int(got[1].sum()) == p.rows.shape[0]
        assert _same(got, want)
        assert pm.metrics.counter("exchange.faults").value == 2
    assert _retries(caplog_port) == 2


def test_persistent_fault_raises_after_max_attempts(ref, caplog_port):
    p = Pair(ref, dict(slot_records=64, max_retry_attempts=3), _rows(1), 1)
    with p.ref_manager() as rm:
        h, _ = p.ref_write(rm)
        rm._exchange.fault_hook = lambda: True
        with pytest.raises(ref.errors.FetchFailedError) as want:
            rm.get_reader(h).read()
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        pm._exchange.fault_hook = lambda: True
        with pytest.raises(FetchFailedError) as got:
            pm.get_reader(h).read()
    assert got.value.attempt == want.value.attempt == 3
    assert str(got.value) == str(want.value)
    assert _retries(caplog_port) == 2


def test_fault_rate_zero_never_fires(ref):
    p = Pair(ref, dict(slot_records=64, fault_injection_rate=0.0),
             _rows(2), 2)
    with p.ref_manager() as rm:
        h, _ = p.ref_write(rm)
        want = _np(*rm.get_reader(h).read())
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        got = pm.get_reader(h).read()
        assert _same(got, want)
        assert pm.metrics.counter("exchange.faults").value == 0


@pytest.mark.parametrize("rate", [0.3, 1.0])
def test_fault_rate_draws_like_the_reference(ref, caplog_port, rate):
    """The legacy rate injector draws from ``default_rng(0xFA17)`` as the
    reference's does: the same reads fail, with the same attempts."""
    p = Pair(ref, dict(slot_records=64, max_retry_attempts=4,
                       fault_injection_rate=rate), _rows(3), 3)

    def outcomes(m, h):
        res = []
        for _ in range(4):
            try:
                res.append(_np(*m.get_reader(h).read())[1].tolist())
            except Exception as e:          # noqa: BLE001 — compared below
                res.append((type(e).__name__, getattr(e, "attempt", None)))
        return res

    with p.ref_manager() as rm:
        h, _ = p.ref_write(rm)
        want = outcomes(rm, h)
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        assert outcomes(pm, h) == want


def test_checkpoint_resume_skips_map_stage(ref, tmp_path):
    """Write and checkpoint in one manager; a fresh manager re-registers
    and resumes, and its read equals the first and the reference's."""
    results = {}
    for side in ("ref", "port"):
        p = Pair(ref, dict(slot_records=64, spill_to_host=True,
                           spill_dir=str(tmp_path / side)), _rows(4), 3)
        make = p.ref_manager if side == "ref" else p.port_manager
        write = p.ref_write if side == "ref" else p.port_write
        m1 = make()
        h, _ = write(m1)
        first = _np(*m1.get_reader(h).read())
        # the process dies without unregistering
        m1._writers.clear()
        m1.runtime.stop()
        m2 = make()
        with pytest.raises(KeyError):       # no checkpoint under this id
            m2.resume_shuffle(m2.register_shuffle(99, D, h.partitioner))
        h2 = m2.register_shuffle(3, D, h.partitioner)
        m2.resume_shuffle(h2)
        again = _np(*m2.get_reader(h2).read())
        assert np.array_equal(again[0], first[0])
        assert np.array_equal(again[1], first[1])
        results[side] = again
        m2.stop()
    assert _same(results["port"], results["ref"])


def test_reader_autorecovers_from_checkpoint(ref, tmp_path):
    """Lost map output on the device: ``read`` restores it from the host
    checkpoint instead of failing."""
    outs = []
    for side in ("ref", "port"):
        p = Pair(ref, dict(slot_records=64, spill_to_host=True,
                           spill_dir=str(tmp_path / side)), _rows(5), 4)
        make = p.ref_manager if side == "ref" else p.port_manager
        with make() as m:
            h, _ = (p.ref_write if side == "ref" else p.port_write)(m)
            m._writers.clear()
            outs.append(_np(*m.get_reader(h).read()))
            assert int(outs[-1][1].sum()) == p.rows.shape[0]
    assert _same(*outs)


def test_no_checkpoint_no_map_output_raises(ref):
    p = Pair(ref, dict(slot_records=64), _rows(6), 5)
    with p.ref_manager() as rm:
        h = rm.register_shuffle(5, D, ref.modulo(D, key_word=1))
        with pytest.raises(RuntimeError, match="no published map output"):
            rm.get_reader(h).read()
    with p.port_manager() as pm:
        h = pm.register_shuffle(5, D, modulo_partitioner(D, key_word=1))
        with pytest.raises(RuntimeError, match="no published map output"):
            pm.get_reader(h).read()


def test_unregister_deletes_checkpoint(ref, tmp_path):
    p = Pair(ref, dict(slot_records=64, spill_to_host=True,
                       spill_dir=str(tmp_path / "ck")), _rows(7), 6)
    with p.port_manager() as pm:
        p.port_write(pm)
        assert pm.store.contains(6)
        assert pm._registry.get(6).total_records == p.rows.shape[0]
        pm.unregister_shuffle(6)
        assert not pm.store.contains(6)
        assert pm._registry.shuffle_ids() == ()
    with p.ref_manager(spill_dir=str(tmp_path / "ref")) as rm:
        p.ref_write(rm)
        assert rm.store.contains(6)
        rm.unregister_shuffle(6)
        assert not rm.store.contains(6)


def _failing_exchange(m, n_failures, make_error):
    """Wrap the live exchange: raise ``make_error()`` ``n_failures``
    times, then run the real exchange."""
    real = m._exchange.exchange
    state = {"left": n_failures, "calls": 0}

    def wrapped(*a, **kw):
        state["calls"] += 1
        if state["left"] > 0:
            state["left"] -= 1
            raise make_error()
        return real(*a, **kw)

    m._exchange.exchange = wrapped
    return state


DEVICE_ERRORS = {
    "accelerator": lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    "kernel_launch": lambda: KernelLaunchError("ring_exchange launch", 700),
}


class TestBackendFailureMapping:
    """A CUDA failure out of the exchange maps to ``FetchFailedError``
    and rides the retry loop, as the reference's ``JaxRuntimeError``
    does."""

    @staticmethod
    def _jax_error():
        import jax

        return jax.errors.JaxRuntimeError(
            "DATA_LOSS: simulated device read failure")

    @pytest.mark.parametrize("kind", sorted(DEVICE_ERRORS))
    def test_transient_backend_error_retried(self, ref, kind, caplog_port):
        p = Pair(ref, dict(slot_records=64, max_retry_attempts=5),
                 _rows(8), 7)
        with p.ref_manager() as rm:
            h, _ = p.ref_write(rm)
            want_state = _failing_exchange(rm, 2, self._jax_error)
            want = _np(*rm.get_reader(h).read())
        with p.port_manager() as pm:
            h, _ = p.port_write(pm)
            state = _failing_exchange(pm, 2, DEVICE_ERRORS[kind])
            got = pm.get_reader(h).read()
        assert state["calls"] == want_state["calls"] == 3
        assert _same(got, want)
        assert _retries(caplog_port) == 2

    @pytest.mark.parametrize("kind", sorted(DEVICE_ERRORS))
    def test_persistent_backend_error_gives_up(self, ref, kind):
        p = Pair(ref, dict(slot_records=64, max_retry_attempts=3),
                 _rows(9), 8)
        with p.ref_manager() as rm:
            h, _ = p.ref_write(rm)
            _failing_exchange(rm, 99, self._jax_error)
            with pytest.raises(ref.errors.FetchFailedError) as want:
                rm.get_reader(h).read()
        with p.port_manager() as pm:
            h, _ = p.port_write(pm)
            _failing_exchange(pm, 99, DEVICE_ERRORS[kind])
            with pytest.raises(FetchFailedError) as got:
                pm.get_reader(h).read()
        assert got.value.attempt == want.value.attempt == 3
        want_type = type(DEVICE_ERRORS[kind]())
        cause = got.value.__cause__
        while cause is not None and not isinstance(cause, want_type):
            cause = cause.__cause__
        assert cause is not None, f"{want_type.__name__} lost from chain"

    @pytest.mark.parametrize("kind", sorted(DEVICE_ERRORS))
    def test_backend_error_recovers_via_checkpoint(self, ref, tmp_path,
                                                   kind):
        """A device failure and lost map output at once: the retry
        restores the writer from the checkpoint and succeeds."""
        p = Pair(ref, dict(slot_records=64, max_retry_attempts=3,
                           spill_to_host=True), _rows(10), 9)
        with p.ref_manager(spill_dir=str(tmp_path / "ref")) as rm:
            h, _ = p.ref_write(rm)
            ref_first = _np(*rm.get_reader(h).read())
            want_state = _failing_exchange(rm, 1, self._jax_error)
            rm._writers.clear()
            want = _np(*rm.get_reader(h).read())
        with p.port_manager(spill_dir=str(tmp_path / "port")) as pm:
            h, _ = p.port_write(pm)
            first = _np(*pm.get_reader(h).read())
            state = _failing_exchange(pm, 1, DEVICE_ERRORS[kind])
            pm._writers.clear()
            got = pm.get_reader(h).read()
        assert state["calls"] == want_state["calls"] == 2
        assert _same(got, first) and _same(got, want)
        assert _same(first, ref_first)


def test_skew_split_shuffle_resumes_from_checkpoint(ref, tmp_path):
    """``split_factor`` round-trips through the checkpoint: a resumed
    skew-split read equals the live one and the reference's."""
    outs = {}
    for side in ("ref", "port"):
        p = Pair(ref, dict(slot_records=2, max_rounds=4, spill_to_host=True,
                           spill_dir=str(tmp_path / side)), _skew_rows(11),
                 20, key_word=0)
        make = p.ref_manager if side == "ref" else p.port_manager
        with make() as m:
            h, plan = (p.ref_write if side == "ref" else p.port_write)(m)
            assert plan.split_factor > 1
            live = _np(*m.get_reader(h).read())
            m._writers.clear()
            resumed = _np(*m.get_reader(h).read())
            assert m._writers[20].plan.split_factor == plan.split_factor
            assert _same(live, resumed)
            outs[side] = resumed
    assert _same(outs["port"], outs["ref"])


def test_sharded_checkpoint_roundtrip(ref, tmp_path):
    """A sharded (multi-host layout) save of the live map output, its
    completeness gate, and a resume through the manager's sharded
    path; the read equals the live one and the reference's."""
    p = Pair(ref, dict(slot_records=64, spill_to_host=True,
                       spill_dir=str(tmp_path / "sharded")), _rows(12), 30)
    with p.ref_manager(spill_dir=str(tmp_path / "ref")) as rm:
        h, _ = p.ref_write(rm)
        want = _np(*rm.get_reader(h).read())
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        writer = pm._writers[30]
        first = _np(*pm.get_reader(h).read())
        store = MapOutputStore(str(tmp_path / "sharded2"))
        recs = records_from_torch(writer.records)
        n = recs.shape[1] // D
        shards = [(c, recs[:, c * n:(c + 1) * n]) for c in range(D)]
        store.save_shards(30, shards, writer.plan, D, recs.shape, 0, 1)
        assert store.contains(30)
    m2 = p.port_manager(spill_dir=str(tmp_path / "sharded2"))
    try:
        h2 = m2.register_shuffle(30, D, h.partitioner)
        m2.resume_shuffle(h2)
        got = _np(*m2.get_reader(h2).read())
    finally:
        m2.stop()
    assert _same(got, first) and _same(got, want)


class TestFaultPlaneRecovery:
    """``fault_spec`` injection through the real call sites."""

    def test_transient_dispatch_fault_spec_retried(self, ref, caplog_port):
        kw = dict(slot_records=64, max_retry_attempts=5,
                  fault_spec="exchange.dispatch:fail@attempt<2")
        p = Pair(ref, kw, _rows(13), 40)
        with p.ref_manager() as rm:
            h, _ = p.ref_write(rm)
            want = _np(*rm.get_reader(h).read())
            want_counts = rm.faults.injected_counts()
        with p.port_manager() as pm:
            h, _ = p.port_write(pm)
            got = pm.get_reader(h).read()
            assert pm.faults.injected_counts() == want_counts == {
                "exchange.dispatch": {"fail": 2}}
            assert faults.active_plane() is pm.faults
        # stop() puts the earlier plane back
        assert not faults.active_plane().enabled
        assert _same(got, want)
        assert _retries(caplog_port) == 2

    @pytest.mark.parametrize("transport", [("xla", True),
                                           ("pallas_ring", True),
                                           ("pallas_ring", False)])
    def test_streaming_round_fault_retried(self, ref, caplog_port,
                                           transport):
        """A fault inside a streaming chunk rides the same retry loop; it
        firing at ``exchange.stream_round`` proves the regime streamed."""
        kw = dict(slot_records=2, max_rounds=16, max_rounds_in_flight=1,
                  max_retry_attempts=5,
                  fault_spec="exchange.stream_round:fail@attempt<1")
        p = Pair(ref, kw, _rows(14, n_per_dev=32), 41)
        with p.ref_manager() as rm:
            h, _ = p.ref_write(rm)
            want = _np(*rm.get_reader(h).read())
        with p.port_manager(transport=transport[0],
                            ring_fused=transport[1]) as pm:
            h, _ = p.port_write(pm)
            got = pm.get_reader(h).read()
            assert pm.faults.injected_counts() == {
                "exchange.stream_round": {"fail": 1}}
            assert pm._exchange.last_dispatches > 1
        assert _same(got, want)
        assert _retries(caplog_port) == 1

    def test_skew_split_ranged_read_fault_retried(self, ref):
        """A fault during a ranged read of a skew-split shuffle: the
        retry gives the partition bytes the clean read gives."""
        kw = dict(slot_records=2, max_rounds=4, max_retry_attempts=5,
                  fault_spec="exchange.dispatch:fail@attempt<1")
        p = Pair(ref, kw, _skew_rows(15), 42, key_word=0)
        with p.ref_manager() as rm:
            h, _ = p.ref_write(rm)
            want = rm.get_reader(h).read_partition(0)
        with p.port_manager() as pm:
            h, plan = p.port_write(pm)
            assert plan.split_factor > 1
            faulted = pm.get_reader(h).read_partition(0)
            assert pm.faults.injected_counts() == {
                "exchange.dispatch": {"fail": 1}}
            clean = pm.get_reader(h).read_partition(0)
        assert np.array_equal(faulted, clean)
        assert faulted.shape[0] == p.rows.shape[0]
        assert np.array_equal(faulted, np.asarray(want))

    def test_pool_acquire_fault_retried(self, ref, caplog_port):
        kw = dict(slot_records=2, max_rounds=16, max_rounds_in_flight=1,
                  max_retry_attempts=5,
                  fault_spec="pool.acquire:fail@attempt<1")
        p = Pair(ref, kw, _rows(16, n_per_dev=32), 43)
        with p.ref_manager() as rm:
            h, _ = p.ref_write(rm)
            want = _np(*rm.get_reader(h).read())
            want_counts = rm.faults.injected_counts()
        with p.port_manager() as pm:
            h, _ = p.port_write(pm)
            before = pm.runtime.pool.stats()["outstanding"]
            got = pm.get_reader(h).read()
            assert pm.faults.injected_counts() == want_counts
            assert pm.runtime.pool.stats()["outstanding"] == before
        assert _same(got, want)
        assert _retries(caplog_port) == 1


class TestBackoffDeadline:
    def test_backoff_follows_the_reference_schedule(self, ref, monkeypatch,
                                                    caplog_port):
        """Each retry sleeps ``faults.backoff_ms(k, base)`` (the journal
        is off, so the read's span id is 0): the reference's schedule,
        to the last bit, within its per-attempt bounds."""
        slept = []
        real_sleep = sm.time.sleep
        monkeypatch.setattr(sm.time, "sleep",
                            lambda s: (slept.append(s * 1e3),
                                       real_sleep(s)))
        kw = dict(slot_records=64, max_retry_attempts=5,
                  retry_backoff_ms=1.0,
                  fault_spec="exchange.dispatch:fail@attempt<2")
        p = Pair(ref, kw, _rows(17), 43)
        with p.port_manager() as pm:
            h, _ = p.port_write(pm)
            pm.get_reader(h).read()
        assert slept == [ref.faults.backoff_ms(k, 1.0, 0) for k in (1, 2)]
        assert 0.5 <= slept[0] <= 1.0 and 1.0 <= slept[1] <= 2.0
        assert _retries(caplog_port) == 2

    def test_no_backoff_when_disabled(self, ref, monkeypatch):
        slept = []
        monkeypatch.setattr(sm.time, "sleep", slept.append)
        kw = dict(slot_records=64, max_retry_attempts=5,
                  fault_spec="exchange.dispatch:fail@attempt<1")
        p = Pair(ref, kw, _rows(18), 44)
        with p.ref_manager() as rm:
            h, _ = p.ref_write(rm)
            want = _np(*rm.get_reader(h).read())
        with p.port_manager() as pm:
            h, _ = p.port_write(pm)
            got = pm.get_reader(h).read()
        assert _same(got, want) and slept == []

    def test_retry_deadline_terminal(self, ref):
        """A persistent fault costs bounded wall-clock: the deadline makes
        the loop terminal well before ``max_retry_attempts``."""
        kw = dict(slot_records=64, max_retry_attempts=100,
                  retry_backoff_ms=20.0, retry_deadline_s=0.05,
                  fault_spec="exchange.dispatch:fail")
        p = Pair(ref, kw, _rows(19), 45)
        with p.ref_manager() as rm:
            h, _ = p.ref_write(rm)
            with pytest.raises(ref.errors.FetchFailedError,
                               match="retry deadline") as want:
                rm.get_reader(h).read()
        with p.port_manager() as pm:
            h, _ = p.port_write(pm)
            with pytest.raises(FetchFailedError,
                               match="retry deadline") as got:
                pm.get_reader(h).read()
        assert 1 < got.value.attempt < 100
        assert 1 < want.value.attempt < 100

    def test_persistent_dispatch_fault_reaches_max_attempts(self, ref):
        kw = dict(slot_records=64, max_retry_attempts=4,
                  fault_spec="exchange.dispatch:fail")
        p = Pair(ref, kw, _rows(20), 46)
        with p.ref_manager() as rm:
            h, _ = p.ref_write(rm)
            with pytest.raises(ref.errors.FetchFailedError) as want:
                rm.get_reader(h).read()
        with p.port_manager() as pm:
            h, _ = p.port_write(pm)
            with pytest.raises(FetchFailedError) as got:
                pm.get_reader(h).read()
        assert got.value.attempt == want.value.attempt == 4
        assert str(got.value) == str(want.value)


class TestChecksumCorruption:
    """Corruption is detected and ends in a recovery or in one clean
    ``UnrecoverableShuffleError``: never wrong data, never a loop."""

    def test_injected_spill_corruption_autorecovers(self, ref, tmp_path):
        """A one-shot corrupt read: the bounded re-read recovers and books
        one ``checkpoint_reread``, in both packages."""
        books = {}
        outs = {}
        for side, fmod in (("ref", ref.faults), ("port", faults)):
            fmod.reset_accounting()
            p = Pair(ref, dict(slot_records=64, spill_to_host=True,
                               spill_dir=str(tmp_path / side),
                               fault_spec="spill.read:corrupt@attempt<1"),
                     _rows(21), 50)
            make = p.ref_manager if side == "ref" else p.port_manager
            with make() as m:
                h, _ = (p.ref_write if side == "ref" else p.port_write)(m)
                m._writers.clear()
                outs[side] = _np(*m.get_reader(h).read())
                assert int(outs[side][1].sum()) == p.rows.shape[0]
                assert m.faults.injected_counts() == {
                    "spill.read": {"corrupt": 1}}
            books[side] = fmod.recovery_counts()
            fmod.reset_accounting()
        assert books["port"] == books["ref"] == {"checkpoint_reread": 1}
        assert _same(outs["port"], outs["ref"])

    def test_corrupt_spill_blob_is_unrecoverable(self, ref, tmp_path,
                                                 caplog_port):
        """A real flipped byte in the records: the CRC catches it on every
        re-read and the read raises one ``UnrecoverableShuffleError``,
        on its first attempt, with no retry."""
        for side in ("ref", "port"):
            root = tmp_path / side
            p = Pair(ref, dict(slot_records=64, spill_to_host=True,
                               spill_dir=str(root)), _rows(22), 51)
            make = p.ref_manager if side == "ref" else p.port_manager
            err = (ref.errors.UnrecoverableShuffleError if side == "ref"
                   else UnrecoverableShuffleError)
            with make() as m:
                h, _ = (p.ref_write if side == "ref" else p.port_write)(m)
                blob = root / "shuffle_51" / "records.u32"
                raw = bytearray(blob.read_bytes())
                raw[16] ^= 0xFF
                blob.write_bytes(bytes(raw))
                m._writers.clear()
                calls = _failing_exchange(m, 0, None)
                with pytest.raises(err, match="checkpoint unreadable"):
                    m.get_reader(h).read()
                assert calls["calls"] == 0
        assert _retries(caplog_port) == 0

    def test_corrupt_checkpoint_shard_detected(self, ref, tmp_path):
        for side in ("ref", "port"):
            store = (ref.Store(str(tmp_path / side), use_native=False)
                     if side == "ref"
                     else MapOutputStore(str(tmp_path / side)))
            from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan

            plan = ShufflePlan(counts=np.ones((8, 8), np.int64),
                               num_rounds=1, out_capacity=8, capacity=8)
            shard = np.random.default_rng(23).integers(
                0, 2**32, size=(4, 8), dtype=np.uint32)
            store.save_shards(52, [(0, shard)], plan, 8, (4, 64), 0, 1)
            f = tmp_path / side / "shuffle_52" / "shard_0.u32"
            raw = bytearray(f.read_bytes())
            raw[8] ^= 0x01
            f.write_bytes(bytes(raw))
            with pytest.raises(OSError, match="CRC32"):
                store.read_shard(52, 0, (4, 8))

    @pytest.mark.parametrize("spec,book", [
        ("checkpoint.read:fail@attempt<1", "checkpoint_reread"),
        ("spill.write:fail@attempt<1", "spill_rewrite")])
    def test_storage_site_recoveries_match(self, ref, tmp_path, spec, book):
        books = {}
        outs = {}
        for side, fmod in (("ref", ref.faults), ("port", faults)):
            fmod.reset_accounting()
            p = Pair(ref, dict(slot_records=64, spill_to_host=True,
                               spill_dir=str(tmp_path / side),
                               fault_spec=spec), _rows(24), 53)
            make = p.ref_manager if side == "ref" else p.port_manager
            with make() as m:
                h, _ = (p.ref_write if side == "ref" else p.port_write)(m)
                m._writers.clear()
                outs[side] = _np(*m.get_reader(h).read())
                hard = m.faults.injected_total()
            books[side] = (fmod.recovery_counts(), hard)
            fmod.reset_accounting()
        assert books["port"] == books["ref"] == ({book: 1}, 1)
        assert _same(outs["port"], outs["ref"])


def test_sharded_checkpoint_incomplete_not_resumable(ref, tmp_path):
    """A torn sharded save (a process marker missing) reads as absent
    in both packages."""
    from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan

    plan = ShufflePlan(counts=np.ones((8, 8), np.int64), num_rounds=1,
                       out_capacity=8, capacity=8)
    for store in (MapOutputStore(str(tmp_path / "port")),
                  ref.Store(str(tmp_path / "ref"), use_native=False)):
        store.save_shards(31, [(0, np.zeros((4, 8), np.uint32))], plan, 8,
                          (4, 64), 0, 2)
        assert not store.contains(31)
        with pytest.raises(KeyError, match="incomplete"):
            store.load_meta(31)


def test_chaos_smoke_accounting_identity(ref, caplog_port):
    """A multi-site schedule through one real shuffle: every hard
    injection is a retry (injections == retries + recoveries +
    degradations, the last two 0 here)."""
    spec = ("exchange.dispatch:fail@attempt<2;"
            "pool.acquire:delay=1ms@attempt<2")
    kw = dict(slot_records=64, max_retry_attempts=6, retry_backoff_ms=0.1,
              fault_spec=spec)
    rows = np.zeros((8 * 16, 4), dtype=np.uint32)
    rows[:, 1] = np.random.default_rng(25).integers(0, 8, size=8 * 16)
    p = Pair(ref, kw, rows, 61)
    with p.ref_manager() as rm:
        h, _ = p.ref_write(rm)
        want = _np(*rm.get_reader(h).read())
        want_hard = rm.faults.injected_total(("fail", "corrupt"))
        want_sites = rm.faults.sites_hit()
    faults.reset_accounting()
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        got = pm.get_reader(h).read()
        assert int(got[1].sum()) == rows.shape[0]
        hard = pm.faults.injected_total(("fail", "corrupt"))
        assert hard == want_hard == 2
        assert pm.faults.sites_hit() == want_sites == [
            "exchange.dispatch", "pool.acquire"]
    assert hard == _retries(caplog_port) + faults.recovery_total() \
        + faults.degradation_total()
    assert _same(got, want)
    faults.reset_accounting()


# --- the port's own cases -------------------------------------------------

@pytest.mark.parametrize("make_error,match", [
    (lambda: RuntimeError("shape mismatch in the tail"), "shape mismatch"),
    (lambda: ValueError("keep_words must start with all key words"),
     "keep_words"),
    (lambda: RuntimeError("nvcc not found: the CUDA kernels cannot be "
                          "built (CUDA toolkit missing)"), "nvcc not found"),
])
def test_other_errors_are_not_retried(make_error, match, caplog_port):
    """A build error, a programming error or any other exception
    propagates on the first attempt: a retry would hide it."""
    p = Pair(None, dict(slot_records=64, max_retry_attempts=5), _rows(26), 70)
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        state = _failing_exchange(pm, 99, make_error)
        with pytest.raises(type(make_error()), match=match) as got:
            pm.get_reader(h).read()
        assert state["calls"] == 1
        assert not isinstance(got.value, FetchFailedError)
    assert _retries(caplog_port) == 0


def test_build_error_is_not_retried(tmp_path, monkeypatch, caplog_port):
    """The build's own "nvcc not found" error, raised where a kernel's
    library is built at its first launch, is not retried."""
    from sparkrdma_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "Path", lambda _: tmp_path / "no-nvcc")
    p = Pair(None, dict(slot_records=64, max_retry_attempts=5), _rows(27), 71)
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        calls = []
        pm._exchange.exchange = lambda *a, **kw: (
            calls.append(1), _build.library("ring_exchange"))
        with pytest.raises(RuntimeError, match="nvcc not found") as got:
            pm.get_reader(h).read()
        assert not isinstance(got.value, (FetchFailedError,
                                          KernelLaunchError))
    assert calls == [1]
    assert _retries(caplog_port) == 0


def test_kernel_launch_error_is_a_check_failure():
    from sparkrdma_tpu_torch import _build

    _build.check(0, "noop")
    with pytest.raises(KernelLaunchError, match="cudaError_t 9") as e:
        _build.check(9, "ring_exchange launch")
    assert e.value.err == 9 and isinstance(e.value, RuntimeError)


@pytest.mark.parametrize("site,hit", [
    ("exchange.stream_round", 0),
    ("exchange.stream_round", 3),   # past queue_depth: chunks queued
    ("pool.acquire", 0),        # the accumulator's
    ("pool.acquire", 3),        # chunk 1's send buffer
    ("pool.acquire", 4)])       # chunk 1's receive buffer, send held
def test_failed_streaming_attempt_returns_its_buffers(site, hit, monkeypatch,
                                                      caplog_port):
    """A failure at the ``hit``-th visit of ``site`` in a streaming read
    abandons the exchange: the accumulator and the chunk's buffers go
    back, so the pool's ``outstanding`` reads as before the attempt; the
    retry gives the bits of a read without faults."""
    kw = dict(slot_records=2, max_rounds=16, max_rounds_in_flight=1,
              queue_depth=2, max_retry_attempts=3)
    p = Pair(None, kw, _rows(28, n_per_dev=32), 72)
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        clean = _np(*pm.get_reader(h).read())
        chunks = (pm._exchange.last_dispatches - 2) // 2
        assert chunks > 3
    with p.port_manager() as pm:
        h, _ = p.port_write(pm)
        pool = pm.runtime.pool
        before = pool.stats()["outstanding"]
        hits = iter(range(10**6))
        real = faults.fire

        def fire(s):
            if s == site and next(hits) == hit:
                return "fail"
            return real(s)

        monkeypatch.setattr(faults, "fire", fire)
        got = _np(*pm.get_reader(h).read())
        monkeypatch.setattr(faults, "fire", real)
        assert pool.stats()["outstanding"] == before
        assert pm.metrics.counter("exchange.faults").value == \
            (site == "exchange.stream_round")
    assert np.array_equal(got[0], clean[0])
    assert np.array_equal(got[1], clean[1])
    assert _retries(caplog_port) == 1
