"""The chaos and oversubscription soaks: the port's scripts against the
reference's, pass for pass, on the CPU.

``scripts/torch_chaos_soak.py`` and ``scripts/torch_oversub_soak.py``
are the port's counterparts of ``scripts/chaos_soak.py`` and
``scripts/oversub_soak.py``. Each fast test runs one pass of both on the
same seed — the reference's function on the forced 8-device CPU mesh,
the port's on 8 partitions stacked on torch's CPU — and holds their
outputs equal (tolerance 0):

- the fault schedule ``build_spec`` makes from a seed;
- ``run_legs`` without faults and under the schedule: every leg's
  output bytes (TeraSort's as its globally sorted stream: the packages'
  samplers pick other splitters), the sites hit, the injections, the
  journal's retries and the books (the port books an injected
  ``serde.encode`` failure as a ``serde_native`` recovery where the
  reference degrades: ROADMAP C.1.13), on the port's ``"xla"`` and
  ``"pallas_ring"`` transports;
- the planner, combine and alert passes' verdicts and evidence;
- the oversubscription soak's verdict and geometry.

The ``slow`` tests run both port scripts whole, as subprocesses (the
RPC pass's workers are subprocesses of the soak). The scripts and the
reference are loaded inside fixtures and tests, so importing this module
costs nothing.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
RPD = 256          # --records-per-device of the in-process passes


def _load(name):
    """A script under ``scripts/`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_soak_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def soaks():
    return {"ref": _load("chaos_soak"), "port": _load("torch_chaos_soak")}


class _Args:
    """The soak's parsed flags, as its passes read them."""

    def __init__(self, **kw):
        self.seed = SEED
        self.records_per_device = RPD
        self.partitions = 8
        self.device = "cpu"
        self.transport = "xla"
        self.__dict__.update(kw)


def _common(**kw):
    """The soak's conf (``chaos_soak.py:949-957``)."""
    return dict(slot_records=256, max_rounds=64, max_rounds_in_flight=1,
                val_words=7, spill_to_host=True, max_retry_attempts=8,
                retry_backoff_ms=1.0, retry_deadline_s=60.0, **kw)


def _include_serde():
    from sparkrdma_tpu.api import serde as ref_serde

    from sparkrdma_tpu_torch.api import serde

    return ref_serde.native_codec_available() and \
        serde.native_codec_available()


def _ref_manager(conf):
    from sparkrdma_tpu import MeshRuntime
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager

    return ShuffleManager(MeshRuntime(conf), conf)


def _core(soak, conf_cls, faults, make_manager, tmp, spec, common):
    """The soak's control and chaos passes (``main`` up to its books):
    each leg's output, and the chaos pass's books."""
    conf_c = conf_cls(spill_dir=os.path.join(tmp, "ctl"), **common)
    m = make_manager(conf_c)
    try:
        control = soak.run_legs(m, SEED, RPD)
    finally:
        m.stop()
    faults.reset_accounting()
    journal = os.path.join(tmp, "journal.jsonl")
    conf_x = conf_cls(spill_dir=os.path.join(tmp, "chaos"),
                      fault_spec=spec, metrics_sink=journal, **common)
    m = make_manager(conf_x)
    try:
        chaos = soak.run_legs(m, SEED, RPD)
        plane = m.faults
    finally:
        m.stop()
    spans = soak.read_spans(journal)
    retries = sum(int(s.get("retry_count") or 0) for s in spans)
    books = {
        "sites_hit": plane.sites_hit(),
        "injected": plane.injected_counts(),
        "hard": plane.injected_total(("fail", "corrupt")),
        "retries": retries,
        "recoveries": faults.recovery_counts(),
        "degradations": faults.active_degradations(),
        "balanced": plane.injected_total(("fail", "corrupt"))
        == retries + faults.recovery_total() + faults.degradation_total(),
        "missing_backoff": [s["span_id"] for s in spans
                            if (s.get("retry_count") or 0) > 0
                            and not s.get("backoff_ms")],
    }
    faults.reset_accounting()
    return control, chaos, books


@pytest.fixture(scope="module")
def ref_core(soaks, tmp_path_factory):
    from sparkrdma_tpu import ShuffleConf, faults
    from sparkrdma_tpu.api import serde

    import random

    spec = soaks["ref"].build_spec(random.Random(SEED), _include_serde())
    try:
        out = _core(soaks["ref"], ShuffleConf, faults, _ref_manager,
                    str(tmp_path_factory.mktemp("ref_core")), spec,
                    _common())
    finally:
        serde._reset_native_degrade()
        faults.reset_accounting()
    return spec, out


def _host(a):
    """A leg's output with rows as ``uint32`` and totals as ``int64``."""
    if isinstance(a, tuple) and len(a) == 2 and hasattr(a[0], "shape"):
        return (np.asarray(a[0], dtype=np.uint32),
                np.asarray(a[1]).astype(np.int64))
    return a


def _sorted_stream(out):
    """A TeraSort read's records in global order: each partition's valid
    prefix, partition after partition. The two packages sample other
    splitters (their samplers differ), so where the partitions cut the
    stream differs; the stream does not."""
    rows, totals = _host(out)
    cap = rows.shape[1] // len(totals)
    return np.concatenate([rows[:, p * cap:p * cap + int(t)]
                           for p, t in enumerate(totals)], axis=1)


def _assert_legs_equal(got, want):
    assert sorted(got) == sorted(want) == ["join", "repartition", "resume",
                                           "serde", "terasort"]
    for leg in want:
        g, w = _host(got[leg]), _host(want[leg])
        if leg == "terasort":
            g, w = (_sorted_stream(g),), (_sorted_stream(w),)
        if isinstance(w, tuple) and hasattr(w[0], "shape"):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y, err_msg=leg)
        else:
            assert g == w, leg


@pytest.mark.parametrize("seed", [0, 7, 11, 12345])
@pytest.mark.parametrize("include_serde", [True, False],
                         ids=["serde", "no_serde"])
def test_build_spec_matches_reference(soaks, seed, include_serde):
    import random

    want = soaks["ref"].build_spec(random.Random(seed), include_serde)
    got = soaks["port"].build_spec(random.Random(seed), include_serde)
    assert got == want
    assert len(got.split(";")) == 6 + include_serde


@pytest.mark.parametrize("transport", ["xla", "pallas_ring"])
def test_run_legs_control_and_chaos_match_reference(soaks, ref_core,
                                                    tmp_path, transport):
    """Both passes leg for leg, and the chaos pass's books: the same
    sites, injections and retries; the reference's ``serde_native``
    degradation is the port's ``serde_native`` recovery (C.1.13)."""
    from sparkrdma_tpu_torch import ShuffleConf, faults

    spec, (want_c, want_x, want_books) = ref_core
    port = soaks["port"]
    args = _Args(transport=transport)
    got_c, got_x, books = _core(
        port, ShuffleConf, faults, lambda c: port.new_manager(c, args),
        str(tmp_path), spec, _common(transport=transport))
    _assert_legs_equal(got_c, want_c)
    _assert_legs_equal(got_x, want_x)
    assert all(soaks["port"].outputs_equal(got_c[leg], got_x[leg])
               for leg in got_c)
    assert books["sites_hit"] == want_books["sites_hit"]
    assert len(books["sites_hit"]) >= 6
    assert books["injected"] == want_books["injected"]
    assert books["hard"] == want_books["hard"]
    assert books["retries"] == want_books["retries"] > 0
    recovered = dict(want_books["recoveries"])
    if "serde_native" in want_books["degradations"]:
        recovered["serde_native"] = recovered.get("serde_native", 0) + 1
    assert books["recoveries"] == recovered
    assert books["degradations"] == [
        d for d in want_books["degradations"] if d != "serde_native"]
    assert books["balanced"] and want_books["balanced"]
    assert books["missing_backoff"] == want_books["missing_backoff"] == []


def test_planner_pass_matches_reference(soaks, tmp_path):
    from sparkrdma_tpu import faults as ref_faults

    from sparkrdma_tpu_torch import faults

    ref_faults.reset_accounting()
    want = soaks["ref"].run_planner_leg(_Args(), _common(),
                                        str(tmp_path / "ref"))
    faults.reset_accounting()
    got = soaks["port"].run_planner_leg(_Args(), _common(),
                                        str(tmp_path / "port"))
    assert want["ok"] and got == want


def test_combine_pass_matches_reference(soaks, tmp_path):
    from sparkrdma_tpu import faults as ref_faults
    from sparkrdma_tpu.api import serde as ref_serde

    from sparkrdma_tpu_torch import faults

    ref_faults.reset_accounting()
    try:
        want = soaks["ref"].run_combine_leg(_Args(), _common(),
                                            str(tmp_path / "ref"))
    finally:
        ref_serde._reset_native_degrade()
        ref_faults.reset_accounting()
    faults.reset_accounting()
    got = soaks["port"].run_combine_leg(_Args(), _common(),
                                        str(tmp_path / "port"))
    faults.reset_accounting()
    assert want["ok"] and got == want


def test_alert_pass_matches_reference(soaks, tmp_path, monkeypatch):
    """Chaos fires ``spill_storm`` and ``straggler_spread`` (journal,
    ``/alerts``, ``shuffle_report --doctor``), the control none, in both.

    The reference's pass can have its 13 recorded reads cut by a
    wall-clock rollup window's edge, and then the stalled read is not in
    the window the straggler rule reads; the port's pass starts them at
    an edge. So here the reference's pass does too: its arm's first
    ``set_active_plane`` (the one before the recorded reads; the second
    restores) waits for the next 2 s edge first."""
    import time

    from sparkrdma_tpu import faults as ref_faults

    from sparkrdma_tpu_torch import faults

    install = ref_faults.set_active_plane
    arm_calls = []

    def at_window_edge(plane):
        if sys._getframe(1).f_code.co_name == "arm":
            arm_calls.append(plane)
            if len(arm_calls) % 2:
                time.sleep(2.0 - time.time() % 2.0 + 0.01)
        return install(plane)

    monkeypatch.setattr(ref_faults, "set_active_plane", at_window_edge)
    ref_faults.reset_accounting()
    want = soaks["ref"].run_alert_leg(_Args(), _common(),
                                      str(tmp_path / "ref"))
    monkeypatch.undo()
    assert len(arm_calls) == 4            # two arms, install and restore
    faults.reset_accounting()
    got = soaks["port"].run_alert_leg(_Args(), _common(),
                                      str(tmp_path / "port"))
    faults.reset_accounting()
    assert want["ok"] and got == want, (want, got)


def test_oversub_soak_matches_reference(capsys):
    """The whole oversubscription soak in-process, at its default size:
    the reference's verdict and geometry are the port's. How many chunks
    the store's writer thread evicts before they are read back depends
    on the threads' timing, in both packages, so the spill and fetch
    bytes are held to be positive and equal to each other (every spilled
    byte read back) rather than to the reference's."""
    ref, port = _load("oversub_soak"), _load("torch_oversub_soak")
    assert ref.main([]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port.main(["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.pop("device") == "cpu"
    for s in (got, want):
        assert s.pop("gbps") > 0
        assert s.pop("spill_bytes") == s.pop("fetch_bytes") > 0
        ev = s.pop("overlap_events")
        assert ev["spill:write"] > 0 and ev["spill:promote"] > 0
        assert 0 < s.pop("prefetch_hits") <= s["chunks"]
    assert want["ok"] is True and want["sync_fetches"] == 0
    assert got == want


@pytest.mark.parametrize("name", ["torch_chaos_soak", "torch_oversub_soak"])
def test_soak_needs_cuda_for_the_card(name):
    """Without a card, ``--device cuda`` (the default) raises: the soak
    never falls back to the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _load(name).main([])


def _run(script, *argv, timeout=900):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script), *argv],
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.slow
@pytest.mark.parametrize("transport", ["xla", "pallas_ring"])
def test_chaos_soak_whole(transport):
    """The whole port soak, every pass (the RPC pass's two workers
    included), at its default size, as the README runs it."""
    s = _run("torch_chaos_soak.py", "--device", "cpu", "--seed", str(SEED),
             "--transport", transport)
    assert s["ok"] is True and s["books_balanced"] is True
    assert len(s["sites_hit"]) >= 6
    assert all(s["bit_identical"].values())
    for leg in ("tenant_leg", "combine_leg", "rpc_leg", "alert_leg",
                "planner_leg"):
        assert s[leg]["ok"] is True, leg
    assert s["rpc_leg"]["clean"]["retries"] == 0


@pytest.mark.slow
def test_oversub_soak_whole():
    s = _run("torch_oversub_soak.py", "--device", "cpu")
    assert s["ok"] is True and s["sync_fetches"] == 0
    assert s["oversub_factor"] >= 10.0
