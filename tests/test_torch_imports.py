"""The port stands alone: no module of ``sparkrdma_tpu_torch``, none of
its scripts (``scripts/torch_*.py``) and not ``chip_smoke.py`` imports
``jax`` or anything of the JAX package, not even its JAX-free modules.
An AST scan, so conditional and function-local imports count too.

Also that the paths earlier slices refused now run."""

import ast
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "sparkrdma_tpu_torch").rglob("*.py")) + \
    sorted((REPO / "scripts").glob("torch_*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "sparkrdma_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_sources_found():
    assert len(SOURCES) > 10 and all(p.is_file() for p in SOURCES)
    assert REPO / "scripts" / "torch_merge_ab.py" in SOURCES


@pytest.mark.parametrize("rel", [
    "hbm/host_staging.py", "hbm/tiered_store.py", "hbm/input_stream.py",
    "meta/checkpoint.py", "workloads/streaming.py"])
def test_out_of_core_modules_scanned(rel):
    """The out-of-core modules are ported (the reference's copies of
    these import no JAX, and the port keeps its own all the same)."""
    path = REPO / "sparkrdma_tpu_torch" / rel
    assert path in SOURCES
    assert not [n for _, n in _imports(path) if _forbidden(n)]


@pytest.mark.parametrize("rel", [
    "api/serde.py", "api/pipeline.py", "plan/__init__.py", "plan/nodes.py",
    "plan/optimizer.py", "plan/executor.py", "workloads/tpcds.py"])
def test_serde_and_planner_modules_scanned(rel):
    """The host codec, the pipeline, the planner and the TPC-DS queries
    are the port's own copies (the reference's ``api/serde.py`` and
    ``plan/optimizer.py`` import no JAX, and are copied all the same)."""
    path = REPO / "sparkrdma_tpu_torch" / rel
    assert path in SOURCES
    assert not [n for _, n in _imports(path) if _forbidden(n)]


@pytest.mark.parametrize("rel", [
    "faults.py", "exchange/errors.py", "meta/map_output.py",
    "meta/checkpoint.py"])
def test_durability_and_fault_modules_scanned(rel):
    """The fault plane, the failure types, the shuffle registry and the
    checkpoint store are the port's own copies (the reference's import
    no JAX, and are copied all the same)."""
    path = REPO / "sparkrdma_tpu_torch" / rel
    assert path in SOURCES
    assert not [n for _, n in _imports(path) if _forbidden(n)]


@pytest.mark.parametrize("rel", [
    "obs/metrics.py", "obs/names.py", "obs/stats.py", "obs/timeline.py",
    "obs/journal.py", "obs/critical_path.py", "obs/watchdog.py",
    "obs/trace.py", "utils/profiling.py", "utils/stats.py"])
def test_observability_modules_scanned(rel):
    """The journal, the timeline, the watchdog, job traces, the critical
    path and the profiling hooks are the port's own copies (the
    reference's ``obs`` modules import no JAX, and are copied all the
    same)."""
    path = REPO / "sparkrdma_tpu_torch" / rel
    assert path in SOURCES
    assert not [n for _, n in _imports(path) if _forbidden(n)]


@pytest.mark.parametrize("rel", [
    "obs/rollup.py", "obs/tsdb.py", "obs/baseline.py", "obs/alerts.py",
    "obs/probe.py", "service/__init__.py", "service/tenant.py",
    "service/admission.py", "service/wire.py", "service/rpc.py",
    "service/client.py", "service/daemon.py"])
def test_telemetry_and_service_modules_scanned(rel):
    """The live telemetry and alert layer and the multi-tenant service
    are the port's own copies (the reference's import no JAX, and are
    copied all the same)."""
    path = REPO / "sparkrdma_tpu_torch" / rel
    assert path in SOURCES
    assert not [n for _, n in _imports(path) if _forbidden(n)]


@pytest.mark.parametrize("rel", [
    "runtime/distributed.py", "exchange/hierarchical.py"])
def test_multi_process_modules_scanned(rel):
    """The bootstrap and the hierarchical transport are the port's own
    (``torch.distributed`` where the reference calls ``jax.distributed``
    and ``lax.all_to_all``), and the package exports the bootstrap."""
    import sparkrdma_tpu_torch
    from sparkrdma_tpu_torch import runtime

    path = REPO / "sparkrdma_tpu_torch" / rel
    assert path in SOURCES
    assert not [n for _, n in _imports(path) if _forbidden(n)]
    assert "initialize_distributed" in sparkrdma_tpu_torch.__all__
    assert runtime.initialize_distributed is \
        sparkrdma_tpu_torch.initialize_distributed


@pytest.mark.parametrize("rel", ["torch_chaos_soak.py",
                                 "torch_oversub_soak.py"])
def test_soak_scripts_scanned(rel):
    """The chaos and oversubscription soaks are the port's own scripts:
    they drive the port and import nothing of the reference (the
    reference's ``shuffle_report.py`` runs as a subprocess of the alert
    pass, over the port's journal)."""
    path = REPO / "scripts" / rel
    assert path in SOURCES
    assert not [n for _, n in _imports(path) if _forbidden(n)]
    assert "sparkrdma_tpu_torch" in {n.split(".")[0]
                                     for _, n in _imports(path)}


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_imports(path):
    bad = [f"{path.name}:{line} imports {name}"
           for line, name in _imports(path) if _forbidden(name)]
    assert not bad, bad


def test_scanner_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from sparkrdma_tpu.config import x\n"
                     "import jax.numpy as jnp\nimport sparkrdma_tpu_torch\n")
    assert sorted(n for _, n in _imports(probe) if _forbidden(n)) == \
        ["jax.numpy", "sparkrdma_tpu.config"]


def _manager(d=8, **kw):
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner

    m = ShuffleManager(MeshRuntime(ShuffleConf(**kw), d, device="cpu"))
    rows = np.arange(64 * m.conf.record_words, dtype=np.uint32)
    h = m.register_shuffle(1, d, hash_partitioner(d, 2))
    m.get_writer(h).write(m.runtime.shard_records(
        rows.reshape(64, -1) % 7)).stop()
    return m, h


def test_ported_paths_run():
    """Aggregator exchanges and partition-range reads are ported."""
    m, h = _manager(slot_records=64)
    for reader in (m.get_reader(h, aggregator="sum"),
                   m.get_reader(h, aggregator="max", float_payload=True),
                   m.get_reader(h, 2, 5),
                   m.get_reader(h, 2, 5, aggregator="min")):
        out, totals = reader.read()
        assert out.shape[0] == 4 and totals.shape == (8,)
    m.stop()


@pytest.mark.parametrize("kw,what", [
    (dict(val_words=23), "pack"),
    (dict(val_words=23, pack_sort_min_payload=0), "wide"),
    (dict(slot_records=1, max_rounds_in_flight=1), "streaming")])
def test_unported_paths_refused(kw, what):
    """The paths earlier slices refused (the pack and wide sort modes,
    the streaming regime) now run, and give the bytes of the plain-mode
    fused read of the same records."""
    m, h = _manager(**kw)
    out, totals = m.get_reader(h, aggregator="sum").read()
    ex = m._exchange
    assert ex.sort_mode(m.conf.record_words) == \
        ("plain" if what == "streaming" else what)
    assert (ex.last_dispatches > 1) == (what == "streaming")
    plain, hp = _manager(**dict(kw, pack_sort_min_payload=0,
                                wide_sort_min_payload=0,
                                max_rounds_in_flight=64))
    want, want_totals = plain.get_reader(hp, aggregator="sum").read()
    assert plain._exchange.last_dispatches == 1
    assert (out == want).all() and (totals == want_totals).all()
    m.stop()
    plain.stop()
