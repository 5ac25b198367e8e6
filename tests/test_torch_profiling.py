"""The port's profiling hooks (``utils/profiling.py``) on the CPU.

``trace`` writes a Chrome trace whose ranges include the read's
``shuffle:exchange#s<span_id>`` (the id of its journal span) and the
writer's ``shuffle:plan``; ``maybe_trace`` is a no-op without a
directory; on a CPU device ``annotate`` never touches NVTX. The card's
side (the kernels' launches in the same trace) is held by
``chip_smoke.py``'s ``obs`` phase.
"""

import json

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
from sparkrdma_tpu_torch.obs.journal import read_journal
from sparkrdma_tpu_torch.utils import profiling

D = 8


def _names(trace_dir):
    with open(trace_dir / profiling.TRACE_FILE) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


@pytest.fixture
def no_nvtx(monkeypatch):
    """NVTX must not be reached on the CPU: any call fails the test."""
    def boom(*a, **k):
        raise AssertionError("NVTX touched on a CPU device")

    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", boom)


def test_trace_holds_the_span_range(tmp_path, no_nvtx):
    sink = tmp_path / "j.jsonl"
    m = ShuffleManager(MeshRuntime(ShuffleConf(slot_records=64,
                                               metrics_sink=str(sink)), D,
                                   device="cpu"))
    rows = np.random.default_rng(0).integers(1, 2**32, size=(D * 16, 4),
                                             dtype=np.uint32)
    try:
        h = m.register_shuffle(5, D, modulo_partitioner(D))
        with profiling.trace(str(tmp_path / "tr")):
            m.get_writer(h).write(m.runtime.shard_records(rows)).stop(True)
            m.get_reader(h).read()
    finally:
        m.stop()
    (span,) = read_journal(str(sink))
    names = _names(tmp_path / "tr")
    assert f"shuffle:exchange#s{span.span_id}" in names
    assert "shuffle:plan" in names


def test_span_name_without_journal(no_nvtx, tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate_span("shuffle:exchange", 0, "cpu"):
            torch.ones(8).sum()
        with profiling.annotate_span("shuffle:exchange", 42,
                                     torch.device("cpu")):
            torch.ones(8).sum()
    names = _names(tmp_path)
    assert {"shuffle:exchange", "shuffle:exchange#s42"} <= names


def test_maybe_trace_noop(tmp_path):
    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(""):
        pass
    assert list(tmp_path.iterdir()) == []
    with profiling.maybe_trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    assert (tmp_path / "t" / profiling.TRACE_FILE).exists()


def test_annotate_on_a_cuda_device_opens_nvtx(monkeypatch):
    """The NVTX half, with the NVTX calls recorded instead of made (the
    CPU build has no NVTX library)."""
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    with profiling.annotate_span("shuffle:exchange", 7, "cuda"):
        calls.append(("body",))
    assert calls == [("push", "shuffle:exchange#s7"), ("body",), ("pop",)]
    calls.clear()
    with pytest.raises(ValueError):
        with profiling.annotate("x", "cuda:0"):
            raise ValueError
    assert calls == [("push", "x"), ("pop",)]
