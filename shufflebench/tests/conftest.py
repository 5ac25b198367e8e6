"""The benchmark's own tests: the harness and the reference on the CPU
at small sizes; tests marked ``gpu`` run the harness on a card and skip
without one (decided in the ``cuda`` fixture, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads a test process, so that parallel test
    processes do not crowd each other's timed windows."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
