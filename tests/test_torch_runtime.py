"""Port runtime vs the reference ``MeshRuntime`` on the 8-device CPU mesh.

``shard_records`` -> ``host_rows`` must round-trip bit-identically and
lay records out exactly as the reference's sharded global array; asking
for CUDA where there is none must raise, never fall back.
"""

import numpy as np
import pytest
import torch

from sparkrdma_tpu_torch import ManagerId, MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager


@pytest.mark.parametrize("w", [4, 25])
def test_shard_roundtrip_matches_reference(runtime, rng, w):
    x = rng.integers(0, 2**32, size=(8 * 37, w), dtype=np.uint32)
    rt = MeshRuntime(ShuffleConf(), num_partitions=8, device="cpu")
    cols = rt.shard_records(x)
    assert cols.dtype == torch.int32 and cols.shape == (w, 8 * 37)
    ref = runtime.shard_records(x)
    np.testing.assert_array_equal(cols.numpy().view(np.uint32),
                                  np.asarray(ref))
    np.testing.assert_array_equal(rt.host_rows(cols), runtime.host_rows(ref))
    np.testing.assert_array_equal(rt.host_rows(cols), x)


def test_partition_view_is_column_group(rng):
    rt = MeshRuntime(num_partitions=4, device="cpu")
    x = rng.integers(0, 2**32, size=(4 * 5, 3), dtype=np.uint32)
    cols = rt.shard_records(x)
    for d in range(4):
        np.testing.assert_array_equal(
            rt.host_rows(rt.partition(cols, d)), x[d * 5:(d + 1) * 5])


def test_shard_rejects_ragged_rows(rng):
    rt = MeshRuntime(num_partitions=8, device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        rt.shard_records(np.zeros((12, 4), np.uint32))


def test_manager_id():
    rt = MeshRuntime(num_partitions=8, device="cpu")
    assert str(rt.manager_id(3)) == "proc0/dev3"
    assert rt.manager_id(3) == ManagerId(0, 3)
    with pytest.raises(ValueError):
        rt.manager_id(8)


@pytest.mark.parametrize("make", [
    lambda: MeshRuntime(),
    lambda: MeshRuntime(num_partitions=1, device="cuda:0"),
    lambda: ShuffleManager(),
])
def test_cuda_without_gpu_raises(monkeypatch, make):
    """The entry points default to CUDA and never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_conf_refuses_unported_transport():
    with pytest.raises(ValueError, match="unknown transport"):
        ShuffleConf(transport="hierarchical")
