"""The out-of-core path as a whole, port vs reference.

Both packages get the same seeded columnar dataset (made with numpy) on
8 partitions in small chunks:

- ``run_tiered_terasort`` (collect) gives bit-identical rows, in the
  all-in-memory control (nothing spilled) and oversubscribed (chunks
  cycle through disk), equal to numpy's full-record order;
- ``run_streaming_terasort`` spills byte-identical sorted runs (keys are
  distinct, so the per-partition order is unique) that both verify, and
  in fold mode gives the same ``fold_sums``, also where the per-word
  sums overflow 2^32;
- the chunk sources and the input streamer, on the CPU; the same on the
  card (``gpu``-marked: skipped without one).

Every run is bounded in time (``bounded``); nothing is generated at
import.
"""

import os
import threading

import numpy as np
import pytest

W, C, CHUNKS, D = 4, 1024, 8, 8


def bounded(fn, timeout=120.0):
    """``fn()`` on a helper thread, failing the test if it has not
    returned within ``timeout`` seconds."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:      # re-raised on the test's thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} still blocked after {timeout} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _cols(seed, w=W, n=CHUNKS * C, low=0):
    return np.random.default_rng(seed).integers(low, 2**32, size=(w, n),
                                                dtype=np.uint32)


def _tier_kw(root, tag):
    return dict(slot_records=256, spill_dir=str(root / f"{tag}-spill"),
                spill_tier_dir=str(root / f"{tag}-tier"),
                spill_tier_host_bytes=4 * W * C * 4, spill_tier_prefetch=2)


@pytest.fixture(scope="module")
def ref_manager(tmp_path_factory):
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager

    root = tmp_path_factory.mktemp("ooc_ref")
    m = RefManager(conf=RefConf(use_native_staging=False,
                                **_tier_kw(root, "ref")))
    yield m
    m.stop()


def _port_manager(root, tag="port", device="cpu", **kw):
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    conf = ShuffleConf(**dict(_tier_kw(root, tag), **kw))
    return ShuffleManager(MeshRuntime(conf, D, device=device))


@pytest.fixture(scope="module")
def port_manager(tmp_path_factory):
    m = _port_manager(tmp_path_factory.mktemp("ooc_port"))
    yield m
    bounded(m.stop, 10)


# --- run_tiered_terasort --------------------------------------------------

@pytest.mark.parametrize("mode", ["control", "oversubscribed"])
def test_tiered_rows_match_reference(ref_manager, port_manager, mode):
    from sparkrdma_tpu.workloads.streaming import \
        run_tiered_terasort as ref_run

    from sparkrdma_tpu_torch.workloads.streaming import (_canon,
                                                         run_tiered_terasort)

    cols = _cols(1)
    base = 9600 if mode == "control" else 9700
    for m in (ref_manager, port_manager):
        m.tiered._watermark = (1 << 30 if mode == "control"
                               else 4 * W * C * 4)
    try:
        want = bounded(lambda: ref_run(ref_manager, cols, C,
                                       shuffle_id_base=base))
        got = bounded(lambda: run_tiered_terasort(port_manager, cols, C,
                                                  shuffle_id_base=base))
    finally:
        for m in (ref_manager, port_manager):
            m.tiered._watermark = m.conf.spill_tier_host_bytes
    assert got.chunks == want.chunks == CHUNKS
    assert got.records == want.records == CHUNKS * C
    assert got.record_bytes == want.record_bytes == 4 * W
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.rows,
                                  _canon(np.ascontiguousarray(cols.T)))
    spill, fetch, hits, sync = got.store_stats
    if mode == "control":
        assert spill == fetch == 0 and want.store_stats[0] == 0
    else:
        assert spill > 0 and fetch > 0 and hits >= CHUNKS - 2
        assert sync <= 2
    assert port_manager.tiered.keys() == []


def test_tiered_collect_false_and_checkpoint_resume(port_manager):
    """``collect=False`` runs without rows; a checkpointed run resumes
    after half its chunks are lost, adopting only those, with the same
    rows."""
    from sparkrdma_tpu_torch.workloads.streaming import (_canon,
                                                         run_tiered_terasort)

    cols = _cols(2)
    m = port_manager
    res = bounded(lambda: run_tiered_terasort(m, cols, C, collect=False,
                                              shuffle_id_base=9800))
    assert res.rows is None and res.records == CHUNKS * C
    first = bounded(lambda: run_tiered_terasort(
        m, cols, C, checkpoint=True, shuffle_id_base=9900))
    assert m.store.contains(9900)
    keys = [f"ts9900.chunk{j}" for j in range(CHUNKS)]
    for j in range(0, CHUNKS, 2):
        m.tiered.put(keys[j], cols[:, j * C:(j + 1) * C])
    assert m.resume_segments(9900) == keys[1::2]
    again = bounded(lambda: run_tiered_terasort(
        m, cols, C, resume=True, shuffle_id_base=9900))
    np.testing.assert_array_equal(again.rows, first.rows)
    np.testing.assert_array_equal(first.rows,
                                  _canon(np.ascontiguousarray(cols.T)))
    assert m.tiered.keys() == []
    m.unregister_shuffle(9900)
    assert not m.store.contains(9900)


def test_tiered_refuses_ragged_dataset(port_manager):
    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort

    with pytest.raises(ValueError, match="not divisible"):
        run_tiered_terasort(port_manager, _cols(3, n=C + 8), C)


def test_tiered_full_width_records(tmp_path):
    """100-byte records (W = 25, the pack sort mode), oversubscribed,
    against numpy."""
    from sparkrdma_tpu_torch.workloads.streaming import (_canon,
                                                         run_tiered_terasort)

    cols = _cols(4, w=25, n=4 * 512)
    m = _port_manager(tmp_path, val_words=23,
                      spill_tier_host_bytes=2 * 25 * 512 * 4)
    try:
        res = bounded(lambda: run_tiered_terasort(m, cols, 512))
    finally:
        bounded(m.stop, 10)
    assert res.store_stats[0] > 0
    np.testing.assert_array_equal(res.rows,
                                  _canon(np.ascontiguousarray(cols.T)))


def test_tiered_runs_match_reference_spill_runs(tmp_path, ref_manager,
                                                port_manager):
    """Each chunk's per-partition read, before any reordering, equals the
    sorted run the reference's spill mode writes for that chunk and
    partition (both draw the splitters from chunk 0 alike; keys are
    distinct, so each run's order is unique); ``device_verify`` passes."""
    from sparkrdma_tpu.hbm.input_stream import \
        ArrayChunkSource as RefSource
    from sparkrdma_tpu.workloads.streaming import \
        run_streaming_terasort as ref_run

    from sparkrdma_tpu_torch.hbm.host_staging import read_array
    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort

    cols = _cols(6)
    bounded(lambda: ref_run(ref_manager, RefSource(cols, C),
                            spill_dir=str(tmp_path), shuffle_id_base=9640))
    got = bounded(lambda: run_tiered_terasort(
        port_manager, cols, C, shuffle_id_base=9650, device_verify=True))
    assert got.verified is True
    assert len(got.runs) == D and all(len(r) == CHUNKS for r in got.runs)
    for d in range(D):
        for j in range(CHUNKS):
            run = got.runs[d][j]
            want = read_array(str(tmp_path / f"run-{j}-dev{d}.bin"),
                              np.uint32, run.shape)
            np.testing.assert_array_equal(run, want)


@pytest.mark.parametrize("fault", ["none", "partitions swapped",
                                   "rows reversed", "record dropped"])
def test_tiered_device_verify_sees_order_and_routing(port_manager,
                                                     monkeypatch, fault):
    """``device_verify`` holds each chunk's read to order and routing, not
    only to its multiset: a read whose partitions trade places, whose
    rows are reversed, or which lost a record fails it."""
    import torch

    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort

    m = port_manager
    real = m.get_reader

    def get_reader(handle, **kw):
        reader = real(handle, **kw)
        read = reader.read

        def damaged(**rkw):
            out, totals = read(**rkw)
            out, totals = out.clone(), totals.clone()
            oc = out.shape[1] // D
            if fault == "partitions swapped":
                out = torch.cat([out[:, oc:2 * oc], out[:, :oc],
                                 out[:, 2 * oc:]], dim=1)
                totals[[0, 1]] = totals[[1, 0]]
            elif fault == "rows reversed":
                k = int(totals[0])
                out[:, :k] = out[:, :k].flip(1)
            elif fault == "record dropped":
                totals[0] -= 1
            return out, totals

        reader.read = damaged
        return reader

    monkeypatch.setattr(m, "get_reader", get_reader)
    res = bounded(lambda: run_tiered_terasort(
        m, _cols(7, n=2 * C), C, collect=False, shuffle_id_base=9660,
        device_verify=True))
    assert res.verified is (fault == "none")
    assert res.runs is None


# --- run_streaming_terasort ----------------------------------------------

def test_streaming_spill_runs_match_reference(tmp_path, ref_manager,
                                              port_manager):
    from sparkrdma_tpu.hbm.input_stream import \
        ArrayChunkSource as RefSource
    from sparkrdma_tpu.workloads.streaming import \
        run_streaming_terasort as ref_run

    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import \
        run_streaming_terasort

    cols = _cols(5)
    dirs = {k: tmp_path / k for k in ("ref", "port")}
    for d in dirs.values():
        d.mkdir()
    want = bounded(lambda: ref_run(ref_manager, RefSource(cols, C),
                                   spill_dir=str(dirs["ref"]), verify=True))
    got = bounded(lambda: run_streaming_terasort(
        port_manager, ArrayChunkSource(cols, C),
        spill_dir=str(dirs["port"]), verify=True))
    assert want.verified is True and got.verified is True
    assert got.chunks == CHUNKS and got.records == CHUNKS * C
    assert [os.path.basename(p) for p in got.run_paths] == \
        [os.path.basename(p) for p in want.run_paths]
    assert len(got.run_paths) == CHUNKS * D
    for p, q in zip(got.run_paths, want.run_paths):
        assert open(p, "rb").read() == open(q, "rb").read(), p


@pytest.mark.parametrize("low", [0, 2**32 - 2**12],
                         ids=["uniform", "near-2^32"])
def test_streaming_fold_sums_match_reference(ref_manager, port_manager,
                                             low):
    """The conservation fold (count, per-word sums mod 2^32) equals the
    reference's and numpy's; with words near 2^32 every per-word sum
    wraps many times."""
    from sparkrdma_tpu.hbm.input_stream import \
        ArrayChunkSource as RefSource
    from sparkrdma_tpu.workloads.streaming import \
        run_streaming_terasort as ref_run

    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import \
        run_streaming_terasort

    cols = _cols(6, n=4 * C, low=low)
    want = bounded(lambda: ref_run(ref_manager, RefSource(cols, C)))
    got = bounded(lambda: run_streaming_terasort(
        port_manager, ArrayChunkSource(cols, C)))
    assert got.verified is None and got.run_paths == ()
    np.testing.assert_array_equal(got.fold_sums, want.fold_sums)
    numpy = np.concatenate([[np.uint32(cols.shape[1])],
                            cols.sum(axis=1, dtype=np.uint32)])
    np.testing.assert_array_equal(got.fold_sums, numpy.astype(np.uint32))
    assert got.fold_sums.dtype == np.uint32
    if low:
        assert (cols.sum(axis=1, dtype=np.uint64) > 2**40).all()


def test_fold_wraps_like_uint32():
    """``_fold`` on int32 bit views (negative for words >= 2^31) against
    uint32 arithmetic with wraparound, accumulated over many chunks."""
    import torch

    from sparkrdma_tpu_torch.workloads.streaming import _fold

    rng = np.random.default_rng(7)
    acc = torch.zeros(4, dtype=torch.int64)
    want = np.zeros(4, np.uint32)
    for _ in range(20):
        words = rng.integers(2**31, 2**32, size=(3, 1000), dtype=np.uint32)
        totals = torch.tensor([600, 400], dtype=torch.int32)
        acc = _fold(acc, torch.from_numpy(words.view(np.int32)), totals)
        want = want + np.concatenate(
            [[np.uint32(1000)], words.sum(axis=1, dtype=np.uint32)])
    np.testing.assert_array_equal(acc.numpy().astype(np.uint32), want)
    assert int(acc.max()) < 2**32 and int(acc.min()) >= 0


def test_streaming_from_reference_files(tmp_path, ref_manager, port_manager):
    """Chunk files written by the reference feed the port's streaming
    sort (the file source reading one file ahead), which verifies and
    spills the same runs as the reference from the same files."""
    from sparkrdma_tpu.hbm.host_staging import write_array as ref_write
    from sparkrdma_tpu.hbm.input_stream import \
        FileChunkSource as RefFiles
    from sparkrdma_tpu.workloads.streaming import \
        run_streaming_terasort as ref_run

    from sparkrdma_tpu_torch.hbm.input_stream import FileChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import \
        run_streaming_terasort

    cols = _cols(8, n=4 * C)
    paths = []
    for j in range(4):
        p = str(tmp_path / f"in{j}.bin")
        ref_write(p, cols[:, j * C:(j + 1) * C], use_native=False)
        paths.append(p)
    for d in ("ref", "port"):
        (tmp_path / d).mkdir()
    src, rsrc = FileChunkSource(paths, W, C), RefFiles(paths, W, C,
                                                      use_native=False)
    try:
        got = bounded(lambda: run_streaming_terasort(
            port_manager, src, spill_dir=str(tmp_path / "port"),
            verify=True))
        want = bounded(lambda: ref_run(
            ref_manager, rsrc, spill_dir=str(tmp_path / "ref"),
            verify=True))
    finally:
        src.close()
        rsrc.close()
    assert got.verified is True and want.verified is True
    for p, q in zip(got.run_paths, want.run_paths):
        assert open(p, "rb").read() == open(q, "rb").read(), p


def test_streaming_refuses_empty_source(port_manager):
    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import \
        run_streaming_terasort

    with pytest.raises(ValueError, match="empty"):
        run_streaming_terasort(port_manager,
                               ArrayChunkSource(_cols(9, n=0), C))


def test_verify_runs_catches_a_bad_run(tmp_path, port_manager):
    """A spilled run that loses its order fails verification."""
    from sparkrdma_tpu_torch.hbm.host_staging import read_array, write_array
    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource
    from sparkrdma_tpu_torch.workloads.streaming import (
        _verify_runs, run_streaming_terasort)

    cols = _cols(10, n=2 * C)
    src = ArrayChunkSource(cols, C)
    res = bounded(lambda: run_streaming_terasort(
        port_manager, src, spill_dir=str(tmp_path)))
    runs = [(p, os.path.getsize(p) // (4 * W)) for p in res.run_paths]
    assert _verify_runs(src, runs, D, 2, W)
    path, k = runs[3]
    rows = read_array(path, np.uint32, (k, W))
    write_array(path, rows[::-1].copy())
    assert not _verify_runs(src, runs, D, 2, W)


# --- chunk sources and the streamer ----------------------------------------

def test_array_chunk_source():
    from sparkrdma_tpu_torch.hbm.input_stream import ArrayChunkSource

    cols = _cols(11, n=4 * 128)
    src = ArrayChunkSource(cols, 128)
    assert len(src) == 4
    np.testing.assert_array_equal(src.chunk(2), cols[:, 256:384])
    with pytest.raises(ValueError, match="not divisible"):
        ArrayChunkSource(cols, 100)


def test_input_streamer_yields_all_chunks_on_cpu(port_manager):
    import torch

    from sparkrdma_tpu_torch.hbm.input_stream import (ArrayChunkSource,
                                                      InputStreamer)

    cols = _cols(12, n=4 * 128)
    for prefetch in (0, 1, 3):
        streamer = InputStreamer(port_manager.runtime,
                                 ArrayChunkSource(cols, 128), prefetch)
        got = list(streamer)
        assert len(streamer) == 4 and len(got) == 4
        assert streamer.host_pool is None         # no staging on the CPU
        assert all(g.dtype == torch.int32 and g.is_contiguous()
                   for g in got)
        np.testing.assert_array_equal(
            np.concatenate([g.numpy().view(np.uint32) for g in got], 1),
            cols)
    # each chunk is a copy: writing it leaves the dataset alone
    got[0].zero_()
    assert cols[:, :128].any()


def test_file_chunk_source_out_of_order(tmp_path):
    from sparkrdma_tpu_torch.hbm.host_staging import write_array
    from sparkrdma_tpu_torch.hbm.input_stream import FileChunkSource

    chunks = [_cols(20 + j, n=32) for j in range(3)]
    paths = []
    for j, c in enumerate(chunks):
        paths.append(str(tmp_path / f"chunk{j}.bin"))
        write_array(paths[-1], c)
    src = FileChunkSource(paths, W, 32)
    try:
        for j in (1, 2, 0, 0, 1):
            np.testing.assert_array_equal(bounded(lambda: src.chunk(j)),
                                          chunks[j])
        assert len(src) == 3
    finally:
        src.close()


def test_store_chunk_source_prefetches(tmp_path):
    from sparkrdma_tpu_torch import ShuffleConf
    from sparkrdma_tpu_torch.hbm.input_stream import StoreChunkSource
    from sparkrdma_tpu_torch.hbm.tiered_store import TieredStore, store_totals

    store = TieredStore(ShuffleConf(spill_tier_dir=str(tmp_path),
                                    spill_tier_host_bytes=0))
    chunks = [_cols(30 + j, n=64) for j in range(4)]
    keys = [f"c{j}" for j in range(4)]
    try:
        for k, c in zip(keys, chunks):
            store.put(k, c)
        bounded(store.drain, 10)
        # every chunk on disk; now room for lookahead + 2 chunks, as the
        # reference's test has, so promotions are not evicted straight
        # back before they are read
        store._watermark = 4 * chunks[0].nbytes
        src = StoreChunkSource(store, keys, lookahead=2)
        base = store_totals()
        np.testing.assert_array_equal(bounded(lambda: src.chunk(0)),
                                      chunks[0])
        for j in (1, 2):
            np.testing.assert_array_equal(bounded(lambda: src.chunk(j)),
                                          chunks[j])
        hits = store_totals()[2] - base[2]
        assert hits >= 2 and len(src) == 4
    finally:
        bounded(lambda: store.close(delete_disk=True), 10)


# --- on the card --------------------------------------------------------

@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the streamer's page-locked "
                    "staging and side-stream copies exist only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_input_streamer_on_card(cuda, port_manager):
    from sparkrdma_tpu_torch import MeshRuntime
    from sparkrdma_tpu_torch.hbm.input_stream import (ArrayChunkSource,
                                                      InputStreamer)

    rt = MeshRuntime(port_manager.conf, D, device=cuda)
    cols = _cols(40, n=8 * 1024)
    streamer = InputStreamer(rt, ArrayChunkSource(cols, 1024), prefetch=2)
    got = [g.cpu().numpy().view(np.uint32) for g in streamer]
    np.testing.assert_array_equal(np.concatenate(got, 1), cols)
    st = streamer.host_pool.stats()
    assert st["outstanding"] == 0 and st["allocations"] <= 4
    assert st["pinned_bytes"] == st["bytes_allocated"]


@pytest.mark.gpu
def test_tiered_terasort_card_equals_cpu(cuda, tmp_path, port_manager):
    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort

    cols = _cols(41)
    m = _port_manager(tmp_path, "card", device=cuda)
    try:
        got = bounded(lambda: run_tiered_terasort(m, cols, C))
    finally:
        bounded(m.stop, 10)
    want = bounded(lambda: run_tiered_terasort(port_manager, cols, C,
                                               shuffle_id_base=9300))
    assert got.store_stats[0] > 0 and got.staging["outstanding"] == 0
    np.testing.assert_array_equal(got.rows, want.rows)
    for d in range(D):
        for j in range(CHUNKS):
            np.testing.assert_array_equal(got.runs[d][j], want.runs[d][j])
