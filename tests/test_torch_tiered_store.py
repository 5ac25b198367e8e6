"""The tiered out-of-core store, port vs reference.

Each case of ``tests/test_tiered_store.py`` that does not use tenant
accounts, held against the port's ``TieredStore`` (LRU order, pinned
segments, the watermark property, no disk tier, CRC re-reads on real
on-disk bit flips, prefetch hits, sync fetches, segment resume); the
disk segments both stores write are byte-identical; a segment
checkpoint written by the reference's ``ShuffleManager`` resumes in the
port, whose ``run_tiered_terasort(resume=True)`` rows equal the
reference's. Every wait on a store thread is bounded (``bounded``).
"""

import os
import sys
import threading

import numpy as np
import pytest

from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.hbm.tiered_store import TieredStore, store_totals
from sparkrdma_tpu_torch.obs.metrics import global_registry


def bounded(fn, timeout=10.0):
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


def _conf(tmp_path, watermark, prefetch=2, **kw):
    return ShuffleConf(spill_tier_dir=str(tmp_path / "tier"),
                       spill_tier_host_bytes=watermark,
                       spill_tier_prefetch=prefetch, **kw)


def _arr(rng, nbytes):
    return rng.integers(0, 2**32, size=(nbytes // 4,), dtype=np.uint32)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def store_of(tmp_path):
    """Factory of stores closed (and their files removed) at teardown."""
    made = []

    def make(conf):
        store = TieredStore(conf)
        made.append(store)
        return store

    yield make
    for store in made:
        bounded(lambda: store.close(delete_disk=True))
        assert all(not t.is_alive() for t in store._threads)


def test_lru_eviction_order(tmp_path, rng, store_of):
    """The writer evicts the least recently used unpinned segment: a get
    refreshes recency, so the untouched segment goes to disk first."""
    seg = 1024
    store = store_of(_conf(tmp_path, watermark=2 * seg))
    a, b, c = (_arr(rng, seg) for _ in range(3))
    store.put("a", a)
    store.put("b", b)
    np.testing.assert_array_equal(store.get("a"), a)  # a becomes MRU
    store.put("c", c)                                 # over watermark
    bounded(store.drain)
    assert store.tier_of("b") == "disk"
    assert store.tier_of("a") == "host"
    assert store.tier_of("c") == "host"
    assert store.occupancy()["host_bytes"] <= 2 * seg
    np.testing.assert_array_equal(bounded(lambda: store.get("b")), b)


def test_pinned_segments_never_evict(tmp_path, rng, store_of):
    seg = 1024
    store = store_of(_conf(tmp_path, watermark=seg // 2))
    a, b = _arr(rng, seg), _arr(rng, seg)
    store.put("a", a, pin=True)
    store.put("b", b)
    bounded(store.drain)
    assert store.tier_of("a") == "host"
    assert store.tier_of("b") == "disk"
    store.unpin("a")
    bounded(store.drain)
    assert store.tier_of("a") == "disk"


@pytest.mark.parametrize("seed", [7, 8])
def test_watermark_property_random_ops(tmp_path, store_of, seed):
    """Under a random put/get/delete workload the drained host occupancy
    never exceeds the watermark, and every surviving segment reads back
    bit-exact from whatever tier it landed in."""
    rng = np.random.default_rng(seed)
    watermark = 8 * 1024
    store = store_of(_conf(tmp_path, watermark=watermark))
    live = {}
    for i in range(120):
        op = rng.integers(0, 10)
        if op < 5 or not live:
            key = f"k{i}"
            data = _arr(rng, int(rng.integers(1, 9)) * 512)
            store.put(key, data)
            live[key] = data
        elif op < 8:
            key = str(rng.choice(sorted(live)))
            np.testing.assert_array_equal(bounded(lambda: store.get(key)),
                                          live[key])
        else:
            key = str(rng.choice(sorted(live)))
            store.delete(key)
            del live[key]
        if i % 20 == 19:
            bounded(store.drain)
            assert store.occupancy()["host_bytes"] <= watermark
    bounded(store.drain)
    occ = store.occupancy()
    assert occ["host_bytes"] <= watermark
    assert occ["host_segments"] + occ["disk_segments"] == len(live)
    for key, data in live.items():
        np.testing.assert_array_equal(store.get(key), data)


def test_no_disk_tier_degrades_to_host_resident(rng, store_of):
    """Without a disk root, eviction refuses cleanly: data stays
    host-resident over the watermark instead of being dropped."""
    store = store_of(ShuffleConf(spill_tier_dir="", spill_dir="",
                                 spill_tier_host_bytes=512))
    a = _arr(rng, 2048)
    store.put("a", a)
    bounded(store.drain)
    assert store.tier_of("a") == "host"
    np.testing.assert_array_equal(store.get("a"), a)


def _flip_payload_byte(path):
    """A real on-disk bit flip in the payload region (not the trailer)."""
    with open(path, "r+b") as f:
        f.seek(3)
        byte = f.read(1)
        f.seek(3)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_crc_persistent_corruption_raises(tmp_path, rng, store_of):
    seg = 1024
    store = store_of(_conf(tmp_path, watermark=0,
                           spill_tier_reread_attempts=3))
    base = global_registry().counter("store.crc_rereads").value
    a = _arr(rng, seg)
    store.put("a", a)
    bounded(store.drain)
    assert store.tier_of("a") == "disk"
    _flip_payload_byte(os.path.join(store.root, "a.seg"))
    with pytest.raises(OSError, match="unreadable after 3 attempts"):
        store.get("a")
    # bounded: attempts - 1 re-reads, then give up
    assert global_registry().counter("store.crc_rereads").value - base == 2


def test_crc_transient_corruption_rereads(tmp_path, rng, monkeypatch,
                                          store_of):
    """The first read hits a real on-disk bit flip and fails its CRC; the
    file heals before the re-read, which succeeds and is counted as a
    ``spill_reread`` recovery."""
    import sparkrdma_tpu_torch.hbm.tiered_store as ts_mod

    store = store_of(_conf(tmp_path, watermark=0,
                           spill_tier_reread_attempts=3))
    reg = global_registry()
    base_reread = reg.counter("store.crc_rereads").value
    base_recover = reg.counter("recover.spill_reread").value
    a = _arr(rng, 1024)
    store.put("a", a)
    bounded(store.drain)
    path = os.path.join(store.root, "a.seg")
    good = open(path, "rb").read()
    _flip_payload_byte(path)
    real = ts_mod.read_array
    calls = {"n": 0}

    def healing(p, dtype, shape, **kw):
        calls["n"] += 1
        if calls["n"] == 2:       # the medium heals between attempts
            with open(path, "wb") as f:
                f.write(good)
        return real(p, dtype, shape, **kw)

    monkeypatch.setattr(ts_mod, "read_array", healing)
    np.testing.assert_array_equal(store.get("a"), a)
    assert calls["n"] == 2
    assert reg.counter("store.crc_rereads").value - base_reread == 1
    assert reg.counter("recover.spill_reread").value - base_recover == 1


def test_prefetch_promotes_and_counts_hits(tmp_path, rng, store_of):
    seg = 1024
    # the watermark holds lookahead + 2 segments, so promotion does not
    # thrash
    store = store_of(_conf(tmp_path, watermark=4 * seg, prefetch=2))
    data = {f"k{i}": _arr(rng, seg) for i in range(6)}
    for k, v in data.items():
        store.put(k, v)
    bounded(store.drain)
    on_disk = [k for k in sorted(data) if store.tier_of(k) == "disk"]
    assert on_disk
    base = store_totals()
    store.prefetch(on_disk[:2])
    for k in on_disk[:2]:
        np.testing.assert_array_equal(bounded(lambda: store.get(k)), data[k])
    d = tuple(b - a for a, b in zip(base, store_totals()))
    assert d[2] == 2     # prefetch_hits
    assert d[3] == 0     # sync_fetches


def test_sync_fetch_counted_without_prefetch(tmp_path, rng, store_of):
    store = store_of(_conf(tmp_path, watermark=0, prefetch=0))
    a = _arr(rng, 1024)
    store.put("a", a)
    bounded(store.drain)
    assert store.tier_of("a") == "disk"
    base = store_totals()
    np.testing.assert_array_equal(store.get("a"), a)
    d = tuple(b - a for a, b in zip(base, store_totals()))
    assert d[3] == 1 and d[2] == 0


def test_get_during_eviction_keeps_segment(tmp_path, rng, monkeypatch,
                                           store_of):
    """A segment read while its demotion is being written is no longer
    the least recently used: it stays on the host, the file written for
    it is removed, and the writer demotes the next least recently used
    segment instead."""
    import sparkrdma_tpu_torch.hbm.tiered_store as ts_mod

    started, go = threading.Event(), threading.Event()
    real = ts_mod.write_array

    def slow_write(path, arr, **kw):
        started.set()
        assert go.wait(10)
        return real(path, arr, **kw)

    monkeypatch.setattr(ts_mod, "write_array", slow_write)
    store = store_of(_conf(tmp_path, watermark=1024))
    a, b = _arr(rng, 1024), _arr(rng, 1024)
    store.put("a", a)
    store.put("b", b)               # over the watermark: "a" is written
    assert started.wait(10)
    np.testing.assert_array_equal(store.get("a"), a)
    go.set()
    bounded(store.drain)
    assert store.tier_of("a") == "host"
    assert store.tier_of("b") == "disk"
    assert not os.path.exists(os.path.join(store.root, "a.seg"))
    np.testing.assert_array_equal(store.get("b"), b)


def test_disk_segments_byte_identical_to_reference(tmp_path, rng):
    """Both stores demote the same segment to the same bytes (raw and
    zlib-coded), and each adopts and reads the other's file."""
    from sparkrdma_tpu.config import ShuffleConf as RefConf
    from sparkrdma_tpu.hbm.tiered_store import TieredStore as RefStore

    a = _arr(rng, 4096).reshape(4, 256)
    for codec in ("", "zlib"):
        kw = dict(spill_tier_host_bytes=0, spill_tier_prefetch=0,
                  serde_schema_spill_codec=codec)
        mine = TieredStore(ShuffleConf(spill_tier_dir=str(tmp_path / "p"),
                                       **kw))
        theirs = RefStore(RefConf(spill_tier_dir=str(tmp_path / "r"),
                                  use_native_staging=False, **kw))
        try:
            for s in (mine, theirs):
                s.put("seg/0", a)
                bounded(s.drain)
                assert s.tier_of("seg/0") == "disk"
            p, r = tmp_path / "p" / "seg_0.seg", tmp_path / "r" / "seg_0.seg"
            assert p.read_bytes() == r.read_bytes()
            mine.adopt("theirs", str(r), a.shape, "uint32")
            theirs.adopt("mine", str(p), a.shape, "uint32")
            np.testing.assert_array_equal(mine.get("theirs"), a)
            np.testing.assert_array_equal(theirs.get("mine"), a)
        finally:
            bounded(lambda: mine.close(delete_disk=True))
            bounded(lambda: theirs.close(delete_disk=True))


def test_delete_shuffle_and_tenant(tmp_path, rng, store_of):
    store = store_of(_conf(tmp_path, watermark=1 << 20))
    store.put("s5.a", _arr(rng, 512), shuffle=5)
    store.put("s5.b", _arr(rng, 512), shuffle=5, tenant="t")
    store.put("s6.a", _arr(rng, 512), shuffle=6, tenant="t")
    assert store.occupancy_by_tenant() == {
        "": {"host_bytes": 512, "disk_bytes": 0},
        "t": {"host_bytes": 1024, "disk_bytes": 0}}
    store.delete_shuffle(5, tenant="t")
    assert store.keys() == ["s5.a", "s6.a"]
    store.delete_shuffle(5)
    store.delete_tenant("t")
    assert store.keys() == [] and store.occupancy()["host_bytes"] == 0
    assert store.host_pool.stats()["outstanding"] == 0


def test_closed_store_refuses_and_threads_exit(tmp_path, rng):
    store = TieredStore(_conf(tmp_path, watermark=0))
    assert store._threads == []           # none before the first put
    store.put("a", _arr(rng, 1024))
    threads = list(store._threads)
    assert len(threads) == 2
    bounded(lambda: store.close(delete_disk=True))
    assert all(not t.is_alive() for t in threads)
    with pytest.raises(RuntimeError, match="closed"):
        store.put("b", _arr(rng, 64))
    bounded(store.drain)                  # a no-op once closed
    assert store.keys() == []


def test_concurrent_churn_bit_exact(tmp_path):
    """Four threads put, prefetch, get and delete their own keys against
    one store whose watermark forces constant eviction and promotion,
    with a short switch interval; every read is bit-exact and the store
    ends empty."""
    store = TieredStore(_conf(tmp_path, watermark=4 * 1024, prefetch=2))
    errors = []

    def worker(w):
        rng = np.random.default_rng(100 + w)
        live = {}
        try:
            for i in range(60):
                key = f"w{w}.{i}"
                live[key] = _arr(rng, 1024)
                store.put(key, live[key])
                keys = sorted(live)
                store.prefetch(keys[-3:])
                pick = keys[int(rng.integers(0, len(keys)))]
                if not np.array_equal(store.get(pick), live[pick]):
                    errors.append(f"{pick} read back wrong")
                if len(live) > 6:
                    gone = keys[0]
                    store.delete(gone)
                    del live[gone]
            for key in list(live):
                store.delete(key)
        except Exception as e:            # reported on the test thread
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(not t.is_alive() for t in threads), "churn hung"
    finally:
        sys.setswitchinterval(old)
        bounded(store.drain)
        leftover = store.keys()
        bounded(lambda: store.close(delete_disk=True))
    assert errors == []
    assert leftover == []
    assert store.host_pool.stats()["outstanding"] == 0


# --- through a manager --------------------------------------------------

def _manager(root, d=8, slot_records=256, **kw):
    conf = ShuffleConf(slot_records=slot_records,
                       spill_dir=str(root / "spill"),
                       spill_tier_dir=str(root / "tier"),
                       spill_tier_host_bytes=64 * 1024,
                       spill_tier_prefetch=2, **kw)
    return ShuffleManager(MeshRuntime(conf, d, device="cpu"))


@pytest.fixture(scope="module")
def manager(tmp_path_factory):
    m = _manager(tmp_path_factory.mktemp("tiered_mgr"))
    yield m
    bounded(m.stop)


def test_resume_replays_only_missing_segments(manager, rng):
    from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan

    mesh = manager.runtime.num_partitions
    chunks = {f"rs.chunk{j}": rng.integers(0, 2**32, size=(4, 256),
                                           dtype=np.uint32)
              for j in range(4)}
    plan = ShufflePlan(counts=np.zeros((mesh, mesh), np.int64),
                       num_rounds=1, out_capacity=32, capacity=32,
                       split_factor=1)
    bounded(lambda: manager.checkpoint_segments(77, list(chunks.items()),
                                                plan, mesh))
    for k, v in chunks.items():
        manager.tiered.put(k, v)
    # lose two segments; resume must adopt exactly those, lazily
    manager.tiered.delete("rs.chunk1")
    manager.tiered.delete("rs.chunk3")
    adopted = manager.resume_segments(77)
    assert sorted(adopted) == ["rs.chunk1", "rs.chunk3"]
    for k in adopted:
        assert manager.tiered.tier_of(k) == "disk"   # not read yet
    for k, v in chunks.items():
        np.testing.assert_array_equal(
            bounded(lambda: manager.tiered.get(k)), v)
    assert manager.resume_segments(77) == []
    # unregister drops the shuffle's adopted segments and its checkpoint
    manager.unregister_shuffle(77)
    assert [k for k in adopted if manager.tiered.contains(k)] == []
    assert not manager.store.contains(77)
    for k in chunks:
        manager.tiered.delete(k)


def test_manager_without_spill_dir(tmp_path):
    m = ShuffleManager(MeshRuntime(ShuffleConf(), 8, device="cpu"))
    try:
        assert m.store is None and m.tiered.root == ""
        with pytest.raises(RuntimeError, match="spill_dir"):
            m.resume_segments(1)
        with pytest.raises(RuntimeError, match="spill_dir"):
            m.checkpoint_segments(1, [], None, 8)
        with pytest.raises(RuntimeError, match="spill_dir"):
            m.resume_shuffle(m.register_shuffle(1, 8, None))
    finally:
        bounded(m.stop)
    # with a spill_dir, spill_to_host is accepted and the store is empty
    m = ShuffleManager(MeshRuntime(ShuffleConf(
        spill_to_host=True, spill_dir=str(tmp_path)), 8, device="cpu"))
    try:
        assert m.store is not None and m.store.list_shuffles() == []
        with pytest.raises(RuntimeError, match="nothing published"):
            m.checkpoint_shuffle(m.register_shuffle(2, 8, None))
    finally:
        bounded(m.stop)


@pytest.mark.parametrize("spill_dir", [False, True])
def test_spill_to_host_checkpoints(tmp_path, spill_dir):
    """``spill_to_host`` is accepted: with a ``spill_dir``,
    ``ShuffleWriter.stop`` writes a whole checkpoint that ``contains``
    finds; without one there is no store and nothing is written, as in
    the reference. The reference's ``use_native_staging`` is no knob of
    the port at all."""
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner

    kw = dict(spill_dir=str(tmp_path / "ck")) if spill_dir else {}
    m = ShuffleManager(MeshRuntime(ShuffleConf(spill_to_host=True, **kw), 8,
                                   device="cpu"))
    rows = np.random.default_rng(3).integers(0, 2**32, size=(8 * 16, 4),
                                             dtype=np.uint32)
    try:
        h = m.register_shuffle(5, 8, hash_partitioner(8, 2))
        bounded(lambda: m.get_writer(h).write(
            m.runtime.shard_records(rows)).stop())
        if spill_dir:
            assert m.store.contains(5) and m.store.list_shuffles() == [5]
            assert (tmp_path / "ck" / "shuffle_5" / "records.u32").is_file()
        else:
            assert m.store is None
            assert not (tmp_path / "ck").exists()
    finally:
        bounded(m.stop)
    with pytest.raises(TypeError, match="use_native_staging"):
        ShuffleConf(use_native_staging=False, **kw)


def test_exchange_acquires_through_the_store(tmp_path, monkeypatch):
    """Every pooled buffer of a streaming read is acquired through the
    store, which pokes its writer once per acquisition."""
    from sparkrdma_tpu_torch.exchange.partitioners import hash_partitioner

    m = _manager(tmp_path, slot_records=16)
    pokes = []
    real = m.tiered.service
    monkeypatch.setattr(m.tiered, "service",
                        lambda: pokes.append(1) or real())
    rows = np.random.default_rng(5).integers(0, 2**32, size=(8 * 512, 4),
                                             dtype=np.uint32)
    try:
        h = m.register_shuffle(31, 8, hash_partitioner(8, 2))
        m.get_writer(h).write(m.runtime.shard_records(rows)).stop()
        m.get_reader(h).read()
        assert m._exchange.last_dispatches > 1          # it streamed
        assert m._exchange.store is m.tiered
        assert len(pokes) >= 3      # send, receive chunk, accumulator
        assert m.runtime.pool.stats()["hits"] > 0
    finally:
        bounded(m.stop)


def _watch_fetches(store, monkeypatch):
    """``(read, counted)``: the keys the store read from its disk tier
    (prefetcher or consumer), and the keys whose ``get`` counted a
    prefetch hit or a sync fetch. Only a ``get`` moves those two
    counters, and it moves one of them by one."""
    read, counted = [], []
    real_read, real_get = store._read_segment, store.get

    def read_segment(seg):
        data = real_read(seg)
        read.append(seg.key)
        return data

    def get(key):
        before = store_totals()
        data = real_get(key)
        after = store_totals()
        if after[2:] != before[2:]:
            assert sum(after[2:]) - sum(before[2:]) == 1
            counted.append(key)
        return data

    monkeypatch.setattr(store, "_read_segment", read_segment)
    monkeypatch.setattr(store, "get", get)
    return read, counted


def test_tiered_terasort_bit_equal_to_in_hbm(manager, rng, monkeypatch):
    """An out-of-core run whose map output spills to disk gives the same
    sorted stream as the all-in-memory control, bit for bit. How far the
    prefetcher keeps ahead of the consumer depends on the scheduling, so
    only what holds under any scheduling is asserted of the counters:
    every chunk read back from disk counts as a prefetch hit or as a
    sync fetch (:func:`test_prefetcher_keeps_ahead` pins the keep-ahead
    itself)."""
    from sparkrdma_tpu_torch.workloads.streaming import (_canon,
                                                         run_tiered_terasort)

    W, C = 4, 1024
    n_chunks = 8
    cols = rng.integers(0, 2**32, size=(W, n_chunks * C), dtype=np.uint32)
    manager.tiered._watermark = 1 << 30
    control = bounded(lambda: run_tiered_terasort(
        manager, cols, chunk_records=C, shuffle_id_base=9600), 60)
    assert control.store_stats[0] == 0
    manager.tiered._watermark = 4 * W * C * 4
    read, counted = _watch_fetches(manager.tiered, monkeypatch)
    tiered = bounded(lambda: run_tiered_terasort(
        manager, cols, chunk_records=C, shuffle_id_base=9700), 60)
    manager.tiered._watermark = manager.conf.spill_tier_host_bytes
    spill, fetch, hits, sync = tiered.store_stats
    assert spill > 0 and fetch > 0
    assert fetch == len(read) * W * C * 4
    assert set(counted) == set(read)
    assert hits + sync == len(counted)
    assert tiered.records == control.records == n_chunks * C
    assert tiered.staging == {}                   # no staging on the CPU
    np.testing.assert_array_equal(tiered.rows, control.rows)
    np.testing.assert_array_equal(
        control.rows, _canon(np.ascontiguousarray(cols.T)))
    assert manager.tiered.keys() == []


def test_prefetcher_keeps_ahead(manager, rng, monkeypatch):
    """The prefetcher's keep-ahead, made deterministic: each ``get``
    first waits for the promotions queued before it and for the writer's
    evictions (``drain``). Then every chunk that comes back from disk was
    promoted ahead of its ``get``: as many prefetch hits as chunks
    fetched, and no sync fetch."""
    from sparkrdma_tpu_torch.workloads.streaming import (_canon,
                                                         run_tiered_terasort)

    W, C = 4, 1024
    n_chunks = 8
    cols = rng.integers(0, 2**32, size=(W, n_chunks * C), dtype=np.uint32)
    store = manager.tiered
    real_get = store.get

    def get(key):
        bounded(store.drain)
        return real_get(key)

    monkeypatch.setattr(store, "get", get)
    store._watermark = 4 * W * C * 4
    try:
        res = bounded(lambda: run_tiered_terasort(
            manager, cols, chunk_records=C, shuffle_id_base=9800), 60)
    finally:
        store._watermark = manager.conf.spill_tier_host_bytes
    spill, fetch, hits, sync = res.store_stats
    fetched = fetch // (W * C * 4)
    assert spill > 0 and fetched > 0
    assert hits == fetched
    assert sync == 0
    np.testing.assert_array_equal(
        res.rows, _canon(np.ascontiguousarray(cols.T)))
    assert store.keys() == []


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """A segment checkpoint written by the reference's tiered TeraSort is
    adopted by the port's ``resume_segments``, and the port's resumed
    run gives the reference's rows."""
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefManager
    from sparkrdma_tpu.workloads.streaming import \
        run_tiered_terasort as ref_run

    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort

    W, C, n_chunks, base = 4, 512, 4, 4200
    cols = np.random.default_rng(11).integers(
        0, 2**32, size=(W, n_chunks * C), dtype=np.uint32)
    spill = str(tmp_path / "spill")
    ref = RefManager(conf=RefConf(slot_records=256, spill_dir=spill,
                                  spill_tier_dir=str(tmp_path / "rtier"),
                                  use_native_staging=False))
    try:
        want = ref_run(ref, cols, chunk_records=C, shuffle_id_base=base,
                       checkpoint=True)
    finally:
        ref.stop()
    m = _manager(tmp_path)
    try:
        # keep half the chunks live: resume adopts only the others
        keys = [f"ts{base}.chunk{j}" for j in range(n_chunks)]
        for j in (0, 2):
            m.tiered.put(keys[j], cols[:, j * C:(j + 1) * C])
        adopted = m.resume_segments(base)
        assert adopted == [keys[1], keys[3]]
        assert all(m.tiered.tier_of(k) == "disk" for k in adopted)
        got = bounded(lambda: run_tiered_terasort(
            m, cols, chunk_records=C, shuffle_id_base=base, resume=True), 60)
    finally:
        bounded(m.stop)
    assert got.records == n_chunks * C
    np.testing.assert_array_equal(got.rows, want.rows)
