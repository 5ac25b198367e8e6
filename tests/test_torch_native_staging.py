"""The port's native staging library (``native/staging.cpp``) on the CPU.

- **ABI**: the port's library, built here with ``g++``, against the JAX
  package's own build of its library (``sparkrdma_tpu.hbm.host_staging
  .load_native``): the same pool classes, the same get/put/stats answers
  (a foreign or second release refused), the same file bytes and the
  same per-batch error count of the spooler.
- **Codecs**: seeded rows through the port's native codec at threads 1,
  2 and 8, the port's numpy codec and the reference's native and numpy
  codecs are bit-identical (tolerance 0: uint32 words), v1 and
  columnar, and decode back to the inputs; errors carry the same text.
- **Files**: spill files and checkpoints written by either path of
  either package read back through the other's, byte for byte.
- **The slice**: the port with native staging and the native codec on
  against the reference (forced 8-device CPU mesh): a payload dataset
  loaded, sorted by key (merge-path geometry) and unloaded; the tiered
  out-of-core TeraSort; a checkpoint and its resume.
- **No silent fallback**: with no compiler, ``use_native_staging`` and
  ``serde_native`` raise; with ``serde_native=False`` no ``serde.*``
  site fires.
- **Fault sites**: one injected ``serde.encode`` / ``serde.decode``
  failure is run again and booked as the ``serde_native`` recovery; a
  failure at every hit raises.

The sanitizer legs (``slow``, as the reference's) build the port's
library with ``-fsanitize=thread`` and ``-fsanitize=address,undefined``
and replay the codec fuzz and the spill paths in a child process with
the matching runtime preloaded: ``python tests/test_torch_native_staging.py
{probe|fuzz}`` with ``SPARKRDMA_NATIVE_FLAVOR`` set.
"""

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
D, W, C, CHUNKS = 8, 4, 1024, 8
SCHEMA = [("u", "uint32"), ("i", "int64"), ("f", "float64"),
          ("b", ("bytes", 21))]


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


@pytest.fixture(scope="module")
def staging():
    from sparkrdma_tpu_torch.hbm import host_staging

    return host_staging


@pytest.fixture(scope="module")
def lib(staging):
    return staging.load_native()


@pytest.fixture(scope="module")
def ref_staging():
    from sparkrdma_tpu.hbm import host_staging

    return host_staging


@pytest.fixture(scope="module")
def reflib(ref_staging):
    lib = ref_staging.load_native()
    assert lib is not None, "the reference's library did not build"
    return lib


@pytest.fixture(scope="module")
def serde():
    from sparkrdma_tpu_torch.api import serde

    return serde


@pytest.fixture(scope="module")
def ref_serde():
    from sparkrdma_tpu.api import serde

    return serde


# --- the ABI against the reference's library ------------------------------

def test_port_library_is_its_own(lib, reflib):
    """The port loads its own build under ``build/native/``, never the
    JAX package's ``native/build`` output."""
    from sparkrdma_tpu_torch import _build

    path = Path(lib._name)
    assert path == _build.native_lib_path("")
    assert path.parent.parent == _build.NATIVE_ROOT
    assert "sparkrdma_tpu/native" not in str(path)
    assert Path(reflib._name) != path


def test_pool_class_of_matches(lib, reflib):
    sizes = [0, 1, 255, 256, 257, 1000, 4096, 4097, 65535, 1 << 20,
             (1 << 20) + 1, 3 << 28]
    assert [lib.sr_pool_class_of(n) for n in sizes] == \
        [reflib.sr_pool_class_of(n) for n in sizes]


def _pool_script(L):
    """One get/put/stats sequence; returns what the library answered."""
    pool, other = L.sr_pool_create(), L.sr_pool_create()
    ptrs = [L.sr_pool_get(pool, n) for n in (100, 300, 300, 5000, 256)]
    aligned = all(p % 256 == 0 for p in ptrs)
    foreign = L.sr_pool_get(other, 64)
    rcs = [L.sr_pool_put(pool, ptrs[1]),
           L.sr_pool_put(pool, ptrs[1]),        # a second release
           L.sr_pool_put(pool, foreign),        # another pool's buffer
           L.sr_pool_put(pool, ptrs[0])]
    again = L.sr_pool_get(pool, 400)            # reuses ptrs[1]'s class
    rcs.append(int(again == ptrs[1]))
    vals = [ctypes.c_long() for _ in range(4)]
    L.sr_pool_stats(pool, *[ctypes.byref(v) for v in vals])
    L.sr_pool_put(other, foreign)
    L.sr_pool_destroy(other)
    L.sr_pool_destroy(pool)
    return aligned, rcs, [v.value for v in vals]


def test_pool_sequence_matches(lib, reflib):
    got = _pool_script(lib)
    assert got == _pool_script(reflib)
    assert got[0] and got[1] == [0, -1, -1, 0, 1]
    assert got[2] == [1, 5, 4, 256 + 512 * 2 + 8192 + 256]


def test_file_io_matches(tmp_path, lib, reflib):
    data = np.random.default_rng(1).integers(0, 256, 10_001, np.uint8)
    for name, L in (("port", lib), ("ref", reflib)):
        p = str(tmp_path / f"{name}.bin").encode()
        assert L.sr_write_file(p, data.ctypes.data, data.nbytes) == \
            data.nbytes
        assert L.sr_file_size(p) == data.nbytes
        back = np.zeros(data.nbytes + 7, np.uint8)
        assert L.sr_read_file(p, back.ctypes.data, back.nbytes) == \
            data.nbytes
        np.testing.assert_array_equal(back[:data.nbytes], data)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "ref.bin").read_bytes()
    missing = str(tmp_path / "no" / "x.bin").encode()
    assert lib.sr_write_file(missing, data.ctypes.data, 4) == \
        reflib.sr_write_file(missing, data.ctypes.data, 4) < 0
    assert lib.sr_read_file(missing, data.ctypes.data, 4) == \
        reflib.sr_read_file(missing, data.ctypes.data, 4) < 0
    assert lib.sr_file_size(missing) == reflib.sr_file_size(missing) < 0


def test_spooler_batch_errors_match(tmp_path, lib, reflib):
    bufs = [np.full(100 + i, i, np.uint8) for i in range(6)]

    def run(L, tag):
        sp = L.sr_spooler_create(2)
        try:
            for i, b in enumerate(bufs):
                d = tmp_path / (tag if i % 3 else f"{tag}-missing")
                d.mkdir(exist_ok=True) if i % 3 else None
                L.sr_spooler_submit(sp, str(d / f"{i}.bin").encode(),
                                    b.ctypes.data, b.nbytes)
            first = L.sr_spooler_drain(sp)
            return first, L.sr_spooler_drain(sp)
        finally:
            L.sr_spooler_destroy(sp)

    assert bounded(lambda: run(lib, "port")) == \
        bounded(lambda: run(reflib, "ref")) == (2, 0)
    for i in (1, 2, 4, 5):
        assert (tmp_path / "port" / f"{i}.bin").read_bytes() == \
            (tmp_path / "ref" / f"{i}.bin").read_bytes() == bufs[i].tobytes()


# --- v1 codec parity -------------------------------------------------------

def _payloads(rng, n, maxb):
    """Lengths 0 and exactly ``maxb`` among random ones."""
    lens = rng.integers(0, maxb + 1, size=n)
    lens[:2] = (0, maxb)[:n]
    return [rng.bytes(int(k)) for k in lens]


@pytest.mark.parametrize("n,kw,maxb", [(1, 1, 0), (7, 1, 4), (300, 2, 37),
                                       (1000, 3, 300), (64, 2, 255)])
def test_v1_rows_bit_identical_everywhere(serde, ref_serde, n, kw, maxb):
    rng = np.random.default_rng(n * 7 + maxb)
    keys = rng.integers(0, 2**32, size=(n, kw), dtype=np.uint32)
    pays = _payloads(rng, n, maxb)
    want = ref_serde.encode_bytes_rows(keys, pays, maxb, native=False)
    np.testing.assert_array_equal(
        ref_serde.encode_bytes_rows(keys, pays, maxb, native=True), want)
    np.testing.assert_array_equal(
        serde.encode_bytes_rows(keys, pays, maxb, native=False), want)
    for threads in (1, 2, 8):
        rows = serde.encode_bytes_rows(keys, pays, maxb, native=True,
                                       threads=threads)
        np.testing.assert_array_equal(rows, want)
        k, p = serde.decode_bytes_rows(rows, kw, native=True,
                                       threads=threads)
        np.testing.assert_array_equal(k, keys)
        assert p == pays
    k, p = serde.decode_bytes_rows(want, kw, native=False)
    assert p == pays and np.array_equal(k, keys)


def test_v1_coerced_payloads(serde, ref_serde):
    """Rows that are not ``bytes`` take the coerce-then-retry path."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, size=(6, 2), dtype=np.uint32)
    raw = _payloads(rng, 6, 19)
    pays = [raw[0], bytearray(raw[1]), memoryview(raw[2]),
            np.frombuffer(raw[3], np.uint8), raw[4], bytearray(raw[5])]
    want = ref_serde.encode_bytes_rows(keys, raw, 19, native=False)
    for native in (True, False):
        np.testing.assert_array_equal(
            serde.encode_bytes_rows(keys, pays, 19, native=native), want)
    # equal-length uint8 arrays, which numpy would broadcast as a block
    same = [np.full(5, i, np.uint8) for i in range(6)]
    np.testing.assert_array_equal(
        serde.encode_bytes_rows(keys, same, 19, native=True),
        ref_serde.encode_bytes_rows(keys, same, 19, native=False))


@pytest.mark.parametrize("case", ["oversize", "str", "corrupt"])
def test_v1_errors_same_text(serde, ref_serde, case):
    keys = np.zeros((3, 1), np.uint32)

    def run(mod, native):
        if case == "oversize":
            mod.encode_bytes_rows(keys, [b"", b"x" * 9, b"y" * 10], 8,
                                  native=native)
        elif case == "str":
            mod.encode_bytes_rows(keys, [b"", b"a", "b"], 8, native=native)
        else:
            rows = mod.encode_bytes_rows(keys, [b"ab", b"", b""], 8,
                                         native=False)
            rows[1, 1] = 99
            mod.decode_bytes_rows(rows, 1, native=native)

    texts = set()
    for mod in (serde, ref_serde):
        for native in (True, False):
            with pytest.raises(ValueError) as e:
                run(mod, native)
            texts.add(str(e.value))
    assert len(texts) == 1, texts


# --- columnar codec parity -------------------------------------------------

def _columns(rng, fields, n):
    cols = {}
    for name, kind in fields:
        if kind == "uint32":
            cols[name] = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        elif kind == "int64":
            cols[name] = rng.integers(-2**63, 2**63 - 1, size=n,
                                      dtype=np.int64)
        elif kind == "float64":
            cols[name] = rng.standard_normal(n) * 1e300
        else:
            cols[name] = _payloads(rng, n, kind[1])
    return cols


@pytest.mark.parametrize("fields", [
    SCHEMA, [("i", "int64")], [("u", "uint32"), ("f", "float64")],
    [("b", ("bytes", 0))], [("f", "float64"), ("b", ("bytes", 300))]],
    ids=["mixed", "int64", "fixed", "empty_bytes", "wide_bytes"])
def test_columnar_rows_bit_identical_everywhere(serde, ref_serde, fields):
    rng = np.random.default_rng(len(fields))
    n, kw = 513, 2
    keys = rng.integers(0, 2**32, size=(n, kw), dtype=np.uint32)
    cols = _columns(rng, fields, n)
    ps, rs = serde.RowSchema(fields), ref_serde.RowSchema(fields)
    want = ref_serde.encode_cols(keys, cols, rs, native=False)
    np.testing.assert_array_equal(
        ref_serde.encode_cols(keys, cols, rs, native=True), want)
    np.testing.assert_array_equal(
        serde.encode_cols(keys, cols, ps, native=False), want)
    for threads in (1, 2, 8):
        rows = serde.encode_cols(keys, cols, ps, native=True,
                                 threads=threads)
        np.testing.assert_array_equal(rows, want)
        k, got = serde.decode_cols(rows, kw, ps, native=True,
                                   threads=threads)
        np.testing.assert_array_equal(k, keys)
        for name, kind in fields:
            if isinstance(kind, tuple):
                assert got[name] == cols[name]
            else:
                np.testing.assert_array_equal(
                    np.ascontiguousarray(got[name]).view(np.uint8),
                    cols[name].view(np.uint8))


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_bytes_only_schema_gives_v1_rows(serde, ref_serde, threads):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 2**32, size=(200, 2), dtype=np.uint32)
    pays = _payloads(rng, 200, 30)
    col = serde.encode_cols(keys, {"payload": pays},
                            serde.RowSchema.bytes_only(30), native=True,
                            threads=threads)
    np.testing.assert_array_equal(
        col, ref_serde.encode_bytes_rows(keys, pays, 30, native=True))
    np.testing.assert_array_equal(
        col, serde.encode_bytes_rows(keys, pays, 30, native=True,
                                     threads=threads))


# --- files across paths and packages ---------------------------------------

@pytest.mark.parametrize("codec", ["", "zlib"])
@pytest.mark.parametrize("writer", ["port_native", "ref_numpy",
                                    "ref_native"])
def test_spill_files_cross_read(tmp_path, staging, ref_staging, codec,
                                writer):
    arrs = [np.random.default_rng(40 + i).integers(
        0, 2**32, size=(300 + i, 4), dtype=np.uint32) for i in range(5)]
    mine = staging.SpillWriter(depth=2, use_native=True, codec=codec)
    numpy_side = staging.SpillWriter(depth=2, use_native=False, codec=codec)
    if writer == "port_native":
        other = ref_staging.SpillWriter(depth=2, use_native=False,
                                        codec=codec)
    else:
        other = ref_staging.SpillWriter(
            depth=2, use_native=writer == "ref_native", codec=codec)
    try:
        for i, a in enumerate(arrs):
            mine.submit(str(tmp_path / f"n{i}.bin"), a)
            numpy_side.submit(str(tmp_path / f"p{i}.bin"), a)
            other.submit(str(tmp_path / f"r{i}.bin"), a)
        assert [bounded(w.drain) for w in (mine, numpy_side, other)] == \
            [0, 0, 0]
    finally:
        for w in (mine, numpy_side, other):
            bounded(w.close)
    for i, a in enumerate(arrs):
        blobs = {(tmp_path / f"{t}{i}.bin").read_bytes() for t in "npr"}
        assert len(blobs) == 1
        for t in "npr":
            p = str(tmp_path / f"{t}{i}.bin")
            np.testing.assert_array_equal(
                staging.read_array(p, np.uint32, a.shape, use_native=True), a)
            np.testing.assert_array_equal(ref_staging.read_array(
                p, np.uint32, a.shape, use_native=False), a)


def test_checkpoints_cross_read(tmp_path):
    from sparkrdma_tpu.exchange.protocol import ShufflePlan as RefPlan
    from sparkrdma_tpu.meta.checkpoint import MapOutputStore as RefStore

    from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan
    from sparkrdma_tpu_torch.meta.checkpoint import MapOutputStore

    rng = np.random.default_rng(5)
    counts = rng.integers(0, 40, size=(D, D)).astype(np.int64)
    geo = dict(num_rounds=2, out_capacity=64, capacity=16, split_factor=1)
    recs = rng.integers(0, 2**32, size=(4, 320), dtype=np.uint32)
    dirs = {}
    for tag, store, plan in (
            ("port", MapOutputStore(str(tmp_path / "port"), use_native=True),
             ShufflePlan(counts=counts, **geo)),
            ("ref_native", RefStore(str(tmp_path / "rn"), use_native=True),
             RefPlan(counts=counts, **geo)),
            ("ref_numpy", RefStore(str(tmp_path / "rp"), use_native=False),
             RefPlan(counts=counts, **geo))):
        dirs[tag] = bounded(lambda: store.save(3, recs, plan, D))
    files = {t: {p.name: p.read_bytes() for p in d.iterdir()}
             for t, d in dirs.items()}
    assert files["port"] == files["ref_native"] == files["ref_numpy"]
    got, _, parts = RefStore(str(tmp_path / "port"), use_native=False).load(3)
    np.testing.assert_array_equal(got, recs)
    for root in ("rn", "rp"):
        got, plan, parts = MapOutputStore(str(tmp_path / root)).load(3)
        np.testing.assert_array_equal(got, recs)
        np.testing.assert_array_equal(plan.counts, counts)


# --- the slice as a whole --------------------------------------------------

KNOBS = dict(slot_records=4096, fast_sort=True, fast_sort_run=128,
             pack_sort_min_payload=0, wide_sort_min_payload=0)


def test_payloads_sort_round_trip_matches_reference(monkeypatch):
    """``from_host_payloads -> sort_by_key -> to_host_payloads``: the
    port with native staging and the native codec (the defaults) against
    the reference, in the merge-path geometry (160 records per
    partition, output capacity 256 = 2 runs)."""
    import jax

    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.dataset import Dataset as RefDataset
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefMgr
    from sparkrdma_tpu.meta.sampling import make_sampler as ref_sampler

    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api import dataset as dataset_mod
    from sparkrdma_tpu_torch.api.serde import payload_words
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.interop import records_from_torch
    from sparkrdma_tpu_torch.obs.metrics import global_registry

    maxb, n = 17, 8 * 160
    conf = dict(KNOBS, val_words=payload_words(maxb),
                serde_chunk_records=256)
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    keys[:, 0] = rng.permutation(n).astype(np.uint32) * 7 + 1
    pays = _payloads(rng, n, maxb)
    rm = RefMgr(conf=RefConf(**conf))
    pm = ShuffleManager(MeshRuntime(ShuffleConf(**conf), D, device="cpu"))
    assert pm.conf.serde_native and pm.conf.use_native_staging
    reg = global_registry()
    before = (reg.counter("serde.encode_native").value,
              reg.counter("serde.decode_native").value)
    try:
        rds = RefDataset.from_host_payloads(rm, keys, pays, maxb)
        pds = dataset_mod.Dataset.from_host_payloads(pm, keys, pays, maxb)
        np.testing.assert_array_equal(records_from_torch(pds.records),
                                      np.asarray(rds.records))
        rt = rm.runtime
        samples = np.asarray(jax.device_get(ref_sampler(
            rt.mesh, rt.axis_name, 2, 256)(rds._dense_records())))
        monkeypatch.setattr(dataset_mod, "make_sampler",
                            lambda *a, **k: (lambda recs: samples))
        rs, ps = rds.sort_by_key(), pds.sort_by_key()
        cap = ps.records.shape[1] // D
        assert rm._exchange._uses_fast_sort(cap, 2, "")
        np.testing.assert_array_equal(records_from_torch(ps.records),
                                      np.asarray(rs.records))
        rk, rp = rs.to_host_payloads()
        pk, pp = ps.to_host_payloads()
        np.testing.assert_array_equal(pk, rk)
        assert pp == list(rp)
        order = np.argsort(keys[:, 0])
        np.testing.assert_array_equal(pk, keys[order])
        assert pp == [pays[i] for i in order]
    finally:
        rm.stop()
        pm.stop()
    assert reg.counter("serde.encode_native").value > before[0]
    assert reg.counter("serde.decode_native").value > before[1]


def _tier_kw(root, tag):
    return dict(slot_records=256, spill_dir=str(root / f"{tag}-spill"),
                spill_tier_dir=str(root / f"{tag}-tier"),
                spill_tier_host_bytes=4 * W * C * 4, spill_tier_prefetch=2)


def test_tiered_terasort_matches_reference(tmp_path):
    """The out-of-core TeraSort through the tiered store, chunks cycling
    through disk, with the port's native pool and file IO: the rows of
    the reference's run (native too), bit for bit."""
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefMgr
    from sparkrdma_tpu.workloads.streaming import \
        run_tiered_terasort as ref_run

    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.workloads.streaming import run_tiered_terasort

    cols = np.random.default_rng(9).integers(0, 2**32, size=(W, CHUNKS * C),
                                             dtype=np.uint32)
    rm = RefMgr(conf=RefConf(**_tier_kw(tmp_path, "ref")))
    pm = ShuffleManager(MeshRuntime(ShuffleConf(**_tier_kw(tmp_path,
                                                           "port")),
                                    D, device="cpu"))
    try:
        assert pm.tiered.host_pool.native
        want = bounded(lambda: ref_run(rm, cols, C, shuffle_id_base=700))
        got = bounded(lambda: run_tiered_terasort(pm, cols, C,
                                                  shuffle_id_base=700))
        np.testing.assert_array_equal(got.rows, want.rows)
        assert got.store_stats[0] > 0 and got.store_stats[1] > 0
        assert pm.tiered.host_pool.stats()["native"] == 1
    finally:
        rm.stop()
        bounded(pm.stop, 10)


def test_checkpoint_resume_matches_reference(tmp_path):
    """A port manager on native staging checkpoints at ``stop()`` and
    resumes the read after losing its map output; the records are the
    reference's read of the same rows, and the checkpoint file is the
    reference's native store's, byte for byte."""
    from sparkrdma_tpu import ShuffleConf as RefConf
    from sparkrdma_tpu.api.shuffle_manager import ShuffleManager as RefMgr
    from sparkrdma_tpu.exchange.partitioners import modulo_partitioner as rmp

    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
    from sparkrdma_tpu_torch.exchange.partitioners import modulo_partitioner
    from sparkrdma_tpu_torch.interop import records_from_torch

    rng = np.random.default_rng(13)
    x = np.zeros((D * 16, 4), dtype=np.uint32)
    x[:, 1] = rng.integers(0, D, size=D * 16)
    x[:, 2] = rng.integers(0, 2**32, size=D * 16, dtype=np.uint32)
    roots = {t: str(tmp_path / t) for t in ("port", "ref")}
    rm = RefMgr(conf=RefConf(slot_records=64, spill_to_host=True,
                             spill_dir=roots["ref"]))
    try:
        h = rm.register_shuffle(4, D, rmp(D, key_word=1))
        rm.get_writer(h).write(rm.runtime.shard_records(x)).stop(True)
        out, totals = rm.get_reader(h).read()
        want = np.asarray(out), np.asarray(totals)
    finally:
        rm.stop()
    pm = ShuffleManager(MeshRuntime(ShuffleConf(
        slot_records=64, spill_to_host=True, spill_dir=roots["port"]), D,
        device="cpu"))
    try:
        assert pm.store.use_native
        h = pm.register_shuffle(4, D, modulo_partitioner(D, key_word=1))
        pm.get_writer(h).write(pm.runtime.shard_records(x)).stop()
        pm._writers.clear()              # the map output is lost
        out, totals = pm.get_reader(h).read()
        np.testing.assert_array_equal(records_from_torch(out), want[0])
        np.testing.assert_array_equal(totals.numpy(), want[1])
    finally:
        pm.stop()
    blob = "shuffle_4/records.u32"
    assert (tmp_path / "port" / blob).read_bytes() == \
        (tmp_path / "ref" / blob).read_bytes()


# --- no silent fallback ----------------------------------------------------

@pytest.fixture
def no_compiler(tmp_path, monkeypatch, staging):
    """A fresh build root and no C++ compiler; the real library comes
    back afterwards."""
    from sparkrdma_tpu_torch import _build

    monkeypatch.setattr(_build, "NATIVE_ROOT", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    staging._reset_native()
    yield
    monkeypatch.undo()
    staging._reset_native()
    staging.load_native()


def test_missing_compiler_raises_never_falls_back(tmp_path, no_compiler,
                                                  staging, serde):
    from sparkrdma_tpu_torch import MeshRuntime, ShuffleConf
    from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager

    x = np.arange(64, dtype=np.uint32).reshape(16, 4)
    calls = [
        lambda: staging.HostBufferPool(use_native=True),
        lambda: staging.SpillWriter(use_native=True),
        lambda: staging.write_array(str(tmp_path / "x.bin"), x),
        lambda: serde.encode_bytes_rows(x[:, :1], [b"a"] * 16, 4),
        lambda: serde.decode_bytes_rows(np.zeros((2, 3), np.uint32), 1),
        lambda: serde.encode_cols(x[:, :1], {"v": x[:, 1]},
                                  serde.RowSchema([("v", "uint32")])),
        lambda: ShuffleManager(MeshRuntime(ShuffleConf(
            spill_dir=str(tmp_path / "ck")), D, device="cpu")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
            call()
    assert not (tmp_path / "x.bin").exists()
    assert not serde.native_codec_available()
    # the numpy paths need no library
    staging.write_array(str(tmp_path / "y.bin"), x, use_native=False)
    np.testing.assert_array_equal(staging.read_array(
        str(tmp_path / "y.bin"), np.uint32, x.shape, use_native=False), x)
    rows = serde.encode_bytes_rows(x[:, :1], [b"a"] * 16, 4, native=False)
    assert serde.decode_bytes_rows(rows, 1, native=False)[1] == [b"a"] * 16
    m = ShuffleManager(MeshRuntime(ShuffleConf(
        spill_dir=str(tmp_path / "ck2"), use_native_staging=False), D,
        device="cpu"))
    assert not m.store.use_native and not m.tiered.host_pool.native
    m.stop()


def test_failed_build_names_the_compiler_error(tmp_path, monkeypatch,
                                               staging):
    from sparkrdma_tpu_torch import _build

    fake = tmp_path / "bad-g++"
    fake.write_text("#!/bin/sh\necho 'staging.cpp:1: error: boom' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "NATIVE_ROOT", tmp_path / "native")
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="error: boom"):
        _build.build_native()
    assert not list((tmp_path / "native").rglob("*.so"))


@pytest.mark.parametrize("what", ["big_endian", "layout"])
def test_codec_refused_where_it_cannot_run(monkeypatch, staging, serde,
                                           what):
    if what == "big_endian":
        monkeypatch.setattr(staging.load_native(), "sr_codec_abi",
                            lambda: 0)
    else:
        monkeypatch.setattr(serde, "_layout_checked", False)
    keys = np.zeros((4, 1), np.uint32)
    with pytest.raises(RuntimeError, match="refused"):
        serde.encode_bytes_rows(keys, [b"ab"] * 4, 8)
    with pytest.raises(RuntimeError, match="refused"):
        serde.decode_cols(np.ones((4, 4), np.uint32), 1,
                          serde.RowSchema([("b", ("bytes", 8))]))
    rows = serde.encode_bytes_rows(keys, [b"ab"] * 4, 8, native=False)
    assert serde.decode_bytes_rows(rows, 1, native=False)[1] == [b"ab"] * 4


def test_numpy_codec_fires_no_serde_site(serde):
    from sparkrdma_tpu_torch import faults

    plane = faults.FaultPlane("serde.encode:fail;serde.decode:fail")
    sch = serde.RowSchema([("b", ("bytes", 9))])
    keys = np.arange(8, dtype=np.uint32)[:, None]
    pays = [b"x" * i for i in range(8)]
    with faults.scoped_plane(plane):
        rows = serde.encode_bytes_rows(keys, pays, 9, native=False)
        assert serde.decode_bytes_rows(rows, 1, native=False)[1] == pays
        crow = serde.encode_cols(keys, {"b": pays}, sch, native=False)
        assert serde.decode_cols(crow, 1, sch, native=False)[1]["b"] == pays
    assert plane.injected_counts() == {}


# --- the serde fault sites -------------------------------------------------

@pytest.mark.parametrize("site", ["serde.encode", "serde.decode"])
@pytest.mark.parametrize("codec", ["v1", "columnar"])
def test_serde_fault_recovered_and_booked(serde, site, codec):
    from sparkrdma_tpu_torch import faults

    rng = np.random.default_rng(17)
    keys = rng.integers(0, 2**32, size=(100, 2), dtype=np.uint32)
    pays = _payloads(rng, 100, 40)
    sch = serde.RowSchema.bytes_only(40)

    def run():
        if codec == "v1":
            rows = serde.encode_bytes_rows(keys, pays, 40)
            return rows, serde.decode_bytes_rows(rows, 2)[1]
        rows = serde.encode_cols(keys, {"payload": pays}, sch)
        return rows, serde.decode_cols(rows, 2, sch)[1]["payload"]

    want_rows, want_pays = run()
    plane = faults.FaultPlane(f"{site}:fail@attempt<1")
    with faults.scoped_plane(plane):
        rows, got = run()
        booked = faults.recovery_counts()
    np.testing.assert_array_equal(rows, want_rows)
    assert got == want_pays == pays
    assert plane.injected_counts() == {site: {"fail": 1}}
    assert booked == {"serde_native": 1}
    assert plane.injected_total() == sum(booked.values())
    with faults.scoped_plane(faults.FaultPlane(f"{site}:fail")):
        with pytest.raises(RuntimeError, match="failed twice"):
            run()


# --- sanitizer legs ---------------------------------------------------------

#: child exit code: the instrumented library did not build or load
_UNAVAILABLE = 3


def _runtime_path(libname):
    """The sanitizer runtime ``gcc`` would link, or None."""
    try:
        out = subprocess.run(["gcc", f"-print-file-name={libname}"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    p = out.stdout.strip()
    return p if p and os.path.isabs(p) and os.path.exists(p) else None


def _child(flavor, runtime, mode, timeout):
    env = dict(os.environ, LD_PRELOAD=runtime,
               SPARKRDMA_NATIVE_FLAVOR=flavor, OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    if flavor == "asan":
        # CPython keeps its interned objects to the end by design
        env["ASAN_OPTIONS"] = "detect_leaks=0"
    return subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           mode], capture_output=True, text=True, env=env,
                          cwd=str(REPO), timeout=timeout)


def _leg(flavor, marker):
    runtime = _runtime_path(f"lib{flavor}.so")
    if runtime is None:
        pytest.skip(f"skipped: no sanitizer toolchain (lib{flavor}.so not "
                    "found by gcc)")
    probe = _child(flavor, runtime, "probe", 600)
    out = probe.stdout + probe.stderr
    blurb = out.strip()[-2000:]
    if probe.returncode != 0:
        if marker in out:
            # a report on the probe's tiny pass is a failure, not a skip
            pytest.fail(f"sanitizer report during the {flavor} probe:\n"
                        f"{out[out.index(marker):][:2000]}")
        pytest.skip(f"skipped: no sanitizer toolchain (probe exited "
                    f"{probe.returncode}: {blurb[-400:]})")
    run = _child(flavor, runtime, "fuzz", 900)
    out = run.stdout + run.stderr
    assert run.returncode == 0, f"{flavor} leg exited {run.returncode}:\n" \
        f"{out[-2000:]}"
    assert marker not in out, \
        f"sanitizer report:\n{out[out.find(marker):][:2000]}"
    assert "fuzz ok" in run.stdout


@pytest.mark.slow
def test_tsan_codec_and_spill_leg():
    """The codec fuzz (threads 1/2/8, v1 and columnar) and the spill
    paths under ThreadSanitizer: the codec's std::thread shards and the
    spooler's writer thread are the race surface."""
    _leg("tsan", "WARNING: ThreadSanitizer")


@pytest.mark.slow
def test_asan_codec_and_spill_leg():
    """The same under AddressSanitizer and UBSan: slots at their maximum
    length, empty heaps, corrupt length words and cut files are the
    overflow surface."""
    _leg("asan", "ERROR: AddressSanitizer")


def _child_probe():
    from sparkrdma_tpu_torch.api import serde
    from sparkrdma_tpu_torch.hbm import host_staging

    try:
        host_staging.load_native()
    except RuntimeError as e:
        print(e)
        return _UNAVAILABLE
    keys = np.arange(4, dtype=np.uint32)[:, None]
    rows = serde.encode_bytes_rows(keys, [b"a", b"", b"bc", b"d"], 4,
                                   threads=2)
    assert serde.decode_bytes_rows(rows, 1, threads=2)[1] == \
        [b"a", b"", b"bc", b"d"]
    print("probe ok")
    return 0


def _child_fuzz():
    import tempfile

    from sparkrdma_tpu_torch.api import serde
    from sparkrdma_tpu_torch.hbm import host_staging as hs

    for threads in (1, 2, 8):
        rng = np.random.default_rng(1000 + threads)
        for _ in range(5):
            n = int(rng.integers(1, 400))
            kw = int(rng.integers(1, 4))
            maxb = int(rng.integers(0, 97))
            keys = rng.integers(0, 2**32, size=(n, kw), dtype=np.uint32)
            pays = _payloads(rng, n, maxb)
            rows = serde.encode_bytes_rows(keys, pays, maxb,
                                           threads=threads)
            assert np.array_equal(rows, serde.encode_bytes_rows(
                keys, pays, maxb, native=False))
            if maxb:
                assert serde.decode_bytes_rows(rows, kw,
                                               threads=threads)[1] == pays
                bad = rows.copy()
                bad[n // 2, kw] = maxb + 4 * 97
                try:
                    serde.decode_bytes_rows(bad, kw, threads=threads)
                    raise AssertionError("corrupt length decoded")
                except ValueError:
                    pass
            fields = [("u", "uint32"), ("i", "int64"),
                      ("b", ("bytes", maxb))]
            sch = serde.RowSchema(fields)
            cols = _columns(rng, fields, n)
            crow = serde.encode_cols(keys, cols, sch, threads=threads)
            assert np.array_equal(crow, serde.encode_cols(
                keys, cols, sch, native=False))
            assert serde.decode_cols(crow, kw, sch,
                                     threads=threads)[1]["b"] == cols["b"]
    with tempfile.TemporaryDirectory() as d:
        pool = hs.HostBufferPool()
        sw = hs.SpillWriter(depth=2, pool=pool)
        arrs = [np.full((100 + i, 4), i, np.uint32) for i in range(12)]
        for i, a in enumerate(arrs):
            sw.submit(os.path.join(d, f"{i}.bin"), a)
        assert sw.drain() == 0
        sw.close()
        for i, a in enumerate(arrs):
            p = os.path.join(d, f"{i}.bin")
            assert np.array_equal(hs.read_array(p, np.uint32, a.shape), a)
            raw = bytearray(open(p, "rb").read())
            for cut in (1, 9, len(raw) // 2):
                open(p, "wb").write(bytes(raw[:-cut]))
                try:
                    hs.read_array(p, np.uint32, a.shape)
                    raise AssertionError("cut file read")
                except OSError:
                    pass
        hs.write_array(os.path.join(d, "w.bin"), arrs[3], pool=pool)
        assert np.array_equal(hs.read_array(os.path.join(d, "w.bin"),
                                            np.uint32, arrs[3].shape),
                              arrs[3])
        assert pool.stats()["outstanding"] == 0
        pool.close()
    print("fuzz ok")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit({"probe": _child_probe, "fuzz": _child_fuzz}[sys.argv[1]]())
