"""Host staging, port vs reference: the spill file format, the host
buffer pool, the spill writer and segment checkpoints.

Files written by the port must be byte-identical to the reference's
numpy path (raw, ``zlib`` and ``lzma``, with and without the CRC
trailer), and each package must read the other's. A damaged file raises
OSError. Every case that touches the pool, a file or the writer runs on
the port's native path and on its numpy path (the ``use_native``
fixture, as the reference's own staging tests run). Every wait on a
writer thread is bounded (``bounded``).
"""

import json
import threading

import numpy as np
import pytest

CODECS = ["", "zlib", "lzma"]


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def use_native(request):
    """The port's path under test: the C++ library or numpy."""
    return request.param


# both packages are imported by fixtures, not at module level: importing
# this file stays cheap (no torch, no JAX)
@pytest.fixture(scope="module")
def port():
    from sparkrdma_tpu_torch.hbm import host_staging

    return host_staging


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu.hbm import host_staging

    return host_staging


@pytest.fixture(scope="module")
def stores():
    """(port MapOutputStore, port ShufflePlan, reference MapOutputStore,
    reference ShufflePlan)."""
    from sparkrdma_tpu.exchange.protocol import ShufflePlan as RefPlan
    from sparkrdma_tpu.meta.checkpoint import MapOutputStore as RefStore
    from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan
    from sparkrdma_tpu_torch.meta.checkpoint import MapOutputStore

    return MapOutputStore, ShufflePlan, RefStore, RefPlan


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


def _records(seed, shape=(513, 4)):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape,
                                                dtype=np.uint32)


# --- file format ------------------------------------------------------

@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape,dtype", [((513, 4), np.uint32),
                                         ((7, 25), np.uint32),
                                         ((1000,), np.uint8)])
def test_write_array_byte_identical(tmp_path, codec, checksum, shape, dtype,
                                    port, ref, use_native):
    x = _records(1, shape).astype(dtype)
    a, b = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    port.write_array(a, x, use_native=use_native, codec=codec,
                     checksum=checksum)
    ref.write_array(b, x, use_native=False, codec=codec, checksum=checksum)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_reads_the_other(tmp_path, codec, writer, port, ref,
                              use_native):
    x = _records(2)
    p = str(tmp_path / "x.bin")
    if writer == "port":
        port.write_array(p, x, use_native=use_native, codec=codec)
        got = ref.read_array(p, np.uint32, x.shape, use_native=False)
    else:
        ref.write_array(p, x, use_native=False, codec=codec)
        got = port.read_array(p, np.uint32, x.shape, use_native=use_native)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("codec", CODECS)
def test_read_into_out(tmp_path, codec, port, use_native):
    x = _records(3)
    p = str(tmp_path / "x.bin")
    port.write_array(p, x, use_native=use_native, codec=codec)
    out = np.zeros_like(x)
    assert port.read_array(p, np.uint32, x.shape, use_native=use_native,
                           out=out) is out
    np.testing.assert_array_equal(out, x)


def test_legacy_file_without_trailer_reads(tmp_path, port, ref, use_native):
    x = _records(4)
    p = str(tmp_path / "x.bin")
    ref.write_array(p, x, use_native=False, checksum=False)
    np.testing.assert_array_equal(
        port.read_array(p, np.uint32, x.shape, use_native=use_native), x)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("offset", [0, 3, 100])
def test_crc_mismatch_raises(tmp_path, codec, offset, port, use_native):
    x = _records(5)
    p = str(tmp_path / "x.bin")
    port.write_array(p, x, use_native=use_native, codec=codec)
    with open(p, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0x10]))
    with pytest.raises(OSError):
        port.read_array(p, np.uint32, x.shape, use_native=use_native)


@pytest.mark.parametrize("cut", [1, 7, 9, 500])
def test_truncated_file_raises(tmp_path, cut, port, use_native):
    """(Cutting exactly the 8-byte trailer leaves a legacy raw file.)"""
    x = _records(6)
    p = str(tmp_path / "x.bin")
    port.write_array(p, x, use_native=use_native)
    data = open(p, "rb").read()
    open(p, "wb").write(data[:-cut])
    with pytest.raises(OSError):
        port.read_array(p, np.uint32, x.shape, use_native=use_native)


def test_missing_file_raises(tmp_path, port, use_native):
    with pytest.raises(OSError, match="unreadable"):
        port.read_array(str(tmp_path / "none.bin"), np.uint32, (4,),
                        use_native=use_native)


@pytest.mark.parametrize("codec", ["zlib", "lzma"])
def test_compress_array_matches_reference(codec, port, ref):
    x = _records(7)
    blob = port.compress_array(x, codec, 1)
    assert blob == ref.compress_array(x, codec, 1)
    assert port.decompress_blob(blob) == x.tobytes()
    with pytest.raises(ValueError):
        port.compress_array(x, "zstd")


def test_decompress_blob_truncation_raises_oserror(port):
    blob = port.compress_array(_records(8), "zlib", 1)
    for cut in (1, 5, 12, 13, len(blob) // 2, len(blob) - 1):
        with pytest.raises(OSError):
            port.decompress_blob(blob[:cut])


def test_crc_frame_into_equals_crc_frame(port, ref, use_native):
    pool = port.HostBufferPool(use_native=use_native)
    for seed, shape in ((9, (513, 4)), (10, (3,)), (11, (512, 4))):
        x = _records(seed, shape)
        frame, lease = port.crc_frame_into(x, pool)
        want = port.crc_frame(x)
        assert frame.tobytes() == want.tobytes()
        assert want.tobytes() == ref.crc_frame(x).tobytes()
        lease.release()
    assert pool.stats()["hits"] >= 1


def test_verify_crc_rejects_bad_magic(port):
    x = _records(12)
    frame = port.crc_frame(x)
    with pytest.raises(OSError, match="not a CRC trailer"):
        port.verify_crc(x, b"XXXX" + frame[-4:].tobytes(), "p")


# --- host buffer pool -------------------------------------------------

def test_pool_size_class_reuse(port, use_native):
    pool = port.HostBufferPool(use_native=use_native)
    assert pool.native == use_native
    b = pool.get(1000)
    assert b.nbytes == 1024 and not b.pinned and b.tensor is None
    v = b.view(np.uint32, (256,))
    v[:] = np.arange(256, dtype=np.uint32)
    assert int(v.sum()) == 255 * 256 // 2
    b.release()
    b2 = pool.get(900)
    st = pool.stats()
    assert st["hits"] == 1 and st["allocations"] == 1
    assert st["outstanding"] == 1 and st["bytes_allocated"] == 1024
    assert st["native"] == int(use_native)
    if use_native:
        assert b2.address % 256 == 0 and b2.address == b.address
    b2.release()
    assert pool.stats()["outstanding"] == 0
    assert port.HostBufferPool.size_class(1) == 256
    assert port.HostBufferPool.size_class(257) == 512


def test_pool_rejects_double_release(port, use_native):
    pool = port.HostBufferPool(use_native=use_native)
    b = pool.get(64)
    b.release()
    with pytest.raises(ValueError, match="already released"):
        pool.put(b)


def test_pool_pinned_limit_on_cpu_pool(port, use_native):
    """A pool made without ``pinned`` never page-locks: its leases are
    host memory with no tensor, and the pinned byte count stays 0."""
    pool = port.HostBufferPool(pinned=False, use_native=use_native)
    b = pool.get(4096)
    assert not b.pinned and b.tensor is None
    b.release()
    assert pool.stats()["pinned_bytes"] == 0


@pytest.mark.gpu
def test_pinned_pool_on_card(port, use_native):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked memory needs CUDA")
    pool = port.HostBufferPool(pinned=True, use_native=use_native)
    a, b = pool.get(1024), pool.get(1024)
    assert a.pinned and a.tensor.is_pinned() and b.tensor.is_pinned()
    assert pool.stats()["pinned_bytes"] == 2 * 1024
    for x in (a, b):
        x.release()
    assert pool.get(1024).tensor.is_pinned()
    assert pool.stats()["allocations"] == 2


# --- spill writer -----------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("with_pool", [False, True])
def test_spill_writer_files_match_reference(tmp_path, codec, with_pool, port,
                                            ref, use_native):
    arrs = [_records(20 + i, (100 + i, 4)) for i in range(12)]
    pool = port.HostBufferPool(use_native=use_native) if with_pool else None
    sw = port.SpillWriter(depth=3, use_native=use_native, codec=codec,
                          pool=pool)
    assert sw.native == use_native
    rw = ref.SpillWriter(depth=3, use_native=False, codec=codec)
    try:
        base = port.spill_count()
        for i, a in enumerate(arrs):
            sw.submit(str(tmp_path / f"p{i}.bin"), a)
            rw.submit(str(tmp_path / f"r{i}.bin"), a)
        assert bounded(sw.drain) == 0
        assert bounded(rw.drain) == 0
        assert port.spill_count() - base == len(arrs)
    finally:
        bounded(sw.close)
        bounded(rw.close)
    for i, a in enumerate(arrs):
        got = open(tmp_path / f"p{i}.bin", "rb").read()
        assert got == open(tmp_path / f"r{i}.bin", "rb").read()
        np.testing.assert_array_equal(
            port.read_array(str(tmp_path / f"p{i}.bin"), np.uint32, a.shape,
                            use_native=use_native), a)
    if pool is not None:
        assert pool.stats()["outstanding"] == 0


def test_spill_writer_counts_write_errors(tmp_path, port, use_native):
    sw = port.SpillWriter(depth=2, use_native=use_native)
    try:
        sw.submit(str(tmp_path / "missing" / "x.bin"), _records(30))
        sw.submit(str(tmp_path / "ok.bin"), _records(31))
        assert bounded(sw.drain) == 1
        assert bounded(sw.drain) == 0          # reset by the drain
    finally:
        bounded(sw.close)
    assert sw._thread is None


def test_spill_writer_rejects_unknown_codec(port):
    with pytest.raises(ValueError):
        port.SpillWriter(codec="zstd")


# --- segment checkpoints ----------------------------------------------

def _segments(seed, n=3):
    return [(f"ck.chunk{j}", _records(seed + j, (4, 256))) for j in range(n)]


@pytest.mark.parametrize("codec", ["", "zlib"])
def test_save_segments_byte_identical(tmp_path, codec, stores, use_native):
    counts = np.arange(16, dtype=np.int64).reshape(8, 2)
    MapOutputStore, ShufflePlan, RefStore, RefPlan = stores
    geo = dict(num_rounds=3, out_capacity=64, capacity=8, split_factor=2)
    mine = MapOutputStore(str(tmp_path / "port"), use_native=use_native,
                          compression=codec)
    theirs = RefStore(str(tmp_path / "ref"), use_native=False,
                      compression=codec)
    segs = _segments(40)
    d1 = bounded(lambda: mine.save_segments(
        5, segs, ShufflePlan(counts=counts, **geo), 8,
        extra_meta={"plan_fp": "abc"}))
    d2 = bounded(lambda: theirs.save_segments(
        5, segs, RefPlan(counts=counts, **geo), 8,
        extra_meta={"plan_fp": "abc"}))
    names = sorted(p.name for p in d1.iterdir())
    assert names == sorted(p.name for p in d2.iterdir())
    assert "segments.json" in names and not any(".tmp" in n for n in names)
    for name in names:
        assert (d1 / name).read_bytes() == (d2 / name).read_bytes(), name
    meta = json.loads((d1 / "segments.json").read_text())
    assert meta["plan_fp"] == "abc" and meta["split_factor"] == 2


def test_segment_store_reads_reference_checkpoint(tmp_path, port, stores,
                                                  use_native):
    root = str(tmp_path / "ck")
    MapOutputStore, ShufflePlan, RefStore, RefPlan = stores
    segs = _segments(50)
    bounded(lambda: RefStore(root, use_native=False).save_segments(
        9, segs, None, 8))
    mine = MapOutputStore(root, use_native=use_native)
    assert mine.contains(9) and not mine.contains(10)
    assert mine.list_segment_checkpoints() == [9]
    meta = mine.load_segment_meta(9)
    assert "counts" not in meta and meta["num_parts"] == 8
    for key, arr in segs:
        entry = meta["segments"][key]
        got = port.read_array(mine.segment_path(9, entry),
                              np.dtype(entry["dtype"]), entry["shape"],
                              use_native=use_native)
        np.testing.assert_array_equal(got, arr)
    mine.delete(9)
    assert not mine.contains(9) and mine.list_segment_checkpoints() == []
    with pytest.raises(KeyError):
        mine.load_segment_meta(9)


def test_reference_reads_port_checkpoint(tmp_path, ref, stores, use_native):
    root = str(tmp_path / "ck")
    MapOutputStore, ShufflePlan, RefStore, RefPlan = stores
    segs = _segments(60)
    bounded(lambda: MapOutputStore(root, use_native=use_native)
            .save_segments(3, segs, None, 8))
    theirs = RefStore(root, use_native=False)
    meta = theirs.load_segment_meta(3)
    assert theirs.list_segment_checkpoints() == [3]
    for key, arr in segs:
        got = ref.read_array(theirs.segment_path(3, meta["segments"][key]),
                             np.uint32, arr.shape, use_native=False)
        np.testing.assert_array_equal(got, arr)


def test_save_segments_failure_leaves_no_manifest(tmp_path, monkeypatch, port,
                                                  stores, use_native):
    import sparkrdma_tpu_torch.meta.checkpoint as ck
    MapOutputStore, ShufflePlan, RefStore, RefPlan = stores

    class Failing(port.SpillWriter):
        def drain(self):
            super().drain()
            return 1                   # one write did not land

    monkeypatch.setattr(ck, "SpillWriter", Failing)
    mine = MapOutputStore(str(tmp_path / "ck"), use_native=use_native)
    with pytest.raises(OSError, match="failed"):
        bounded(lambda: mine.save_segments(
            4, [("bad", _records(70, (4, 8)))], None, 8))
    assert not mine.contains(4)
    assert not list((mine.root / "shuffle_4").iterdir())
