"""The host row codecs: port vs reference on the CPU.

The same seeded (or hypothesis-drawn) keys, payloads and columns go
through ``sparkrdma_tpu.api.serde`` and ``sparkrdma_tpu_torch.api.serde``;
the encoded rows must be bit-equal (tolerance 0: uint32 words), and each
decode must give the reference's keys, payloads and column values. The
reference may take its native codec, whose rows are bit-identical to its
numpy path by its own tests. Errors are held to the same class and
message.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sparkrdma_tpu_torch.api import serde as port
from sparkrdma_tpu_torch.obs.metrics import global_registry

FUZZ = settings(max_examples=40, deadline=None, database=None,
                suppress_health_check=[HealthCheck.function_scoped_fixture])


@pytest.fixture(scope="module")
def ref():
    from sparkrdma_tpu.api import serde as ref_serde

    return ref_serde


def _payloads(rng, n, maxb):
    return [rng.bytes(int(k)) for k in rng.integers(0, maxb + 1, size=n)]


@FUZZ
@given(n=st.integers(0, 40), kw=st.integers(1, 3),
       maxb=st.integers(0, 37), seed=st.integers(0, 2**31))
def test_v1_rows_bit_equal_and_lossless(ref, n, kw, maxb, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=(n, kw), dtype=np.uint32)
    pays = _payloads(rng, n, maxb)
    rows = port.encode_bytes_rows(keys, pays, maxb)
    want = ref.encode_bytes_rows(keys, pays, maxb)
    assert rows.shape == (n, kw + port.payload_words(maxb))
    np.testing.assert_array_equal(rows, want)
    k, p = port.decode_bytes_rows(rows, kw)
    rk, rp = ref.decode_bytes_rows(want, kw)
    np.testing.assert_array_equal(k, rk)
    assert p == rp == pays


_KINDS = st.sampled_from(["uint32", "int64", "float64"])


@st.composite
def _schemas(draw):
    kinds = draw(st.lists(_KINDS, min_size=0, max_size=4))
    fields = [(f"c{i}", k) for i, k in enumerate(kinds)]
    if not fields or draw(st.booleans()):
        fields.append(("blob", ("bytes", draw(st.integers(0, 29)))))
    return fields


def _columns(rng, fields, n):
    cols = {}
    for name, kind in fields:
        if kind == "uint32":
            cols[name] = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        elif kind == "int64":
            cols[name] = rng.integers(-2**63, 2**63 - 1, size=n,
                                      dtype=np.int64)
        elif kind == "float64":
            cols[name] = rng.standard_normal(n) * 1e30
        else:
            cols[name] = _payloads(rng, n, kind[1])
    return cols


@FUZZ
@given(fields=_schemas(), n=st.integers(0, 40), kw=st.integers(1, 3),
       seed=st.integers(0, 2**31))
def test_columnar_rows_bit_equal_and_decode(ref, fields, n, kw, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=(n, kw), dtype=np.uint32)
    cols = _columns(rng, fields, n)
    ps, rs = port.RowSchema(fields), ref.RowSchema(fields)
    assert (ps.payload_words, ps.fixed, ps.var_len_word,
            ps.var_slot_words) == (rs.payload_words, rs.fixed,
                                   rs.var_len_word, rs.var_slot_words)
    rows = port.encode_cols(keys, cols, ps)
    want = ref.encode_cols(keys, cols, rs)
    np.testing.assert_array_equal(rows, want)
    k, got = port.decode_cols(rows, kw, ps)
    rk, rgot = ref.decode_cols(want, kw, rs)
    np.testing.assert_array_equal(k, rk)
    for name, kind in fields:
        if isinstance(kind, tuple):
            assert got[name] == rgot[name].to_list() == cols[name]
            np.testing.assert_array_equal(got[name].offsets,
                                          rgot[name].offsets)
        else:
            np.testing.assert_array_equal(got[name], rgot[name])
            np.testing.assert_array_equal(
                np.ascontiguousarray(got[name]).view(np.uint8),
                cols[name].view(np.uint8))


def test_bytes_only_schema_is_v1(ref):
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, size=(64, 2), dtype=np.uint32)
    pays = _payloads(rng, 64, 23)
    v1 = port.encode_bytes_rows(keys, pays, 23)
    col = port.encode_cols(keys, {"payload": pays},
                           port.RowSchema.bytes_only(23))
    np.testing.assert_array_equal(col, v1)
    np.testing.assert_array_equal(col, ref.encode_bytes_rows(keys, pays,
                                                             23))


def test_bytescolumn_reencodes_without_rows(ref):
    """A decoded BytesColumn (offsets + heap) and an ``(offsets, heap)``
    pair encode to the same rows as the list of bytes."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2**32, size=(50, 1), dtype=np.uint32)
    pays = _payloads(rng, 50, 17)
    sch = port.RowSchema([("x", "int64"), ("b", ("bytes", 17))])
    cols = {"x": np.arange(50), "b": pays}
    rows = port.encode_cols(keys, cols, sch)
    _, dec = port.decode_cols(rows, 1, sch)
    bc = dec["b"]
    assert isinstance(bc, port.BytesColumn) and len(bc) == 50
    assert bc[3] == pays[3] and bc[-1] == pays[-1] and bc[1:3] == pays[1:3]
    for b in (bc, (bc.offsets, bc.heap)):
        np.testing.assert_array_equal(
            port.encode_cols(keys, {"x": dec["x"], "b": b}, sch), rows)
    np.testing.assert_array_equal(
        rows, ref.encode_cols(keys, cols, ref.RowSchema(sch.fields)))


def test_decode_views_keep_rows_alive():
    """Fixed columns are views over the rows, and outlive the caller's
    reference to them."""
    sch = port.RowSchema([("v", "float64")])
    rows = port.encode_cols(np.zeros((4, 1), np.uint32),
                            {"v": np.arange(4.0)}, sch)
    _, cols = port.decode_cols(rows, 1, sch)
    assert np.shares_memory(cols["v"], rows)
    del rows
    np.testing.assert_array_equal(cols["v"], np.arange(4.0))


@pytest.mark.parametrize("case", ["oversize", "corrupt", "str", "int",
                                  "count", "cols_missing", "cols_oversize",
                                  "cols_corrupt", "cols_width"])
def test_errors_match_reference(ref, case):
    keys = np.zeros((2, 2), np.uint32)
    sch = [("a", "uint32"), ("b", ("bytes", 8))]

    def run(mod):
        if case == "oversize":
            mod.encode_bytes_rows(keys, [b"z" * 9, b""], 8)
        elif case == "corrupt":
            rows = mod.encode_bytes_rows(keys, [b"ab", b""], 8)
            rows[1, 2] = 999
            mod.decode_bytes_rows(rows, 2)
        elif case == "str":
            mod.encode_bytes_rows(keys, [b"a", "b"], 8)
        elif case == "int":
            mod.encode_bytes_rows(keys, [5, b"b"], 8)
        elif case == "count":
            mod.encode_bytes_rows(keys, [b"a"], 8)
        elif case == "cols_missing":
            mod.encode_cols(keys, {"a": [1, 2]}, mod.RowSchema(sch))
        elif case == "cols_oversize":
            mod.encode_cols(keys, {"a": [1, 2], "b": [b"x" * 9, b""]},
                            mod.RowSchema(sch))
        elif case == "cols_corrupt":
            s = mod.RowSchema(sch)
            rows = mod.encode_cols(keys, {"a": [1, 2], "b": [b"", b""]}, s)
            rows[0, 3] = 77
            mod.decode_cols(rows, 2, s)
        else:
            mod.decode_cols(np.zeros((2, 3), np.uint32), 2,
                            mod.RowSchema(sch))

    with pytest.raises(ValueError) as want:
        run(ref)
    with pytest.raises(ValueError) as got:
        run(port)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fields", [
    [], [("keys", "uint32")], [("a", "uint32"), ("a", "int64")],
    [("b", ("bytes", 4)), ("a", "uint32")], [("a", "int8")],
    [("a", ("bytes", -1))], [("", "uint32")], ["a"]])
def test_schema_validation_matches_reference(ref, fields):
    with pytest.raises(ValueError) as want:
        ref.RowSchema(fields)
    with pytest.raises(ValueError) as got:
        port.RowSchema(fields)
    assert str(got.value) == str(want.value)


def test_schema_spans_and_keep_words(ref):
    fields = [("u", "uint32"), ("i", "int64"), ("f", "float64"),
              ("b", ("bytes", 13))]
    ps, rs = port.RowSchema(fields), ref.RowSchema(fields)
    assert ps == port.RowSchema(fields) and hash(ps) == hash(rs)
    assert repr(ps) == repr(rs)
    for name in ("u", "i", "f", "b"):
        assert ps.column_word_span(name) == rs.column_word_span(name)
    for cols in (("i",), ("f", "u"), ("b",), ("b", "i", "b")):
        assert ps.keep_words(cols, 2) == rs.keep_words(cols, 2)
    with pytest.raises(KeyError):
        ps.keep_words(("nope",), 2)
    one = port.RowSchema.bytes_only(9)
    assert one.is_bytes_only and not ps.is_bytes_only
    assert one.payload_words == port.payload_words(9) == \
        ref.payload_words(9)


def test_counters_and_totals_match_reference(ref):
    """One v1 and one columnar encode/decode add the same bytes and calls
    to each package's process-wide registry."""
    from sparkrdma_tpu.obs.metrics import global_registry as ref_registry

    names = [f"{fam}.{op}_{k}" for fam in ("serde", "serde.columnar")
             for op in ("encode", "decode") for k in ("bytes", "calls")]

    def snap(reg):
        return {n: int(reg.counter(n).value) for n in names}

    rng = np.random.default_rng(6)
    keys = rng.integers(0, 2**32, size=(32, 2), dtype=np.uint32)
    pays = _payloads(rng, 32, 11)
    sch = [("x", "int64"), ("b", ("bytes", 11))]
    deltas = []
    for mod, reg in ((ref, ref_registry()), (port, global_registry())):
        before = snap(reg)
        mod.decode_bytes_rows(mod.encode_bytes_rows(keys, pays, 11), 2)
        s = mod.RowSchema(sch)
        mod.decode_cols(mod.encode_cols(
            keys, {"x": np.arange(32), "b": pays}, s), 2, s)
        deltas.append({n: v - before[n] for n, v in snap(reg).items()})
    assert deltas[0] == deltas[1]
    assert deltas[1]["serde.encode_calls"] == 1
    tot = port.codec_totals()
    assert set(tot) == set(ref.codec_totals())
    assert tot["serde_encode_bytes"] >= tot["serde_columnar_encode_bytes"] \
        > 0


def test_content_digest_matches_reference(ref):
    rows = np.random.default_rng(7).integers(0, 2**32, size=(40, 4),
                                             dtype=np.uint32)
    assert port.rows_content_digest(rows) == ref.rows_content_digest(rows)
    assert port.rows_content_digest(rows[::2]) == \
        ref.rows_content_digest(rows[::2])
