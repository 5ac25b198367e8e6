"""Spark-verb convenience layer over the ShuffleManager SPI.

Counterpart of ``sparkrdma_tpu.api.dataset``'s record-level verbs. A
:class:`Dataset` wraps a columnar record batch ``int32[W, D*cap]`` on the
runtime's device (``MeshRuntime.shard_records``), partition ``d`` in
column group ``d``, with ``totals[d]`` valid records each. Every shuffle
verb runs one planned exchange through the public SPI and returns a NEW
Dataset holding a copy of the exchange output, so Datasets are plain
value handles and never see the pool's consume-before-reuse contract.
The reference runs each per-device step as a ``shard_map`` program; here
it is a function over the stacked partitions, looping over them where a
step is per partition.

ACROSS PROCESSES (a runtime spanning a ``torch.distributed`` group) a
Dataset holds this process's partitions: records ``[W, L*cap]`` and
totals ``(L,)``, ``L = runtime.local_partitions``, as the reader returns
them. It runs what the reference runs there: the exchange verbs on a
dataset loaded from the host (``filter`` / ``select`` views of it
included), and ``to_host_payloads`` / ``to_host_columns`` of such a
dataset, which give this process's rows. The rest raises
``NotImplementedError`` at entry, naming the line where the reference
reads a global array on the host (ROADMAP A.12): ``count``,
``to_host_rows``, ``collect_rows``, the grouping and join verbs, and any
verb on a dataset whose totals an exchange or the caller gave
(:attr:`Dataset.exchanged`).

RESERVED NULL KEY: the all-ones key (every key word 0xFFFFFFFF) is
reserved by this layer. When a chained verb re-densifies a padded
Dataset, filler rows carry the null key; ``to_host_rows``/``count``
filter them out and the join masks them. ``from_host_rows`` refuses user
rows with that key.

A Dataset may carry a :class:`~sparkrdma_tpu_torch.api.serde.RowSchema`
(``from_host_columns``, ``from_host_payloads(schema=)``,
``from_host_rows(schema=)``): layout-preserving verbs keep it, an
aggregator drops it, ``select`` projects by its columns (lazily, fused
into the next exchange's ``keep_words``), and ``to_host_columns``
decodes through it. Byte payloads and columns load and unload through
the pipelined codec (``api/pipeline.py``). ``plan`` lifts a dataset into
the query planner (``plan/``). Under :meth:`ShuffleManager.job` every
exchange-backed verb opens a job-trace stage named after itself
(``repartition``, ``sort_by_key``, ``reduce_by_key``, ``distinct``,
``group_by_key``, ``cogroup``, ``join``), unless the caller has a stage
open already (``obs/trace.py auto_stage``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.api.pipeline import (decode_cols_from_device,
                                              decode_rows_from_device,
                                              encode_cols_to_device,
                                              encode_rows_to_device)
from sparkrdma_tpu_torch.api.serde import payload_words, rows_content_digest
from sparkrdma_tpu_torch.api.shuffle_manager import ShuffleManager
from sparkrdma_tpu_torch.config import size_class, size_class_fine
from sparkrdma_tpu_torch.exchange.partitioners import (hash_partitioner,
                                                       mul32,
                                                       range_partitioner)
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.kernels.aggregate import combine_by_key_cols
from sparkrdma_tpu_torch.kernels.group import cogroup_tables, group_runs_cols
from sparkrdma_tpu_torch.kernels.sort import as_unsigned, sort_by_lead_cols
from sparkrdma_tpu_torch.meta.map_output import DuplicateShuffleIdError
from sparkrdma_tpu_torch.meta.sampling import compute_splitters, make_sampler
from sparkrdma_tpu_torch.obs import trace as _trace
from sparkrdma_tpu_torch.runtime.distributed import refuse_across_processes
from sparkrdma_tpu_torch.workloads.join import _local_join, _local_join_rows

#: Dataset-layer shuffle ids live in their own range, clear of the ids a
#: user registers on the same manager
_ID_COUNTER = itertools.count(1 << 20)

_NULL = np.uint32(0xFFFFFFFF)
_NULL_WORD = -1                 # the int32 bit-view of 0xFFFFFFFF
_LOW = 0xFFFFFFFF

#: where the reference fails across processes (it reads an array that
#: spans other processes' devices on the host)
_REF = "sparkrdma_tpu/api/dataset.py"
_REF_CHAINED = f"{_REF}:660"            # _dense_records' totals


def _parts(x: torch.Tensor, mesh: int) -> List[torch.Tensor]:
    """The per-partition column groups of a stacked batch (views)."""
    cap = x.shape[-1] // mesh
    return [x[..., d * cap:(d + 1) * cap] for d in range(mesh)]


def _valid_nonfiller(r: torch.Tensor, t: int, kw: int) -> torch.Tensor:
    """One partition's validity: inside the valid prefix AND not a
    reserved null-key filler row (ALL key words 0xFFFFFFFF). The one
    implementation of the filler contract."""
    filler = (r[:kw] == _NULL_WORD).all(dim=0)
    return (torch.arange(r.shape[1], device=r.device) < t) & ~filler


def _low_word_hash(num_parts: int, key_ix: int) -> Callable:
    """Hash-partition on the LOW key word only — the join key (a
    full-key hash would send rows that agree on the low word but not the
    high one to different partitions, losing their matches)."""

    def part(records: torch.Tensor) -> torch.Tensor:
        return mul32(as_unsigned(records[key_ix]), 2654435761) % num_parts

    part.cache_key = ("lowhash", num_parts, key_ix)
    return part


def _valid_prefixes(x: torch.Tensor, totals) -> List[torch.Tensor]:
    """Each partition's first ``totals[d]`` columns (views)."""
    return [p[..., :int(t)] for p, t in zip(_parts(x, len(totals)), totals)]


def _strip_filler(m: ShuffleManager, r: torch.Tensor, t: int
                  ) -> Tuple[torch.Tensor, int]:
    """One partition with its filler and padding zeroed and its valid
    records moved, in order, to the front: ``(records, valid count)``."""
    kw = m.conf.key_words
    v = _valid_nonfiller(r, t, kw)
    r = torch.where(v[None], r, 0)
    mode = m._exchange.sort_mode(m.conf.record_words)
    return sort_by_lead_cols(r, ~v, mode), int(v.sum())


def _join_counts(m: ShuffleManager, a: "Dataset", b: "Dataset",
                 key_ix: int) -> Tuple[np.ndarray, float]:
    """Filler-stripped :func:`_local_join` of every partition: the
    per-partition match counts and the sum of payload products over all
    partitions (the reference's ``psum``)."""
    mesh = m.runtime.local_partitions
    counts, sums = [], []
    for ra, ta, rb, tb in zip(_parts(a.records, mesh), a.totals.tolist(),
                              _parts(b.records, mesh), b.totals.tolist()):
        ra, ta = _strip_filler(m, ra, ta)
        rb, tb = _strip_filler(m, rb, tb)
        c, s = _local_join(ra, ta, rb, tb, key_ix=key_ix,
                           pay_ix=m.conf.key_words)
        counts.append(c)
        sums.append(s)
    return (np.asarray(counts, dtype=np.int64),
            float(torch.stack(sums).sum()))


def _join_rows(m: ShuffleManager, a: "Dataset", b: "Dataset",
               out_capacity: int, key_ix: int):
    """Filler-stripped :func:`_local_join_rows` of every partition:
    ``(joined [kw + 2*vw, D*out_capacity], counts int64[D])``."""
    mesh = m.runtime.local_partitions
    kw, vw = m.conf.key_words, m.conf.val_words
    counts, pieces = [], []
    for ra, ta, rb, tb in zip(_parts(a.records, mesh), a.totals.tolist(),
                              _parts(b.records, mesh), b.totals.tolist()):
        ra, ta = _strip_filler(m, ra, ta)
        rb, tb = _strip_filler(m, rb, tb)
        joined, c = _local_join_rows(ra, ta, rb, tb, out_capacity, key_ix,
                                     kw, vw, vw)
        pieces.append(joined)
        counts.append(c)
    return torch.cat(pieces, dim=1), np.asarray(counts, dtype=np.int64)


def _check_schema_width(manager: ShuffleManager, schema) -> None:
    if schema is not None and \
            schema.payload_words != manager.conf.val_words:
        raise ValueError(
            f"schema declares {schema.payload_words} payload words but "
            f"the manager was configured with "
            f"val_words={manager.conf.val_words}")


def _check_keys(keys: np.ndarray, what: str = "keys") -> None:
    """Refuse host keys carrying the RESERVED all-ones key, which later
    verbs would drop silently."""
    if keys.ndim == 2 and keys.size and \
            bool((keys == _NULL).all(axis=1).any()):
        raise ValueError(
            f"input {what} use the reserved all-ones (0xFFFFFFFF) key, "
            "which this layer reserves for padding filler — remap that "
            "key before loading")


@dataclasses.dataclass
class GroupedData:
    """``rdd.groupByKey`` result in CSR form (``kernels/group.py``).

    Partition ``d``: ``group_totals[d]`` unique keys live in
    ``groups[:, d*cap : d*cap + group_totals[d]]`` as ``(key words...,
    count, offset)`` rows; key ``g``'s values are the ``count``
    contiguous records ``values[:, d*cap + offset : ... + count]``
    (offsets are partition-local). ``values`` holds the full key-sorted
    records, so payload rows start at ``key_words``."""

    manager: ShuffleManager
    values: torch.Tensor           # [W, mesh * cap] key-sorted records
    groups: torch.Tensor           # [key_words + 2, mesh * cap]
    group_totals: np.ndarray       # [mesh] unique keys per partition
    totals: np.ndarray             # [mesh] valid records per partition

    def to_host(self) -> Dict[tuple, np.ndarray]:
        """Test-scale view: key tuple -> payload rows ``uint32[count,
        vw]``."""
        kw = self.manager.conf.key_words
        mesh = self.manager.runtime.num_partitions
        cap = self.values.shape[1] // mesh
        vals = records_from_torch(self.values)
        grp = records_from_torch(self.groups)
        out: Dict[tuple, np.ndarray] = {}
        for d in range(mesh):
            g = grp[:, d * cap: d * cap + int(self.group_totals[d])]
            for i in range(g.shape[1]):
                key = tuple(int(g[k, i]) for k in range(kw))
                cnt, off = int(g[kw, i]), int(g[kw + 1, i])
                if key in out:  # not an assert: must hold under python -O
                    raise RuntimeError(
                        f"grouped key {key} appears on two partitions — "
                        "exchange partitioning invariant violated")
                out[key] = vals[kw:, d * cap + off: d * cap + off + cnt].T
        return out


@dataclasses.dataclass
class CoGroupedData:
    """``rdd.cogroup`` result: per key (values_a, values_b) in CSR form.

    ``cotable`` rows are ``(key words..., count_a, offset_a, count_b,
    offset_b)`` over the UNION of both sides' keys (absent side: count
    0); offsets are partition-local into the respective values buffer,
    as in :class:`GroupedData`."""

    manager: ShuffleManager
    values_a: torch.Tensor         # [Wa, mesh * cap_a]
    values_b: torch.Tensor         # [Wb, mesh * cap_b]
    cotable: torch.Tensor          # [key_words + 4, mesh * cap_u]
    union_totals: np.ndarray       # [mesh]

    def to_host(self) -> Dict[tuple, Tuple[np.ndarray, np.ndarray]]:
        """Test-scale view: key -> (payload rows A, payload rows B)."""
        kw = self.manager.conf.key_words
        mesh = self.manager.runtime.num_partitions
        ca = self.values_a.shape[1] // mesh
        cb = self.values_b.shape[1] // mesh
        cu = self.cotable.shape[1] // mesh
        va, vb = records_from_torch(self.values_a), records_from_torch(self.values_b)
        ct = records_from_torch(self.cotable)
        out: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}
        for d in range(mesh):
            t = ct[:, d * cu: d * cu + int(self.union_totals[d])]
            for i in range(t.shape[1]):
                key = tuple(int(t[k, i]) for k in range(kw))
                if key in out:  # not an assert: must hold under python -O
                    raise RuntimeError(
                        f"cogrouped key {key} appears on two partitions — "
                        "exchange partitioning invariant violated")
                na, oa = int(t[kw, i]), int(t[kw + 1, i])
                nb, ob = int(t[kw + 2, i]), int(t[kw + 3, i])
                out[key] = (va[kw:, d * ca + oa: d * ca + oa + na].T,
                            vb[kw:, d * cb + ob: d * cb + ob + nb].T)
        return out


class Dataset:
    """A distributed batch of fixed-width records with Spark-ish verbs."""

    def __init__(self, manager: ShuffleManager, records: torch.Tensor,
                 totals: Optional[torch.Tensor] = None, schema=None):
        self.manager = manager
        self.records = records          # columnar int32 [W, local * cap]
        #: the totals came from an exchange (a verb's result, a filter /
        #: select view of one) or from the caller, not from a load: the
        #: reference's are then a sharded array, which no verb reads
        #: across processes
        self.exchanged = totals is not None
        mesh = manager.runtime.local_partitions
        if totals is None:
            totals = torch.full((mesh,), records.shape[1] // mesh,
                                dtype=torch.int32, device=records.device)
        self.totals = totals
        #: the payload words' RowSchema, if declared (None: opaque words)
        self.schema = schema
        #: pending predicate and projection (filter / select pushdown):
        #: consumed by the NEXT exchange, where filtered rows never take a
        #: slot and dropped words never move, or by
        #: :meth:`_materialize_pending` for host exits
        self._pending_filter: Optional[Callable] = None
        self._pending_select: Optional[Tuple[str, ...]] = None
        #: the live columns after a projection ran (None: all); dropped
        #: columns read as zeros
        self.projected: Optional[Tuple[str, ...]] = None
        #: memo of :meth:`_materialize_pending`: chained host exits run the
        #: filter pass once
        self._materialized: Optional["Dataset"] = None
        #: content digest of the host rows this dataset was built from
        #: (:meth:`from_host_rows` only; derived datasets leave it empty)
        self.content_digest: str = ""

    def _refuse(self, what: str, reference: str) -> None:
        """Refuse ``what`` across processes, as the reference fails at
        ``reference`` (ROADMAP A.12)."""
        refuse_across_processes(self.manager.runtime, what, reference)

    def _refuse_chained(self, what: str, reference: str = _REF_CHAINED
                        ) -> None:
        """Refuse ``what`` across processes on a dataset whose totals an
        exchange or the caller gave (:attr:`exchanged`)."""
        if self.exchanged:
            self._refuse(f"{what} on the output of an exchange", reference)

    def _view(self, records: torch.Tensor) -> "Dataset":
        """A dataset over ``records`` that keeps this one's totals, schema
        and :attr:`exchanged` mark (a filter, a select, their
        materialization)."""
        ds = Dataset(self.manager, records, self.totals, schema=self.schema)
        ds.exchanged = self.exchanged
        return ds

    # ------------------------------------------------------------------
    @classmethod
    def from_host_rows(cls, manager: ShuffleManager, rows: np.ndarray,
                       schema=None) -> "Dataset":
        """Rows ``uint32[N, W]`` -> a Dataset on the runtime's device (N
        divisible by the partition count). Refuses rows carrying the
        RESERVED all-ones key, which later verbs would drop silently.
        ``schema`` declares the payload layout of already encoded rows
        (its ``payload_words`` must equal ``val_words``)."""
        rows = np.asarray(rows)
        _check_schema_width(manager, schema)
        _check_keys(rows[:, :manager.conf.key_words], "rows")
        ds = cls(manager, manager.runtime.shard_records(rows), schema=schema)
        ds.content_digest = rows_content_digest(rows)
        return ds

    @classmethod
    def from_host_payloads(cls, manager: ShuffleManager, keys: np.ndarray,
                           payloads, max_payload_bytes: int, *,
                           chunk_records: Optional[int] = None,
                           overlap: bool = True,
                           schema=None) -> "Dataset":
        """Byte payloads -> a Dataset through the pipelined codec
        (``api/pipeline.py``): ``keys`` ``uint32[N, key_words]``, N
        payloads of at most ``max_payload_bytes`` each, and
        ``payload_words(max_payload_bytes)`` equal to ``val_words``. A
        bytes-only ``schema`` takes the columnar codec (bit-identical
        rows) when ``conf.serde_schema_columnar`` is on, and marks the
        dataset so :meth:`to_host_payloads` decodes through it."""
        conf = manager.conf
        pw = payload_words(max_payload_bytes)
        if pw != conf.val_words:
            raise ValueError(
                f"max_payload_bytes={max_payload_bytes} needs "
                f"val_words={pw} but the manager was configured with "
                f"val_words={conf.val_words} — size the ShuffleConf with "
                f"payload_words(max_payload_bytes)")
        if schema is not None:
            if not schema.is_bytes_only:
                raise ValueError(
                    "from_host_payloads takes a bytes-only schema "
                    "(use from_host_columns for multi-column schemas)")
            if schema.var_max_bytes != max_payload_bytes:
                raise ValueError(
                    f"schema bytes column caps {schema.var_max_bytes} "
                    f"bytes but max_payload_bytes={max_payload_bytes}")
        keys = np.asarray(keys)
        _check_keys(keys)
        if schema is not None and conf.serde_schema_columnar:
            records = encode_cols_to_device(
                manager, keys, {schema.var_name: payloads}, schema,
                chunk_records=chunk_records, overlap=overlap)
        else:
            records = encode_rows_to_device(
                manager, keys, payloads, max_payload_bytes,
                chunk_records=chunk_records, overlap=overlap)
        return cls(manager, records, schema=schema)

    @classmethod
    def from_host_columns(cls, manager: ShuffleManager, keys: np.ndarray,
                          columns, schema, *,
                          chunk_records: Optional[int] = None,
                          overlap: bool = True) -> "Dataset":
        """Named host columns -> a Dataset under ``schema``
        (``schema.payload_words`` equal to ``val_words``), through the
        pipelined columnar codec."""
        _check_schema_width(manager, schema)
        keys = np.asarray(keys)
        _check_keys(keys)
        records = encode_cols_to_device(
            manager, keys, columns, schema,
            chunk_records=chunk_records, overlap=overlap)
        return cls(manager, records, schema=schema)

    def to_host_payloads(self, *, overlap: bool = True):
        """Inverse of :meth:`from_host_payloads`: ``(keys uint32[N, kw],
        payloads)``, filler rows dropped, each partition's window copied
        down while the one before decodes. With a bytes-only schema (and
        ``serde_schema_columnar``) the payloads are a lazy
        :class:`~sparkrdma_tpu_torch.api.serde.BytesColumn`, which
        compares and iterates like a list of bytes. Across processes: this
        process's partitions' rows, of a dataset loaded from the host."""
        self._refuse_chained("to_host_payloads",
                             "sparkrdma_tpu/api/pipeline.py:245")
        if self._pending_filter is not None or \
                self._pending_select is not None:
            return self._materialize_pending().to_host_payloads(
                overlap=overlap)
        sch = self.schema
        if (sch is not None and sch.is_bytes_only
                and self.manager.conf.serde_schema_columnar):
            keys, cols = decode_cols_from_device(
                self.manager, self.records, self.totals, sch,
                overlap=overlap)
            return keys, cols[sch.var_name]
        return decode_rows_from_device(self.manager, self.records,
                                       self.totals, overlap=overlap)

    def to_host_columns(self, *, overlap: bool = True):
        """Decode through the dataset's schema: ``(keys uint32[N, kw],
        {name: column})``, filler rows dropped; fixed columns are numpy
        views over each partition's fetched window, the bytes column a
        ``BytesColumn``. Across processes: this process's partitions'
        rows, of a dataset loaded from the host."""
        self._refuse_chained("to_host_columns",
                             "sparkrdma_tpu/api/pipeline.py:479")
        if self._pending_filter is not None or \
                self._pending_select is not None:
            return self._materialize_pending().to_host_columns(
                overlap=overlap)
        if self.schema is None:
            raise ValueError(
                "to_host_columns needs a schema-carrying dataset — "
                "declare a RowSchema at from_host_columns/"
                "from_host_payloads time")
        return decode_cols_from_device(self.manager, self.records,
                                       self.totals, self.schema,
                                       overlap=overlap)

    def to_host_rows(self) -> np.ndarray:
        """Valid records only, concatenated in partition order (filler
        rows filtered out); pending :meth:`filter` / :meth:`select` ops
        apply here."""
        self._refuse("to_host_rows", f"{_REF}:531")
        if self._pending_filter is not None or \
                self._pending_select is not None:
            return self._materialize_pending().to_host_rows()
        rt = self.manager.runtime
        # only the valid prefixes leave the device (an aggregator's
        # output keeps a few rows in a capacity sized by raw counts)
        rows = rt.host_rows(torch.cat(_valid_prefixes(
            self.records, self.totals.tolist()), dim=1))
        kw = self.manager.conf.key_words
        null = (rows[:, :kw] == _NULL).all(axis=1)
        return rows[~null]

    @property
    def count(self) -> int:
        """Valid, non-filler record count, reduced on the device."""
        self._refuse("count", f"{_REF}:575")
        if self._pending_filter is not None:
            return self._materialize_pending().count
        m = self.manager
        mesh = m.runtime.local_partitions
        kw = m.conf.key_words
        return int(sum(_valid_nonfiller(r, t, kw).sum() for r, t in zip(
            _parts(self.records, mesh), self.totals.tolist())))

    # ------------------------------------------------------------------
    def _exchange(self, partitioner: Callable, num_parts: int,
                  key_ordering: bool = False,
                  aggregator: Optional[str] = None,
                  float_payload: bool = False,
                  op: str = "exchange",
                  combine_hint: Optional[Tuple[bool, float]] = None
                  ) -> "Dataset":
        """:meth:`_exchange_traced` inside a job-trace stage named ``op``
        (a no-op outside a job, or when the caller opened a stage)."""
        with _trace.auto_stage(op):
            return self._exchange_traced(partitioner, num_parts,
                                         key_ordering, aggregator,
                                         float_payload, combine_hint)

    def _exchange_traced(self, partitioner: Callable, num_parts: int,
                         key_ordering: bool = False,
                         aggregator: Optional[str] = None,
                         float_payload: bool = False,
                         combine_hint: Optional[Tuple[bool, float]] = None
                         ) -> "Dataset":
        """One exchange of this dataset through the SPI, the pending
        filter pushed into it; a recycled output is copied out of the
        pool's recycling before the shuffle is unregistered. A pending select
        becomes the read's ``keep_words``; the schema survives a
        layout-preserving exchange and an aggregator drops it."""
        m = self.manager
        sel = self._pending_select
        keep_words = (self.schema.keep_words(sel, m.conf.key_words)
                      if sel is not None else None)
        # skip ids a user registered explicitly on this manager: draw
        # until one sticks; any other registry error propagates
        while True:
            sid = next(_ID_COUNTER)
            try:
                handle = m.register_shuffle(sid, num_parts, partitioner)
                break
            except DuplicateShuffleIdError:
                continue
        try:
            m.get_writer(handle).write(self._dense_records()).stop(True)
            out, totals = m.get_reader(
                handle, key_ordering=key_ordering, aggregator=aggregator,
                float_payload=float_payload,
                row_filter=self._pending_filter, keep_words=keep_words,
                combine_hint=combine_hint).read()
            # a fused read's output is the exchange's recycled buffer,
            # overwritten by its next read: copy it; a streaming read's
            # is a fresh tensor, which the dataset may keep as it is
            recycled = any(out is buf
                           for buf in m._exchange._out_prev.values())
            res = Dataset(m, out.clone() if recycled else out,
                          totals.clone(),
                          schema=self.schema if aggregator is None
                          else None)
            if sel is not None and aggregator is None:
                res.projected = sel
            return res
        finally:
            m.unregister_shuffle(sid)

    def _dense_records(self) -> torch.Tensor:
        """Writer input: the exchange counts every column, so a padded
        Dataset is re-densified first. Each partition compacts its valid
        records to the front (a stable validity sort) and the uniform
        capacity shrinks to the fine size class of the largest
        partition's count; the tail carries the RESERVED null key, so
        every later verb can exclude it. Records never leave their
        partition (moving them is the exchange's job). Across processes
        only a loaded dataset gets here, which is dense (every process
        then writes the same width)."""
        tot = self.totals.tolist()
        if sum(tot) == self.records.shape[1]:
            return self.records
        m = self.manager
        mesh = m.runtime.local_partitions
        cap = self.records.shape[1] // mesh
        kw = m.conf.key_words
        mode = m._exchange.sort_mode(self.records.shape[0])
        new_cap = min(cap, size_class_fine(max(1, max(tot))))
        live = torch.arange(new_cap, device=self.records.device)
        pieces = []
        for r, t in zip(_parts(self.records, mesh), tot):
            valid = _valid_nonfiller(r, t, kw)
            packed = sort_by_lead_cols(r, ~valid, mode)[:, :new_cap]
            pieces.append(torch.where((live < valid.sum())[None], packed,
                                      _NULL_WORD))
        return torch.cat(pieces, dim=1)

    def _materialize_pending(self) -> "Dataset":
        """Apply a pending :meth:`filter` / :meth:`select` eagerly — the
        escape hatch for consumers that cannot fuse them (host exits,
        verbs that rewrite payload words before their shuffle).
        Filtered-out rows become null-key filler, then projected-away
        words become 0, as the fused path gives them. Memoized on this
        instance."""
        pred = self._pending_filter
        sel = self._pending_select
        if pred is None and sel is None:
            return self
        if self._materialized is None:
            recs = self.records
            if pred is not None:
                recs = torch.where(pred(recs)[None], recs, _NULL_WORD)
            if sel is not None:
                live = torch.zeros((recs.shape[0], 1), dtype=torch.bool,
                                   device=recs.device)
                live[list(self.schema.keep_words(
                    sel, self.manager.conf.key_words))] = True
                recs = torch.where(live, recs, 0)
            res = self._view(recs)
            if sel is not None:
                res.projected = sel
            self._materialized = res
        return self._materialized

    # ------------------------------------------------------------------
    # the Spark verbs
    # ------------------------------------------------------------------
    def filter(self, pred: Callable,
               cache_key: Optional[Tuple] = None) -> "Dataset":
        """LOGICAL predicate pushdown (rdd.filter, lazy): the predicate
        fuses into the next shuffle, where dropped rows never take a
        slot; host exits apply it eagerly. ``pred`` maps full-width
        records ``int32[W, n]`` (uint32 words: read them with
        ``as_unsigned``) to ``bool[n]``, elementwise over the columns.
        Chained filters AND together. ``cache_key`` names the predicate
        for the exchange's output-buffer key."""
        if cache_key is not None:
            pred.cache_key = cache_key
        prev = self._pending_filter
        if prev is not None:
            old, new = prev, pred

            def pred(r, _old=old, _new=new):  # noqa: F811 — composed
                return _old(r) & _new(r)

            pred.cache_key = ("and",
                              getattr(old, "cache_key", None) or id(old),
                              getattr(new, "cache_key", None) or id(new))
        ds = self._view(self.records)
        ds._pending_filter = pred
        ds._pending_select = self._pending_select
        ds.projected = self.projected
        return ds

    def select(self, *columns: str) -> "Dataset":
        """LOGICAL projection pushdown (df.select, lazy): keep only the
        named schema columns. The next exchange ships only the key words
        and these columns' words (the rest come back zero), and host
        exits zero the dropped words eagerly. Needs a schema; a chained
        select names a subset of the previous one."""
        if self.schema is None:
            raise ValueError(
                "select needs a schema-carrying dataset — declare a "
                "RowSchema at load time")
        names = tuple(columns)
        if not names:
            raise ValueError("select needs at least one column name")
        for n in names:
            self.schema.column_word_span(n)  # validates the name
        if self._pending_select is not None:
            gone = [n for n in names if n not in self._pending_select]
            if gone:
                raise ValueError(
                    f"column(s) {gone} were already projected away by a "
                    f"previous select({list(self._pending_select)})")
        ds = self._view(self.records)
        ds._pending_filter = self._pending_filter
        ds._pending_select = names
        ds.projected = self.projected
        return ds

    def repartition(self, num_parts: Optional[int] = None) -> "Dataset":
        """Hash-repartition across the partitions (rdd.repartition)."""
        self._refuse_chained("repartition")
        m = self.manager
        num_parts = num_parts or m.runtime.num_partitions
        part = hash_partitioner(num_parts, m.conf.key_words)
        return self._exchange(part, num_parts, op="repartition")

    def sort_by_key(self, samples_per_device: int = 256) -> "Dataset":
        """Globally sort by the key words (rdd.sortByKey): sample ->
        range partition -> exchange -> the fused per-partition sort. A
        pending filter applies first, so the sample sees only survivors
        (filtered rows become filler, which sorts to the tail). Across
        processes every process computes the splitters from the
        all-gathered sample."""
        self._refuse_chained("sort_by_key")
        m = self.manager
        mesh = m.runtime.num_partitions
        kw = m.conf.key_words
        base = self._materialize_pending()
        records = base._dense_records()
        samples = make_sampler(mesh, kw, samples_per_device,
                               runtime=m.runtime,
                               collectives=m.collectives)(records)
        part = range_partitioner(compute_splitters(samples, mesh), kw)
        return Dataset(m, records, schema=base.schema)._exchange(
            part, mesh, key_ordering=True, op="sort_by_key")

    def reduce_by_key(self, op: str = "sum", float_payload: bool = False,
                      combine_hint: Optional[Tuple[bool, float]] = None
                      ) -> "Dataset":
        """Combine payloads per unique key (rdd.reduceByKey): hash
        co-partition and the reader's fused aggregator. ``combine_hint``
        is a hoisted combine-gate decision (``ShuffleExchange
        .plan_combine``); None keeps the sampling gate."""
        self._refuse_chained("reduce_by_key")
        m = self.manager
        num_parts = m.runtime.num_partitions
        part = hash_partitioner(num_parts, m.conf.key_words)
        return self._exchange(part, num_parts, aggregator=op,
                              float_payload=float_payload,
                              op="reduce_by_key",
                              combine_hint=combine_hint)

    def distinct(self) -> "Dataset":
        """Unique FULL rows (rdd.distinct): a full-row hash exchange puts
        duplicates together, then each partition deduplicates with the
        combine-by-key machinery keyed on every word."""
        self._refuse_chained("distinct")
        m = self.manager
        w = m.conf.record_words
        kw = m.conf.key_words
        num_parts = m.runtime.num_partitions
        pack = m._exchange.sort_mode(w) == "pack"

        def full_row_hash(records):
            h = torch.full((records.shape[1],), 0x9E3779B9,
                           dtype=torch.int64, device=records.device)
            for i in range(w):
                h = mul32(h ^ as_unsigned(records[i]), 0x85EBCA6B)
                h = ((h << 13) | (h >> 19)) & _LOW
            return h % num_parts

        full_row_hash.cache_key = ("fullhash", num_parts, w)
        a = self._exchange(full_row_hash, num_parts, op="distinct")
        outs, totals = [], []
        for r, t in zip(_parts(a.records, m.runtime.local_partitions),
                        a.totals.tolist()):
            out, nuniq = combine_by_key_cols(r, _valid_nonfiller(r, t, kw),
                                             w, pack=pack)
            outs.append(out)
            totals.append(nuniq)
        return Dataset(m, torch.cat(outs, dim=1), torch.tensor(
            totals, dtype=torch.int32, device=a.records.device),
            schema=self.schema)

    def count_by_key(self) -> "Dataset":
        """Per-key record counts (rdd.countByKey): rows become ``(key
        words, count, 0...)``, counts in the first payload word, summed
        across the partitions by the fused aggregator. A pending filter
        applies first (it sees full-width records, which this rewrites)."""
        self._refuse_chained("count_by_key")
        m = self.manager
        if m.conf.val_words < 1:
            raise ValueError("count_by_key needs at least one payload "
                             "word to hold the count")
        kw = m.conf.key_words
        base = self._materialize_pending()
        ones = torch.zeros_like(base.records[kw:])
        ones[0] = 1
        counted = Dataset(m, torch.cat([base.records[:kw], ones]),
                          base.totals)
        counted.exchanged = base.exchanged
        return counted.reduce_by_key("sum")

    def _grouped(self, a: "Dataset"):
        """Per-partition filler stripping and CSR grouping of an exchange
        output: ``(values, groups, n_groups int[D], totals int[D])``."""
        m = self.manager
        kw = m.conf.key_words
        mode = m._exchange.sort_mode(m.conf.record_words)
        mesh = m.runtime.local_partitions
        vals, grps, ngs, tots = [], [], [], []
        for r, t in zip(_parts(a.records, mesh), a.totals.tolist()):
            values, groups, n_groups, total = group_runs_cols(
                r, _valid_nonfiller(r, t, kw), kw, wide=mode == "wide",
                ride_words=m.conf.wide_sort_ride_words, pack=mode == "pack")
            vals.append(values)
            grps.append(groups)
            ngs.append(n_groups)
            tots.append(total)
        return (torch.cat(vals, dim=1), torch.cat(grps, dim=1),
                np.asarray(ngs, dtype=np.int64),
                np.asarray(tots, dtype=np.int64))

    def group_by_key(self) -> GroupedData:
        """Materialize per-key value lists (rdd.groupByKey): full-key
        hash co-partition, then each partition key-sorts its records and
        emits the CSR ``(groups, values)`` pair."""
        self._refuse("group_by_key", f"{_REF}:1015")
        m = self.manager
        num_parts = m.runtime.num_partitions
        part = hash_partitioner(num_parts, m.conf.key_words)
        values, groups, n_groups, totals = self._grouped(
            self._exchange(part, num_parts, op="group_by_key"))
        return GroupedData(m, values, groups, n_groups, totals)

    def cogroup(self, other: "Dataset") -> CoGroupedData:
        """Group BOTH datasets by key and pair the groups (rdd.cogroup):
        the union of keys, per key (A values, B values). Both sides take
        the same full-key hash partitioner, so equal keys meet on one
        partition."""
        self._refuse("cogroup", f"{_REF}:1064")
        m = self.manager
        if m is not other.manager:
            raise ValueError("cogroup requires Datasets on the same "
                             "manager (one mesh)")
        kw = m.conf.key_words
        mesh = m.runtime.num_partitions
        part = hash_partitioner(mesh, kw)
        local = m.runtime.local_partitions
        values_a, groups_a, na, _ = self._grouped(
            self._exchange(part, mesh, op="cogroup"))
        values_b, groups_b, nb, _ = self._grouped(
            other._exchange(part, mesh, op="cogroup"))
        tables, n_union = [], []
        for ga, a_n, gb, b_n in zip(_parts(groups_a, local), na,
                                    _parts(groups_b, local), nb):
            table, n_u = cogroup_tables(ga, int(a_n), gb, int(b_n), kw)
            tables.append(table)
            n_union.append(n_u)
        return CoGroupedData(m, values_a, values_b, torch.cat(tables, dim=1),
                             np.asarray(n_union, dtype=np.int64))

    def _co_partition(self, other: "Dataset"):
        """Both sides exchanged by the low-word hash (the join key)."""
        m = self.manager
        if m is not other.manager:
            raise ValueError("join requires Datasets on the same manager "
                             "(one mesh)")
        if m.conf.val_words < 1:
            raise ValueError("join needs at least one payload word")
        key_ix = m.conf.key_words - 1
        mesh = m.runtime.num_partitions
        part = _low_word_hash(mesh, key_ix)
        return (self._exchange(part, mesh, op="join"),
                other._exchange(part, mesh, op="join"), key_ix)

    def join_count(self, other: "Dataset") -> Tuple[int, float]:
        """Inner-join cardinality and sum of payload products against
        ``other`` on the LOW key word (the aggregate join of TPC-DS-style
        queries). The reserved null key never matches."""
        self._refuse("join_count", f"{_REF}:1086")
        a, b, key_ix = self._co_partition(other)
        counts, sums = _join_counts(self.manager, a, b, key_ix)
        return int(counts.sum()), sums

    def join(self, other: "Dataset", out_capacity: Optional[int] = None
             ) -> Tuple[torch.Tensor, np.ndarray]:
        """MATERIALIZED inner join on the LOW key word (rdd.join):
        ``(joined_cols, totals)``. ``joined_cols`` is columnar
        ``int32[key_words + 2*val_words, D * out_capacity]``: per
        partition the first ``totals[d]`` columns are joined rows ``(key
        words, A payload, B payload)``, the tail zero; a key matching M
        rows on one side and N on the other gives M×N rows.

        ``out_capacity`` per partition: None runs a counting pass first
        and sizes it to the power-of-two class of the largest count; an
        explicit capacity below a partition's match count raises."""
        self._refuse("join", f"{_REF}:1122")
        m = self.manager
        a, b, key_ix = self._co_partition(other)
        if out_capacity is None:
            per, _ = _join_counts(m, a, b, key_ix)
            out_capacity = size_class(max(1, int(per.max())))
        joined, totals = _join_rows(m, a, b, out_capacity, key_ix)
        if int(totals.max(initial=0)) > out_capacity:
            raise ValueError(
                f"join overflow: a partition matched {int(totals.max())} "
                f"rows > out_capacity {out_capacity}; pass a larger "
                "out_capacity (or None to auto-size)")
        return joined, totals

    def plan(self, name: str = ""):
        """Lift this dataset into a lazy
        :class:`~sparkrdma_tpu_torch.plan.LogicalPlan` source node: verbs
        chained on the plan build a DAG that the optimizer rewrites
        before anything runs (``plan/``). The source's reuse identity is
        its ``content_digest`` when it has one, else a process-unique
        token; a ``name`` asserts that what carries it holds stable
        content (see ``plan/nodes.py``)."""
        from sparkrdma_tpu_torch.plan import LogicalPlan

        return LogicalPlan.dataset(self, name=name)

    @staticmethod
    def collect_rows(cols: torch.Tensor, totals) -> np.ndarray:
        """Valid rows of a padded columnar result (e.g. :meth:`join`'s),
        concatenated in partition order, as host ``uint32[n, W]``. One
        process only, as the reference (ROADMAP A.12)."""
        refuse_across_processes(None, "collect_rows", f"{_REF}:1165")
        return np.ascontiguousarray(records_from_torch(torch.cat(
            _valid_prefixes(cols, np.asarray(totals).tolist()), dim=1)).T)


__all__ = ["Dataset", "GroupedData", "CoGroupedData"]
