"""Stage-DAG executor: runs an optimized plan on a ShuffleManager.

Counterpart of ``sparkrdma_tpu.plan.executor``. ``PlanExecutor.run``
opens a job trace (``manager.job``), optimizes the DAG
(``plan/optimizer.py``) inside its ``plan_optimize`` stage, keeps the
decisions in :attr:`PlanExecutor.decisions`, counts them and journals
each as a ``{"kind": "plan"}`` line (:func:`plan_line`, the frozen
:data:`PLAN_FIELDS`), then walks the DAG bottom-up, running each node
through the Dataset verbs (a node's explicit ``stage`` opens that
stage). ``run_inline`` does the same under the caller's job and stages.
One executor can run a query SUITE: its exchange-reuse memo
(fingerprint -> exchange output) spans ``run`` calls. The combine hoist,
each reuse and each broadcast join journal their own plan lines.

Per rewrite gate:

- ``plan_pushdown`` OFF: every filter/select node materializes eagerly
  (filtered rows become filler that still ships). ON: they stay lazy and
  the consuming exchange fuses them into ``row_filter`` / ``keep_words``;
  each ``reduce_by_key`` node's combine-gate sample is taken here and
  handed to the exchange as ``combine_hint``.
- ``plan_reuse`` ON: exchange outputs memoize by fingerprint; with a
  MapOutputStore (``conf.spill_dir``) they are also persisted through
  ``checkpoint_segments`` under a fingerprint-derived shuffle id, so a
  restarted process adopts them through ``resume_segments`` and the
  tiered store.
- ``plan_broadcast_join`` ON: marked joins pull the dim side to the host,
  sort its keys and replicate them to every partition; neither side
  exchanges. A dim side with duplicate keys raises
  :class:`BroadcastBuildError` (the reference degrades to the shuffle
  join; the port has no degradation rung).
- ``plan_overlap`` ON: marked deferred dim sources encode on a
  :class:`~sparkrdma_tpu_torch.api.pipeline.HostPrefetcher` worker while
  the fact side's exchanges run. A failed background encode raises (the
  reference encodes again synchronously).

The lookup join of each partition is ``torch.sort(stable=True)`` of the
dim's keys and ``torch.searchsorted`` into them. Every rewrite is
bit-identical on and off at the ``to_host_rows`` level.
"""

from __future__ import annotations

import logging
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.api.dataset import (Dataset, _low_word_hash,
                                             _parts, _valid_nonfiller)
from sparkrdma_tpu_torch.api.pipeline import HostPrefetcher
from sparkrdma_tpu_torch.interop import records_from_torch
from sparkrdma_tpu_torch.kernels.sort import as_unsigned
from sparkrdma_tpu_torch.obs import trace as _trace
from sparkrdma_tpu_torch.obs.journal import SCHEMA_VERSION
from sparkrdma_tpu_torch.plan.nodes import (LogicalPlan, PlanNode,
                                            fingerprint_hex)
from sparkrdma_tpu_torch.plan.optimizer import Decision, optimize

log = logging.getLogger("sparkrdma_tpu_torch.plan")

#: durable reuse-cache shuffle ids: derived from the exchange fingerprint
#: (so a restarted process computes the same id), above the Dataset
#: layer's ``1 << 20`` counter; the manifest also records the FULL
#: fingerprint, so a colliding id costs a cache slot, never wrong data
_REUSE_ID_BASE = 1 << 24
_REUSE_ID_SPAN = 1 << 44

_PAD_KEY = 0xFFFFFFFF

#: the frozen field set of every ``{"kind": "plan"}`` journal line (the
#: reference's; the CLIs read these keys)
PLAN_FIELDS = frozenset({
    "kind", "schema", "ts", "trace_id", "job", "node", "op", "rewrite",
    "fingerprint", "rows", "bytes_saved", "detail",
})


def reuse_shuffle_id(fp: str) -> int:
    """Deterministic checkpoint shuffle id for an exchange fingerprint."""
    return _REUSE_ID_BASE + int(fp, 16) % _REUSE_ID_SPAN


def plan_line(node: str, op: str, rewrite: str, fingerprint: str,
              rows: int = 0, bytes_saved: int = 0,
              detail: str = "") -> dict:
    """One ``{"kind": "plan"}`` journal line (schema v13). ``rewrite``
    is ``pushdown`` / ``reuse`` / ``broadcast_join`` / ``overlap`` /
    ``combine_hoist``. The drift check raises (it survives ``python
    -O``)."""
    tc = _trace.current_trace()
    line = {
        "kind": "plan",
        "schema": SCHEMA_VERSION,
        "ts": time.time(),
        "trace_id": tc.trace_id if tc else "",
        "job": tc.job if tc else "",
        "node": node,
        "op": op,
        "rewrite": rewrite,
        "fingerprint": fingerprint,
        "rows": int(rows),
        "bytes_saved": int(bytes_saved),
        "detail": detail,
    }
    if set(line) != PLAN_FIELDS:
        raise RuntimeError("plan journal line drifted from PLAN_FIELDS "
                           "— update the frozen set and this emitter "
                           "together")
    return line


class BroadcastBuildError(RuntimeError):
    """A broadcast dim build failed (duplicate primary keys)."""


class PlanExecutor:
    """Executes optimized :class:`LogicalPlan` DAGs on one manager."""

    def __init__(self, manager):
        self.manager = manager
        #: exchange-reuse memo: fingerprint -> (records, totals, schema,
        #: projected); spans run() calls
        self._memo: Dict[str, Tuple] = {}
        #: per-run source results (object identity, not a rewrite)
        self._results: Dict[int, object] = {}
        self._prefetcher = None
        self._prefetched: set = set()
        #: what ``optimize`` decided for the last run
        self.decisions: List[Decision] = []

    # ------------------------------------------------------------------
    def run(self, plan: LogicalPlan, job_name: str = ""):
        """Optimize and execute under a job trace named ``job_name`` (else
        the plan's name, else ``"plan"``): host rows for a ``sink`` root,
        a ``GroupedData`` for a ``group_by_key`` root, else a Dataset."""
        m = self.manager
        self._reset_run_state()
        with m.job(job_name or plan.name or "plan"):
            with _trace.stage("plan_optimize"):
                root, self.decisions = optimize(plan.root, m.conf)
            self._journal_decisions(self.decisions)
            return self._exec(root)

    def run_inline(self, plan: LogicalPlan):
        """Optimize and execute under the CALLER's job and stage scopes:
        no job of its own, no ``plan_optimize`` stage (a planner-built
        fragment inside an explicitly staged workload, as q95's
        ``co_partition`` stage)."""
        self._reset_run_state()
        root, self.decisions = optimize(plan.root, self.manager.conf)
        self._journal_decisions(self.decisions)
        return self._exec(root)

    def _journal_decisions(self, decisions: List[Decision]) -> None:
        m = self.manager
        for d in decisions:
            if d.rewrite == "pushdown" and d.detail.startswith("fused"):
                m.metrics.counter("plan.pushdown_sunk").inc()
            m.journal.emit_raw(plan_line(
                d.node, d.op, d.rewrite, d.fingerprint,
                rows=d.rows, bytes_saved=d.bytes_saved, detail=d.detail))

    def _reset_run_state(self) -> None:
        """Per-run source results and prefetch bookkeeping; an aborted
        run's unconsumed encodes are dropped, so a stale Dataset never
        reaches a later run's source node."""
        self._results = {}
        self._prefetched.clear()
        if self._prefetcher is not None:
            self._prefetcher.drain()

    # ------------------------------------------------------------------
    # node dispatch
    # ------------------------------------------------------------------
    def _exec(self, node: PlanNode):
        op = node.op
        if op == "source":
            return self._exec_source(node)
        if op == "filter":
            ds = self._exec(node.children[0])
            return self._eager(ds.filter(node.pred,
                                         cache_key=node.pred_key))
        if op == "select":
            ds = self._exec(node.children[0])
            return self._eager(ds.select(*node.columns))
        if op == "sink":
            return self._exec(node.children[0]).to_host_rows()
        if op == "join":
            return self._exec_join(node)
        ds = self._exec(node.children[0])
        with self._maybe_stage(node.stage):
            if op == "repartition":
                return self._memo_exchange(
                    node.fp, node, lambda: ds.repartition(node.num_parts))
            if op == "sort_by_key":
                return self._memo_exchange(
                    node.fp, node,
                    lambda: ds.sort_by_key(node.samples_per_device))
            if op == "reduce_by_key":
                hint = self._hoist_combine(node, ds)
                return self._memo_exchange(
                    node.fp, node,
                    lambda: ds.reduce_by_key(
                        node.agg, float_payload=node.float_payload,
                        combine_hint=hint))
            if op == "group_by_key":
                # a CSR result, not memoized (the memo holds Datasets)
                return ds.group_by_key()
        raise ValueError(f"unknown plan op {op!r}")

    @staticmethod
    def _maybe_stage(name: str):
        """The node's explicit job-trace stage, if it names one."""
        return _trace.stage(name) if name else nullcontext()

    def _eager(self, ds: Dataset) -> Dataset:
        """Pushdown off materializes pending ops now (filtered rows
        become wire-visible filler); on leaves them to the next
        exchange."""
        if self.manager.conf.plan_pushdown:
            return ds
        return ds._materialize_pending()

    def _exec_source(self, node: PlanNode) -> Dataset:
        hit = self._results.get(id(node))
        if hit is not None:
            return hit
        if node.dataset is not None:
            ds = node.dataset
        elif self._prefetcher is not None and node.fp in self._prefetched:
            self._prefetched.discard(node.fp)
            ds = self._prefetcher.take(node.fp)
        else:
            ds = Dataset.from_host_rows(node.manager or self.manager,
                                        node.rows, schema=node.schema)
        self._results[id(node)] = ds
        return ds

    def _hoist_combine(self, node: PlanNode,
                       ds: Dataset) -> Optional[Tuple[bool, float]]:
        """The combine gate's decision, sampled once per node (pushdown
        on only)."""
        m = self.manager
        if not m.conf.plan_pushdown:
            return None
        use, ratio = m._exchange.plan_combine(ds.records, node.agg)
        m.journal.emit_raw(plan_line(
            node.label, node.op, "combine_hoist", node.fp,
            detail=f"use={use} ratio={ratio:.3f}"))
        return (use, ratio)

    # ------------------------------------------------------------------
    # shuffle-output reuse
    # ------------------------------------------------------------------
    def _memo_exchange(self, fp: str, node: PlanNode,
                       run: Callable[[], Dataset]) -> Dataset:
        m = self.manager
        if not m.conf.plan_reuse:
            return run()
        hit = self._memo.get(fp)
        via = "memo"
        if hit is None and m.store is not None:
            hit = self._try_resume(fp, node)
            via = "resume_segments"
        if hit is not None:
            records, totals, schema, projected = hit
            rows = int(totals.sum())
            m.metrics.counter("plan.reuse_hits").inc()
            m.journal.emit_raw(plan_line(
                node.label, node.op, "reuse", fp, rows=rows,
                bytes_saved=rows * int(records.shape[0]) * 4,
                detail=f"adopted via {via}"))
            ds = Dataset(m, records, totals, schema=schema)
            ds.projected = projected
            return ds
        out = run()
        self._memo[fp] = (out.records, out.totals, out.schema,
                          out.projected)
        if m.store is not None:
            self._persist(fp, out)
        return out

    def _persist(self, fp: str, ds: Dataset) -> None:
        m = self.manager
        sid = reuse_shuffle_id(fp)
        try:
            existing = m.store.load_segment_meta(sid)
        except KeyError:
            existing = None
        if existing is not None and existing.get("plan_fp") not in (None,
                                                                    fp):
            # a derived-id collision keeps the first entry; this
            # fingerprint stays memo-only
            log.warning("plan reuse id collision: shuffle id %d already "
                        "holds fingerprint %s; not persisting %s", sid,
                        existing.get("plan_fp"), fp)
            return
        m.checkpoint_segments(
            sid, [(f"plan{fp}:cols", records_from_torch(ds.records)),
                  (f"plan{fp}:totals", ds.totals.cpu().numpy())],
            plan=None, num_parts=m.runtime.num_partitions,
            extra_meta={"plan_fp": fp})

    def _try_resume(self, fp: str, node: PlanNode) -> Optional[Tuple]:
        """Cross-restart adoption: segment checkpoint -> tiered store. A
        manifest without OUR full fingerprint is a miss."""
        m = self.manager
        sid = reuse_shuffle_id(fp)
        try:
            meta = m.store.load_segment_meta(sid)
        except KeyError:
            return None
        if meta.get("plan_fp") != fp:
            return None
        m.resume_segments(sid)
        try:
            cols = m.tiered.get(f"plan{fp}:cols")
            totals = m.tiered.get(f"plan{fp}:totals")
        except KeyError:
            return None
        records = m.runtime.shard_records(np.ascontiguousarray(cols).T)
        return (records, torch.from_numpy(np.asarray(totals, np.int32)).to(
            m.runtime.device), self._subtree_schema(node), None)

    @staticmethod
    def _subtree_schema(node: PlanNode):
        """Output schema of a resumed exchange: the source's if every op
        on the path preserves the layout, else None."""
        while node.children:
            if node.op in ("reduce_by_key", "group_by_key", "join"):
                return None
            node = node.children[0]
        return node.schema

    # ------------------------------------------------------------------
    # joins
    # ------------------------------------------------------------------
    def _exec_join(self, node: PlanNode) -> Dataset:
        left_node, dim_node = node.children
        self._maybe_prefetch(dim_node)
        left = self._exec(left_node)
        with self._maybe_stage(node.stage):
            if node.broadcast and self.manager.conf.plan_broadcast_join:
                return self._broadcast_join(node, left, dim_node)
            return self._shuffle_join(node, left, dim_node)

    def _maybe_prefetch(self, dim_node: PlanNode) -> None:
        """Start a marked dim source's host encode on the background
        worker before the fact side runs, keyed by its fingerprint (never
        ``id()``, which CPython reuses)."""
        src = dim_node
        while src.children:
            src = src.children[0]
        if not (self.manager.conf.plan_overlap
                and src.op == "source" and src.prefetch
                and src.rows is not None and src.fp):
            return
        if src.fp in self._prefetched or id(src) in self._results:
            return
        if self._prefetcher is None:
            self._prefetcher = HostPrefetcher()
        manager = src.manager or self.manager
        rows, schema = src.rows, src.schema
        self._prefetched.add(src.fp)
        self._prefetcher.submit(
            src.fp,
            lambda: Dataset.from_host_rows(manager, rows, schema=schema))
        self.manager.metrics.counter("plan.overlapped_stages").inc()

    def _shuffle_join(self, node: PlanNode, left: Dataset,
                      dim_node: PlanNode) -> Dataset:
        """Co-partition both sides on the low key word, then each
        partition's primary-key lookup."""
        m = self.manager
        mesh = m.runtime.num_partitions
        key_ix = m.conf.key_words - 1
        part = _low_word_hash(mesh, key_ix)
        fp_l = fingerprint_hex(("xjoin_left", node.children[0].fp,
                                key_ix, mesh))
        fp_d = fingerprint_hex(("xjoin_dim", dim_node.fp, key_ix, mesh))
        l2 = self._memo_exchange(
            fp_l, node, lambda: left._exchange(part, mesh, op="join"))
        dim = self._exec(dim_node)
        d2 = self._memo_exchange(
            fp_d, node, lambda: dim._exchange(part, mesh, op="join"))
        kw = m.conf.key_words
        out = torch.empty_like(l2.records)
        for lc, lt, dc, dt, o in zip(_parts(l2.records, mesh),
                                     l2.totals.tolist(),
                                     _parts(d2.records, mesh),
                                     d2.totals.tolist(), _parts(out, mesh)):
            vd = _valid_nonfiller(dc, dt, kw)
            dk = torch.where(vd, as_unsigned(dc[key_ix]), _PAD_KEY)
            sd, order = torch.sort(dk, stable=True)
            self._lookup(lc, lt, sd, dc[kw][order], node, o)
        return Dataset(m, out, l2.totals, schema=node.schema)

    def _broadcast_join(self, node: PlanNode, left: Dataset,
                        dim_node: PlanNode) -> Dataset:
        """Replicate the (small) dim table to every partition: neither
        side exchanges. The same rows as the shuffle join; only their
        placement differs, which the next exchange makes canonical."""
        m = self.manager
        with _trace.auto_stage("broadcast_build"):
            sd, attrs, n_slots = self._broadcast_build(dim_node)
        left = left._materialize_pending()
        mesh = m.runtime.num_partitions
        out = torch.empty_like(left.records)
        totals = left.totals.tolist()
        for lc, lt, o in zip(_parts(left.records, mesh), totals,
                             _parts(out, mesh)):
            self._lookup(lc, lt, sd, attrs, node, o)
        m.metrics.counter("plan.broadcast_joins").inc()
        m.journal.emit_raw(plan_line(
            node.label, node.op, "broadcast_join", node.fp,
            rows=sum(totals), detail=f"dim replicated ({n_slots} slots)"))
        return Dataset(m, out, left.totals, schema=node.schema)

    def _broadcast_build(self, dim_node: PlanNode):
        """The dim side on the host: its sorted unique keys (as unsigned
        int64) and attributes on the device, padded to a power-of-two
        count with all-ones keys, and that count. Duplicate keys
        raise."""
        dim = self._exec(dim_node)
        rows = dim.to_host_rows()
        kw = self.manager.conf.key_words
        keys = rows[:, kw - 1].astype(np.uint32)
        attrs = rows[:, kw].astype(np.uint32)
        live = keys != 0          # key 0: null/padding rows, never match
        keys, attrs = keys[live], attrs[live]
        if len(keys) and len(np.unique(keys)) != len(keys):
            raise BroadcastBuildError(
                f"dim side has duplicate primary keys "
                f"({len(keys) - len(np.unique(keys))} collisions)")
        order = np.argsort(keys, kind="stable")
        keys, attrs = keys[order], attrs[order]
        n_pad = 1 << max(0, int(len(keys) - 1).bit_length()) \
            if len(keys) else 1
        pad = n_pad - len(keys)
        sd = np.concatenate([keys, np.full(pad, _PAD_KEY, np.uint32)])
        at = np.concatenate([attrs, np.zeros(pad, np.uint32)])
        dev = self.manager.runtime.device
        return (torch.from_numpy(sd.astype(np.int64)).to(dev),
                torch.from_numpy(at.view(np.int32)).to(dev), n_pad)

    def _lookup(self, lc: torch.Tensor, lt: int, sd: torch.Tensor,
                attrs: torch.Tensor, node: PlanNode,
                out: torch.Tensor) -> None:
        """One partition's lookup of left records ``lc`` (``lt`` valid)
        in sorted dim keys ``sd`` (unsigned, int64) riding ``attrs``,
        written into ``out`` (``lc``'s shape): a found row's key becomes
        payload word ``key_from`` and payload word ``attr_to`` takes the
        attribute; every other row becomes zeros."""
        kw = self.manager.conf.key_words
        vw = self.manager.conf.val_words
        key_ix = kw - 1
        vl = _valid_nonfiller(lc, lt, kw)
        lk = as_unsigned(lc[key_ix])
        idx = torch.searchsorted(sd, lk).clamp_(max=sd.numel() - 1)
        # keys 0 (the null group) and all-ones (filler, padding) never
        # match, in the shuffle and the broadcast path alike
        live = (lk != 0) & (lk != _PAD_KEY)
        found = (sd[idx] == lk) & vl & live
        out[:key_ix] = 0
        torch.mul(lc[kw + node.key_from], found, out=out[key_ix])
        for j in range(vw):
            src = attrs[idx] if j == node.attr_to else lc[kw + j]
            torch.mul(src, found, out=out[kw + j])

    # ------------------------------------------------------------------
    def invalidate_reuse(self) -> None:
        """Drop the in-memory memo and every durable plan-reuse
        checkpoint in the manager's store: the escape hatch for a named
        source whose content changed under its name."""
        self._memo.clear()
        m = self.manager
        if m.store is None:
            return
        for sid in m.store.list_segment_checkpoints():
            if sid < _REUSE_ID_BASE:
                continue
            try:
                is_plan = "plan_fp" in m.store.load_segment_meta(sid)
            except (KeyError, ValueError):
                continue
            if is_plan:
                m.store.delete(sid)

    def close(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None


__all__ = ["PlanExecutor", "PLAN_FIELDS", "plan_line", "reuse_shuffle_id",
           "BroadcastBuildError"]
