"""Logical query plan over the Dataset verbs — the lazy DAG layer.

Counterpart of ``sparkrdma_tpu.plan.nodes``. A :class:`LogicalPlan` is an
immutable handle onto a DAG of :class:`PlanNode` shuffle-verb nodes
(``filter`` / ``select`` / ``repartition`` / ``sort_by_key`` /
``reduce_by_key`` / ``group_by_key`` / ``join`` plus ``source`` / ``sink``
nodes carrying the :class:`~sparkrdma_tpu_torch.api.serde.RowSchema`),
built from ``Dataset.plan()`` or :meth:`LogicalPlan.dataset`. Nothing
runs until :meth:`LogicalPlan.execute` hands the DAG to
:class:`~sparkrdma_tpu_torch.plan.executor.PlanExecutor`, which runs the
optimizer (``plan/optimizer.py``) first.

The plan's ``join`` is the DIMENSION-LOOKUP join of the TPC-DS star
shape (``workloads/tpcds.py``): the right side is a dimension table whose
low key word is a unique primary key; each left row with key ``k`` looks
up dim row ``k``, its key becomes payload word ``key_from`` and payload
word ``attr_to`` receives the dimension attribute (the dim's first
payload word). Unmatched left rows become zeros (key 0 is the null
group, which the final aggregate discards), so the join output keeps the
LEFT side's record shape.

Every node carries a canonical FINGERPRINT (:func:`node_fingerprint`): a
content hash of ``repr`` of a tuple of the subtree's ops, parameters and
source identities. The tuple holds only Python scalars, strings and
tuples, never a tensor, so a plan over the same named, digested sources
fingerprints as the reference's does. The executor's reuse memo and its
durable ``checkpoint_segments`` cache key on it, and both outlive one
plan, so a source identity is never recycled:

- deferred host-row sources fingerprint by a CONTENT DIGEST of their
  rows;
- unnamed Dataset sources by their ``content_digest`` when they have one
  (``Dataset.from_host_rows`` stamps it), else by a process-unique,
  never reissued object token;
- NAMED sources by ``(name, content digest)``; a dataset without a digest
  falls back to the name alone, a CONTRACT that the name means stable
  content for as long as a reuse cache may serve it
  (``PlanExecutor.invalidate_reuse()`` breaks it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import uuid
import weakref
from typing import Callable, List, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.api.serde import rows_content_digest

#: ops that run at least one exchange when executed (the stage
#: boundaries of the DAG)
EXCHANGE_OPS = frozenset({
    "repartition", "sort_by_key", "reduce_by_key", "group_by_key",
    "join",
})

#: exchange ops a ``filter``/``select`` node commutes with: they only
#: move/reorder rows, never rewrite record words, so a predicate or
#: projection applied below them is bit-identical to one applied above
LAYOUT_PRESERVING_EXCHANGES = frozenset({"repartition", "sort_by_key"})


@dataclasses.dataclass
class PlanNode:
    """One logical operator. A plain mutable dataclass: the optimizer
    rewrites the DAG in place (on a private copy — see
    ``optimizer.clone_dag``) and annotates nodes with its decisions."""

    op: str
    children: List["PlanNode"] = dataclasses.field(default_factory=list)
    # --- source ------------------------------------------------------
    dataset: Optional[object] = None     # pre-materialized Dataset
    rows: Optional[np.ndarray] = None    # deferred host rows [N, W]
    schema: object = None                # RowSchema (source and sink)
    manager: Optional[object] = None     # deferred sources need one
    name: str = ""                       # stable reuse identity
    # --- filter / select --------------------------------------------
    pred: Optional[Callable] = None
    pred_key: Optional[Tuple] = None     # stable predicate cache_key
    columns: Optional[Tuple[str, ...]] = None
    # --- exchange verbs ----------------------------------------------
    num_parts: Optional[int] = None      # repartition
    samples_per_device: int = 256        # sort_by_key
    agg: str = "sum"                     # reduce_by_key
    float_payload: bool = False
    # --- join (dimension lookup) -------------------------------------
    key_from: int = 0                    # payload word -> next key
    attr_to: int = 0                     # payload word <- dim attribute
    # --- tracing -----------------------------------------------------
    stage: str = ""                      # explicit job-trace stage name
    # --- optimizer annotations (set by plan/optimizer.py) ------------
    label: str = ""                      # node id, "op#i"
    fp: str = ""                         # canonical fingerprint hex
    fuses_into: str = ""                 # pushdown: target exchange op
    broadcast: bool = False              # join: broadcast selected
    prefetch: bool = False               # source: overlap-encode it
    # --- fingerprint cache --------------------------------------------
    content_fp: str = ""                 # cached digest of deferred rows


#: per-process nonce folded into every object token, so a token can
#: never equal one minted by a different process (a restarted executor
#: must MISS the durable cache for identity-fingerprinted sources)
_PROCESS_NONCE = uuid.uuid4().hex[:8]
_token_counter = itertools.count()
_OBJ_TOKENS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: fallback table for _obj_token on objects that cannot be weak-keyed;
#: pins the object alive, which is the price of a stable identity
_PINNED_TOKENS: dict = {}


def _obj_token(obj) -> str:
    """Process-unique NON-RECYCLABLE identity token for a live object.

    Unlike ``id()``, a token is never reissued after the object dies
    (the counter only moves forward), so fingerprints built from it can
    safely key caches that outlive the object — CPython id reuse would
    otherwise alias a fresh dataset/predicate with a dead one's cache
    entry."""
    try:
        tok = _OBJ_TOKENS.get(obj)
        if tok is None:
            tok = f"{_PROCESS_NONCE}.{next(_token_counter)}"
            _OBJ_TOKENS[obj] = tok
        return tok
    except TypeError:
        # unhashable / non-weakrefable callables: keep them pinned so
        # their id cannot be recycled either
        hit = _PINNED_TOKENS.get(id(obj))
        if hit is not None and hit[0] is obj:
            return hit[1]
        tok = f"{_PROCESS_NONCE}.{next(_token_counter)}"
        _PINNED_TOKENS[id(obj)] = (obj, tok)
        return tok


def _source_ident(node: PlanNode) -> Tuple:
    """Cache-safe identity of a source node (see module docstring)."""
    if node.rows is not None:
        if not node.content_fp:
            node.content_fp = rows_content_digest(node.rows)
        digest = node.content_fp
    else:
        digest = getattr(node.dataset, "content_digest", "") or ""
    if node.name:
        return ("named", node.name, digest)
    if digest:
        return ("anon", digest)
    return ("anon", _obj_token(node.dataset))


def _fp_tuple(node: PlanNode) -> Tuple:
    """Canonical structure tuple for hashing. Source identity is
    content-addressed (or object-token-addressed) — see module
    docstring — so two sources only ever share a fingerprint when
    adopting one's exchange output for the other is bit-identical."""
    if node.op == "source":
        shape = (tuple(node.rows.shape) if node.rows is not None
                 else tuple(node.dataset.records.shape))
        return ("source", _source_ident(node), shape)
    kids = tuple(_fp_tuple(c) for c in node.children)
    if node.op == "filter":
        return ("filter",
                node.pred_key or ("anon_pred", _obj_token(node.pred)),
                kids)
    if node.op == "select":
        return ("select", node.columns, kids)
    if node.op == "repartition":
        return ("repartition", node.num_parts, kids)
    if node.op == "sort_by_key":
        return ("sort_by_key", node.samples_per_device, kids)
    if node.op == "reduce_by_key":
        return ("reduce_by_key", node.agg, node.float_payload, kids)
    if node.op == "group_by_key":
        return ("group_by_key", kids)
    if node.op == "join":
        return ("join", node.key_from, node.attr_to, kids)
    if node.op == "sink":
        return ("sink", kids)
    raise ValueError(f"unknown plan op {node.op!r}")


def fingerprint_hex(payload: Tuple) -> str:
    """12-hex-digit content hash of a canonical structure tuple."""
    return hashlib.sha256(repr(payload).encode()).hexdigest()[:12]


def node_fingerprint(node: PlanNode) -> str:
    """Canonical fingerprint of the subtree rooted at ``node``."""
    return fingerprint_hex(_fp_tuple(node))


class LogicalPlan:
    """Immutable builder handle onto a :class:`PlanNode` DAG.

    Every verb returns a NEW handle; the underlying nodes are shared,
    which is exactly what lets two branches reference one subtree (the
    reuse rewrite's input shape). Terminal nodes (``group_by_key``,
    ``sink``) reject further chaining.
    """

    def __init__(self, root: PlanNode, name: str = "plan"):
        self.root = root
        self.name = name

    # -- sources ------------------------------------------------------
    @staticmethod
    def dataset(ds, name: str = "") -> "LogicalPlan":
        """Source node over an already-materialized Dataset (the
        ``Dataset.plan()`` entry point)."""
        node = PlanNode("source", dataset=ds, schema=ds.schema,
                        manager=ds.manager, name=name)
        return LogicalPlan(node, name=name or "plan")

    @staticmethod
    def from_host_rows(manager, rows: np.ndarray, schema=None,
                       name: str = "") -> "LogicalPlan":
        """DEFERRED source: host rows that encode to device only when
        the executor reaches the node — which is what lets the
        stage-overlap rewrite start this encode on a background worker
        while an earlier stage's exchange tail drains."""
        node = PlanNode("source", rows=np.asarray(rows), schema=schema,
                        manager=manager, name=name)
        return LogicalPlan(node, name=name or "plan")

    # -- verb builders ------------------------------------------------
    def _chain(self, node: PlanNode) -> "LogicalPlan":
        if self.root.op in ("group_by_key", "sink"):
            raise ValueError(
                f"cannot chain {node.op!r} after terminal node "
                f"{self.root.op!r}")
        node.children = [self.root]
        return LogicalPlan(node, name=self.name)

    def filter(self, pred: Callable,
               cache_key: Optional[Tuple] = None) -> "LogicalPlan":
        """Predicate node (lazy; a torch function ``int32[W, n] ->
        bool[n]`` over full-width records, words read with
        ``as_unsigned``). Give a stable ``cache_key``: it is the reuse
        fingerprint's component (an unkeyed function fingerprints by a
        process-unique object token, which defeats cross-plan reuse)."""
        key = cache_key or getattr(pred, "cache_key", None)
        return self._chain(PlanNode("filter", pred=pred, pred_key=key))

    def select(self, *columns: str) -> "LogicalPlan":
        """Projection node: keep only the named schema columns."""
        if not columns:
            raise ValueError("select needs at least one column name")
        return self._chain(PlanNode("select", columns=tuple(columns)))

    def repartition(self, num_parts: Optional[int] = None,
                    stage: str = "") -> "LogicalPlan":
        return self._chain(PlanNode("repartition", num_parts=num_parts,
                                    stage=stage))

    def sort_by_key(self, samples_per_device: int = 256,
                    stage: str = "") -> "LogicalPlan":
        return self._chain(PlanNode(
            "sort_by_key", samples_per_device=samples_per_device,
            stage=stage))

    def reduce_by_key(self, op: str = "sum", float_payload: bool = False,
                      stage: str = "") -> "LogicalPlan":
        return self._chain(PlanNode("reduce_by_key", agg=op,
                                    float_payload=float_payload,
                                    stage=stage))

    def group_by_key(self, stage: str = "") -> "LogicalPlan":
        """Terminal: executes to a ``GroupedData`` CSR result."""
        return self._chain(PlanNode("group_by_key", stage=stage))

    def join(self, dim: "LogicalPlan", key_from: int = 0,
             attr_to: Optional[int] = None, schema=None,
             stage: str = "") -> "LogicalPlan":
        """Dimension-lookup inner join (see module docstring): ``dim``'s
        low key word must be a unique primary key (1-based; key 0 is
        the null group, 0xFFFFFFFF the filler sentinel — neither ever
        matches); the output keeps this side's record shape with its
        key replaced by payload word ``key_from`` and payload word
        ``attr_to`` (default: ``key_from`` itself, the TPC-DS q64
        chaining convention) receiving the dim attribute.
        Broadcast-eligible when the dim side fits
        ``conf.plan_broadcast_records``.

        ``schema`` optionally declares the OUTPUT payload layout — the
        planner's analogue of Catalyst operator output attributes.
        Joins reroute payload words, so the input schema cannot
        survive; declaring the rerouted layout here re-enables
        ``select`` (projection pushdown) downstream of the join."""
        node = PlanNode("join", key_from=int(key_from),
                        attr_to=int(key_from if attr_to is None
                                    else attr_to),
                        schema=schema, stage=stage)
        if self.root.op in ("group_by_key", "sink"):
            raise ValueError("cannot join after a terminal node")
        if dim.root.op in ("group_by_key", "sink"):
            raise ValueError("cannot join against a terminal plan")
        node.children = [self.root, dim.root]
        return LogicalPlan(node, name=self.name)

    def sink(self) -> "LogicalPlan":
        """Terminal host-exit node: executes to the collected valid
        host rows. Carries the propagated RowSchema so a reader of the
        plan (or ``explain()``) can see the output layout without
        executing."""
        node = PlanNode("sink", schema=self._propagated_schema())
        return self._chain(node)

    def _propagated_schema(self):
        """Schema surviving layout-preserving ops (aggregators and
        joins rewrite payload words, so it drops there — the same rule
        ``Dataset._exchange`` applies at runtime)."""
        node = self.root
        while node.children:
            if node.op in ("reduce_by_key", "group_by_key", "join"):
                return None
            node = node.children[0]
        return node.schema

    # -- execution ----------------------------------------------------
    def execute(self, executor=None, manager=None):
        """Optimize and run the DAG. Pass an existing
        :class:`~sparkrdma_tpu_torch.plan.executor.PlanExecutor` to share its
        exchange-reuse memo across plans (a query suite); otherwise a
        fresh one is built from ``manager`` (or the plan's own source
        manager)."""
        if executor is None:
            from sparkrdma_tpu_torch.plan.executor import PlanExecutor

            executor = PlanExecutor(manager or self._manager())
        return executor.run(self)

    def _manager(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.manager is not None:
                return n.manager
            stack.extend(n.children)
        raise ValueError("plan has no source node carrying a manager")

    def explain(self) -> str:
        """Indented operator tree with fingerprints — debugging aid."""
        lines: List[str] = []

        def walk(node: PlanNode, depth: int) -> None:
            extra = ""
            if node.op == "source":
                extra = f" name={node.name!r}" if node.name else " (anon)"
            elif node.op == "join":
                extra = (f" key_from={node.key_from}"
                         f" attr_to={node.attr_to}"
                         + (" BROADCAST" if node.broadcast else ""))
            elif node.op == "select":
                extra = f" columns={list(node.columns or ())}"
            elif node.op == "reduce_by_key":
                extra = f" agg={node.agg}"
            fp = node.fp or node_fingerprint(node)
            lines.append("  " * depth + f"{node.op}{extra} [{fp}]")
            for c in node.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)


__all__ = ["PlanNode", "LogicalPlan", "node_fingerprint",
           "fingerprint_hex", "EXCHANGE_OPS",
           "LAYOUT_PRESERVING_EXCHANGES"]
