"""Optimizer pass pipeline over a ``PlanNode`` DAG (``plan/nodes.py``).

Counterpart of ``sparkrdma_tpu.plan.optimizer``: plain Python, the same
passes and decisions. Four rewrites, each gated by its own ShuffleConf
knob, each bit-identical on and off:

1. **Pushdown propagation** (``conf.plan_pushdown``): sink ``filter`` /
   ``select`` nodes below every layout-preserving exchange
   (``repartition`` / ``sort_by_key``) so they fuse into the EARLIEST
   exchange's ``row_filter`` / ``keep_words``. The executor also hoists
   each ``reduce_by_key`` node's combine-gate sample to plan time.
2. **Shuffle-output reuse** (``conf.plan_reuse``): exchange nodes carry
   canonical fingerprints; the executor memoizes exchange outputs by
   them (and persists them through ``checkpoint_segments``).
3. **Broadcast-join selection** (``conf.plan_broadcast_join``): a
   plan-time row-count estimate of the dimension side; when it fits
   ``conf.plan_broadcast_records`` the join replicates the dim table to
   every partition and skips BOTH sides' exchanges.
4. **Stage overlap** (``conf.plan_overlap``): deferred host-row sources
   feeding a join's dim side are marked for a background encode.

The optimizer never mutates the caller's DAG: ``clone_dag`` copies it
first, keeping shared subtrees shared. Passes 2–4 only ANNOTATE; the
executor acts on the annotations.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from sparkrdma_tpu_torch.plan.nodes import (
    EXCHANGE_OPS,
    LAYOUT_PRESERVING_EXCHANGES,
    PlanNode,
    _fp_tuple,
    fingerprint_hex,
)


@dataclasses.dataclass
class Decision:
    """One planner decision (the reference journals each as a
    ``{"kind": "plan"}`` line)."""

    rewrite: str        # pushdown | broadcast_join | overlap
    node: str           # node label, "op#i"
    op: str
    fingerprint: str
    rows: int = 0
    bytes_saved: int = 0
    detail: str = ""


def clone_dag(node: PlanNode,
              memo: Optional[Dict[int, PlanNode]] = None) -> PlanNode:
    """Deep-copy the DAG structure, shallow-copying node payloads and
    preserving shared-subtree identity (one original node -> one
    clone, however many parents reach it)."""
    if memo is None:
        memo = {}
    hit = memo.get(id(node))
    if hit is not None:
        return hit
    clone = dataclasses.replace(node, children=[])
    memo[id(node)] = clone
    clone.children = [clone_dag(c, memo) for c in node.children]
    return clone


def _walk(node: PlanNode, out: List[PlanNode],
          seen: Dict[int, int]) -> None:
    """Postorder unique-node walk; ``seen`` doubles as refcount."""
    if id(node) in seen:
        seen[id(node)] += 1
        return
    seen[id(node)] = 1
    for c in node.children:
        _walk(c, out, seen)
    out.append(node)


def _annotate(root: PlanNode) -> Tuple[List[PlanNode], Dict[int, int]]:
    """Assign labels + canonical fingerprints to every node."""
    nodes: List[PlanNode] = []
    refs: Dict[int, int] = {}
    _walk(root, nodes, refs)
    counts: Dict[str, int] = {}
    for n in nodes:
        i = counts.get(n.op, 0)
        counts[n.op] = i + 1
        n.label = f"{n.op}#{i}"
        n.fp = fingerprint_hex(_fp_tuple(n))
    return nodes, refs


def _sink_pushables(root: PlanNode, refs: Dict[int, int],
                    decisions: List[Decision]) -> PlanNode:
    """Rewrite 1 (structural half): bubble filter/select below
    layout-preserving exchanges. Shared subtrees (refcount > 1) are a
    barrier — sinking through them would leak the predicate into the
    other consumer's result."""

    def sink(node: PlanNode) -> PlanNode:
        node.children = [sink(c) for c in node.children]
        if node.op in ("filter", "select") and node.children:
            child = node.children[0]
            if (child.op in LAYOUT_PRESERVING_EXCHANGES
                    and refs.get(id(child), 1) == 1):
                node.children = list(child.children)
                child.children = [sink(node)]
                decisions.append(Decision(
                    rewrite="pushdown", node=node.label, op=node.op,
                    fingerprint=node.fp,
                    detail=f"sunk below {child.label}"))
                return child
        return node

    return sink(root)


def _refingerprint(root: PlanNode) -> None:
    """Recompute fingerprints after a structural rewrite: a sunk filter
    changes what its exchange SHIPS, so the exchange must not keep the
    pre-rewrite fingerprint — the reuse memo would alias it with the
    bare exchange from a plan that never had the filter. Labels keep
    their pre-rewrite values (they are node ids, not cache keys)."""
    for n in _all_nodes(root):
        n.fp = fingerprint_hex(_fp_tuple(n))


def _mark_fusions(root: PlanNode, decisions: List[Decision]) -> None:
    """Rewrite 1 (fusion half): a filter/select whose consumer chain
    (walking up through other filter/select nodes) reaches an exchange
    op will fuse into that exchange's ``row_filter``/``keep_words``
    because the executor leaves it lazy. Record the target."""
    parent: Dict[int, PlanNode] = {}
    stack = [root]
    visited = set()
    while stack:
        n = stack.pop()
        if id(n) in visited:
            continue
        visited.add(id(n))
        for c in n.children:
            parent.setdefault(id(c), n)
            stack.append(c)
    for n in _all_nodes(root):
        if n.op not in ("filter", "select"):
            continue
        up = parent.get(id(n))
        while up is not None and up.op in ("filter", "select"):
            up = parent.get(id(up))
        if up is not None and up.op in EXCHANGE_OPS:
            n.fuses_into = up.label
            decisions.append(Decision(
                rewrite="pushdown", node=n.label, op=n.op,
                fingerprint=n.fp,
                detail=f"fused into {up.label}"))


def _all_nodes(root: PlanNode) -> List[PlanNode]:
    nodes: List[PlanNode] = []
    _walk(root, nodes, {})
    return nodes


def estimate_rows(node: PlanNode) -> Optional[int]:
    """Plan-time row-count estimate: exact for sources, pass-through
    upper bound across row-preserving ops, unknown past aggregates and
    joins (conservative — broadcast selection then declines). Across
    processes a loaded dataset holds an even share of its rows, and an
    exchange's output is unknown (its global count would take a
    collective), so every process decides alike."""
    if node.op == "source":
        if node.rows is not None:
            return int(node.rows.shape[0])
        ds = node.dataset
        procs = ds.manager.runtime.process_count
        if procs > 1 and ds.exchanged:
            return None
        return int(ds.totals.sum()) * procs
    if node.op in ("filter", "select", "repartition",
                   "sort_by_key") and node.children:
        return estimate_rows(node.children[0])
    return None


def _select_broadcasts(root: PlanNode, conf,
                       decisions: List[Decision]) -> None:
    """Rewrite 3: mark joins whose dim side fits the broadcast budget."""
    limit = int(conf.plan_broadcast_records)
    if limit <= 0:
        return
    for n in _all_nodes(root):
        if n.op != "join":
            continue
        est = estimate_rows(n.children[1])
        if est is not None and est <= limit:
            n.broadcast = True
            decisions.append(Decision(
                rewrite="broadcast_join", node=n.label, op=n.op,
                fingerprint=n.fp, rows=est,
                detail=f"dim ~{est} rows <= {limit}, replicate"))


def _mark_overlaps(root: PlanNode, decisions: List[Decision]) -> None:
    """Rewrite 4: a deferred-source dim side of a join can encode on a
    background worker while the left (fact) subtree's exchanges drain."""
    for n in _all_nodes(root):
        if n.op != "join":
            continue
        left, dim = n.children
        if not _has_exchange(left):
            continue
        src = dim
        while src.children:
            src = src.children[0]
        if src.op == "source" and src.rows is not None and not src.prefetch:
            src.prefetch = True
            decisions.append(Decision(
                rewrite="overlap", node=src.label, op="source",
                fingerprint=src.fp, rows=int(src.rows.shape[0]),
                detail=f"dim encode overlaps {n.label} left subtree"))


def _has_exchange(node: PlanNode) -> bool:
    return any(n.op in EXCHANGE_OPS for n in _all_nodes(node))


def optimize(root: PlanNode, conf) -> Tuple[PlanNode, List[Decision]]:
    """Run the gated pass pipeline over a private clone of ``root``.

    Returns the optimized root plus the decision list the executor
    keeps (and counts in the ``plan.*`` counters). With every knob off
    this is label/fingerprint annotation only — the executor then
    replays the DAG exactly as written (the naive control arm of the
    bit-identity tests).
    """
    decisions: List[Decision] = []
    memo: Dict[int, PlanNode] = {}
    root = clone_dag(root, memo)
    nodes, refs = _annotate(root)
    if getattr(conf, "plan_pushdown", False):
        n_before = len(decisions)
        root = _sink_pushables(root, refs, decisions)
        if len(decisions) > n_before:       # structure changed
            _refingerprint(root)
        _mark_fusions(root, decisions)
    if getattr(conf, "plan_broadcast_join", False):
        _select_broadcasts(root, conf, decisions)
    if getattr(conf, "plan_overlap", False):
        _mark_overlaps(root, decisions)
    return root, decisions


__all__ = ["optimize", "Decision", "clone_dag", "estimate_rows"]
