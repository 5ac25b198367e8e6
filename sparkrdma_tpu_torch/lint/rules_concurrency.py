"""Interprocedural concurrency rules over the call graph + lock model.

Five rules share one analysis pass (memoized on the
:class:`~sparkrdma_tpu_torch.lint.core.LintContext`):

- **lock-order** — builds the acquisition graph (lock A held while lock
  B is acquired, lexically or through resolved call chains) and reports
  every cycle with a witness path. ``scripts/torch_srlint.py --dot`` exports
  the same graph as Graphviz DOT.
- **blocking-under-lock** — no file/socket I/O, ``subprocess`` spawns,
  unbounded ``queue.Queue.get/put``, ``time.sleep``, ``Thread.join``,
  ``faults.fire``, or journal ``emit``/``emit_raw`` while a declared
  lock is held, traced through callees. Ops a callee performs under its
  *own* lock are that callee's business (reported there, or suppressed
  there with a reason) and do not propagate to callers.
- **guarded-by-inference** — thread-escape analysis rooted at every
  ``Thread(target=self.m)`` / ``Timer(..., self.m)``: attributes written
  inside the background entry point's intraclass closure and accessed
  from foreground methods must carry a ``# guarded-by:`` annotation
  (the finding suggests the annotation text). This turns the opt-in
  ``guarded-by`` rule into default-on coverage for shared mutable state.
- **condition-wait-loop** — ``Condition.wait`` only under the
  condition's own lock and only inside a ``while``-predicate loop
  (``wait_for`` encodes the predicate itself, so it only needs the
  lock).
- **thread-lifecycle** — every started ``threading.Thread`` must be
  joined somewhere its owner can reach (``stop()``/``close()`` for
  attribute-stored threads, the creating function for locals), or be
  explicitly ``# srlint: ignore[thread-lifecycle]``-documented as
  daemon-by-design.

All five inherit the engine's conservatism contract: unresolved calls
and undeclared names produce no edges and no findings — a missed
finding is a lint gap, an invented one would poison the meta-test that
pins the repo clean.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import Finding, LintContext, SourceFile, rule
from .callgraph import CallGraph, FuncInfo, build_callgraph
from .locks import (THREAD_SAFE_CTORS, FileLockModel, LockDecl,
                    ThreadDecl, build_lock_models, with_lock_decls)

#: attribute calls treated as file/socket I/O wherever they appear
_IO_ATTRS = frozenset({
    "write", "writelines", "read", "readinto", "recv", "recvfrom",
    "send", "sendall", "sendto", "connect", "accept", "flush", "fsync",
    "tofile", "fromfile",
})

#: ``subprocess.<attr>`` calls that block on a child process
_SUBPROC_ATTRS = frozenset({"run", "call", "check_call", "check_output",
                            "Popen", "communicate"})

#: bound on traced effects per function / chain depth — keeps the
#: propagation linear even on pathological fixture graphs
_MAX_EFFECTS = 64
_MAX_DEPTH = 8


def _recv_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)


@dataclasses.dataclass(frozen=True)
class _Op:
    """One blocking operation, at its source location."""

    desc: str
    rel: str
    line: int
    chain: Tuple[str, ...] = ()     # callee shorts walked to reach it
    #: lock ids this op is allowed to hold (Condition.wait releases its
    #: own mutex while waiting)
    exempt: FrozenSet[str] = frozenset()


@dataclasses.dataclass(frozen=True)
class _Acq:
    """One lock acquisition, at its source location."""

    lock_id: str
    kind: str
    rel: str
    line: int
    chain: Tuple[str, ...] = ()


@dataclasses.dataclass
class _Facts:
    """Lexical facts of one function body."""

    #: (op, lock ids held at the op)
    ops: List[Tuple[_Op, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)
    #: (line, lock ids held, resolved callee or None)
    calls: List[Tuple[int, Tuple[str, ...], Optional[FuncInfo]]] = \
        dataclasses.field(default_factory=list)
    #: (acq, lock ids held when acquired)
    acqs: List[Tuple[_Acq, Tuple[str, ...]]] = \
        dataclasses.field(default_factory=list)


class ConcurrencyAnalysis:
    """Shared whole-program pass: facts, traced effects, lock graph."""

    def __init__(self, ctx: LintContext):
        self.cg: CallGraph = build_callgraph(ctx)
        self.models: Dict[str, FileLockModel] = build_lock_models(ctx)
        self._facts: Dict[str, _Facts] = {}
        self._exposed: Dict[str, List[_Op]] = {}
        self._acq_eff: Dict[str, List[_Acq]] = {}

    # -- lexical layer -------------------------------------------------
    def facts(self, fi: FuncInfo) -> _Facts:
        got = self._facts.get(fi.qual)
        if got is None:
            got = self._facts[fi.qual] = self._scan(fi)
        return got

    def _scan(self, fi: FuncInfo) -> _Facts:
        model = self.models.get(fi.rel)
        facts = _Facts()
        if model is None:
            return facts

        def visit(node, held: Tuple[str, ...]):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return          # nested defs run at some other time
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    visit(item.context_expr, held)
                decls = with_lock_decls(node, fi.cls, model)
                inner = list(held)
                for d in decls:
                    if d.lock_id not in inner:
                        facts.acqs.append((_Acq(d.lock_id, d.kind,
                                                fi.rel, node.lineno),
                                           tuple(inner)))
                        inner.append(d.lock_id)
                for stmt in node.body:
                    visit(stmt, tuple(inner))
                return
            if isinstance(node, ast.Call):
                op = self._classify(node, fi, model)
                if op is not None:
                    facts.ops.append((op, held))
                callee = self.cg.resolve(node, fi)
                if callee is not None and callee.qual != fi.qual:
                    facts.calls.append((node.lineno, held, callee))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fi.node.body:
            visit(stmt, ())
        return facts

    def _classify(self, call: ast.Call, fi: FuncInfo,
                  model: FileLockModel) -> Optional[_Op]:
        f = call.func
        line = call.lineno
        if isinstance(f, ast.Name):
            if f.id == "open":
                return _Op("file I/O open()", fi.rel, line)
            return None
        if not isinstance(f, ast.Attribute):
            return None
        attr = f.attr
        recv = f.value
        if isinstance(recv, ast.Name) and recv.id == "time" \
                and attr == "sleep":
            return _Op("time.sleep()", fi.rel, line)
        if isinstance(recv, ast.Name) and recv.id == "subprocess" \
                and attr in _SUBPROC_ATTRS:
            return _Op(f"subprocess.{attr}()", fi.rel, line)
        if attr in ("emit", "emit_raw"):
            return _Op(f"journal {attr}()", fi.rel, line)
        if attr == "fire":
            return _Op("faults.fire()", fi.rel, line)
        if attr in _IO_ATTRS:
            return _Op(f"file/socket I/O .{attr}()", fi.rel, line)
        name = _recv_name(recv)
        if name is None:
            return None
        if attr in ("get", "put"):
            q = model.queue_decl(fi.cls, name)
            if q is None or _has_kw(call, "timeout"):
                return None
            if attr == "get" or q.bounded:
                return _Op(f"queue .{attr}() without timeout",
                           fi.rel, line)
            return None
        if attr == "join" and not call.args \
                and not _has_kw(call, "timeout"):
            kind = model.sync_type(fi.cls, name)
            if kind in ("Thread", "Timer"):
                return _Op("Thread.join() without timeout", fi.rel, line)
            if model.queue_decl(fi.cls, name) is not None:
                return _Op("Queue.join()", fi.rel, line)
            return None
        if attr == "wait" and not call.args \
                and not _has_kw(call, "timeout"):
            if model.is_event(fi.cls, name):
                return _Op("Event.wait() without timeout", fi.rel, line)
            decl = model.lock_decl(fi.cls, name)
            if decl is not None and decl.kind == "Condition":
                own = model.canonical_lock(fi.cls, name)
                exempt = frozenset(
                    {decl.lock_id} | ({own.lock_id} if own else set()))
                return _Op("Condition.wait()", fi.rel, line,
                           exempt=exempt)
        return None

    # -- traced effects ------------------------------------------------
    def exposed(self, fi: FuncInfo, _stack: FrozenSet[str] = frozenset(),
                _depth: int = 0) -> List[_Op]:
        """Blocking ops ``fi`` performs while holding *no* lock of its
        own — the effects a caller's lock region inherits."""
        got = self._exposed.get(fi.qual)
        if got is not None:
            return got
        if fi.qual in _stack or _depth >= _MAX_DEPTH:
            return []
        out: List[_Op] = []
        facts = self.facts(fi)
        for op, held in facts.ops:
            if not held:
                out.append(op)
        for line, held, callee in facts.calls:
            if held or callee is None:
                continue
            for op in self.exposed(callee, _stack | {fi.qual},
                                   _depth + 1):
                out.append(_Op(op.desc, op.rel, op.line,
                               (callee.short,) + op.chain, op.exempt))
                if len(out) >= _MAX_EFFECTS:
                    break
        out = out[:_MAX_EFFECTS]
        self._exposed[fi.qual] = out
        return out

    def acq_effects(self, fi: FuncInfo,
                    _stack: FrozenSet[str] = frozenset(),
                    _depth: int = 0) -> List[_Acq]:
        """Every lock ``fi`` may acquire (lexically or transitively)."""
        got = self._acq_eff.get(fi.qual)
        if got is not None:
            return got
        if fi.qual in _stack or _depth >= _MAX_DEPTH:
            return []
        out: List[_Acq] = []
        seen: Set[str] = set()
        facts = self.facts(fi)
        for acq, _held in facts.acqs:
            if acq.lock_id not in seen:
                seen.add(acq.lock_id)
                out.append(acq)
        for line, _held, callee in facts.calls:
            if callee is None:
                continue
            for acq in self.acq_effects(callee, _stack | {fi.qual},
                                        _depth + 1):
                if acq.lock_id not in seen:
                    seen.add(acq.lock_id)
                    out.append(_Acq(acq.lock_id, acq.kind, acq.rel,
                                    acq.line,
                                    (callee.short,) + acq.chain))
                if len(out) >= _MAX_EFFECTS:
                    break
        out = out[:_MAX_EFFECTS]
        self._acq_eff[fi.qual] = out
        return out

    # -- the acquisition graph -----------------------------------------
    def lock_edges(self) -> Dict[Tuple[str, str], dict]:
        """(held, acquired) -> witness {rel, line, func, chain, kind}."""
        edges: Dict[Tuple[str, str], dict] = {}

        def add(held_id, acq: _Acq, fi, line=None, via=()):
            key = (held_id, acq.lock_id)
            if key not in edges:
                edges[key] = {
                    "rel": fi.rel, "line": line or acq.line,
                    "func": fi.short, "chain": tuple(via) + acq.chain,
                    "kind": acq.kind,
                }

        for fi in self.cg.funcs.values():
            facts = self.facts(fi)
            for acq, held in facts.acqs:
                for h in held:
                    add(h, acq, fi)
            for line, held, callee in facts.calls:
                if not held or callee is None:
                    continue
                for acq in self.acq_effects(callee):
                    for h in held:
                        add(h, acq, fi, line=line,
                            via=(callee.short,))
        return edges

    def lock_kinds(self) -> Dict[str, str]:
        kinds: Dict[str, str] = {}
        for model in self.models.values():
            for decl in model.locks.values():
                kinds[decl.lock_id] = decl.kind
        return kinds


def analysis(ctx: LintContext) -> ConcurrencyAnalysis:
    return ctx.memo("concurrency-analysis", ConcurrencyAnalysis)


def _fmt_chain(chain: Sequence[str]) -> str:
    return f" via {' -> '.join(chain)}" if chain else ""


# ---------------------------------------------------------------------
# lock-order
# ---------------------------------------------------------------------

def _find_cycles(edges: Dict[Tuple[str, str], dict]
                 ) -> List[List[str]]:
    """Unique elementary cycles (each as the node sequence, first node
    repeated at the end), canonicalized by rotation."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    for v in adj.values():
        v.sort()
    cycles: List[List[str]] = []
    seen: Set[Tuple[str, ...]] = set()

    def canon(path: List[str]) -> Tuple[str, ...]:
        i = path.index(min(path))
        return tuple(path[i:] + path[:i])

    def dfs(start: str, node: str, path: List[str],
            onpath: Set[str]) -> None:
        for nxt in adj.get(node, ()):
            if nxt == start:
                key = canon(path)
                if key not in seen:
                    seen.add(key)
                    cycles.append(path + [start])
            elif nxt not in onpath and nxt > start and len(path) < 8:
                # only expand to nodes > start: every cycle is found
                # exactly once, rooted at its smallest node
                dfs(start, nxt, path + [nxt], onpath | {nxt})

    for start in sorted(adj):
        dfs(start, start, [start], {start})
    return cycles


@rule("lock-order",
      "lock acquisition order forms no cycle across call chains "
      "(potential deadlock); export the graph with srlint --dot")
def check_lock_order(ctx: LintContext) -> List[Finding]:
    ana = analysis(ctx)
    edges = ana.lock_edges()
    kinds = ana.lock_kinds()
    findings: List[Finding] = []
    for cycle in _find_cycles(edges):
        if len(cycle) == 2 and kinds.get(cycle[0]) in ("RLock",):
            continue        # RLock self-acquisition is reentrant
        steps = []
        for a, b in zip(cycle, cycle[1:]):
            w = edges[(a, b)]
            steps.append(f"  {a} -> {b} at {w['rel']}:{w['line']} "
                         f"(in {w['func']}{_fmt_chain(w['chain'])})")
        first = edges[(cycle[0], cycle[1])]
        label = " -> ".join(cycle)
        what = ("non-reentrant lock reacquired while held "
                "(self-deadlock)" if len(cycle) == 2
                and cycle[0] == cycle[1] else "lock acquisition cycle")
        findings.append(Finding(
            "lock-order", first["rel"], first["line"],
            f"potential deadlock: {what} {label}\n"
            + "\n".join(steps)
            + "\n  order the acquisitions consistently, or document "
              "the hierarchy with '# srlint: ignore[lock-order]' at "
              "the first edge"))
    return findings


def lock_order_edges(root) -> Dict[Tuple[str, str], dict]:
    """The acquisition graph of ``root`` (CLI/DOT entry point)."""
    return analysis(LintContext(root)).lock_edges()


def render_lock_dot(root) -> str:
    """Graphviz DOT of the acquisition graph: one node per declared
    lock, one labeled edge per held->acquired pair."""
    ana = analysis(LintContext(root))
    edges = ana.lock_edges()
    kinds = ana.lock_kinds()
    lines = ["digraph lock_order {"]
    nodes = sorted(set(kinds)
                   | {n for e in edges for n in e})
    for n in nodes:
        lines.append(f'  "{n}" [kind="{kinds.get(n, "Lock")}"];')
    for (a, b), w in sorted(edges.items()):
        lines.append(f'  "{a}" -> "{b}" '
                     f'[label="{w["rel"]}:{w["line"]}"];')
    lines.append("}")
    return "\n".join(lines)


# ---------------------------------------------------------------------
# blocking-under-lock
# ---------------------------------------------------------------------

@rule("blocking-under-lock",
      "no file/socket I/O, subprocess, unbounded queue get/put, sleep, "
      "join, faults.fire, or journal emit while holding a lock "
      "(traced through callees)")
def check_blocking_under_lock(ctx: LintContext) -> List[Finding]:
    ana = analysis(ctx)
    findings: List[Finding] = []
    reported: Set[Tuple[str, int, str]] = set()

    def report(rel, line, op: _Op, held, func):
        locks = ", ".join(h for h in held if h not in op.exempt)
        if not locks:
            return
        key = (rel, line, op.desc)
        if key in reported:
            return
        reported.add(key)
        where = "" if (op.rel, op.line) == (rel, line) \
            else f" ({op.rel}:{op.line}{_fmt_chain(op.chain)})"
        findings.append(Finding(
            "blocking-under-lock", rel, line,
            f"blocking {op.desc}{where} while holding {locks} "
            f"(in {func}) — snapshot under the lock, do the slow work "
            "outside it"))

    for fi in ana.cg.funcs.values():
        facts = ana.facts(fi)
        for op, held in facts.ops:
            if held:
                report(fi.rel, op.line, op, held, fi.short)
        for line, held, callee in facts.calls:
            if not held or callee is None:
                continue
            for op in ana.exposed(callee):
                chained = _Op(op.desc, op.rel, op.line,
                              (callee.short,) + op.chain, op.exempt)
                report(fi.rel, line, chained, held, fi.short)
    return findings


# ---------------------------------------------------------------------
# guarded-by-inference
# ---------------------------------------------------------------------

def _class_attr_writes(fn_node: ast.AST) -> Dict[str, int]:
    """{attr: first write line} for ``self.<attr>`` assignment targets."""
    out: Dict[str, int] = {}
    for node in ast.walk(fn_node):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                out.setdefault(t.attr, node.lineno)
    return out


def _class_attr_accesses(fn_node: ast.AST) -> Set[str]:
    return {n.attr for n in ast.walk(fn_node)
            if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "self"}


@rule("guarded-by-inference",
      "attributes written from a Thread(target=...) entry point and "
      "accessed elsewhere carry a '# guarded-by:' annotation")
def check_guarded_by_inference(ctx: LintContext) -> List[Finding]:
    from .rules_safety import _guard_decls

    ana = analysis(ctx)
    findings: List[Finding] = []
    for sf in ctx.package_files():
        model = ana.models.get(sf.rel)
        if model is None or not model.threads:
            continue
        annotated, _ = _guard_decls(sf)
        roots_by_cls: Dict[str, Dict[str, ThreadDecl]] = {}
        for td in model.threads:
            if td.cls and td.target_attr:
                roots_by_cls.setdefault(td.cls, {}) \
                    .setdefault(td.target_attr, td)
        for cls, roots in sorted(roots_by_cls.items()):
            table = ana.cg.class_methods(sf.rel, cls)
            bg = ana.cg.class_reachable(sf.rel, cls, roots)
            fg = ana.cg.class_reachable(
                sf.rel, cls, [m for m in table if m not in roots])
            writes: Dict[str, Tuple[int, str]] = {}
            for m in sorted(bg):
                if m == "__init__":
                    continue
                for attr, line in _class_attr_writes(
                        table[m].node).items():
                    writes.setdefault(attr, (line, m))
            accessed_fg: Set[str] = set()
            for m in fg:
                if m == "__init__":
                    continue
                accessed_fg |= _class_attr_accesses(table[m].node)
            class_locks = sorted(
                (d for (owner, _), d in model.locks.items()
                 if owner == cls), key=lambda d: d.line)
            suggest = class_locks[0].name if class_locks else "<lock>"
            init_decls = _class_attr_writes(table["__init__"].node) \
                if "__init__" in table else {}
            for attr in sorted(writes):
                if attr in annotated.get(cls, {}):
                    continue
                if model.sync_type(cls, attr) in THREAD_SAFE_CTORS:
                    continue
                if attr not in accessed_fg:
                    continue
                line, writer = writes[attr]
                anchor = init_decls.get(attr, line)
                root = next(iter(sorted(
                    r for r in roots if writer in
                    ana.cg.class_reachable(sf.rel, cls, [r]))), "?")
                findings.append(Finding(
                    "guarded-by-inference", sf.rel, anchor,
                    f"self.{attr} is written by background thread "
                    f"entry {cls}.{root} (in {cls}.{writer}) and "
                    f"accessed from foreground methods — annotate its "
                    f"declaration with '# guarded-by: {suggest}' and "
                    f"take the lock on every access, or restructure"))
    return findings


# ---------------------------------------------------------------------
# condition-wait-loop
# ---------------------------------------------------------------------

@rule("condition-wait-loop",
      "Condition.wait happens under the condition's own lock and "
      "inside a while-predicate loop (spurious-wakeup safety)")
def check_condition_wait_loop(ctx: LintContext) -> List[Finding]:
    ana = analysis(ctx)
    findings: List[Finding] = []
    for fi in ana.cg.funcs.values():
        model = ana.models.get(fi.rel)
        if model is None:
            continue

        def visit(node, held: Set[str], in_while: bool):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            if isinstance(node, ast.While):
                in_while = True
            if isinstance(node, (ast.With, ast.AsyncWith)):
                held = held | {d.lock_id for d in with_lock_decls(
                    node, fi.cls, model)}
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("wait", "wait_for"):
                name = _recv_name(node.func.value)
                decl = model.lock_decl(fi.cls, name) if name else None
                if decl is not None and decl.kind == "Condition":
                    own = model.canonical_lock(fi.cls, name)
                    own_ids = {decl.lock_id} | (
                        {own.lock_id} if own else set())
                    if not (held & own_ids):
                        findings.append(Finding(
                            "condition-wait-loop", fi.rel, node.lineno,
                            f"{name}.{node.func.attr}() without "
                            f"holding the condition's lock (in "
                            f"{fi.short}) — wrap in 'with "
                            f"self.{name}:'"))
                    if node.func.attr == "wait" and not in_while:
                        findings.append(Finding(
                            "condition-wait-loop", fi.rel, node.lineno,
                            f"{name}.wait() outside a while-predicate "
                            f"loop (in {fi.short}) — spurious wakeups "
                            "make a bare wait return early; use "
                            "'while not <predicate>: wait()' or "
                            "wait_for(<predicate>)"))
            for child in ast.iter_child_nodes(node):
                visit(child, held, in_while)

        for stmt in fi.node.body:
            visit(stmt, set(), False)
    return findings


# ---------------------------------------------------------------------
# thread-lifecycle
# ---------------------------------------------------------------------

def _calls_on(node: ast.AST, attr: str, recv_attr: Optional[str] = None,
              recv_local: Optional[str] = None) -> bool:
    """Is there a ``self.<recv_attr>.<attr>()`` / ``<recv_local>.
    <attr>()`` call anywhere under ``node``?"""
    for n in ast.walk(node):
        if not (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == attr):
            continue
        recv = n.func.value
        if recv_attr is not None and isinstance(recv, ast.Attribute) \
                and isinstance(recv.value, ast.Name) \
                and recv.value.id == "self" and recv.attr == recv_attr:
            return True
        if recv_local is not None and isinstance(recv, ast.Name) \
                and recv.id == recv_local:
            return True
    return False


@rule("thread-lifecycle",
      "every started threading.Thread is joined from a reachable "
      "stop()/close() path, or documented daemon-by-design with a "
      "suppression")
def check_thread_lifecycle(ctx: LintContext) -> List[Finding]:
    ana = analysis(ctx)
    findings: List[Finding] = []
    for rel, model in sorted(ana.models.items()):
        sf = ctx.file(rel)
        for td in model.threads:
            if td.kind != "Thread":
                continue        # Timer follows a cancel() discipline
            if td.store is None:
                findings.append(Finding(
                    "thread-lifecycle", rel, td.line,
                    "thread started inline and never joined — store "
                    "it and join from stop()/close(), or mark the "
                    "creation '# srlint: ignore[thread-lifecycle]' "
                    "as daemon-by-design"))
                continue
            how, name = td.store
            if how == "attr" and td.cls:
                scope_nodes = [f.node for f in ana.cg.class_methods(
                    rel, td.cls).values()]
                started = any(_calls_on(n, "start", recv_attr=name)
                              for n in scope_nodes)
                joined = any(_calls_on(n, "join", recv_attr=name)
                             for n in scope_nodes)
                label = f"self.{name}"
            else:
                owner = (ana.cg.method(rel, td.cls, td.func)
                         if td.cls and td.func else None) \
                    or (ana.cg.module_funcs.get(rel, {})
                        .get(td.func or ""))
                if owner is None:
                    continue    # module-level script code: out of scope
                started = _calls_on(owner.node, "start",
                                    recv_local=name)
                joined = _calls_on(owner.node, "join", recv_local=name)
                label = name
            if started and not joined:
                findings.append(Finding(
                    "thread-lifecycle", rel, td.line,
                    f"thread {label} is started but never joined — "
                    "join it from stop()/close() (a bounded "
                    "join(timeout=...) counts), or mark the creation "
                    "'# srlint: ignore[thread-lifecycle]' as "
                    "daemon-by-design"))
        del sf
    return findings


__all__ = ["ConcurrencyAnalysis", "analysis", "lock_order_edges",
           "render_lock_dot"]
