"""Lock model — the concurrency rules' shared view of one file.

Scans a :class:`~sparkrdma_tpu_torch.lint.core.SourceFile` for every
synchronization-object creation site and classifies it structurally
(no imports of the package under analysis, same as the rest of srlint):

- **locks** — ``threading.Lock/RLock/Condition/Semaphore`` assigned to
  ``self.<x>`` in a class body or to a module global. A
  ``Condition(lock)`` built over a named lock records the alias: holding
  either name means holding the same mutex, which both the ``guarded-by``
  rule and the lock-order graph honour.
- **queues** — ``queue.Queue`` family creations, with boundedness
  (``Queue()``/``maxsize=0`` never blocks on ``put``; anything else can).
- **threads** — every ``threading.Thread(target=...)`` / ``Timer(...,
  fn)`` creation: where it is stored (``self.<x>`` / local / dropped),
  and which function it runs — the thread roots of the whole-program
  analysis.
- **events** — ``threading.Event`` creations (their ``wait`` blocks but
  the objects themselves are thread-safe, so guarded-by inference skips
  them).

Only *declared* names count: ``with self._lock:`` is treated as a lock
acquisition only when ``_lock``'s creation site was seen (in the class
or at module level of the same file). That keeps arbitrary context
managers (``with tempfile...``, ``with mesh:``) out of the lock graph.

Lock identity is class-scoped (``TieredStore._lock``) or module-scoped
(``obs/metrics.py::_global_lock``): two instances of one class share a
lock node. That is the usual conservative choice for a static
acquisition graph — a self-edge through another instance of the same
class is reported, which is exactly the hierarchy-violation pattern
that deadlocks real code.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .core import SourceFile

#: constructor names that create a mutex (or mutex-wrapping) object
LOCK_CTORS = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                        "BoundedSemaphore"})
#: constructor names that create a queue
QUEUE_CTORS = frozenset({"Queue", "LifoQueue", "PriorityQueue",
                         "SimpleQueue"})
#: constructor names whose objects are internally synchronized — safe
#: to share without a guarded-by annotation
THREAD_SAFE_CTORS = (LOCK_CTORS | QUEUE_CTORS
                     | frozenset({"Event", "Thread", "Timer", "Barrier",
                                  "local"}))


@dataclasses.dataclass
class LockDecl:
    """One lock creation site."""

    rel: str
    line: int
    cls: Optional[str]          # owning class, None for module globals
    name: str                   # attribute / global name
    kind: str                   # "Lock" | "RLock" | "Condition" | ...
    alias_of: Optional[str] = None   # Condition(<lock>): underlying name

    @property
    def lock_id(self) -> str:
        """Graph-node identity: class-scoped or module-scoped."""
        return f"{self.cls}.{self.name}" if self.cls \
            else f"{self.rel}::{self.name}"


@dataclasses.dataclass
class QueueDecl:
    rel: str
    line: int
    cls: Optional[str]
    name: str
    bounded: bool               # True when put() can block


@dataclasses.dataclass
class ThreadDecl:
    """One ``Thread(target=...)`` / ``Timer(..., fn)`` creation site."""

    rel: str
    line: int
    cls: Optional[str]          # class whose method creates the thread
    func: Optional[str]         # creating function name
    kind: str                   # "Thread" | "Timer"
    target_attr: Optional[str]  # method name for target=self.<m>
    target_name: Optional[str]  # function name for target=<f>
    store: Optional[Tuple[str, str]] = None   # ("attr"|"local", name)


def _ctor_name(call: ast.Call) -> Optional[str]:
    """``threading.Lock()`` / ``Lock()`` / ``_q.Queue()`` → the bare
    constructor name when it is one we model, else None."""
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    return name if name in (LOCK_CTORS | QUEUE_CTORS
                            | {"Event", "Thread", "Timer"}) else None


def _bare_name(node: ast.AST) -> Optional[str]:
    """``self.x`` → ``x``; ``x`` → ``x``; anything else → None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _queue_bounded(call: ast.Call) -> bool:
    """Conservatively True unless the creation is provably unbounded
    (no maxsize, or a literal 0/negative)."""
    size = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "maxsize":
            size = kw.value
    if size is None:
        return False
    if isinstance(size, ast.Constant) and isinstance(size.value, int):
        return size.value > 0
    return True


def _thread_target(call: ast.Call, kind: str
                   ) -> Tuple[Optional[str], Optional[str]]:
    """(target method name on self, target plain function name)."""
    tgt = None
    if kind == "Thread":
        for kw in call.keywords:
            if kw.arg == "target":
                tgt = kw.value
    else:  # Timer(interval, function, ...)
        if len(call.args) >= 2:
            tgt = call.args[1]
        for kw in call.keywords:
            if kw.arg == "function":
                tgt = kw.value
    if isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) \
            and tgt.value.id == "self":
        return tgt.attr, None
    if isinstance(tgt, ast.Name):
        return None, tgt.id
    return None, None


class FileLockModel:
    """Every lock/queue/thread/event declaration in one source file."""

    def __init__(self, sf: SourceFile):
        self.rel = sf.rel
        #: (cls-or-None, name) -> LockDecl
        self.locks: Dict[Tuple[Optional[str], str], LockDecl] = {}
        #: (cls-or-None, name) -> QueueDecl
        self.queues: Dict[Tuple[Optional[str], str], QueueDecl] = {}
        #: (cls-or-None, name) -> "Event"
        self.events: Set[Tuple[Optional[str], str]] = set()
        #: names of attrs/locals holding Thread objects, per scope key
        self.threads: List[ThreadDecl] = []
        #: (cls-or-None, name) -> ctor kind, for thread-safe-type checks
        self.sync_types: Dict[Tuple[Optional[str], str], str] = {}
        self._scan(sf.tree)

    # -- construction --------------------------------------------------
    def _scan(self, tree: ast.AST) -> None:
        def visit(node, cls, func):
            if isinstance(node, ast.ClassDef):
                for child in ast.iter_child_nodes(node):
                    visit(child, node.name, func)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for child in ast.iter_child_nodes(node):
                    visit(child, cls, node.name)
                return
            if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and isinstance(getattr(node, "value", None), ast.Call):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                self._decl(node.value, targets, node.lineno, cls, func)
            elif isinstance(node, ast.Expr) \
                    and isinstance(node.value, ast.Call):
                call = node.value
                if _ctor_name(call) in ("Thread", "Timer"):
                    self._thread(call, None, node.lineno, cls, func)
                # inline ``Thread(...).start()``: the ctor is the func's
                # receiver, not the statement expression
                f = call.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Call) \
                        and _ctor_name(f.value) in ("Thread", "Timer"):
                    self._thread(f.value, None, node.lineno, cls, func)
            for child in ast.iter_child_nodes(node):
                visit(child, cls, func)

        for stmt in tree.body:
            visit(stmt, None, None)

    def _decl(self, call: ast.Call, targets, line, cls, func) -> None:
        ctor = _ctor_name(call)
        if ctor is None:
            return
        for t in targets:
            name = _bare_name(t)
            if name is None:
                continue
            if ctor in ("Thread", "Timer"):
                store = ("attr", name) if isinstance(t, ast.Attribute) \
                    else ("local", name)
                self._thread(call, store, line, cls, func)
                if isinstance(t, ast.Attribute):
                    self.sync_types.setdefault((cls, name), ctor)
                continue
            # ``self.x`` inside a method declares a class attr; a bare
            # name at module level declares a global. Locals are out of
            # model scope (a lock that never escapes a frame cannot be
            # contended cross-thread through the names we track).
            if isinstance(t, ast.Attribute):
                owner = cls
            elif func is None:
                owner = None
            else:
                continue
            key = (owner, name)
            self.sync_types.setdefault(key, ctor)
            if ctor in LOCK_CTORS:
                alias = None
                if ctor == "Condition" and call.args:
                    alias = _bare_name(call.args[0])
                self.locks.setdefault(key, LockDecl(
                    self.rel, line, owner, name, ctor, alias))
            elif ctor in QUEUE_CTORS:
                self.queues.setdefault(key, QueueDecl(
                    self.rel, line, owner, name, _queue_bounded(call)))
            elif ctor == "Event":
                self.events.add(key)

    def _thread(self, call: ast.Call, store, line, cls, func) -> None:
        kind = _ctor_name(call)
        ta, tn = _thread_target(call, kind)
        self.threads.append(ThreadDecl(self.rel, line, cls, func, kind,
                                       ta, tn, store))

    # -- queries -------------------------------------------------------
    def lock_decl(self, cls: Optional[str], name: str
                  ) -> Optional[LockDecl]:
        """The declared lock visible as ``name`` from class ``cls``
        (class attr first, then module global)."""
        if cls is not None and (cls, name) in self.locks:
            return self.locks[(cls, name)]
        return self.locks.get((None, name))

    def queue_decl(self, cls: Optional[str], name: str
                   ) -> Optional[QueueDecl]:
        if cls is not None and (cls, name) in self.queues:
            return self.queues[(cls, name)]
        return self.queues.get((None, name))

    def is_event(self, cls: Optional[str], name: str) -> bool:
        return (cls, name) in self.events or (None, name) in self.events

    def sync_type(self, cls: Optional[str], name: str) -> Optional[str]:
        if cls is not None and (cls, name) in self.sync_types:
            return self.sync_types[(cls, name)]
        return self.sync_types.get((None, name))

    def alias_groups(self) -> Dict[Optional[str], Dict[str, Set[str]]]:
        """Per-scope equivalence groups: ``Condition(lock)`` makes the
        condition name and the lock name interchangeable guards."""
        groups: Dict[Optional[str], Dict[str, Set[str]]] = {}
        for (owner, name), decl in self.locks.items():
            scope = groups.setdefault(owner, {})
            group = scope.setdefault(name, {name})
            if decl.alias_of:
                other = scope.setdefault(decl.alias_of, {decl.alias_of})
                merged = group | other
                for n in merged:
                    scope[n] = merged
        return groups

    def canonical_lock(self, cls: Optional[str], name: str
                       ) -> Optional[LockDecl]:
        """Like :meth:`lock_decl` but resolved through Condition
        aliases: ``Condition(self._lock)`` acquisitions canonicalize to
        the underlying ``_lock`` so both spellings share a graph node."""
        decl = self.lock_decl(cls, name)
        seen = set()
        while decl is not None and decl.alias_of \
                and decl.alias_of not in seen:
            seen.add(decl.alias_of)
            under = self.lock_decl(decl.cls, decl.alias_of)
            if under is None:
                break
            decl = under
        return decl


def with_lock_decls(node, cls: Optional[str], model: FileLockModel
                    ) -> List[LockDecl]:
    """The *declared* locks a ``with`` statement acquires (``with
    self.<l>:`` / ``with <l>:``; undeclared names and calls are not
    lock acquisitions)."""
    out = []
    for item in node.items:
        name = _bare_name(item.context_expr)
        if name is None:
            continue
        decl = model.canonical_lock(cls, name)
        if decl is not None:
            out.append(decl)
    return out


def build_lock_models(ctx) -> Dict[str, FileLockModel]:
    """rel path -> FileLockModel, memoized on the context."""
    return ctx.memo("lock-models", lambda c: {
        sf.rel: FileLockModel(sf) for sf in c.package_files()})


__all__ = ["LockDecl", "QueueDecl", "ThreadDecl", "FileLockModel",
           "with_lock_decls", "build_lock_models", "LOCK_CTORS",
           "QUEUE_CTORS", "THREAD_SAFE_CTORS"]
