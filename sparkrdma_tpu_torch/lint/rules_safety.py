"""Safety rules: lock discipline, ``python -O`` survival, and
never-raise exception contracts.

``guarded-by`` is annotation-driven: a comment ``# guarded-by: <lock>``
on the line that first assigns an attribute (or module global) declares
which lock protects it, and every other access must sit lexically
inside ``with self.<lock>:`` / ``with <lock>:``. The named guard may be
a ``threading.Lock``, ``RLock``, or ``Condition`` — and when the lock
model (:mod:`sparkrdma_tpu_torch.lint.locks`) sees ``cond =
threading.Condition(lock)``, holding either name counts as holding the
other, since they are the same mutex. ``__init__`` and methods whose
names end in ``_locked`` (the repo's caller-holds-lock convention) are
exempt. The walk is an AST scope walk — receiver,
enclosing class, enclosing function, and the stack of held locks are
all tracked structurally, not by regex.

``never-raise-io`` is the same idea for exception contracts: a
``# never-raises`` comment on a ``def`` declares the journal-style
contract that the function may be called from any thread at any point
and must swallow its own I/O failures; inside it, every I/O call must
be lexically inside a ``try`` whose handlers catch ``OSError`` (or
wider).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from .core import Finding, LintContext, SourceFile, rule
from .locks import build_lock_models

# ---------------------------------------------------------------------
# guarded-by
# ---------------------------------------------------------------------

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")


def _annotation_lines(sf: SourceFile, pattern: re.Pattern
                      ) -> Dict[int, str]:
    """{lineno: annotation value} — same-line, with a comment-only line
    also annotating the line below (same convention as suppressions)."""
    out: Dict[int, str] = {}
    for i, line in enumerate(sf.lines, 1):
        m = pattern.search(line)
        if not m:
            continue
        out[i] = m.group(1)
        if line.strip().startswith("#"):
            out[i + 1] = m.group(1)
    return out


def _guard_decls(sf: SourceFile):
    """Collect guarded declarations from annotation comments.

    Returns ``(attrs, globals_)`` where ``attrs`` maps class name →
    {attr: lock} (declared by an annotated ``self.x = ...`` or a class-
    body ``x: T`` line) and ``globals_`` maps module global → (lock,
    declaration lineno).
    """
    ann = _annotation_lines(sf, _GUARD_RE)
    attrs: Dict[str, Dict[str, str]] = {}
    globals_: Dict[str, Tuple[str, int]] = {}
    if not ann:
        return attrs, globals_

    def collect(node, cls):
        if isinstance(node, ast.ClassDef):
            for child in node.body:
                collect(child, node.name)
            return
        lock = ann.get(getattr(node, "lineno", -1))
        if lock is not None:
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self" and cls:
                        attrs.setdefault(cls, {})[t.attr] = lock
                    elif isinstance(t, ast.Name):
                        if cls:
                            attrs.setdefault(cls, {})[t.id] = lock
                        else:
                            globals_[t.id] = (lock, node.lineno)
        for child in ast.iter_child_nodes(node):
            collect(child, cls)

    for stmt in sf.tree.body:
        collect(stmt, None)
    return attrs, globals_


def _with_locks(node) -> Set[str]:
    """Lock names a ``with`` statement acquires: ``with self.<l>:`` and
    ``with <l>:`` both contribute the bare name ``l``."""
    out = set()
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Name):
            out.add(e.id)
        elif isinstance(e, ast.Attribute) \
                and isinstance(e.value, ast.Name) and e.value.id == "self":
            out.add(e.attr)
    return out


def _exempt(func: str) -> bool:
    return func == "__init__" or func.endswith("_locked")


@rule("guarded-by",
      "attributes annotated '# guarded-by: <lock>' are only accessed "
      "under 'with <lock>:' (Lock/RLock/Condition; a Condition guards "
      "through its own lock and vice versa)")
def check_guarded_by(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    models = build_lock_models(ctx)
    for sf in ctx.package_files():
        attrs, globals_ = _guard_decls(sf)
        if not attrs and not globals_:
            continue
        model = models.get(sf.rel)
        alias_groups = model.alias_groups() if model is not None else {}

        def held_names(node, cls) -> Set[str]:
            """Names a ``with`` acquires, closed over Condition aliases:
            ``with self._cond:`` where ``_cond = Condition(self._lock)``
            holds both ``_cond`` and ``_lock``."""
            out = _with_locks(node)
            for scope in (cls, None):
                groups = alias_groups.get(scope, {})
                for n in list(out):
                    out |= groups.get(n, set())
            return out

        def enforce(node, cls, func, locks):
            if isinstance(node, ast.ClassDef):
                for child in ast.iter_child_nodes(node):
                    enforce(child, node.name, func, locks)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for child in ast.iter_child_nodes(node):
                    enforce(child, cls, node.name, locks)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                locks = locks | held_names(node, cls)
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self" and cls:
                lock = attrs.get(cls, {}).get(node.attr)
                if lock is not None and lock not in locks \
                        and not (func and _exempt(func)):
                    findings.append(Finding(
                        "guarded-by", sf.rel, node.lineno,
                        f"self.{node.attr} is guarded by "
                        f"{lock!r} but accessed outside 'with "
                        f"self.{lock}:' (in "
                        f"{func or cls or '<module>'})"))
            elif isinstance(node, ast.Name) and node.id in globals_:
                lock, decl_line = globals_[node.id]
                if lock not in locks and node.lineno != decl_line \
                        and not (func and _exempt(func)):
                    findings.append(Finding(
                        "guarded-by", sf.rel, node.lineno,
                        f"global {node.id} is guarded by {lock!r} but "
                        f"accessed outside 'with {lock}:' (in "
                        f"{func or '<module>'})"))
            for child in ast.iter_child_nodes(node):
                enforce(child, cls, func, locks)

        for stmt in sf.tree.body:
            enforce(stmt, None, None, frozenset())
    return findings


# ---------------------------------------------------------------------
# assert-safety
# ---------------------------------------------------------------------

@rule("assert-safety",
      "no bare assert in package code (stripped under python -O)")
def check_assert_safety(ctx: LintContext) -> List[Finding]:
    findings = []
    for sf in ctx.package_files():
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assert):
                findings.append(Finding(
                    "assert-safety", sf.rel, node.lineno,
                    "bare assert disappears under python -O — raise "
                    "ValueError/RuntimeError (or drop the check) so "
                    "the invariant survives optimized runs"))
    return findings


# ---------------------------------------------------------------------
# never-raise-io
# ---------------------------------------------------------------------

_NEVER_RE = re.compile(r"#\s*never-raises\b")

#: exception names wide enough to satisfy the contract for I/O
_CATCHES_IO = ("OSError", "IOError", "Exception", "BaseException")

#: method/function names treated as I/O when called
_IO_ATTRS = frozenset({
    "open", "write", "writelines", "flush", "close", "fsync", "tofile",
    "replace", "rename", "unlink", "makedirs", "fstat", "getsize",
})


def _handler_qualifies(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in _CATCHES_IO:
            return True
    return False


def _is_io_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Name):
        return f.id == "open"
    return isinstance(f, ast.Attribute) and f.attr in _IO_ATTRS


@rule("never-raise-io",
      "functions annotated '# never-raises' guard every I/O call with "
      "try/except OSError or wider")
def check_never_raise_io(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.package_files():
        ann = _annotation_lines(
            sf, re.compile(r"#\s*(never-raises)\b"))
        if not ann:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if node.lineno not in ann:
                continue

            def scan(stmt, guarded):
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)):
                    return   # closures run at other times; out of scope
                if isinstance(stmt, ast.Try):
                    q = guarded or any(_handler_qualifies(h)
                                       for h in stmt.handlers)
                    for s in stmt.body:
                        scan(s, q)
                    for h in stmt.handlers:
                        for s in h.body:
                            scan(s, guarded)
                    for s in stmt.orelse + stmt.finalbody:
                        scan(s, guarded)
                    return
                if _is_io_call(stmt) and not guarded:
                    findings.append(Finding(
                        "never-raise-io", sf.rel, stmt.lineno,
                        f"I/O call inside never-raises function "
                        f"{node.name!r} is not wrapped in try/except "
                        "OSError — a disk error here would break the "
                        "no-raise contract"))
                for child in ast.iter_child_nodes(stmt):
                    scan(child, guarded)

            for stmt in node.body:
                scan(stmt, False)
    return findings
