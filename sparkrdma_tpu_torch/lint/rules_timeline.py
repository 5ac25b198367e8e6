"""Timeline B/E pairing: every ``begin`` has an ``end`` on the same
code path.

Chrome-trace duration events nest by (name, B/E) discipline; an
unmatched ``B`` leaves a span open forever in Perfetto and skews the
stall watchdog's notion of "in flight". The rule walks each function
body and requires that every constant-named begin emission — via
``.begin("x")``, ``.event("x", ph="B")``, or ``record_active("x",
ph="B")`` — has a matching end emission in the *same function at the
same loop depth* (a ``B`` inside a loop whose ``E`` is outside fires
once per iteration but closes once — a real pairing bug, so the rule
tracks the chain of enclosing loops, not just the function).

One allowance: within a single class, a top-level begin in one method
may be closed by a top-level end in a sibling method. That is the
context-manager discipline — ``B`` in ``__enter__`` paired with ``E``
in ``__exit__``, or split ``_begin_*``/``_end_*`` helpers driven by a
scope object (``obs.trace.JobTrace`` is the canonical case). The two
methods run on the same code path even though they are separate
functions. Plain module-level functions and closures stay strict: a
begin in a nested def cannot be closed by its enclosing function, they
run at different times.

Variable-named emissions (like the timeline API's own internals) are
invisible to the rule; the convention the repo actually uses is
constant names at call sites, which is exactly what it checks.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, LintContext, SourceFile, call_str_arg, rule

_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _classify(call: ast.Call) -> Optional[Tuple[str, str]]:
    """(ph, name) for a timeline emission with a constant name, else
    None. ``ph`` is only ever "B" or "E" — instants don't pair."""
    name = call_str_arg(call)
    if name is None:
        return None
    f = call.func
    attr = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    if attr == "begin":
        return ("B", name)
    if attr == "end":
        return ("E", name)
    if attr in ("event", "record_active"):
        for kw in call.keywords:
            if kw.arg == "ph" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value in ("B", "E"):
                return (kw.value.value, name)
        if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
                and call.args[1].value in ("B", "E"):
            return (call.args[1].value, name)
    return None


def _flag(unmatched: Dict[str, Tuple[int, str]], sf: SourceFile,
          findings: List[Finding], suffix: str = "") -> None:
    for name, (lineno, where) in sorted(unmatched.items(),
                                        key=lambda kv: kv[1][0]):
        findings.append(Finding(
            "timeline-pairing", sf.rel, lineno,
            f"timeline begin {name!r} in {where} has no matching "
            f"end at the same loop depth{suffix} — the span never "
            "closes"))


def _scan_scope(scope_name: str, body, sf: SourceFile,
                findings: List[Finding]
                ) -> Tuple[Dict[str, Tuple[int, str]], Set[str]]:
    """Check one function (or module) body. Loop-depth mismatches are
    flagged directly; top-level (depth-0) unmatched begins and the
    depth-0 end names are *returned* so the caller decides — plain
    scopes flag them as-is, class scopes pool across sibling methods.
    Nested defs recurse as their own strict scopes — a begin in a
    closure can't be closed by the enclosing function, they run at
    different times."""
    begins = {}   # (loop_chain, name) -> first lineno
    ends = set()  # (loop_chain, name)
    nested = []
    classes = []

    def visit(node, chain):
        if isinstance(node, _DEFS):
            nested.append(node)
            return
        if isinstance(node, ast.ClassDef):
            classes.append(node)
            return
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.Call):
            hit = _classify(node)
            if hit is not None:
                ph, name = hit
                if ph == "B":
                    begins.setdefault((chain, name), node.lineno)
                else:
                    ends.add((chain, name))
        if isinstance(node, _LOOPS):
            inner = chain + (node.lineno,)
            for stmt in node.body:
                visit(stmt, inner)
            for stmt in node.orelse:
                visit(stmt, chain)
            header = node.test if isinstance(node, ast.While) else node.iter
            visit(header, chain)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, chain)

    for stmt in body:
        visit(stmt, ())
    unmatched: Dict[str, Tuple[int, str]] = {}
    for (chain, name), lineno in sorted(begins.items(),
                                        key=lambda kv: kv[1]):
        if (chain, name) in ends:
            continue
        if chain:
            findings.append(Finding(
                "timeline-pairing", sf.rel, lineno,
                f"timeline begin {name!r} in loop at line {chain[-1]} "
                f"of {scope_name} has no matching end at the same loop "
                "depth — the span never closes"))
        elif name not in unmatched:
            unmatched[name] = (lineno, scope_name)
    top_ends = {name for (chain, name) in ends if not chain}

    for fn in nested:
        child = (f"{scope_name}.{fn.name}"
                 if scope_name != "<module>" else fn.name)
        sub_unmatched, _ = _scan_scope(child, fn.body, sf, findings)
        _flag(sub_unmatched, sf, findings)
    for cls in classes:
        _scan_class(scope_name, cls, sf, findings)
    return unmatched, top_ends


def _scan_class(scope_name: str, cls: ast.ClassDef, sf: SourceFile,
                findings: List[Finding]) -> None:
    """One class: methods pool their depth-0 unmatched begins and end
    names, so a ``B`` in ``__enter__`` closed by an ``E`` in
    ``__exit__`` (or split begin/end helper methods) passes."""
    cls_name = (f"{scope_name}.{cls.name}"
                if scope_name != "<module>" else cls.name)
    pooled: Dict[str, Tuple[int, str]] = {}
    pooled_ends: Set[str] = set()
    rest = []
    for stmt in cls.body:
        if isinstance(stmt, _DEFS):
            method = f"{cls_name}.{stmt.name}"
            un, en = _scan_scope(method, stmt.body, sf, findings)
            for name, at in un.items():
                pooled.setdefault(name, at)
            pooled_ends |= en
        else:
            rest.append(stmt)
    if rest:
        un, en = _scan_scope(cls_name, rest, sf, findings)
        for name, at in un.items():
            pooled.setdefault(name, at)
        pooled_ends |= en
    leftover = {n: at for n, at in pooled.items() if n not in pooled_ends}
    _flag(leftover, sf, findings,
          suffix=f" (or in a sibling method of {cls.name})")


@rule("timeline-pairing",
      "every timeline begin emission has a matching end in the same "
      "function and loop (sibling methods of one class may pair)")
def check_timeline_pairing(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.package_files():
        unmatched, _ = _scan_scope("<module>", sf.tree.body, sf, findings)
        _flag(unmatched, sf, findings)
    return findings
