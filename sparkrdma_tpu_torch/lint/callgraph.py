"""Conservative whole-program call graph over the package sources.

One :class:`FuncInfo` per top-level function and per directly-declared
method, indexed three ways (by qualified name, per module, per class).
Call-site resolution is deliberately *under*-approximate — an edge is
only added when the target is unambiguous:

1. ``self.m(...)`` resolves to method ``m`` of the caller's own class
   (same file);
2. a bare ``f(...)`` resolves to module-level ``f`` in the caller's own
   file;
3. otherwise (including ``obj.attr(...)`` on a foreign receiver) the
   name resolves only when exactly **one** definition with that name
   exists package-wide — common names like ``get``/``put``/``close``
   with several definitions produce no edge rather than a wrong one,
   and names that collide with stdlib methods (``join``, ``flush``,
   ``submit``, ...) never resolve through this fallback at all.

Class names resolve to their ``__init__`` (rule 3), so ``Foo()`` under
a lock traces into the constructor.

Under-approximation is the right polarity for the concurrency rules:
a missed edge can hide a real finding (acceptable for a lint), while an
invented edge would fabricate deadlock cycles and blocking-op traces
that do not exist (not acceptable — the repo pins itself clean against
these rules in the meta-test).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional

from .core import SourceFile

#: attribute names that collide with stdlib container/file/threading/
#: executor methods — never resolved through the unique-global-name
#: fallback. Without this, ``"".join(...)`` or ``self._fh.flush()``
#: resolves to an unrelated package method that happens to be uniquely
#: named, and the concurrency rules inherit effects (and deadlock
#: cycles) that do not exist.
_AMBIENT_ATTRS = frozenset({
    "join", "get", "put", "wait", "set", "clear", "close", "open",
    "read", "write", "flush", "send", "recv", "start", "run", "stop",
    "cancel", "acquire", "release", "append", "extend", "pop",
    "update", "items", "keys", "values", "copy", "split", "strip",
    "encode", "decode", "format", "add", "remove", "discard", "count",
    "index", "insert", "sort", "reverse", "seek", "tell", "readline",
    "readlines", "writelines", "submit", "result", "done", "shutdown",
})


@dataclasses.dataclass
class FuncInfo:
    """One function or method definition."""

    rel: str
    cls: Optional[str]
    name: str
    node: ast.AST              # FunctionDef / AsyncFunctionDef
    sf: SourceFile

    @property
    def qual(self) -> str:
        owner = f"{self.cls}." if self.cls else ""
        return f"{self.rel}::{owner}{self.name}"

    @property
    def short(self) -> str:
        """Human-facing name for witness traces."""
        return f"{self.cls}.{self.name}" if self.cls else self.name


class CallGraph:
    """Function index + unambiguous call-site resolution."""

    def __init__(self, files: List[SourceFile]):
        self.funcs: Dict[str, FuncInfo] = {}
        #: bare name -> every definition with that name (functions,
        #: methods, and class names standing for their __init__)
        self.by_name: Dict[str, List[FuncInfo]] = {}
        #: (rel, cls) -> {method name: FuncInfo}
        self.methods: Dict[tuple, Dict[str, FuncInfo]] = {}
        #: rel -> {function name: FuncInfo} (module level only)
        self.module_funcs: Dict[str, Dict[str, FuncInfo]] = {}
        for sf in files:
            self._index(sf)

    def _index(self, sf: SourceFile) -> None:
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FuncInfo(sf.rel, None, node.name, node, sf)
                self.funcs[fi.qual] = fi
                self.module_funcs.setdefault(sf.rel, {})[node.name] = fi
                self.by_name.setdefault(node.name, []).append(fi)
            elif isinstance(node, ast.ClassDef):
                for child in node.body:
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        fi = FuncInfo(sf.rel, node.name, child.name,
                                      child, sf)
                        self.funcs[fi.qual] = fi
                        self.methods.setdefault(
                            (sf.rel, node.name), {})[child.name] = fi
                        self.by_name.setdefault(
                            child.name, []).append(fi)
                        if child.name == "__init__":
                            # ``Foo()`` resolves to Foo.__init__
                            self.by_name.setdefault(
                                node.name, []).append(fi)

    # -- resolution ----------------------------------------------------
    def resolve(self, call: ast.Call, caller: FuncInfo
                ) -> Optional[FuncInfo]:
        f = call.func
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and caller.cls is not None:
                m = self.methods.get(
                    (caller.rel, caller.cls), {}).get(f.attr)
                if m is not None:
                    return m
            if f.attr in _AMBIENT_ATTRS:
                return None
            cands = self.by_name.get(f.attr, ())
            return cands[0] if len(cands) == 1 else None
        if isinstance(f, ast.Name):
            m = self.module_funcs.get(caller.rel, {}).get(f.id)
            if m is not None:
                return m
            cands = self.by_name.get(f.id, ())
            return cands[0] if len(cands) == 1 else None
        return None

    def method(self, rel: str, cls: str, name: str) -> Optional[FuncInfo]:
        return self.methods.get((rel, cls), {}).get(name)

    def class_methods(self, rel: str, cls: str) -> Dict[str, FuncInfo]:
        return self.methods.get((rel, cls), {})

    def class_reachable(self, rel: str, cls: str, roots) -> set:
        """Method names of ``cls`` reachable from ``roots`` through
        ``self.x()`` calls — the intraclass closure guarded-by inference
        walks from thread entry points."""
        table = self.class_methods(rel, cls)
        seen = set()
        work = [r for r in roots if r in table]
        while work:
            name = work.pop()
            if name in seen:
                continue
            seen.add(name)
            for call in (n for n in ast.walk(table[name].node)
                         if isinstance(n, ast.Call)):
                f = call.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == "self" and f.attr in table \
                        and f.attr not in seen:
                    work.append(f.attr)
        return seen


def build_callgraph(ctx) -> CallGraph:
    """Whole-package call graph, memoized on the context."""
    return ctx.memo("callgraph",
                    lambda c: CallGraph(c.package_files()))


__all__ = ["FuncInfo", "CallGraph", "build_callgraph"]
