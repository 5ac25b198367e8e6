"""srlint engine — source model, rule registry, suppressions, runner.

Kept stdlib-only and import-light: the engine itself never imports the
package under analysis (rules that need schema facts parse them out of
the source with :mod:`ast`), so srlint runs in environments where torch
or the card is missing — which is exactly when the importability rule
needs to fire. The port's copy of the reference's engine; only the
enforcement surface differs (:meth:`LintContext.package_files`,
:meth:`LintContext.test_files`).
"""

from __future__ import annotations

import ast
import dataclasses
import re
import traceback
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

#: ``# srlint: ignore[rule-a,rule-b]`` — on the flagged line, or on a
#: comment-only line directly above it
_SUPPRESS_RE = re.compile(r"#\s*srlint:\s*ignore\[([A-Za-z0-9_\-, ]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a repo-relative path and line.

    ``line`` is 1-based; 0 means file- or repo-level (not suppressible
    by line comment). ``obj`` optionally names the legacy
    ``check_markers`` failure object (a test module name, "scripts",
    "sparkrdma_tpu_torch"), as the reference's engine does.
    """

    rule: str
    path: str
    line: int
    message: str
    obj: str = ""

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


class SourceFile:
    """One repo file: text, split lines, lazy AST, parsed suppressions."""

    def __init__(self, root: Path, path: Path):
        self.root = root
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text(encoding="utf-8")
        self.lines = self.text.splitlines()
        self._tree: Optional[ast.AST] = None
        self._suppress: Optional[Dict[int, Set[str]]] = None

    @property
    def tree(self) -> ast.AST:
        """Parsed AST (raises SyntaxError — rules that only need text
        should not touch this on files they don't own)."""
        if self._tree is None:
            self._tree = ast.parse(self.text, filename=self.rel)
        return self._tree

    def suppressions(self) -> Dict[int, Set[str]]:
        """``{line: {rule ids suppressed on that line}}`` (1-based).

        A suppression on a comment-only line also covers the next line,
        so long statements can carry it without exceeding line length.
        """
        if self._suppress is None:
            sup: Dict[int, Set[str]] = {}
            for i, line in enumerate(self.lines, 1):
                m = _SUPPRESS_RE.search(line)
                if not m:
                    continue
                ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
                sup.setdefault(i, set()).update(ids)
                if line.strip().startswith("#"):
                    sup.setdefault(i + 1, set()).update(ids)
            self._suppress = sup
        return self._suppress

    def suppressed(self, rule_id: str, line: int) -> bool:
        return rule_id in self.suppressions().get(line, ())


class LintContext:
    """Cached view of one repo root, shared by every rule in a run."""

    def __init__(self, root):
        self.root = Path(root).resolve()
        self._cache: Dict[str, Optional[SourceFile]] = {}
        self._memo: Dict[str, object] = {}

    def memo(self, key: str, builder: Callable[["LintContext"], object]):
        """Build-once cache for cross-rule analyses (call graph, lock
        model): the first rule to ask pays the build, the rest reuse it
        — this is what keeps the five concurrency rules one AST pass."""
        if key not in self._memo:
            self._memo[key] = builder(self)
        return self._memo[key]

    def file(self, rel: str) -> Optional[SourceFile]:
        """The file at ``rel`` (repo-relative), or None when absent."""
        if rel not in self._cache:
            p = self.root / rel
            self._cache[rel] = SourceFile(self.root, p) if p.is_file() \
                else None
        return self._cache[rel]

    def glob(self, pattern: str) -> List[SourceFile]:
        out = []
        for p in sorted(self.root.glob(pattern)):
            if p.is_file():
                sf = self.file(p.relative_to(self.root).as_posix())
                if sf is not None:
                    out.append(sf)
        return out

    def package_files(self) -> List[SourceFile]:
        """Every ``sparkrdma_tpu_torch/**/*.py`` (the enforcement
        surface)."""
        return self.glob("sparkrdma_tpu_torch/**/*.py")

    def test_files(self) -> List[SourceFile]:
        """The port's own test modules, ``tests/test_torch_*.py``."""
        return self.glob("tests/test_torch_*.py")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered rule: id, one-line doc, legacy kind, check fn."""

    id: str
    doc: str
    kind: str
    check: Callable[[LintContext], List[Finding]]


_REGISTRY: Dict[str, Rule] = {}


def rule(rule_id: str, doc: str, kind: str = ""):
    """Class-free registration decorator for rule check functions.

    ``kind`` is the legacy ``check_markers`` failure-bucket name for the
    four ported rules; new rules leave it defaulted to the rule id.
    """
    def deco(fn: Callable[[LintContext], List[Finding]]):
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate srlint rule id {rule_id!r}")
        _REGISTRY[rule_id] = Rule(rule_id, doc, kind or rule_id, fn)
        return fn
    return deco


def all_rules() -> List[Rule]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    try:
        return _REGISTRY[rule_id]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(
            f"unknown srlint rule {rule_id!r} (known: {known})") from None


def run_rules(root, select: Optional[Sequence[str]] = None,
              ) -> List[Finding]:
    """Run rules against ``root``; returns surviving findings, sorted.

    ``select`` limits the run to the named rule ids (unknown names
    raise). Suppression comments are applied here, after the rules run,
    so rules stay suppression-oblivious. A rule that crashes reports
    itself as a finding instead of killing the run — a broken lint must
    fail loudly, not silently stop linting.
    """
    ctx = LintContext(root)
    rules = ([get_rule(r) for r in select] if select is not None
             else all_rules())
    findings: List[Finding] = []
    for r in rules:
        try:
            produced: Iterable[Finding] = r.check(ctx)
        except Exception:
            findings.append(Finding(
                r.id, "<srlint>", 0,
                f"rule crashed:\n{traceback.format_exc(limit=5)}"))
            continue
        for f in produced:
            sf = ctx.file(f.path)
            if sf is not None and f.line and sf.suppressed(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.rule, f.path, f.line, f.message))
    return findings


# ---------------------------------------------------------------------
# shared AST helpers (used by several rule modules)
# ---------------------------------------------------------------------

def call_str_arg(node: ast.Call) -> Optional[str]:
    """First positional arg of a call when it is a plain string literal."""
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def call_fstr_pattern(node: ast.Call) -> Optional[str]:
    """First positional arg as a wildcard pattern when it is an f-string:
    every interpolated hole becomes ``*`` (``f"serde.{op}_bytes"`` →
    ``"serde.*_bytes"``)."""
    if not node.args or not isinstance(node.args[0], ast.JoinedStr):
        return None
    parts = []
    for v in node.args[0].values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            parts.append("*")
    return "".join(parts)


def attr_name(node: ast.AST) -> Optional[str]:
    """``.attr`` of an Attribute node, else None."""
    return node.attr if isinstance(node, ast.Attribute) else None


def string_elts(node: ast.AST) -> Optional[List[str]]:
    """String elements of a literal tuple/list/set (or ``frozenset({...})``
    / ``frozenset((...))`` call); None when the node is anything else."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("frozenset", "set", "tuple") and node.args:
        node = node.args[0]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    return None


def module_assign(tree: ast.AST, name: str) -> Optional[ast.AST]:
    """The value node of a module-level ``name = ...`` / ``name: T = ...``
    assignment (first match wins)."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node.value
        elif isinstance(node, ast.AnnAssign):
            if isinstance(node.target, ast.Name) \
                    and node.target.id == name and node.value is not None:
                return node.value
    return None


def find_class(tree: ast.AST, name: str) -> Optional[ast.ClassDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


__all__ = ["Finding", "SourceFile", "LintContext", "Rule", "rule",
           "all_rules", "get_rule", "run_rules", "call_str_arg",
           "call_fstr_pattern", "attr_name", "string_elts",
           "module_assign", "find_class"]
