"""Contract-sync rules: stringly-typed schemas cross-checked by AST.

The reference's eight sync rules, anchored on the port's declaring
modules (``sparkrdma_tpu_torch/obs/journal.py``, ``faults.py``,
``config.py``, ``obs/names.py``, ...). The *declaration* is parsed out
of the source that owns it, never imported, so the lint works even when
the package can't import. The CLIs the rules read are the reference's
own (``scripts/shuffle_report.py`` and its siblings), which read the
port's journals, so the port's schemas are held against them.

Three rules also read a form the port writes where the reference
writes another, and fire on it as strictly:

- ``fault-site-sync``: ``faults.fire(site)`` where ``site`` is a
  parameter of a module-level function fires every literal its callers
  pass for it (``api/serde.py``'s ``_fire_codec``);
- ``config-key-sync``: a ``for name in ("a", "b"):`` loop over
  ``getattr(self, name)`` in ``__post_init__`` validates ``a`` and
  ``b``;
- ``counter-name-sync``: an f-string metric name whose holes are all
  parameters of a module-level function emits, for every call site,
  the name with that call's literals filled in (``api/serde.py``'s
  ``_count``); its shapes with some holes left open cover the declared
  wildcards.

A parameter resolves only when every call site found passes a literal
for it; otherwise the rule reads the construct as the reference does.
Every rule here skips quietly when its anchor file is absent — that is
what lets ``tests/test_torch_lint.py`` exercise one rule at a time
against a synthetic repo containing only the files that rule reads.
"""

from __future__ import annotations

import ast
import fnmatch
import itertools
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import (Finding, LintContext, SourceFile, find_class,
                   module_assign, rule, string_elts)

# ---------------------------------------------------------------------
# parameters resolved to their callers' literals (the port's idioms)
# ---------------------------------------------------------------------

class _CallIndex:
    """Module-level functions and every call by bare or attribute name,
    over the package: what resolves a parameter to the literals its
    callers pass."""

    def __init__(self, ctx: LintContext):
        #: function name -> [(rel, FunctionDef)], module level only
        self.defs: Dict[str, List[tuple]] = {}
        #: every def name, methods included (uniqueness test)
        self.def_count: Dict[str, int] = {}
        #: called name -> [(rel, Call)]
        self.calls: Dict[str, List[tuple]] = {}
        for sf in ctx.package_files():
            for node in sf.tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    self.defs.setdefault(node.name, []).append(
                        (sf.rel, node))
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    self.def_count[node.name] = \
                        self.def_count.get(node.name, 0) + 1
                elif isinstance(node, ast.Call):
                    f = node.func
                    name = f.id if isinstance(f, ast.Name) else (
                        f.attr if isinstance(f, ast.Attribute) else None)
                    if name is not None:
                        self.calls.setdefault(name, []).append(
                            (sf.rel, node))

    def callers(self, rel: str, fn: ast.FunctionDef) -> List[tuple]:
        """Call sites of module-level ``fn`` of ``rel``: every call by
        its name when the name is defined once in the package, else the
        bare-name calls in its own file."""
        sites = self.calls.get(fn.name, [])
        if self.def_count.get(fn.name, 0) == 1:
            return list(sites)
        return [(r, c) for r, c in sites
                if r == rel and isinstance(c.func, ast.Name)]

    def literal_bindings(self, rel: str, fn: ast.FunctionDef,
                         params: Set[str]) -> Optional[List[tuple]]:
        """``[(caller rel, line, {param: literal})]``, one per call
        site, or None when there is no call site, or some site passes
        anything but a string literal (or ``*args``/``**kw``) for one
        of ``params``."""
        a = fn.args
        if a.vararg is not None or a.kwarg is not None:
            return None
        positional = [p.arg for p in a.posonlyargs + a.args]
        defaults = dict(zip(positional[len(positional)
                                       - len(a.defaults):], a.defaults))
        defaults.update({p.arg: d for p, d in zip(a.kwonlyargs,
                                                  a.kw_defaults) if d})
        out = []
        for crel, call in self.callers(rel, fn):
            if any(isinstance(x, ast.Starred) for x in call.args) \
                    or any(k.arg is None for k in call.keywords):
                return None
            bound = dict(zip(positional, call.args))
            bound.update({k.arg: k.value for k in call.keywords})
            values = {}
            for p in params:
                v = bound.get(p, defaults.get(p))
                if not (isinstance(v, ast.Constant)
                        and isinstance(v.value, str)):
                    return None
                values[p] = v.value
            out.append((crel, call.lineno, values))
        return out or None


def _call_index(ctx: LintContext) -> _CallIndex:
    return ctx.memo("sync-call-index", _CallIndex)


def _module_funcs_with(tree: ast.AST):
    """``(module-level function, node inside it)`` for every node."""
    for fn in tree.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn):
                yield fn, node


def _param_names(fn: ast.FunctionDef) -> Set[str]:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


# ---------------------------------------------------------------------
# journal-schema-sync  (port of check_span_schema_sync)
# ---------------------------------------------------------------------

#: CLI scripts whose span-field reads must match the dataclass
SPAN_READERS = ("shuffle_report.py", "shuffle_trace.py", "shuffle_top.py")

#: span-field access pattern the lint recognizes; by convention the CLIs
#: bind a span dict to ``s`` or ``span`` before reading fields from it
SPAN_GET = re.compile(r'\b(?:s|span)\.get\(\s*"([A-Za-z0-9_]+)"')

#: rollup / heartbeat access patterns; by convention the CLIs bind a
#: rollup dict to ``rb`` and a heartbeat dict to ``hb``
ROLLUP_GET = re.compile(r'\brb\.get\(\s*"([A-Za-z0-9_]+)"')
HEARTBEAT_GET = re.compile(r'\bhb\.get\(\s*"([A-Za-z0-9_]+)"')

#: critical-path access patterns (schema v10): by convention the CLIs
#: bind a span's ``phase_s`` dict to ``ph`` before reading phases, and
#: bottleneck verdicts appear as ``...-bound`` string literals
PHASE_GET = re.compile(r'\bph\.get\(\s*"([A-Za-z0-9_]+)"')
VERDICT_LITERAL = re.compile(r'"([a-z]+-bound)"')


def _class_ann_fields(sf: SourceFile, cls_name: str) -> Optional[Set[str]]:
    """Annotated field names of a (dataclass) class body, or None."""
    cls = find_class(sf.tree, cls_name)
    if cls is None:
        return None
    return {stmt.target.id for stmt in cls.body
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)}


def _frozen_field_set(sf: SourceFile, name: str) -> Optional[Set[str]]:
    elts = None
    node = module_assign(sf.tree, name)
    if node is not None:
        elts = string_elts(node)
    return set(elts) if elts is not None else None


@rule("journal-schema-sync",
      "CLI journal-field reads name real ExchangeSpan/rollup/heartbeat "
      "fields", kind="schema-sync")
def check_journal_schema_sync(ctx: LintContext) -> List[Finding]:
    """Spans: ``total_bytes`` (a derived property serialized by
    ``to_dict``) and ``kind`` (the auxiliary-line tag) are allowed on
    top of the dataclass fields, exactly as in the original lint."""
    checks = []
    journal = ctx.file("sparkrdma_tpu_torch/obs/journal.py")
    if journal is not None:
        span_fields = _class_ann_fields(journal, "ExchangeSpan")
        if span_fields is not None:
            checks.append((SPAN_GET, span_fields | {"total_bytes", "kind"},
                           "span", "ExchangeSpan"))
    rollup = ctx.file("sparkrdma_tpu_torch/obs/rollup.py")
    if rollup is not None:
        for set_name, pattern, what in (
                ("ROLLUP_FIELDS", ROLLUP_GET, "rollup"),
                ("HEARTBEAT_FIELDS", HEARTBEAT_GET, "heartbeat")):
            fields = _frozen_field_set(rollup, set_name)
            if fields is not None:
                checks.append((pattern, fields, what,
                               f"obs.rollup.{set_name}"))
    cpath = ctx.file("sparkrdma_tpu_torch/obs/critical_path.py")
    if cpath is not None:
        for set_name, pattern, what in (
                ("PHASES", PHASE_GET, "critical-path phase"),
                ("VERDICTS", VERDICT_LITERAL, "bottleneck verdict")):
            names = _frozen_field_set(cpath, set_name)
            if names is not None:
                checks.append((pattern, names, what,
                               f"obs.critical_path.{set_name}"))
    findings = []
    for script in SPAN_READERS:
        sf = ctx.file(f"scripts/{script}")
        if sf is None:
            continue
        for lineno, line in enumerate(sf.lines, 1):
            for pattern, allowed, what, where in checks:
                for m in pattern.finditer(line):
                    if m.group(1) not in allowed:
                        findings.append(Finding(
                            "journal-schema-sync", sf.rel, lineno,
                            f"scripts/{script} reads {what} field "
                            f"{m.group(1)!r} which does not exist in "
                            f"{where} — rename the field or fix the "
                            "script", obj="scripts"))
    return findings


# ---------------------------------------------------------------------
# fault-site-sync  (port of check_fault_site_sync)
# ---------------------------------------------------------------------

#: fault-site call pattern: ``faults.fire("<site>")`` / ``_faults.fire``
#: (the single entry point every layer uses to consult the active plane)
FIRE_CALL = re.compile(r'\b(?:_?faults)\.fire\(\s*"([a-z0-9_.]+)"')


@rule("fault-site-sync",
      "faults.fire() call sites and faults.SITES agree both ways",
      kind="fault-site-sync")
def check_fault_site_sync(ctx: LintContext) -> List[Finding]:
    faults = ctx.file("sparkrdma_tpu_torch/faults.py")
    if faults is None:
        return []
    node = module_assign(faults.tree, "SITES")
    sites = string_elts(node) if node is not None else None
    if sites is None:
        return [Finding("fault-site-sync", faults.rel, 0,
                        "faults.SITES is not a literal tuple of site "
                        "names — the lint (and the fault_spec parser "
                        "docs) rely on it being one",
                        obj="sparkrdma_tpu_torch")]
    sites_line = (node.lineno if node is not None else 0)
    fired: Dict[str, List[tuple]] = {}
    index = _call_index(ctx)
    for sf in ctx.package_files():
        if sf.path.name == "faults.py":
            continue   # the registry itself, not a call site
        for lineno, line in enumerate(sf.lines, 1):
            for m in FIRE_CALL.finditer(line):
                fired.setdefault(m.group(1), []).append((sf.rel, lineno))
        # faults.fire(site) with ``site`` a parameter: the callers'
        # literals are the sites fired, at the callers' lines
        for fn, node in _module_funcs_with(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fire"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in ("faults", "_faults")
                    and node.args and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in _param_names(fn)):
                continue
            param = node.args[0].id
            for crel, cline, values in index.literal_bindings(
                    sf.rel, fn, {param}) or ():
                fired.setdefault(values[param], []).append((crel, cline))
    for where in fired.values():
        where.sort()
    findings = []
    for site, where in sorted(fired.items()):
        if site not in sites:
            rel, lineno = where[0]
            findings.append(Finding(
                "fault-site-sync", rel, lineno,
                f"{rel} fires unregistered fault site {site!r} — add it "
                "to faults.SITES or fix the call", obj="sparkrdma_tpu_torch"))
    for site in sites:
        if site not in fired:
            findings.append(Finding(
                "fault-site-sync", faults.rel, sites_line,
                f"faults.SITES registers {site!r} but no "
                "faults.fire(...) call site exists in the package — a "
                "fault_spec naming it would inject nothing",
                obj="sparkrdma_tpu_torch"))
    return findings


# ---------------------------------------------------------------------
# config-key-sync
# ---------------------------------------------------------------------

_NUMERIC_ANNOTATIONS = ("int", "float")


def _shuffleconf_surface(sf: SourceFile):
    """(fields, numeric fields, methods/properties, __post_init__ node)
    parsed out of the ``ShuffleConf`` class body."""
    cls = find_class(sf.tree, "ShuffleConf")
    if cls is None:
        return None
    fields: Dict[str, int] = {}
    numeric: Dict[str, int] = {}
    methods: Set[str] = set()
    post_init = None
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) \
                and isinstance(stmt.target, ast.Name):
            fields[stmt.target.id] = stmt.lineno
            ann = stmt.annotation
            if isinstance(ann, ast.Name) and ann.id in _NUMERIC_ANNOTATIONS:
                numeric[stmt.target.id] = stmt.lineno
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if stmt.name == "__post_init__":
                post_init = stmt
            elif not stmt.name.startswith("__"):
                methods.add(stmt.name)
    return fields, numeric, methods, post_init


def _getattr_loop_names(loop: ast.For) -> List[str]:
    """The names of ``for name in ("a", "b"): ... getattr(self, name)``
    — the loop validates each field it reads by name (empty when the
    loop is anything else)."""
    if not isinstance(loop.target, ast.Name):
        return []
    names = string_elts(loop.iter)
    if not names:
        return []
    for stmt in loop.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id == "getattr" and len(node.args) >= 2 \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id == "self" \
                    and isinstance(node.args[1], ast.Name) \
                    and node.args[1].id == loop.target.id:
                return names
    return []


@rule("config-key-sync",
      "ShuffleConf fields are validated, documented, read somewhere, "
      "and every conf.<attr> access names a real field")
def check_config_key_sync(ctx: LintContext) -> List[Finding]:
    """Convention the rule pins: locals/attributes named ``conf`` /
    ``_conf`` / ``cfg`` hold a ``ShuffleConf`` — the package uses those
    names for nothing else, which is what makes accesses checkable."""
    conf_sf = ctx.file("sparkrdma_tpu_torch/config.py")
    if conf_sf is None:
        return []
    surface = _shuffleconf_surface(conf_sf)
    if surface is None:
        return [Finding("config-key-sync", conf_sf.rel, 0,
                        "config.py defines no ShuffleConf class")]
    fields, numeric, methods, post_init = surface
    findings = []

    # (a) numeric fields must be range-checked in __post_init__
    validated: Set[str] = set()
    if post_init is not None:
        for node in ast.walk(post_init):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                validated.add(node.attr)
            elif isinstance(node, ast.For):
                validated.update(_getattr_loop_names(node))
    for name, lineno in sorted(numeric.items()):
        if name not in validated:
            findings.append(Finding(
                "config-key-sync", conf_sf.rel, lineno,
                f"numeric ShuffleConf field {name!r} is never touched "
                "by __post_init__ — add a range check (a bad value "
                "should fail at construction, not mid-shuffle)"))

    # (b) every field documented (backticked) in the README config table
    readme = ctx.file("README.md")
    if readme is not None:
        section, header_line = "", 0
        m = re.search(r"^## Configuration\b.*$", readme.text, re.M)
        if m:
            header_line = readme.text[:m.start()].count("\n") + 1
            rest = readme.text[m.end():]
            nxt = re.search(r"^## ", rest, re.M)
            section = rest[:nxt.start()] if nxt else rest
        for name, _ in sorted(fields.items()):
            if f"`{name}`" not in section:
                findings.append(Finding(
                    "config-key-sync", readme.rel, header_line,
                    f"ShuffleConf field {name!r} is not documented in "
                    "the README '## Configuration' section — add a "
                    "table row (backticked name)"))

    # (c) every field read somewhere in the package; (d) every
    # conf.<attr> access names a real field/property/method. Reads
    # inside config.py itself count (fields consumed through derived
    # properties like prealloc_classes are wired up), but __post_init__
    # does not — validation alone must not satisfy the "read" check.
    read: Set[str] = set()
    conf_receivers = ("conf", "_conf", "cfg")
    post_init_nodes = ({id(n) for n in ast.walk(post_init)}
                       if post_init is not None else set())
    for sf in ctx.package_files():
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Attribute):
                continue
            if sf.rel == conf_sf.rel and id(node) in post_init_nodes:
                continue
            if node.attr in fields:
                read.add(node.attr)
            base = node.value
            is_conf = (isinstance(base, ast.Name)
                       and base.id in conf_receivers) or \
                      (isinstance(base, ast.Attribute)
                       and base.attr in conf_receivers)
            if is_conf and not node.attr.startswith("__") \
                    and node.attr not in fields \
                    and node.attr not in methods:
                findings.append(Finding(
                    "config-key-sync", sf.rel, node.lineno,
                    f"conf.{node.attr} does not name a ShuffleConf "
                    "field or property — typo, or a field that was "
                    "removed"))
    for name, lineno in sorted(fields.items()):
        if name not in read:
            findings.append(Finding(
                "config-key-sync", conf_sf.rel, lineno,
                f"ShuffleConf field {name!r} is never read anywhere in "
                "the package — dead knob (delete it or wire it up)"))
    return findings


# ---------------------------------------------------------------------
# counter-name-sync
# ---------------------------------------------------------------------

_EMIT_ATTRS = ("counter", "gauge", "histogram")

#: metric-shaped strings the CLI scan considers, e.g. ``pool.hits`` or
#: ``pool.outstanding (hb)``
_METRIC_SHAPE = re.compile(r"^[a-z_]+(\.[a-z_]+)+( \(hb\))?$")

#: dotted strings that are filenames, not metric names
_FILE_SUFFIXES = (".py", ".so", ".cpp", ".md", ".txt", ".log",
                  ".json", ".jsonl", ".gz")


def _declared_names(names_sf: SourceFile):
    """Parse obs/names.py: per-set name→lineno maps, or None if any of
    the five declarations is missing/non-literal."""
    out = {}
    const_lines = {}
    for node in ast.walk(names_sf.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            const_lines.setdefault(node.value, node.lineno)
    for set_name in ("COUNTERS", "GAUGES", "HISTOGRAMS",
                     "TIMELINE_TRACKS", "WILDCARDS"):
        node = module_assign(names_sf.tree, set_name)
        elts = string_elts(node) if node is not None else None
        if elts is None:
            return None
        out[set_name] = {e: const_lines.get(e, 0) for e in elts}
    return out


def _name_arg_exprs(call: ast.Call) -> List[ast.AST]:
    """The expression(s) a call's first argument can evaluate to —
    unwraps conditional expressions, so
    ``counter(f"a.{x}" if flag else f"b.{x}")`` yields both arms."""
    if not call.args:
        return []
    out, stack = [], [call.args[0]]
    while stack:
        e = stack.pop()
        if isinstance(e, ast.IfExp):
            stack.extend((e.body, e.orelse))
        else:
            out.append(e)
    return out


def _as_pattern(expr: ast.AST) -> Optional[str]:
    """An f-string's literal skeleton with ``*`` per hole, else None."""
    if not isinstance(expr, ast.JoinedStr):
        return None
    parts = []
    for v in expr.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            parts.append("*")
    return "".join(parts)


def _resolve_fstring(expr: ast.AST, fn: Optional[ast.FunctionDef],
                     rel: str, index: _CallIndex) -> Optional[List[tuple]]:
    """For an f-string inside module-level ``fn`` whose every hole is a
    bare parameter of ``fn``: ``[(caller rel, line, name, shapes)]``,
    one per call site, where ``name`` has that call's literals filled
    in and ``shapes`` are the name with each subset of holes left as
    ``*``. None when the f-string is anything else or a parameter does
    not resolve at every call site."""
    if fn is None or not isinstance(expr, ast.JoinedStr):
        return None
    params = _param_names(fn)
    holes = [v.value.id for v in expr.values
             if isinstance(v, ast.FormattedValue)
             and isinstance(v.value, ast.Name)]
    n_holes = sum(isinstance(v, ast.FormattedValue) for v in expr.values)
    if not holes or len(holes) != n_holes \
            or any(v.format_spec is not None or v.conversion != -1
                   for v in expr.values
                   if isinstance(v, ast.FormattedValue)) \
            or not set(holes) <= params:
        return None
    sites = index.literal_bindings(rel, fn, set(holes))
    if sites is None:
        return None
    out = []
    for crel, cline, values in sites:
        shapes = set()
        for keep in itertools.product((False, True), repeat=len(holes)):
            parts, i = [], 0
            for v in expr.values:
                if isinstance(v, ast.FormattedValue):
                    parts.append("*" if keep[i] else values[holes[i]])
                    i += 1
                else:
                    parts.append(v.value)
            shapes.add("".join(parts))
        name = "".join(values[v.value.id]
                       if isinstance(v, ast.FormattedValue) else v.value
                       for v in expr.values)
        out.append((crel, cline, name, shapes))
    return out


def _docstring_ids(tree: ast.AST) -> Set[int]:
    """ids of every statement-position string constant (docstrings and
    bare-string separators) — excluded from the CLI name scan."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Expr) \
                and isinstance(node.value, ast.Constant):
            out.add(id(node.value))
    return out


@rule("counter-name-sync",
      "every emitted metric name is declared in obs/names.py, every "
      "declared name is emitted, and CLI reads name real metrics")
def check_counter_name_sync(ctx: LintContext) -> List[Finding]:
    names_sf = ctx.file("sparkrdma_tpu_torch/obs/names.py")
    if names_sf is None:
        return []
    declared = _declared_names(names_sf)
    if declared is None:
        return [Finding("counter-name-sync", names_sf.rel, 0,
                        "obs/names.py must declare COUNTERS, GAUGES, "
                        "HISTOGRAMS, TIMELINE_TRACKS and WILDCARDS as "
                        "literal frozensets of strings")]
    counters = set(declared["COUNTERS"])
    gauges = set(declared["GAUGES"])
    histograms = set(declared["HISTOGRAMS"])
    tracks = set(declared["TIMELINE_TRACKS"])
    wildcards = set(declared["WILDCARDS"])
    allowed_by_kind = {
        # timeline.counter() tracks share the method name with registry
        # counters, so the counter kind accepts both namespaces
        "counter": counters | tracks,
        "gauge": gauges,
        "histogram": histograms,
    }
    all_declared = counters | gauges | histograms | tracks

    emitted: Set[str] = set()
    emitted_patterns: Set[str] = set()
    findings = []
    index = _call_index(ctx)

    def declared_ok(kind: str, name: str) -> bool:
        return name in allowed_by_kind[kind] or any(
            fnmatch.fnmatchcase(name, w) for w in wildcards)

    for sf in ctx.package_files():
        if sf.rel == names_sf.rel:
            continue
        owner = {id(node): fn for fn, node in _module_funcs_with(sf.tree)}
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EMIT_ATTRS):
                continue
            kind = node.func.attr
            for expr in _name_arg_exprs(node):
                resolved = _resolve_fstring(expr, owner.get(id(node)),
                                            sf.rel, index)
                if resolved is not None:
                    # the name each caller's literals make, at its line
                    for crel, cline, name, shapes in resolved:
                        emitted.add(name)
                        emitted_patterns.update(shapes)
                        if not declared_ok(kind, name):
                            findings.append(Finding(
                                "counter-name-sync", crel, cline,
                                f".{kind}({name!r}) emits a metric name "
                                "not declared in obs/names.py — add it "
                                "to the registry or fix the name"))
                    continue
                if isinstance(expr, ast.Constant) \
                        and isinstance(expr.value, str):
                    name = expr.value
                    emitted.add(name)
                    if not declared_ok(kind, name):
                        findings.append(Finding(
                            "counter-name-sync", sf.rel, node.lineno,
                            f".{kind}({name!r}) emits a metric name "
                            "not declared in obs/names.py — add it to "
                            "the registry or fix the name"))
                    continue
                pattern = _as_pattern(expr)
                if pattern is not None:
                    emitted_patterns.add(pattern)
                    if pattern not in wildcards:
                        findings.append(Finding(
                            "counter-name-sync", sf.rel, node.lineno,
                            f".{kind}(f\"...\") matches wildcard shape "
                            f"{pattern!r} which is not declared in "
                            "obs/names.py WILDCARDS"))
                # non-constant, non-fstring names can't be checked
                # statically

    for name in sorted(all_declared):
        if name not in emitted:
            line = (declared["COUNTERS"].get(name)
                    or declared["GAUGES"].get(name)
                    or declared["HISTOGRAMS"].get(name)
                    or declared["TIMELINE_TRACKS"].get(name) or 0)
            findings.append(Finding(
                "counter-name-sync", names_sf.rel, line,
                f"obs/names.py declares {name!r} but nothing in the "
                "package emits it — stale registry entry"))
    for pattern in sorted(wildcards):
        if pattern not in emitted_patterns:
            findings.append(Finding(
                "counter-name-sync", names_sf.rel,
                declared["WILDCARDS"].get(pattern, 0),
                f"obs/names.py declares wildcard {pattern!r} but no "
                "f-string emission matches it"))

    # CLI side: dotted metric-name strings the scripts read back must
    # name something the package actually emits
    for script in SPAN_READERS:
        sf = ctx.file(f"scripts/{script}")
        if sf is None:
            continue
        doc_ids = _docstring_ids(sf.tree)
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and id(node) not in doc_ids):
                continue
            val = node.value
            if not _METRIC_SHAPE.match(val) \
                    or val.endswith(_FILE_SUFFIXES):
                continue
            base = val[:-5] if val.endswith(" (hb)") else val
            ok = base in all_declared or any(
                fnmatch.fnmatchcase(base, w) for w in wildcards)
            if not ok:
                findings.append(Finding(
                    "counter-name-sync", sf.rel, node.lineno,
                    f"scripts/{script} reads metric {base!r} which is "
                    "not declared in obs/names.py — it would render as "
                    "zero forever"))
    return findings


# ---------------------------------------------------------------------
# alert-rule-sync
# ---------------------------------------------------------------------

#: alert-line access pattern; by convention the CLIs bind an alert dict
#: to ``al`` before reading fields from it (the rb/hb convention)
ALERT_GET = re.compile(r'\bal\.get\(\s*"([A-Za-z0-9_]+)"')


def _alert_rule_registrations(sf: SourceFile) -> List[tuple]:
    """``(rule_id, lineno, [metric names])`` per ``alert_rule(...)`` /
    ``AlertRule(...)`` registration in obs/alerts.py. Non-literal ids
    or metrics tuples yield ``None`` entries the caller flags."""
    regs = []
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call)
                and ((isinstance(node.func, ast.Name)
                      and node.func.id in ("alert_rule", "AlertRule")))):
            continue
        rid = None
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            rid = node.args[0].value
        metrics: Optional[List[str]] = []
        for kw in node.keywords:
            if kw.arg == "id" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                rid = kw.value.value
            if kw.arg == "metrics":
                elts = string_elts(kw.value)
                metrics = list(elts) if elts is not None else None
        regs.append((rid, node.lineno, metrics))
    return regs


def _alert_line_keys(sf: SourceFile) -> Optional[tuple]:
    """(keys, lineno) of the ``{"kind": "alert", ...}`` dict literal the
    emitter builds, or None when no such literal exists."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Dict):
            continue
        keys = []
        is_alert = False
        literal = True
        for k, v in zip(node.keys, node.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                literal = False
                break
            keys.append(k.value)
            if k.value == "kind" and isinstance(v, ast.Constant) \
                    and v.value == "alert":
                is_alert = True
        if literal and is_alert:
            return set(keys), node.lineno
    return None


@rule("alert-rule-sync",
      "ALERT_RULES metrics name declared metrics, the alert-line "
      "emitter matches ALERT_FIELDS exactly, and CLI alert-field reads "
      "exist on the schema", kind="schema-sync")
def check_alert_rule_sync(ctx: LintContext) -> List[Finding]:
    """Convention the rule pins: CLIs bind an alert dict to ``al``
    before reading fields (the span/rb/hb convention), and every rule
    registration declares the registry metrics it consumes as a literal
    ``metrics=(...)`` tuple."""
    alerts_sf = ctx.file("sparkrdma_tpu_torch/obs/alerts.py")
    if alerts_sf is None:
        return []
    findings = []
    fields = _frozen_field_set(alerts_sf, "ALERT_FIELDS")
    if fields is None:
        return [Finding("alert-rule-sync", alerts_sf.rel, 0,
                        "obs/alerts.py must declare ALERT_FIELDS as a "
                        "literal frozenset of strings",
                        obj="sparkrdma_tpu_torch")]

    # (a) the emitter's dict literal carries exactly ALERT_FIELDS —
    # both directions, so a key added to one side must hit the other
    line_keys = _alert_line_keys(alerts_sf)
    if line_keys is None:
        findings.append(Finding(
            "alert-rule-sync", alerts_sf.rel, 0,
            "obs/alerts.py builds no literal {\"kind\": \"alert\"} "
            "line dict — the emitter drifted from the lintable shape",
            obj="sparkrdma_tpu_torch"))
    else:
        keys, lineno = line_keys
        for extra in sorted(keys - fields):
            findings.append(Finding(
                "alert-rule-sync", alerts_sf.rel, lineno,
                f"the alert line emits key {extra!r} missing from "
                "ALERT_FIELDS — declare it", obj="sparkrdma_tpu_torch"))
        for missing in sorted(fields - keys):
            findings.append(Finding(
                "alert-rule-sync", alerts_sf.rel, lineno,
                f"ALERT_FIELDS declares {missing!r} but the alert line "
                "never emits it — stale schema entry",
                obj="sparkrdma_tpu_torch"))

    # (b) every rule's declared metrics exist in obs/names.py (exact
    # name or declared wildcard pattern)
    names_sf = ctx.file("sparkrdma_tpu_torch/obs/names.py")
    declared = _declared_names(names_sf) if names_sf is not None else None
    if declared is not None:
        all_declared = (set(declared["COUNTERS"])
                        | set(declared["GAUGES"])
                        | set(declared["HISTOGRAMS"]))
        wildcards = set(declared["WILDCARDS"])
        for rid, lineno, metrics in _alert_rule_registrations(alerts_sf):
            label = rid if rid is not None else "<non-literal id>"
            if metrics is None:
                # non-literal metrics tuples (the decorator helper
                # forwarding its parameter) can't be checked statically
                continue
            for m in metrics:
                ok = m in all_declared or m in wildcards or any(
                    fnmatch.fnmatchcase(m, w) for w in wildcards)
                if not ok:
                    findings.append(Finding(
                        "alert-rule-sync", alerts_sf.rel, lineno,
                        f"alert rule {label!r} references metric {m!r} "
                        "which obs/names.py does not declare — the rule "
                        "would watch a series nothing emits",
                        obj="sparkrdma_tpu_torch"))

    # (c) every CLI read of an alert field exists on the schema
    for script in SPAN_READERS:
        sf = ctx.file(f"scripts/{script}")
        if sf is None:
            continue
        for lineno, line in enumerate(sf.lines, 1):
            for m in ALERT_GET.finditer(line):
                if m.group(1) not in fields:
                    findings.append(Finding(
                        "alert-rule-sync", sf.rel, lineno,
                        f"scripts/{script} reads alert field "
                        f"{m.group(1)!r} which does not exist in "
                        "obs.alerts.ALERT_FIELDS — rename the field or "
                        "fix the script", obj="scripts"))
    return findings


# ---------------------------------------------------------------------
# trace-schema-sync
# ---------------------------------------------------------------------

#: job / stage access patterns; by convention the CLIs bind a
#: ``{"kind": "job"}`` dict to ``jb`` and a per-stage record (one entry
#: of its ``stages`` list) to ``st``. Both quote styles are accepted —
#: job readers often sit inside f-strings where the inner delimiter
#: must be the other quote.
JOB_GET = re.compile(r'\bjb\.get\(\s*[\'"]([A-Za-z0-9_]+)[\'"]')
STAGE_GET = re.compile(r'\bst\.get\(\s*[\'"]([A-Za-z0-9_]+)[\'"]')

#: workload stage annotations: ``_trace.stage("<name>")`` /
#: ``trace.stage(...)`` / ``auto_stage(...)`` with a literal name.
#: Calls passing a variable can't be checked statically and are skipped.
STAGE_CALL = re.compile(
    r'\b(?:_?trace\.)?(?:auto_)?stage\(\s*[\'"]([A-Za-z0-9_]+)[\'"]')


def _dict_literal_keys(sf: SourceFile, name: str) -> Optional[tuple]:
    """(string keys, lineno) of a module-level ``name = {...}`` dict
    literal, or None when absent / not a literal-keyed dict."""
    node = module_assign(sf.tree, name)
    if not isinstance(node, ast.Dict):
        return None
    keys = []
    for k in node.keys:
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        keys.append(k.value)
    return set(keys), node.lineno


@rule("trace-schema-sync",
      "CLI job/stage-field reads name real JOB_FIELDS/STAGE_FIELDS "
      "keys, stage-advice tables and workload stage annotations use "
      "the declared STAGE_VOCAB", kind="schema-sync")
def check_trace_schema_sync(ctx: LintContext) -> List[Finding]:
    """Convention the rule pins: CLIs bind a ``{"kind": "job"}`` dict
    to ``jb`` and a per-stage record to ``st`` before reading fields
    (the span/rb/hb/al convention — ``st`` is reserved for stage
    records in the three span-reader scripts), and workloads annotate
    stages with literal names drawn from ``obs.trace.STAGE_VOCAB``.
    Ad-hoc user stage names stay legal at runtime; the vocabulary only
    pins what ships in-tree so ``shuffle_report --doctor`` advice keys
    can never dangle."""
    trace_sf = ctx.file("sparkrdma_tpu_torch/obs/trace.py")
    if trace_sf is None:
        return []
    findings = []
    checks = []
    for set_name, pattern, what in (
            ("JOB_FIELDS", JOB_GET, "job"),
            ("STAGE_FIELDS", STAGE_GET, "stage")):
        fields = _frozen_field_set(trace_sf, set_name)
        if fields is None:
            findings.append(Finding(
                "trace-schema-sync", trace_sf.rel, 0,
                f"obs/trace.py must declare {set_name} as a literal "
                "frozenset of strings", obj="sparkrdma_tpu_torch"))
            continue
        checks.append((pattern, fields, what, f"obs.trace.{set_name}"))

    # (a) every CLI read of a job/stage field exists on the schema
    for script in SPAN_READERS:
        sf = ctx.file(f"scripts/{script}")
        if sf is None:
            continue
        for lineno, line in enumerate(sf.lines, 1):
            for pattern, allowed, what, where in checks:
                for m in pattern.finditer(line):
                    if m.group(1) not in allowed:
                        findings.append(Finding(
                            "trace-schema-sync", sf.rel, lineno,
                            f"scripts/{script} reads {what} field "
                            f"{m.group(1)!r} which does not exist in "
                            f"{where} — rename the field or fix the "
                            "script", obj="scripts"))

    vocab = _frozen_field_set(trace_sf, "STAGE_VOCAB")
    if vocab is None:
        findings.append(Finding(
            "trace-schema-sync", trace_sf.rel, 0,
            "obs/trace.py must declare STAGE_VOCAB as a literal "
            "frozenset of strings", obj="sparkrdma_tpu_torch"))
        return findings

    # (b) shuffle_report's stage-advice table keys on declared stages
    # only — an advice key outside the vocabulary can never match a
    # shipped workload and would silently never fire
    report_sf = ctx.file("scripts/shuffle_report.py")
    if report_sf is not None:
        advice = _dict_literal_keys(report_sf, "STAGE_ADVICE")
        if advice is not None:
            keys, lineno = advice
            for extra in sorted(keys - vocab):
                findings.append(Finding(
                    "trace-schema-sync", report_sf.rel, lineno,
                    f"STAGE_ADVICE keys on stage {extra!r} which is "
                    "not in obs.trace.STAGE_VOCAB — add the stage to "
                    "the vocabulary or drop the advice row",
                    obj="scripts"))

    # (c) in-tree stage annotations use the declared vocabulary
    for sf in ctx.package_files():
        if sf.rel == trace_sf.rel:
            continue   # the declaring module, not an annotation site
        for lineno, line in enumerate(sf.lines, 1):
            for m in STAGE_CALL.finditer(line):
                if m.group(1) not in vocab:
                    findings.append(Finding(
                        "trace-schema-sync", sf.rel, lineno,
                        f"{sf.rel} annotates stage {m.group(1)!r} "
                        "which is not in obs.trace.STAGE_VOCAB — "
                        "register the name so report/doctor advice "
                        "and lint stay in sync", obj="sparkrdma_tpu_torch"))
    return findings


# ---------------------------------------------------------------------
# plan-schema-sync
# ---------------------------------------------------------------------

#: plan-line access pattern; by convention the CLIs bind a
#: ``{"kind": "plan"}`` dict to ``pl`` before reading fields from it
#: (the span/rb/hb/al/jb convention)
PLAN_GET = re.compile(r'\bpl\.get\(\s*[\'"]([A-Za-z0-9_]+)[\'"]')


def _plan_line_keys(sf: SourceFile) -> Optional[tuple]:
    """(keys, lineno) of the ``{"kind": "plan", ...}`` dict literal the
    emitter builds, or None when no such literal exists."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Dict):
            continue
        keys = []
        is_plan = False
        literal = True
        for k, v in zip(node.keys, node.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                literal = False
                break
            keys.append(k.value)
            if k.value == "kind" and isinstance(v, ast.Constant) \
                    and v.value == "plan":
                is_plan = True
        if literal and is_plan:
            return set(keys), node.lineno
    return None


@rule("plan-schema-sync",
      "the plan-line emitter matches PLAN_FIELDS exactly and CLI "
      "plan-field reads exist on the schema", kind="schema-sync")
def check_plan_schema_sync(ctx: LintContext) -> List[Finding]:
    """Convention the rule pins: CLIs bind a ``{"kind": "plan"}`` dict
    to ``pl`` before reading fields (the span/rb/hb/al/jb convention),
    and ``plan/executor.py`` builds the journal line as a literal dict
    next to its ``PLAN_FIELDS`` declaration. The executor's own
    RuntimeError drift check runs only when a rewrite actually fires;
    this rule catches the drift at lint time, on both sides."""
    exec_sf = ctx.file("sparkrdma_tpu_torch/plan/executor.py")
    if exec_sf is None:
        return []
    findings = []
    fields = _frozen_field_set(exec_sf, "PLAN_FIELDS")
    if fields is None:
        return [Finding("plan-schema-sync", exec_sf.rel, 0,
                        "plan/executor.py must declare PLAN_FIELDS as a "
                        "literal frozenset of strings",
                        obj="sparkrdma_tpu_torch")]

    # (a) the emitter's dict literal carries exactly PLAN_FIELDS —
    # both directions, so a key added to one side must hit the other
    line_keys = _plan_line_keys(exec_sf)
    if line_keys is None:
        findings.append(Finding(
            "plan-schema-sync", exec_sf.rel, 0,
            "plan/executor.py builds no literal {\"kind\": \"plan\"} "
            "line dict — the emitter drifted from the lintable shape",
            obj="sparkrdma_tpu_torch"))
    else:
        keys, lineno = line_keys
        for extra in sorted(keys - fields):
            findings.append(Finding(
                "plan-schema-sync", exec_sf.rel, lineno,
                f"the plan line emits key {extra!r} missing from "
                "PLAN_FIELDS — declare it", obj="sparkrdma_tpu_torch"))
        for missing in sorted(fields - keys):
            findings.append(Finding(
                "plan-schema-sync", exec_sf.rel, lineno,
                f"PLAN_FIELDS declares {missing!r} but the plan line "
                "never emits it — stale schema entry",
                obj="sparkrdma_tpu_torch"))

    # (b) every CLI read of a plan field exists on the schema
    for script in SPAN_READERS:
        sf = ctx.file(f"scripts/{script}")
        if sf is None:
            continue
        for lineno, line in enumerate(sf.lines, 1):
            for m in PLAN_GET.finditer(line):
                if m.group(1) not in fields:
                    findings.append(Finding(
                        "plan-schema-sync", sf.rel, lineno,
                        f"scripts/{script} reads plan field "
                        f"{m.group(1)!r} which does not exist in "
                        "plan.executor.PLAN_FIELDS — rename the field "
                        "or fix the script", obj="scripts"))
    return findings


# ---------------------------------------------------------------------
# rpc-schema-sync
# ---------------------------------------------------------------------

#: lease-row access pattern; by convention the CLIs bind a lease-table
#: row (or a ``{"kind": "lease"}`` journal line) to ``ls`` before
#: reading fields from it (the span/rb/hb/al/jb/pl convention)
LEASE_GET = re.compile(r'\bls\.get\(\s*[\'"]([A-Za-z0-9_]+)[\'"]')

#: client-side op call sites: every RpcClient convenience method funnels
#: through ``self._call("<op>", ...)``
RPC_CALL = re.compile(r'\b_call\(\s*"([a-z_]+)"')

#: the frozensets service/wire.py must declare (the protocol's single
#: source of truth)
_WIRE_SETS = ("REQUEST_FIELDS", "REPLY_FIELDS", "OPS", "LEASE_FIELDS")


def _marked_dict_keys(sf: SourceFile, marker: str,
                      value: Optional[str] = None) -> Optional[tuple]:
    """(keys, lineno) of the first all-literal dict whose string keys
    include ``marker`` (and, when given, map it to ``value``)."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Dict):
            continue
        keys = []
        hit = False
        literal = True
        for k, v in zip(node.keys, node.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                literal = False
                break
            keys.append(k.value)
            if k.value == marker and (
                    value is None
                    or (isinstance(v, ast.Constant)
                        and v.value == value)):
                hit = True
        if literal and hit:
            return set(keys), node.lineno
    return None


def _pin_dict(findings: List[Finding], rel: str, keys: Set[str],
              lineno: int, declared: Set[str], what: str,
              set_name: str) -> None:
    """Both-direction key pin of one emitter dict against its set."""
    for extra in sorted(keys - declared):
        findings.append(Finding(
            "rpc-schema-sync", rel, lineno,
            f"the {what} carries key {extra!r} missing from "
            f"wire.{set_name} — declare it", obj="sparkrdma_tpu_torch"))
    for missing in sorted(declared - keys):
        findings.append(Finding(
            "rpc-schema-sync", rel, lineno,
            f"wire.{set_name} declares {missing!r} but the {what} "
            "never carries it — stale schema entry",
            obj="sparkrdma_tpu_torch"))


@rule("rpc-schema-sync",
      "client request / server reply / lease-line field sets match "
      "service/wire.py both directions, the op vocabulary is pinned "
      "three-way, and CLI lease-field reads exist on the schema",
      kind="schema-sync")
def check_rpc_schema_sync(ctx: LintContext) -> List[Finding]:
    """Convention the rule pins: ``service/wire.py`` owns the protocol
    as four literal frozensets; ``service/client.py`` builds its
    request envelope as ONE literal dict (the one carrying an ``"op"``
    key) and funnels every op through ``_call("<op>")``;
    ``service/rpc.py`` builds its reply envelope as the literal dict
    carrying an ``"ok"`` key, its lease line as the ``{"kind":
    "lease"}`` literal, and routes ops through the handler-table
    literal containing the ``"hello"`` key. CLIs bind lease rows to
    ``ls``. The runtime drift checks only fire when a line is emitted;
    this rule catches every drift at lint time."""
    wire_sf = ctx.file("sparkrdma_tpu_torch/service/wire.py")
    if wire_sf is None:
        return []
    findings: List[Finding] = []
    sets: Dict[str, Optional[Set[str]]] = {}
    for name in _WIRE_SETS:
        sets[name] = _frozen_field_set(wire_sf, name)
        if sets[name] is None:
            findings.append(Finding(
                "rpc-schema-sync", wire_sf.rel, 0,
                f"service/wire.py must declare {name} as a literal "
                "frozenset of strings", obj="sparkrdma_tpu_torch"))
    if any(v is None for v in sets.values()):
        return findings

    # (a) the client's request envelope == REQUEST_FIELDS, and its
    # _call("<op>") sites cover OPS exactly (both directions)
    client_sf = ctx.file("sparkrdma_tpu_torch/service/client.py")
    if client_sf is not None:
        req = _marked_dict_keys(client_sf, "op")
        if req is None:
            findings.append(Finding(
                "rpc-schema-sync", client_sf.rel, 0,
                "service/client.py builds no literal request dict "
                "(an all-literal dict carrying an \"op\" key) — the "
                "envelope drifted from the lintable shape",
                obj="sparkrdma_tpu_torch"))
        else:
            _pin_dict(findings, client_sf.rel, req[0], req[1],
                      sets["REQUEST_FIELDS"], "request envelope",
                      "REQUEST_FIELDS")
        called: Dict[str, int] = {}
        for lineno, line in enumerate(client_sf.lines, 1):
            for m in RPC_CALL.finditer(line):
                called.setdefault(m.group(1), lineno)
        for op, lineno in sorted(called.items()):
            if op not in sets["OPS"]:
                findings.append(Finding(
                    "rpc-schema-sync", client_sf.rel, lineno,
                    f"client calls op {op!r} which is not in wire.OPS "
                    "— typo, or an op that was removed",
                    obj="sparkrdma_tpu_torch"))
        for op in sorted(sets["OPS"] - set(called)):
            findings.append(Finding(
                "rpc-schema-sync", client_sf.rel, 0,
                f"wire.OPS declares {op!r} but service/client.py has "
                "no _call(\"" + op + "\") site — dead op or missing "
                "client method", obj="sparkrdma_tpu_torch"))

    # (b) the server's reply envelope == REPLY_FIELDS, its lease line
    # == LEASE_FIELDS, and the handler table's keys == OPS
    rpc_sf = ctx.file("sparkrdma_tpu_torch/service/rpc.py")
    if rpc_sf is not None:
        rep = _marked_dict_keys(rpc_sf, "ok")
        if rep is None:
            findings.append(Finding(
                "rpc-schema-sync", rpc_sf.rel, 0,
                "service/rpc.py builds no literal reply dict (an "
                "all-literal dict carrying an \"ok\" key) — the "
                "envelope drifted from the lintable shape",
                obj="sparkrdma_tpu_torch"))
        else:
            _pin_dict(findings, rpc_sf.rel, rep[0], rep[1],
                      sets["REPLY_FIELDS"], "reply envelope",
                      "REPLY_FIELDS")
        lease = _marked_dict_keys(rpc_sf, "kind", "lease")
        if lease is None:
            findings.append(Finding(
                "rpc-schema-sync", rpc_sf.rel, 0,
                "service/rpc.py builds no literal {\"kind\": "
                "\"lease\"} line dict — the emitter drifted from the "
                "lintable shape", obj="sparkrdma_tpu_torch"))
        else:
            _pin_dict(findings, rpc_sf.rel, lease[0], lease[1],
                      sets["LEASE_FIELDS"], "lease line",
                      "LEASE_FIELDS")
        table = _marked_dict_keys(rpc_sf, "hello")
        if table is None:
            findings.append(Finding(
                "rpc-schema-sync", rpc_sf.rel, 0,
                "service/rpc.py has no literal handler table (a dict "
                "literal keyed by op names, incl. \"hello\") — "
                "dispatch drifted from the lintable shape",
                obj="sparkrdma_tpu_torch"))
        else:
            keys, lineno = table
            for extra in sorted(keys - sets["OPS"]):
                findings.append(Finding(
                    "rpc-schema-sync", rpc_sf.rel, lineno,
                    f"the server handles op {extra!r} which is not in "
                    "wire.OPS — declare it", obj="sparkrdma_tpu_torch"))
            for missing in sorted(sets["OPS"] - keys):
                findings.append(Finding(
                    "rpc-schema-sync", rpc_sf.rel, lineno,
                    f"wire.OPS declares {missing!r} but the server "
                    "handler table has no entry for it — unhandled op",
                    obj="sparkrdma_tpu_torch"))

    # (c) every CLI read of a lease field exists on the schema
    for script in SPAN_READERS:
        sf = ctx.file(f"scripts/{script}")
        if sf is None:
            continue
        for lineno, line in enumerate(sf.lines, 1):
            for m in LEASE_GET.finditer(line):
                if m.group(1) not in sets["LEASE_FIELDS"]:
                    findings.append(Finding(
                        "rpc-schema-sync", sf.rel, lineno,
                        f"scripts/{script} reads lease field "
                        f"{m.group(1)!r} which does not exist in "
                        "wire.LEASE_FIELDS — rename the field or fix "
                        "the script", obj="scripts"))
    return findings
