"""Native-ABI sync rules: the ``extern "C"`` ↔ ctypes bridge, verified.

Two rules share one parsed model (memoized on the
:class:`~sparkrdma_tpu_torch.lint.core.LintContext`):

- **abi-sync** — a clang-free tokenizer extracts every ``sr_*``
  function in an ``extern "C"`` block (return type, parameter types,
  arity) and cross-checks both directions against the ctypes table that
  binds it. The port has two such pairs:

  - ``native/staging.cpp`` (the host staging library) against
    ``hbm/host_staging.py``;
  - every ``csrc/<name>.cu`` (the CUDA kernels) against
    ``_build.py``'s ``SIGNATURES["<name>"]``.

  A table is either the reference's form, one ``lib.sr_x.restype =`` /
  ``lib.sr_x.argtypes =`` statement per symbol, or the port's: a
  module-level dict of ``"sr_x": (argtypes, restype)`` entries (nested
  one level, keyed by library, in ``_build.py``), whose names may be
  module-level aliases (``_P, _I = ctypes.c_void_p, ctypes.c_int``) and
  which a ``for`` loop over the dict applies. Each entry is compared
  with its C prototype as strictly as a statement is: a C symbol the
  Python side never declares, a Python declaration with no C
  definition, an arity drift, a width-inexact type (``size_t`` must be
  ``c_size_t``, ``long`` must be ``c_long``, ``long long`` must be
  ``c_longlong``, ``int64_t`` must be ``c_int64`` — ``c_int`` for any
  of them truncates on LP64), a missing ``argtypes``, and the classic
  footgun: a pointer-returning function with no ``restype`` defaults to
  ``c_int`` and silently truncates 64-bit pointers. A dict table that
  no loop applies, or whose loop sets no ``restype``, leaves every
  entry's ``argtypes`` or ``restype`` unset, and is reported so. A C
  struct passed by value must be a ``ctypes.Structure`` of the same
  name whose ``_fields_`` match the C struct's fields in order: name,
  type and array length (``PeerTable`` ↔ ``csrc/ring_exchange.cu``).
- **abi-gate** — symbols declared inside a feature-probe ``try``/
  ``except AttributeError`` block (the ones an older prebuilt ``.so``
  may lack, gated by an ``sr_has_*`` flag) may only be called where the
  probe dominates the call: a read of the gate flag, or a call to a
  probe helper (a package function that reads the flag, transitively),
  earlier in the same function — so a stale library degrades instead
  of segfaulting. The port's staging table declares no gated symbol.

Both rules skip when their anchor files are absent, which is what makes
one-rule-at-a-time fixtures possible; unparseable declarations produce
no findings (conservatism contract: a missed mismatch is a lint gap, an
invented one poisons the repo-clean meta-test).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import PurePosixPath
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, LintContext, SourceFile, rule

_CPP_REL = "sparkrdma_tpu_torch/native/staging.cpp"
_PY_REL = "sparkrdma_tpu_torch/hbm/host_staging.py"
#: the kernels' table, one sub-dict per ``csrc/<name>.cu``
_BUILD_REL = "sparkrdma_tpu_torch/_build.py"
_CSRC_DIR = "sparkrdma_tpu_torch/csrc"

#: C scalar type → the exact ctypes name it must map to (width-exact:
#: the lint exists precisely to reject "c_int is probably fine")
_SCALAR_MAP = {
    "size_t": "c_size_t",
    "long": "c_long",
    "long long": "c_longlong",
    "int": "c_int",
    "int64_t": "c_int64",
    "uint64_t": "c_uint64",
    "int32_t": "c_int32",
    "uint32_t": "c_uint32",
    "double": "c_double",
    "float": "c_float",
}

#: C pointee type → the typed-pointer spelling also accepted (besides
#: the universal c_void_p)
_POINTER_MAP = {
    "long": "POINTER(c_long)",
    "long long": "POINTER(c_longlong)",
    "int64_t": "POINTER(c_int64)",
    "uint64_t": "POINTER(c_uint64)",
    "int32_t": "POINTER(c_int32)",
    "uint32_t": "POINTER(c_uint32)",
    "uint8_t": "POINTER(c_uint8)",
    "double": "POINTER(c_double)",
}

#: words that name a C type, never a parameter
_C_TYPE_WORDS = frozenset({"void", "char", "short", "int", "long", "float",
                           "double", "unsigned", "signed", "const",
                           "volatile", "struct"})

_FUNC_RE = re.compile(
    r"(?:^|[;}])\s*([A-Za-z_][A-Za-z0-9_]*(?:\s*\*+)?)\s+"
    r"(sr_[A-Za-z0-9_]*)\s*\(([^)]*)\)\s*\{", re.S)

_STRUCT_RE = re.compile(
    r"\bstruct\s+([A-Za-z_][A-Za-z0-9_]*)\s*\{([^{}]*)\}\s*;")


@dataclasses.dataclass(frozen=True)
class CFunc:
    """One ``extern "C"`` function: normalized (base, ptr-depth) types."""

    name: str
    line: int
    ret: Tuple[str, int]
    params: Tuple[Tuple[str, int], ...]


@dataclasses.dataclass(frozen=True)
class CStruct:
    """One C struct: ``(name, (base, ptr-depth), array length)`` fields
    in order (length 0 for a scalar field)."""

    name: str
    line: int
    fields: Tuple[Tuple[str, Tuple[str, int], int], ...]


def _strip_comments(text: str) -> str:
    """Remove ``//`` and ``/* */`` comments, preserving line numbers."""
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"/\*.*?\*/",
                  lambda m: "\n" * m.group(0).count("\n"), text, flags=re.S)


def _extern_c_region(text: str) -> Tuple[int, str]:
    """(start line, body text) of the first ``extern "C" { ... }``
    block, matched by brace counting."""
    m = re.search(r'extern\s+"C"\s*\{', text)
    if m is None:
        return 0, ""
    depth, start = 1, m.end()
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return text.count("\n", 0, start) + 1, text[start:i]
    return text.count("\n", 0, start) + 1, text[start:]


def _parse_ctype(tokens: str) -> Optional[Tuple[str, int]]:
    """``const void* const*`` → ``("void", 2)``; ``long long`` →
    ``("long long", 0)``; None when empty."""
    ptr = tokens.count("*")
    words = [w for w in re.split(r"[\s*]+", tokens)
             if w and w not in ("const", "volatile", "struct", "unsigned",
                                "signed")]
    if not words:
        return None
    if words[:2] == ["long", "long"]:
        return "long long", ptr
    return words[0], ptr


def _split_decl(decl: str) -> Tuple[str, str]:
    """``const void* in`` → (``const void* ``, ``in``): the type tokens
    and the declared name ('' when the declaration names none)."""
    words = [w for w in re.split(r"[\s*]+", decl.strip()) if w]
    if len([w for w in words if w != "const"]) > 1 \
            and words[-1] not in _C_TYPE_WORDS:
        return decl[:decl.rindex(words[-1])], words[-1]
    return decl, ""


def parse_extern_c(sf: SourceFile) -> List[CFunc]:
    text = _strip_comments(sf.text)
    base_line, region = _extern_c_region(text)
    out: List[CFunc] = []
    # collect only depth-0 text of the region so identifiers inside
    # function bodies can't masquerade as declarations
    depth, top = 0, []
    for ch in region:
        if ch == "{":
            depth += 1
            if depth == 1:
                top.append("{")     # the marker _FUNC_RE anchors on
            continue
        if ch == "}":
            depth -= 1
            if depth == 0:
                top.append("}")
            continue
        if depth == 0:
            top.append(ch)
    flat = "".join(top)
    for m in _FUNC_RE.finditer(flat):
        ret = _parse_ctype(m.group(1))
        if ret is None:
            continue
        params: List[Tuple[str, int]] = []
        plist = m.group(3).strip()
        if plist and plist != "void":
            ok = True
            for p in plist.split(","):
                # drop the trailing parameter name when present
                t = _parse_ctype(_split_decl(p)[0])
                if t is None:
                    ok = False
                    break
                params.append(t)
            if not ok:
                continue
        # line number: count newlines up to the match in the flat text
        # is wrong (bodies elided) — find the symbol in the real text
        sym = re.search(r"\b%s\s*\(" % re.escape(m.group(2)), text)
        line = text.count("\n", 0, sym.start()) + 1 if sym else base_line
        out.append(CFunc(m.group(2), line, ret, tuple(params)))
    return out


def parse_c_structs(sf: SourceFile) -> Dict[str, CStruct]:
    """Every ``struct Name { fields };`` with plain fields (no nested
    braces); a struct with a field the parser cannot read is left out."""
    text = _strip_comments(sf.text)
    out: Dict[str, CStruct] = {}
    for m in _STRUCT_RE.finditer(text):
        fields = []
        ok = True
        for decl in m.group(2).split(";"):
            if not decl.strip():
                continue
            length = 0
            arr = re.search(r"\[\s*(\d+)\s*\]\s*$", decl.strip())
            if arr is not None:
                length = int(arr.group(1))
                decl = decl.strip()[:arr.start()]
            tokens, fname = _split_decl(decl)
            ctype = _parse_ctype(tokens)
            if ctype is None or not fname:
                ok = False
                break
            fields.append((fname, ctype, length))
        if ok and fields:
            out.setdefault(m.group(1), CStruct(
                m.group(1), text.count("\n", 0, m.start()) + 1,
                tuple(fields)))
    return out


# ---------------------------------------------------------------------
# python side: the ctypes declaration table
# ---------------------------------------------------------------------

@dataclasses.dataclass
class PyDecl:
    """restype/argtypes assignments for one ``lib.sr_*`` symbol."""

    name: str
    line: int
    restype: Optional[str] = None       # canonical name, "None", or
    restype_line: int = 0               # None = never assigned
    argtypes: Optional[List[str]] = None
    argtypes_line: int = 0
    unparsed: bool = False              # a value we couldn't evaluate


@dataclasses.dataclass(frozen=True)
class PyStruct:
    """One ``ctypes.Structure`` subclass: ``(name, canonical type,
    array length)`` fields, or None when ``_fields_`` is unreadable."""

    name: str
    line: int
    fields: Optional[Tuple[Tuple[str, str, int], ...]]


def _canon_ctype(node: ast.AST, aliases: Optional[Dict[str, str]] = None
                 ) -> Optional[str]:
    """``ctypes.c_long`` / ``c_long`` / ``POINTER(c_long)`` / ``None``
    → canonical string, else None (unparsable). A name bound at module
    level to a ctypes type (``_P = ctypes.c_void_p``) stands for it."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    if isinstance(node, ast.Name):
        return (aliases or {}).get(node.id, node.id)
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        fn = node.func
        fname = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if fname == "POINTER" and len(node.args) == 1:
            inner = _canon_ctype(node.args[0], aliases)
            if inner is not None:
                return f"POINTER({inner})"
    return None


def _eval_argtypes(node: ast.AST, aliases: Optional[Dict[str, str]] = None
                   ) -> Optional[List[str]]:
    """Evaluate the small list algebra the table uses:
    ``[...]``, ``list + list``, ``list * int``."""
    if isinstance(node, ast.List):
        out = []
        for e in node.elts:
            c = _canon_ctype(e, aliases)
            if c is None:
                return None
            out.append(c)
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _eval_argtypes(node.left, aliases)
        right = _eval_argtypes(node.right, aliases)
        if left is None or right is None:
            return None
        return left + right
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        left = _eval_argtypes(node.left, aliases)
        if left is not None and isinstance(node.right, ast.Constant) \
                and isinstance(node.right.value, int):
            return left * node.right.value
        return None
    return None


def _ctype_aliases(tree: ast.AST) -> Dict[str, str]:
    """Module-level names bound to a ctypes type: ``_P = c_void_p`` and
    ``_P, _I = ctypes.c_void_p, ctypes.c_int`` (in order, so an alias
    may be built from an earlier one)."""
    aliases: Dict[str, str] = {}
    for node in getattr(tree, "body", ()):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t, v = node.targets[0], node.value
        pairs = []
        if isinstance(t, ast.Name):
            pairs = [(t, v)]
        elif isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple) \
                and len(t.elts) == len(v.elts):
            pairs = list(zip(t.elts, v.elts))
        for tn, vn in pairs:
            if not isinstance(tn, ast.Name):
                continue
            c = _canon_ctype(vn, aliases)
            if c is not None and (c.startswith("c_")
                                  or c.startswith("POINTER(")):
                aliases[tn.id] = c
    return aliases


def _py_structs(tree: ast.AST, aliases: Dict[str, str]
                ) -> Dict[str, PyStruct]:
    """Every ``class X(ctypes.Structure)`` with its ``_fields_``."""
    out: Dict[str, PyStruct] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if not any((isinstance(b, ast.Attribute) and b.attr == "Structure")
                   or (isinstance(b, ast.Name) and b.id == "Structure")
                   for b in node.bases):
            continue
        fields: Optional[List[Tuple[str, str, int]]] = None
        line = node.lineno
        for st in node.body:
            if isinstance(st, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_fields_"
                    for t in st.targets):
                line = st.lineno
                fields = []
                elts = st.value.elts if isinstance(
                    st.value, (ast.List, ast.Tuple)) else None
                for e in elts or ():
                    if not (isinstance(e, ast.Tuple) and len(e.elts) == 2
                            and isinstance(e.elts[0], ast.Constant)
                            and isinstance(e.elts[0].value, str)):
                        fields = None
                        break
                    tnode, length = e.elts[1], 0
                    if isinstance(tnode, ast.BinOp) \
                            and isinstance(tnode.op, ast.Mult) \
                            and isinstance(tnode.right, ast.Constant) \
                            and isinstance(tnode.right.value, int):
                        tnode, length = tnode.left, tnode.right.value
                    c = _canon_ctype(tnode, aliases)
                    if c is None:
                        fields = None
                        break
                    fields.append((e.elts[0].value, c, length))
                if elts is None:
                    fields = None
        out[node.name] = PyStruct(node.name, line,
                                  tuple(fields) if fields is not None
                                  else None)
    return out


def _table_entries(node: ast.AST) -> Optional[List[Tuple[str, ast.AST]]]:
    """``[(symbol, value node)]`` of a dict literal keyed by ``sr_*``
    string literals, else None."""
    if not isinstance(node, ast.Dict) or not node.keys:
        return None
    out = []
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and k.value.startswith("sr_")):
            return None
        out.append((k, v))
    return out


def _applied(tree: ast.AST, table: str) -> Tuple[bool, bool]:
    """(sets argtypes, sets restype): whether some ``for`` loop over
    the table (``for n, (a, r) in TABLE.items():`` or over a sub-dict
    of it) assigns each attribute in its body."""
    args = res = False
    for node in ast.walk(tree):
        if not isinstance(node, (ast.For, ast.AsyncFor)):
            continue
        if not any(isinstance(n, ast.Name) and n.id == table
                   for n in ast.walk(node.iter)):
            continue
        for st in node.body:
            for sub in ast.walk(st):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if isinstance(t, ast.Attribute):
                            args |= t.attr == "argtypes"
                            res |= t.attr == "restype"
    return args, res


def _dict_decls(entries, aliases: Dict[str, str], applied: Tuple[bool, bool]
                ) -> Dict[str, PyDecl]:
    """One PyDecl per ``"sr_x": (argtypes, restype)`` entry, at the
    entry's line; what the applying loop never sets stays unset."""
    sets_args, sets_res = applied
    decls: Dict[str, PyDecl] = {}
    for k, v in entries:
        d = PyDecl(k.value, k.lineno)
        if not (isinstance(v, ast.Tuple) and len(v.elts) == 2):
            d.unparsed = True
            decls.setdefault(k.value, d)
            continue
        if sets_args:
            d.argtypes = _eval_argtypes(v.elts[0], aliases)
            d.argtypes_line = k.lineno
            if d.argtypes is None:
                d.unparsed = True
        if sets_res:
            d.restype = _canon_ctype(v.elts[1], aliases)
            d.restype_line = k.lineno
            if d.restype is None:
                d.unparsed = True
        decls.setdefault(k.value, d)
    return decls


def _flat_tables(tree: ast.AST) -> List[Tuple[str, list]]:
    """``(name, entries)`` of every module-level ``NAME = {"sr_x": ...}``."""
    out = []
    for node in getattr(tree, "body", ()):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            entries = _table_entries(node.value)
            if entries is not None:
                out.append((node.targets[0].id, entries))
    return out


def _nested_tables(tree: ast.AST) -> List[Tuple[str, Dict[str, list]]]:
    """``(name, {library: entries})`` of every module-level
    ``NAME = {"lib": {"sr_x": ...}, ...}``."""
    out = []
    for node in getattr(tree, "body", ()):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Dict) and node.value.keys):
            continue
        libs: Dict[str, list] = {}
        for k, v in zip(node.value.keys, node.value.values):
            entries = _table_entries(v)
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)) or entries is None:
                libs = {}
                break
            libs[k.value] = entries
        if libs:
            out.append((node.targets[0].id, libs))
    return out


def _statement_decls(tree: ast.AST) -> Dict[str, PyDecl]:
    """The reference's form: ``lib.sr_x.restype = ...`` /
    ``lib.sr_x.argtypes = ...`` statements."""
    decls: Dict[str, PyDecl] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        # lib.sr_x.restype / lib.sr_x.argtypes
        if isinstance(t, ast.Attribute) and t.attr in ("restype",
                                                       "argtypes") \
                and isinstance(t.value, ast.Attribute) \
                and t.value.attr.startswith("sr_"):
            sym = t.value.attr
            d = decls.setdefault(sym, PyDecl(sym, node.lineno))
            if t.attr == "restype":
                d.restype = _canon_ctype(node.value)
                d.restype_line = node.lineno
                if d.restype is None:
                    d.unparsed = True
            else:
                d.argtypes = _eval_argtypes(node.value)
                d.argtypes_line = node.lineno
                if d.argtypes is None:
                    d.unparsed = True
    return decls


@dataclasses.dataclass
class AbiPair:
    """One C source and the Python table that binds its exports."""

    c_rel: str
    py_rel: str
    cfuncs: Dict[str, CFunc]
    decls: Dict[str, PyDecl]
    cstructs: Dict[str, CStruct]
    pystructs: Dict[str, PyStruct]

    @property
    def c_name(self) -> str:
        return PurePosixPath(self.c_rel).name

    @property
    def py_name(self) -> str:
        return PurePosixPath(self.py_rel).name


@dataclasses.dataclass
class AbiModel:
    """Parsed C exports + Python declarations + feature-gate map."""

    pairs: List[AbiPair]
    #: gated symbol → gate flag name (``sr_has_codec`` / ...)
    gates: Dict[str, str]
    #: gate flag → names of probe helpers (transitive readers)
    probes: Dict[str, Set[str]]

    @property
    def present(self) -> bool:
        return bool(self.pairs)


def _c_side(sf: Optional[SourceFile]) -> Tuple[Dict[str, CFunc],
                                               Dict[str, CStruct]]:
    if sf is None:
        return {}, {}
    return {f.name: f for f in parse_extern_c(sf)}, parse_c_structs(sf)


def _build(ctx: LintContext) -> AbiModel:
    pairs: List[AbiPair] = []
    gates: Dict[str, str] = {}
    cpp = ctx.file(_CPP_REL)
    py = ctx.file(_PY_REL)
    if cpp is not None and py is not None:
        aliases = _ctype_aliases(py.tree)
        decls = _statement_decls(py.tree)
        for name, entries in _flat_tables(py.tree):
            for sym, d in _dict_decls(entries, aliases,
                                      _applied(py.tree, name)).items():
                decls.setdefault(sym, d)
        cfuncs, cstructs = _c_side(cpp)
        pairs.append(AbiPair(cpp.rel, py.rel, cfuncs, decls, cstructs,
                             _py_structs(py.tree, aliases)))
        gates = _gates(py.tree)
    build = ctx.file(_BUILD_REL)
    if build is not None:
        aliases = _ctype_aliases(build.tree)
        structs = _py_structs(build.tree, aliases)
        libs: Dict[str, Dict[str, PyDecl]] = {}
        for name, tables in _nested_tables(build.tree):
            applied = _applied(build.tree, name)
            for lib, entries in tables.items():
                libs.setdefault(lib, _dict_decls(entries, aliases, applied))
        sources = {PurePosixPath(sf.rel).stem: sf
                   for sf in ctx.glob(f"{_CSRC_DIR}/*.cu")}
        for lib in sorted(set(sources) | set(libs)):
            cfuncs, cstructs = _c_side(sources.get(lib))
            pairs.append(AbiPair(f"{_CSRC_DIR}/{lib}.cu", build.rel,
                                 cfuncs, libs.get(lib, {}), cstructs,
                                 structs))
    probes = _probe_helpers(ctx, set(gates.values()))
    return AbiModel(pairs, gates, probes)


def _gates(tree: ast.AST) -> Dict[str, str]:
    """Feature gates: a Try whose body sets ``lib.sr_has_X`` and whose
    handler catches AttributeError gates every symbol declared (or
    probed) inside its body."""
    gates: Dict[str, str] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        if not any(isinstance(h.type, ast.Name)
                   and h.type.id == "AttributeError"
                   for h in node.handlers if h.type is not None):
            continue
        flag = None
        for st in node.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Attribute) \
                    and st.targets[0].attr.startswith("sr_has_"):
                flag = st.targets[0].attr
        if flag is None:
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) \
                    and sub.attr.startswith("sr_") \
                    and not sub.attr.startswith("sr_has_"):
                gates.setdefault(sub.attr, flag)
    return gates


def _reads_flag(fn_node: ast.AST, flag: str) -> bool:
    """A *read* of the gate flag — functions that assign it (the
    ``_declare`` writer) are not probes; counting them would make every
    ``load_native()`` caller pass the gate vacuously."""
    for n in ast.walk(fn_node):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Attribute) and t.attr == flag:
                    return False
    for n in ast.walk(fn_node):
        if isinstance(n, ast.Attribute) and n.attr == flag:
            return True
        if isinstance(n, ast.Constant) and n.value == flag:
            return True             # getattr(lib, "sr_has_x", False)
    return False


def _probe_helpers(ctx: LintContext, flags: Set[str]
                   ) -> Dict[str, Set[str]]:
    """Package functions that read a gate flag, closed transitively:
    a function that calls a probe helper is itself a probe helper."""
    from .callgraph import build_callgraph
    cg = build_callgraph(ctx)
    probes: Dict[str, Set[str]] = {f: set() for f in flags}
    for flag in flags:
        for fi in cg.funcs.values():
            if _reads_flag(fi.node, flag):
                probes[flag].add(fi.name)
        for _ in range(3):          # bounded transitive closure
            grew = False
            for fi in cg.funcs.values():
                if fi.name in probes[flag]:
                    continue
                for call in (n for n in ast.walk(fi.node)
                             if isinstance(n, ast.Call)):
                    f = call.func
                    callee = f.id if isinstance(f, ast.Name) else (
                        f.attr if isinstance(f, ast.Attribute) else None)
                    if callee in probes[flag]:
                        probes[flag].add(fi.name)
                        grew = True
                        break
            if not grew:
                break
    return probes


def abi_model(ctx: LintContext) -> AbiModel:
    return ctx.memo("abi-model", _build)


def _expected_for(ctype: Tuple[str, int]) -> Set[str]:
    base, ptr = ctype
    if ptr == 0:
        exact = _SCALAR_MAP.get(base)
        return {exact} if exact else set()
    if ptr == 1 and base == "char":
        return {"c_char_p"}
    allowed = {"c_void_p"}
    if ptr == 1 and base in _POINTER_MAP:
        allowed.add(_POINTER_MAP[base])
    if ptr == 2 and base == "void":
        allowed.add("POINTER(c_void_p)")
    return allowed


def _ctype_str(ctype: Tuple[str, int]) -> str:
    return ctype[0] + "*" * ctype[1]


def _struct_findings(pair: AbiPair, cs: CStruct, report) -> None:
    """Hold the ctypes.Structure of ``cs``'s name to the C struct."""
    ps = pair.pystructs.get(cs.name)
    if ps is None or ps.fields is None:
        return          # reported at the parameter / unreadable: skip
    if len(ps.fields) != len(cs.fields):
        report(ps.line,
               f"ctypes.Structure {cs.name} has {len(ps.fields)} "
               f"field(s) but struct {cs.name} in {pair.c_name} has "
               f"{len(cs.fields)}")
        return
    for j, ((pn, pt, plen), (cn, ct, clen)) in enumerate(
            zip(ps.fields, cs.fields)):
        want = _expected_for(ct)
        if pn != cn or plen != clen or (want and pt not in want):
            cdesc = f"{_ctype_str(ct)} {cn}" + (f"[{clen}]" if clen else "")
            pdesc = f"({pn!r}, {pt}" + (f" * {plen}" if plen else "") + ")"
            report(ps.line,
                   f"ctypes.Structure {cs.name} field {j} is {pdesc} but "
                   f"struct {cs.name} in {pair.c_name} has {cdesc}")


def _check_pair(pair: AbiPair, findings: List[Finding]) -> None:
    def report(line: int, msg: str) -> None:
        findings.append(Finding("abi-sync", pair.py_rel, line, msg))

    structs_used: Dict[str, CStruct] = {}
    for name, cf in sorted(pair.cfuncs.items()):
        d = pair.decls.get(name)
        if d is None:
            findings.append(Finding(
                "abi-sync", pair.c_rel, cf.line,
                f"{name} is exported from {pair.c_name} but "
                f"{pair.py_name} never declares its restype/argtypes "
                "— calls go through ctypes defaults (everything c_int)"))
            continue
        if d.unparsed:
            continue                # can't judge what we can't evaluate
        # return type -------------------------------------------------
        want_ret = _expected_for(cf.ret)
        if cf.ret == ("void", 0):
            if d.restype not in (None, "None"):
                report(d.restype_line or d.line,
                       f"{name} returns void in C but declares "
                       f"restype {d.restype} — drop it or set None")
        elif d.restype is None:
            hint = (" (a 64-bit pointer truncated to c_int)"
                    if cf.ret[1] else "")
            report(d.line,
                   f"{name} returns {_ctype_str(cf.ret)} in C but has "
                   f"no restype — ctypes defaults to c_int{hint}")
        elif want_ret and d.restype not in want_ret:
            report(d.restype_line,
                   f"{name} returns {_ctype_str(cf.ret)} in C but "
                   f"restype is {d.restype} (expected "
                   f"{' or '.join(sorted(want_ret))})")
        # arguments ---------------------------------------------------
        if d.argtypes is None:
            report(d.line,
                   f"{name} takes {len(cf.params)} parameter(s) in C "
                   "but has no argtypes — ctypes applies default "
                   "conversions with no width checking (declare [] "
                   "even for zero parameters)")
            continue
        if len(d.argtypes) != len(cf.params):
            report(d.argtypes_line,
                   f"{name} takes {len(cf.params)} parameter(s) in C "
                   f"but argtypes lists {len(d.argtypes)}")
            continue
        for i, (ct, py) in enumerate(zip(cf.params, d.argtypes)):
            if ct[1] == 0 and ct[0] in pair.cstructs:
                # a struct passed by value: the ctypes.Structure of the
                # same name, whose fields are checked once below
                structs_used.setdefault(ct[0], pair.cstructs[ct[0]])
                if py != ct[0] or ct[0] not in pair.pystructs:
                    report(d.argtypes_line,
                           f"{name} parameter {i} is struct {ct[0]} "
                           f"passed by value in C but argtypes[{i}] is "
                           f"{py} (expected the ctypes.Structure "
                           f"{ct[0]})")
                continue
            want = _expected_for(ct)
            if want and py not in want:
                report(d.argtypes_line,
                       f"{name} parameter {i} is {_ctype_str(ct)} in C "
                       f"but argtypes[{i}] is {py} (expected "
                       f"{' or '.join(sorted(want))})")
    for cs in structs_used.values():
        _struct_findings(pair, cs, report)
    for name, d in sorted(pair.decls.items()):
        if name not in pair.cfuncs:
            report(d.line,
                   f"{name} is declared in {pair.py_name} but "
                   f"{pair.c_name} exports no such symbol — stale "
                   "declaration or a typo that AttributeErrors at load")


@rule("abi-sync",
      "the extern \"C\" exports in native/staging.cpp and the ctypes "
      "restype/argtypes table in hbm/host_staging.py must agree on "
      "symbols, arity, and exact widths")
def check_abi_sync(ctx: LintContext) -> List[Finding]:
    findings: List[Finding] = []
    for pair in abi_model(ctx).pairs:
        _check_pair(pair, findings)
    return findings


@rule("abi-gate",
      "calls to feature-gated native symbols (declared under a "
      "try/except AttributeError probe) must be dominated by a read of "
      "the gate flag or a probe helper")
def check_abi_gate(ctx: LintContext) -> List[Finding]:
    m = abi_model(ctx)
    if not m.present or not m.gates:
        return []
    findings: List[Finding] = []
    for sf in ctx.package_files():
        try:
            tree = sf.tree
        except SyntaxError:
            continue
        for fn in (n for n in ast.iter_child_nodes(tree)
                   if isinstance(n, (ast.FunctionDef, ast.ClassDef))):
            for scope in ([fn] if isinstance(fn, ast.FunctionDef)
                          else [c for c in fn.body
                                if isinstance(c, ast.FunctionDef)]):
                findings.extend(_gate_scan(m, sf, scope))
    return findings


def _gate_scan(m: AbiModel, sf: SourceFile, fn: ast.FunctionDef
               ) -> List[Finding]:
    out: List[Finding] = []
    # probe references, by flag, at their line numbers
    probe_lines: Dict[str, List[int]] = {f: [] for f in m.probes}
    for n in ast.walk(fn):
        for flag, helpers in m.probes.items():
            if isinstance(n, ast.Attribute) and n.attr == flag:
                probe_lines[flag].append(n.lineno)
            elif isinstance(n, ast.Constant) and n.value == flag:
                probe_lines[flag].append(n.lineno)
            elif isinstance(n, ast.Call):
                f = n.func
                callee = f.id if isinstance(f, ast.Name) else (
                    f.attr if isinstance(f, ast.Attribute) else None)
                if callee in helpers:
                    probe_lines[flag].append(n.lineno)
    # gated calls must be preceded by a probe, or sit inside a
    # try/except AttributeError (the _declare pattern)
    guarded: Set[int] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Try) and any(
                isinstance(h.type, ast.Name)
                and h.type.id == "AttributeError"
                for h in n.handlers if h.type is not None):
            for sub in ast.walk(n):
                guarded.add(id(sub))
    for n in ast.walk(fn):
        if not (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)):
            continue
        sym = n.func.attr
        flag = m.gates.get(sym)
        if flag is None or id(n) in guarded:
            continue
        if any(ln <= n.lineno for ln in probe_lines.get(flag, ())):
            continue
        out.append(Finding(
            "abi-gate", sf.rel, n.lineno,
            f"{fn.name} calls {sym} without checking {flag} first — an "
            "older libsparkstaging.so lacks the symbol and this "
            "segfaults instead of degrading; guard with the probe "
            "helper"))
    return out


__all__ = ["AbiModel", "AbiPair", "abi_model", "parse_extern_c",
           "parse_c_structs", "CFunc", "CStruct"]
