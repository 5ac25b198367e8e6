"""Resource-lifecycle rules: paired acquire/release, enforced statically.

Two rules share one declaration-model pass (memoized on the
:class:`~sparkrdma_tpu_torch.lint.core.LintContext`):

- **resource-leak** — every acquisition of a modeled resource (an
  admission ticket from ``admit()``, a device slot from
  ``acquire_device``/``get_shaped``, a ``HostBufferPool`` lease from a
  pool-named ``.get``, a bare ``open()``, a quota ``charge``/
  ``try_charge`` with its tier literal) must reach a discharge in
  document order: a ``with`` statement, a matching release
  (``handle.release()``, ``pool.put(handle)``, ``put_shaped``/
  ``release_device``, tier-matched ``account.release``), or an
  ownership transfer (returning the handle, storing it on an attribute
  or container, passing it to another call — the obligation then
  belongs to the new owner). Between the acquisition and its discharge,
  any statement that can itself fail — another modeled acquisition
  (allocation and quota admission raise) or an explicit ``raise`` —
  must sit inside a ``try`` whose handler or ``finally`` releases the
  first resource, or the failure leaks it. This is exactly the
  partial-multi-tier-charge and charge-then-allocate bug class.
- **teardown-completeness** — every resource-bearing attribute a class
  constructs in ``__init__`` (a modeled acquisition, or a package class
  that itself defines ``close``/``stop``) must be released somewhere in
  the intraclass closure reachable from that class's ``close``/``stop``
  — the shipped tiered-store teardown leak, generalized. Attributes
  *injected* through parameters are the injector's responsibility and
  are exempt (only direct constructor calls create the obligation).

Interprocedural ownership follows the conservative call graph: a
function whose acquisition is discharged by returning the bare handle
becomes a derived acquirer — resolved calls to it create the same
obligation at the call site (one level deep, matching the graph's
under-approximation contract: a missed obligation is a lint gap, an
invented one would poison the repo-clean meta-test).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, LintContext, rule
from .callgraph import CallGraph, FuncInfo, build_callgraph

#: receiver names (bare or ``self.<name>``) whose ``.get(...)`` hands
#: out a pooled lease — ``get`` is far too common to model unqualified
_POOLISH = frozenset({"pool", "_pool", "host_pool", "_host_pool",
                      "buf_pool", "lease_pool"})

#: method names whose call on the *handle* releases it
_HANDLE_RELEASE = frozenset({"release", "close"})

#: method names that release when the handle is passed as an argument
_POOL_RELEASE = frozenset({"put", "put_shaped", "release_device"})

#: ``self.x.<name>()`` inside close/stop that counts as releasing x
_TEARDOWN_RELEASE = frozenset({"close", "stop", "shutdown", "release",
                               "cancel", "join", "destroy", "drain"})

#: bound on tracked obligations per function — pathological fixtures
#: stay linear, real functions never get near it
_MAX_OBLIGATIONS = 32


@dataclasses.dataclass(frozen=True)
class _Spec:
    """One modeled resource kind."""

    kind: str                   # human-facing ("host lease", ...)
    handle_release: frozenset   # handle.<m>() releases
    pool_release: frozenset     # <recv>.<m>(handle) releases


_TICKET = _Spec("admission ticket", frozenset({"release"}), frozenset())
_DEVICE = _Spec("device slot", frozenset(),
                frozenset({"put_shaped", "release_device"}))
_LEASE = _Spec("host lease", _HANDLE_RELEASE, frozenset({"put"}))
_FILE = _Spec("file handle", frozenset({"close"}), frozenset())
_CHARGE = _Spec("quota charge", frozenset(), frozenset())


def _recv_text(node: ast.AST) -> str:
    """Source text of a call receiver — the identity key for matching
    ``acct.charge(...)`` to ``acct.release(...)``."""
    try:
        return ast.unparse(node)
    except Exception:               # pragma: no cover - malformed tree
        return "<?>"


def _recv_tail(node: ast.AST) -> Optional[str]:
    """Last name component of a receiver (``self.host_pool`` →
    ``host_pool``), for the pool-named ``.get`` heuristic."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


@dataclasses.dataclass
class _Obligation:
    """One live acquisition inside one function."""

    spec: _Spec
    line: int
    #: local name the handle is bound to ("" = unbound/charge)
    handle: str
    #: for charges: (receiver source text, tier literal)
    charge_key: Optional[Tuple[str, str]] = None

    def describe(self) -> str:
        if self.spec is _CHARGE:
            recv, tier = self.charge_key
            return f"{recv}.charge({tier!r}, ...)"
        return f"{self.spec.kind} {self.handle or '<discarded>'}"


def _charge_call(call: ast.Call) -> Optional[Tuple[str, str]]:
    """``(receiver text, tier)`` when ``call`` is a tier-literal
    ``charge``/``try_charge``, else None."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in ("charge", "try_charge") \
            and call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return _recv_text(f.value), call.args[0].value
    return None


def _charge_release(call: ast.Call, key: Tuple[str, str]) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "release"
            and call.args and isinstance(call.args[0], ast.Constant)
            and call.args[0].value == key[1]
            and _recv_text(f.value) == key[0])


class ResourceModel:
    """Declaration model + per-function obligation analysis."""

    def __init__(self, ctx: LintContext):
        self.ctx = ctx
        self.cg: CallGraph = build_callgraph(ctx)
        #: FuncInfo.qual of functions that return a fresh handle —
        #: resolved calls to them acquire the same resource kind
        self.derived: Dict[str, _Spec] = {}
        self._facts: Dict[str, dict] = {}
        for fi in self.cg.funcs.values():
            facts = self._analyze(fi, derived=False)
            self._facts[fi.qual] = facts
            spec = facts["returns_fresh"]
            if spec is not None:
                self.derived[fi.qual] = spec

    # -- acquisition recognition --------------------------------------
    def _acquire_spec(self, call: ast.Call, fi: FuncInfo,
                      derived: bool) -> Optional[_Spec]:
        f = call.func
        if isinstance(f, ast.Name) and f.id == "open":
            return _FILE
        if isinstance(f, ast.Attribute):
            if f.attr == "admit":
                return _TICKET
            if f.attr in ("acquire_device", "get_shaped"):
                return _DEVICE
            if f.attr == "get" and _recv_tail(f.value) in _POOLISH:
                return _LEASE
        if derived:
            target = self.cg.resolve(call, fi)
            if target is not None and target.qual != fi.qual:
                return self.derived.get(target.qual)
        return None

    # -- per-function analysis ----------------------------------------
    def findings_for(self, fi: FuncInfo) -> List[Finding]:
        return self._analyze(fi, derived=True)["findings"]

    def _analyze(self, fi: FuncInfo, derived: bool) -> dict:
        entries: List[Tuple[ast.stmt, Tuple[ast.Try, ...], bool]] = []
        _linearize(fi.node.body, (), False, entries)
        obligations: List[Tuple[int, _Obligation]] = []
        findings: List[Finding] = []
        returns_fresh: Optional[_Spec] = None

        for idx, (st, _tries, _cleanup) in enumerate(entries):
            if len(obligations) >= _MAX_OBLIGATIONS:
                break
            for call in self._own_calls(st):
                key = _charge_call(call)
                if key is not None:
                    obligations.append((idx, _Obligation(
                        _CHARGE, call.lineno, "", key)))
                    continue
                spec = self._acquire_spec(call, fi, derived)
                if spec is None:
                    continue
                if isinstance(st, (ast.With, ast.AsyncWith)):
                    continue        # scoped: __exit__ releases
                handle = _bound_name(st, call)
                if handle is None:
                    findings.append(Finding(
                        "resource-leak", fi.rel, call.lineno,
                        f"{fi.short}: {spec.kind} acquired here is "
                        "discarded — bind it and release it, or use "
                        "'with'"))
                    continue
                if handle == "":
                    continue        # bound straight into a new owner
                obligations.append((idx, _Obligation(
                    spec, call.lineno, handle)))

        for idx, ob in obligations:
            end, how = self._discharge_index(entries, idx, ob)
            if end is None:
                # a charge's balance legitimately outlives the function
                # (the stored segment owns it) — only handles must be
                # discharged locally
                if ob.spec is not _CHARGE:
                    findings.append(Finding(
                        "resource-leak", fi.rel, ob.line,
                        f"{fi.short}: {ob.describe()} is never "
                        "released, returned, or stored — release it "
                        "(try/finally), use 'with', or transfer "
                        "ownership"))
                    continue
                end = len(entries)
            for j in range(idx + 1, end):
                st, tries, cleanup = entries[j]
                if cleanup:
                    continue
                risk = self._risk_of(st, ob)
                if risk is None:
                    continue
                if any(self._try_releases(t, ob) for t in tries):
                    continue
                findings.append(Finding(
                    "resource-leak", fi.rel, ob.line,
                    f"{fi.short}: {ob.describe()} leaks if {risk} at "
                    f"line {st.lineno} raises first — wrap the window "
                    "in try/finally or release in an except handler"))
                break                   # one window finding per obligation

            if ob.spec is not _CHARGE and how == "return" \
                    and end < len(entries) \
                    and _returns_bare(entries[end][0], ob.handle):
                returns_fresh = ob.spec

        return {"findings": findings, "returns_fresh": returns_fresh}

    # -- discharge ----------------------------------------------------
    def _discharge_index(self, entries, start: int, ob: _Obligation
                         ) -> Tuple[Optional[int], str]:
        """First entry after ``start`` that discharges ``ob`` (branch-
        insensitive: any later statement counts — under-approximation
        keeps false leaks out at the cost of missing some real ones)."""
        for j in range(start + 1, len(entries)):
            st, _tries, _cleanup = entries[j]
            how = self._discharges(st, ob)
            if how is not None:
                return j, how
        return None, ""

    def _discharges(self, st: ast.stmt, ob: _Obligation) -> Optional[str]:
        if ob.spec is _CHARGE:
            for call in self._own_calls(st):
                if _charge_release(call, ob.charge_key):
                    return "release"
            return None
        h = ob.handle
        for call in self._own_calls(st):
            f = call.func
            if isinstance(f, ast.Attribute):
                if f.attr in ob.spec.handle_release \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == h:
                    return "release"
                if f.attr in ob.spec.pool_release \
                        and _names_arg(call, h):
                    return "release"
            if _names_arg(call, h):
                return "transfer"       # new owner: callee
        if isinstance(st, ast.Return) and st.value is not None \
                and _mentions(st.value, h):
            return "return"
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Yield) \
                and st.value.value is not None \
                and _mentions(st.value.value, h):
            return "return"
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            value = st.value
            targets = (st.targets if isinstance(st, ast.Assign)
                       else [st.target])
            if value is not None and _mentions(value, h) \
                    and not _is_handle_method(value, h):
                for t in targets:
                    if not (isinstance(t, ast.Name) and t.id == h):
                        return "transfer"   # stored / aliased away
        return None

    # -- exception windows --------------------------------------------
    def _risk_of(self, st: ast.stmt, ob: _Obligation) -> Optional[str]:
        """Why ``st`` can raise mid-window: another modeled acquisition
        (allocation / blocking quota admission) or an explicit raise.
        Ordinary calls are deliberately not 'risky' — flagging every
        call would drown the signal; the modeled acquisitions are the
        ones whose failure modes (MemoryError, QuotaExceededError) the
        repo actually ships."""
        if isinstance(st, ast.Raise):
            return "the raise"
        for call in self._own_calls(st):
            key = _charge_call(call)
            if key is not None and key != ob.charge_key:
                return f"the {key[0]}.charge({key[1]!r}) admission"
            spec = self._acquire_spec(call, None, derived=False)
            if spec is not None and spec is not ob.spec:
                return f"the {spec.kind} acquisition"
            if spec is not None and spec is ob.spec \
                    and call.lineno != ob.line:
                return f"the second {spec.kind} acquisition"
        return None

    def _try_releases(self, t: ast.Try, ob: _Obligation) -> bool:
        """Does a handler or finally of ``t`` release ``ob``?"""
        bodies = list(t.finalbody)
        for h in t.handlers:
            bodies.extend(h.body)
        for st in bodies:
            for sub in ast.walk(st):
                if isinstance(sub, ast.Call):
                    if ob.spec is _CHARGE:
                        if _charge_release(sub, ob.charge_key):
                            return True
                    else:
                        f = sub.func
                        if isinstance(f, ast.Attribute) and (
                                (f.attr in ob.spec.handle_release
                                 and isinstance(f.value, ast.Name)
                                 and f.value.id == ob.handle)
                                or (f.attr in ob.spec.pool_release
                                    and _names_arg(sub, ob.handle))):
                            return True
        return False

    # -- statement-local node harvesting ------------------------------
    @staticmethod
    def _own_calls(st: ast.stmt) -> List[ast.Call]:
        """Calls belonging to ``st`` itself — a compound statement owns
        only its header (test / iterable / context expressions), never
        its body (those are separate entries)."""
        roots: List[ast.AST] = []
        if isinstance(st, (ast.If, ast.While)):
            roots.append(st.test)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            roots.append(st.iter)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            roots.extend(i.context_expr for i in st.items)
        elif isinstance(st, ast.Try):
            return []
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return []               # nested scopes analyzed on their own
        else:
            roots.append(st)
        out: List[ast.Call] = []
        for r in roots:
            out.extend(n for n in ast.walk(r) if isinstance(n, ast.Call))
        return out


def _linearize(body: Sequence[ast.stmt], tries: Tuple[ast.Try, ...],
               cleanup: bool,
               out: List[Tuple[ast.stmt, Tuple[ast.Try, ...], bool]]
               ) -> None:
    """Document-order statement list, each tagged with the ``try``
    statements whose *body* (the protected region) encloses it and
    whether it lives in cleanup position (an except handler or
    ``finally`` — rollback code there re-raises by design and must not
    count as a new leak window)."""
    for st in body:
        out.append((st, tries, cleanup))
        if isinstance(st, ast.Try):
            _linearize(st.body, tries + (st,), cleanup, out)
            for h in st.handlers:
                _linearize(h.body, tries, True, out)
            _linearize(st.orelse, tries, cleanup, out)
            _linearize(st.finalbody, tries, True, out)
        elif isinstance(st, (ast.If, ast.While, ast.For, ast.AsyncFor)):
            _linearize(st.body, tries, cleanup, out)
            _linearize(st.orelse, tries, cleanup, out)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            _linearize(st.body, tries, cleanup, out)


def _bound_name(st: ast.stmt, call: ast.Call) -> Optional[str]:
    """Local name an acquisition's result is bound to; None when the
    result is discarded (an ``Expr`` statement whose value IS the
    call). Any binding shape other than a plain name — tuple target,
    attribute target, use as a sub-expression — is treated as an
    immediate ownership transfer ('' sentinel)."""
    if isinstance(st, ast.Assign) and st.value is call \
            and len(st.targets) == 1 \
            and isinstance(st.targets[0], ast.Name):
        return st.targets[0].id
    if isinstance(st, ast.Expr) and st.value is call:
        return None
    return ""


def _mentions(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def _is_handle_method(node: ast.AST, name: str) -> bool:
    """``h.view(...)``-style: the only mention of ``h`` is as the
    receiver of its own method call — reading through the handle is not
    a transfer."""
    mentions = [n for n in ast.walk(node)
                if isinstance(n, ast.Name) and n.id == name]
    receivers = [f.value for f in ast.walk(node)
                 if isinstance(f, ast.Attribute)]
    return all(m in receivers for m in mentions)


def _names_arg(call: ast.Call, name: str) -> bool:
    """Is the bare ``name`` one of the call's arguments (directly or
    inside a container literal)?"""
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        if _mentions(a, name):
            return True
    return False


def _returns_bare(st: ast.stmt, name: str) -> bool:
    """``return h`` / ``return ..., h, ...`` — the shapes that make the
    caller the handle's owner."""
    if not isinstance(st, ast.Return) or st.value is None:
        return False
    v = st.value
    if isinstance(v, ast.Name) and v.id == name:
        return True
    if isinstance(v, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id == name
                   for e in v.elts)
    return False


def model(ctx: LintContext) -> ResourceModel:
    return ctx.memo("resource-model", ResourceModel)


@rule("resource-leak",
      "modeled resources (leases, tickets, device slots, quota charges, "
      "open files) must reach a release, 'with', or ownership transfer "
      "on every path including exception paths")
def check_resource_leak(ctx: LintContext) -> List[Finding]:
    m = model(ctx)
    findings: List[Finding] = []
    for fi in m.cg.funcs.values():
        findings.extend(m.findings_for(fi))
    return findings


@rule("teardown-completeness",
      "resource-bearing attributes constructed in __init__ must be "
      "released somewhere reachable from the class's close()/stop()")
def check_teardown_completeness(ctx: LintContext) -> List[Finding]:
    m = model(ctx)
    cg = m.cg
    findings: List[Finding] = []
    for (rel, cls), methods in sorted(cg.methods.items()):
        roots = [r for r in ("close", "stop") if r in methods]
        if not roots or "__init__" not in methods:
            continue
        owned = _owned_attrs(cg, methods["__init__"], m)
        if not owned:
            continue
        reachable = cg.class_reachable(rel, cls, roots)
        released = _released_attrs(
            [methods[name].node for name in reachable if name in methods])
        for attr, (line, what) in sorted(owned.items()):
            if attr in released:
                continue
            findings.append(Finding(
                "teardown-completeness", rel, line,
                f"{cls}.__init__ constructs self.{attr} ({what}) but "
                f"{'/'.join(roots)} never releases it — call "
                f"self.{attr}.close()/stop() during teardown"))
    return findings


def _owned_attrs(cg: CallGraph, init: FuncInfo, m: ResourceModel
                 ) -> Dict[str, Tuple[int, str]]:
    """``self.x = <Call>`` bindings in ``__init__`` whose call
    constructs a resource the class now owns: a modeled acquisition, or
    an unambiguous package class that itself defines close/stop.
    ``self.x = injected`` parameter passthrough is exempt — the
    injector owns it."""
    owned: Dict[str, Tuple[int, str]] = {}
    for st in ast.walk(init.node):
        if not isinstance(st, ast.Assign) or len(st.targets) != 1:
            continue
        t = st.targets[0]
        if not (isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name) and t.value.id == "self"
                and isinstance(st.value, ast.Call)):
            continue
        call = st.value
        spec = m._acquire_spec(call, init, derived=False)
        if spec is not None and spec is not _CHARGE:
            owned[t.attr] = (st.lineno, spec.kind)
            continue
        if isinstance(call.func, ast.Name):
            cands = cg.by_name.get(call.func.id, ())
            if len(cands) == 1 and cands[0].name == "__init__" \
                    and cands[0].cls is not None:
                ctor_methods = cg.class_methods(cands[0].rel,
                                                cands[0].cls)
                if "close" in ctor_methods or "stop" in ctor_methods:
                    owned[t.attr] = (st.lineno, cands[0].cls)
    return owned


def _released_attrs(nodes: Sequence[ast.AST]) -> Set[str]:
    """Attributes ``x`` with a ``self.x.<release>()`` call (or a
    ``self.x`` passed to any call — delegated teardown) in ``nodes``."""
    out: Set[str] = set()
    for node in nodes:
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in _TEARDOWN_RELEASE \
                    and isinstance(f.value, ast.Attribute) \
                    and isinstance(f.value.value, ast.Name) \
                    and f.value.value.id == "self":
                out.add(f.value.attr)
            for a in list(n.args) + [kw.value for kw in n.keywords]:
                if isinstance(a, ast.Attribute) \
                        and isinstance(a.value, ast.Name) \
                        and a.value.id == "self":
                    out.add(a.attr)
    return out


__all__ = ["ResourceModel", "model"]
