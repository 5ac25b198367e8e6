"""srlint for the port (``sparkrdma_tpu_torch/lint``): parity with the
reference's rules, the port's idioms, the real ctypes tables, the
engine, the CLI, and the clean-tree meta-test.

- **Parity.** Every fixture mini-repo of ``tests/test_lint.py`` is one
  case of :func:`test_parity_with_reference`. The reference's
  ``run_rules`` reads it under ``sparkrdma_tpu/``, the port's reads the
  same sources under ``sparkrdma_tpu_torch/`` (and ``tests/test_*.py``
  as ``tests/test_torch_*.py``); rule, path, line, message and legacy
  object must be equal once the package name is swapped.
- **Idioms.** Each form the port writes where the reference writes
  another has a clean fixture and a bad twin that fires.
- **ABI.** Copies of the real ``_build.py``, ``csrc/*.cu``,
  ``hbm/host_staging.py`` and ``native/staging.cpp``, mutated.

The reference's lint is imported inside the tests; this module imports
only stdlib, pytest and the port's stdlib-only lint at module level.
"""

import json
import re
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from sparkrdma_tpu_torch.lint import Finding, all_rules, run_rules
from sparkrdma_tpu_torch.lint import core as lint_core

REPO = Path(__file__).resolve().parent.parent
PKG = "sparkrdma_tpu_torch"


def repo(root, files):
    """Materialize a {relpath: source} mini-repo (``None`` makes an
    empty directory) and return its root."""
    root.mkdir(parents=True, exist_ok=True)
    for rel, text in files.items():
        p = root / rel
        if text is None:
            p.mkdir(parents=True, exist_ok=True)
            continue
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return root


def rules_of(findings):
    return [f.rule for f in findings]


def msgs_of(findings):
    return " | ".join(f.message for f in findings)


# ---------------------------------------------------------------------
# parity: the fixture mini-repos of tests/test_lint.py
# ---------------------------------------------------------------------

_JOURNAL = """
    import dataclasses

    @dataclasses.dataclass
    class ExchangeSpan:
        shuffle_id: int
        rounds: int
"""

_ROLLUP = """
    ROLLUP_FIELDS = frozenset({"ts", "window_s"})
    HEARTBEAT_FIELDS = frozenset({"ts", "rss_mb"})
"""

_CONF = """
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class ShuffleConf:
        alpha: int = 4
        beta: str = "x"

        def __post_init__(self):
            if self.alpha <= 0:
                raise ValueError("alpha must be positive")
"""

_CONF_README = """
    # demo

    ## Configuration

    | field | meaning |
    |---|---|
    | `alpha` | slots |
    | `beta` | tag |

    ## Next section
"""

_CONF_USE = "def f(conf):\n    return conf.alpha + len(conf.beta)\n"

_NAMES = """
    COUNTERS = frozenset({"pool.hits"})
    GAUGES = frozenset({"g.x"})
    HISTOGRAMS = frozenset({"h.x"})
    TIMELINE_TRACKS = frozenset({"t.x"})
    WILDCARDS = frozenset({"w.*"})
"""

_EMIT = """
    def emit(reg, tl, op):
        reg.counter("pool.hits").inc()
        reg.gauge("g.x").set(1)
        reg.histogram("h.x").observe(2)
        tl.counter("t.x", 3)
        reg.counter(f"w.{op}").inc()
"""

_ALERTS = """
    ALERT_FIELDS = frozenset({"kind", "schema", "ts", "rule"})

    def _line(rule, ts):
        return {"kind": "alert", "schema": 11, "ts": ts, "rule": rule}

    def _register():
        alert_rule("spill_storm", severity="warn", subsystem="store",
                   condition="delta", metrics=("pool.hits", "w.spill"))
"""

_TRACE = """
    JOB_FIELDS = frozenset({"kind", "ts", "trace_id", "job", "wall_s",
                            "dominant_stage", "stages"})
    STAGE_FIELDS = frozenset({"stage", "attempt", "wall_s", "spans"})
    STAGE_VOCAB = frozenset({"probe_join", "rank_update"})
"""

_PLAN_EXEC = """
    PLAN_FIELDS = frozenset({"kind", "schema", "ts", "rewrite",
                             "bytes_saved"})

    def plan_line(rewrite, saved):
        return {"kind": "plan", "schema": 13, "ts": 0.0,
                "rewrite": rewrite, "bytes_saved": saved}
"""

_WIRE = """
    RPC_SCHEMA_VERSION = 1
    REQUEST_FIELDS = frozenset({"op", "req_id", "client", "schema",
                                "args"})
    REPLY_FIELDS = frozenset({"ok", "req_id", "schema", "value",
                              "error", "retryable"})
    OPS = frozenset({"hello", "read"})
    LEASE_FIELDS = frozenset({"kind", "schema", "ts", "event",
                              "client", "ttl_s"})
"""

_RPC_CLIENT = """
    class RpcClient:
        def _call(self, op, **args):
            return {
                "op": op,
                "req_id": "r1",
                "client": "c1",
                "schema": 1,
                "args": args,
            }

        def hello(self):
            return self._call("hello")

        def read(self):
            return self._call("read")
"""

_RPC_SERVER = """
    _HANDLERS = {"hello": "_op_hello", "read": "_op_read"}

    def lease_line(event, client):
        return {"kind": "lease", "schema": 14, "ts": 0.0,
                "event": event, "client": client, "ttl_s": 0.0}

    def reply(req_id, ok, value):
        return {"ok": ok, "req_id": req_id, "schema": 1,
                "value": value, "error": "", "retryable": False}
"""

_GUARDED = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0          # guarded-by: _lock

        def good(self):
            with self._lock:
                self.n += 1

        def drain_locked(self):
            self.n -= 1
"""

_DEADLOCK = """
    import threading

    class A:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def one(self):
            with self._a:
                with self._b:
                    pass

        def two(self):
            with self._b:
                self.helper()

        def helper(self):
            with self._a:
                pass
"""

_REENTER = """
    import threading

    class R:
        def __init__(self):
            self._r = threading.{ctor}()

        def outer(self):
            with self._r:
                self.inner()

        def inner(self):
            with self._r:
                pass
"""

_BLOCKING = """
    import queue
    import threading
    import time

    class W:
        def __init__(self):
            self._lock = threading.Lock()
            self._q = queue.Queue()

        def bad_direct(self):
            with self._lock:
                time.sleep(0.1)

        def bad_through_callee(self):
            with self._lock:
                self.slow()

        def slow(self):
            time.sleep(0.5)

        def bad_queue(self):
            with self._lock:
                return self._q.get()

        def good_snapshot(self):
            with self._lock:
                n = 1
            time.sleep(0)
            return n

        def good_bounded(self):
            with self._lock:
                return self._q.get(timeout=1.0)
"""

_ESCAPE = """
    import threading

    class E:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
            self._t = threading.Thread(target=self._loop)

        def _loop(self):
            self.count += 1

        def read(self):
            return self.count
"""

_CONDWAIT = """
    import threading

    class CW:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition(self._lock)
            self.ready = False

        def good_while(self):
            with self._cond:
                while not self.ready:
                    self._cond.wait()

        def good_wait_for_under_alias(self):
            with self._lock:
                self._cond.wait_for(lambda: self.ready)

        def bad_no_loop(self):
            with self._cond:
                self._cond.wait()

        def bad_no_lock(self):
            self._cond.wait()
"""

_LIFECYCLE = """
    import threading

    class T:
        def __init__(self):
            self._t = threading.Thread(target=self._run)

        def start(self):
            self._t.start()

        def _run(self):
            pass
"""

_TEARDOWN_LEAKY = """
    class TieredThing:
        def __init__(self, conf):
            self._segments = {}

        def close(self):
            self._segments.clear()

    class Service:
        def __init__(self, conf):
            self.store = TieredThing(conf)
            self.label = str(conf)

        def stop(self):
            self.label = ""
"""

_CPP_OK = """
    // minimal extern block exercising scalars, pointers, and void
    static int helper(int x) { return x; }

    extern "C" {

    void* sr_pool_create() { return 0; }

    long sr_write_file(const char* path, const void* buf, size_t len) {
      return (long)len;
    }

    void sr_pool_stats(void* pool, long* hits) { *hits = 0; }

    }  // extern "C"
"""

_PY_OK = """
    import ctypes

    def _declare(lib):
        lib.sr_pool_create.restype = ctypes.c_void_p
        lib.sr_pool_create.argtypes = []
        lib.sr_write_file.restype = ctypes.c_long
        lib.sr_write_file.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_size_t]
        lib.sr_pool_stats.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_long)]
        return lib
"""

_PY_GATED = """
    import ctypes

    def _declare(lib):
        lib.sr_pool_create.restype = ctypes.c_void_p
        lib.sr_pool_create.argtypes = []
        try:
            lib.sr_encode_rows.restype = ctypes.c_long
            lib.sr_encode_rows.argtypes = [ctypes.c_void_p]
            lib.sr_has_codec = True
        except AttributeError:
            lib.sr_has_codec = False
        return lib

    def codec_available(lib):
        return bool(getattr(lib, "sr_has_codec", False))
"""

_CPP = "sparkrdma_tpu/native/staging.cpp"
_PY = "sparkrdma_tpu/hbm/host_staging.py"


def _case(cid, select, files):
    return pytest.param(select, files, id=cid)


PARITY_CASES = [
    # -- test-hygiene rules --------------------------------------------
    _case("tests-importable-broken", "tests-importable", {
        "tests/test_ok.py": "X = 1\n",
        "tests/test_broken.py": "import no_such_module_xyzzy\n"}),
    _case("tests-importable-fixed", "tests-importable", {
        "tests/test_ok.py": "X = 1\n", "tests/test_broken.py": "Y = 2\n"}),
    _case("tests-importable-empty-suite", "tests-importable",
          {"tests": None}),
    _case("slow-marker-missing", "tests-slow-marker", {
        "tests/test_proc.py": 'import subprocess\n\ndef test_x():\n'
                              '    subprocess.run(["true"])\n'}),
    _case("slow-marker-present", "tests-slow-marker", {
        "tests/test_proc.py": 'import pytest\nimport subprocess\n\n'
                              '@pytest.mark.slow\ndef test_x():\n'
                              '    subprocess.run(["true"])\n'}),
    # -- contract-sync rules -------------------------------------------
    _case("journal-schema-clean", "journal-schema-sync", {
        "sparkrdma_tpu/obs/journal.py": _JOURNAL,
        "sparkrdma_tpu/obs/rollup.py": _ROLLUP,
        "scripts/shuffle_report.py": """
            def render(s, rb, hb):
                return (s.get("shuffle_id"), s.get("total_bytes"),
                        rb.get("ts"), hb.get("rss_mb"))
        """}),
    _case("journal-schema-ghosts", "journal-schema-sync", {
        "sparkrdma_tpu/obs/journal.py": _JOURNAL,
        "sparkrdma_tpu/obs/rollup.py": _ROLLUP,
        "scripts/shuffle_report.py": """
            def render(s, rb, hb):
                return (s.get("ghost_field"), rb.get("zzz"), hb.get("ts"))
        """}),
    _case("fault-site-clean", "fault-site-sync", {
        "sparkrdma_tpu/faults.py": 'SITES = ("a.b", "c.d")\n',
        "sparkrdma_tpu/x.py": """
            def f(_faults):
                _faults.fire("a.b")
                _faults.fire("c.d")
        """}),
    _case("fault-site-both-ways", "fault-site-sync", {
        "sparkrdma_tpu/faults.py": 'SITES = ("a.b", "c.d")\n',
        "sparkrdma_tpu/x.py": """
            def f(_faults):
                _faults.fire("a.b")
                _faults.fire("zz.unregistered")
        """}),
    _case("config-clean", "config-key-sync", {
        "sparkrdma_tpu/config.py": _CONF, "README.md": _CONF_README,
        "sparkrdma_tpu/use.py": _CONF_USE}),
    _case("config-unvalidated-numeric", "config-key-sync", {
        "sparkrdma_tpu/config.py": _CONF.replace(
            'beta: str = "x"', 'beta: str = "x"\n        gamma: int = 1'),
        "README.md": _CONF_README, "sparkrdma_tpu/use.py": _CONF_USE}),
    _case("config-undocumented", "config-key-sync", {
        "sparkrdma_tpu/config.py": _CONF,
        "README.md": _CONF_README.replace("| `beta` | tag |\n", ""),
        "sparkrdma_tpu/use.py": _CONF_USE}),
    _case("config-typo-access", "config-key-sync", {
        "sparkrdma_tpu/config.py": _CONF, "README.md": _CONF_README,
        "sparkrdma_tpu/use.py":
            "def f(conf):\n    return conf.alpha + conf.betta\n"}),
    _case("config-dead-knob", "config-key-sync", {
        "sparkrdma_tpu/config.py": _CONF, "README.md": _CONF_README,
        "sparkrdma_tpu/use.py": "def f(conf):\n    return conf.alpha\n"}),
    _case("counter-clean", "counter-name-sync", {
        "sparkrdma_tpu/obs/names.py": _NAMES,
        "sparkrdma_tpu/m.py": _EMIT}),
    _case("counter-both-ways", "counter-name-sync", {
        "sparkrdma_tpu/obs/names.py": _NAMES,
        "sparkrdma_tpu/m.py": _EMIT.replace('reg.counter("pool.hits")',
                                            'reg.counter("rogue.name")')}),
    _case("counter-fstring-arm-and-cli", "counter-name-sync", {
        "sparkrdma_tpu/obs/names.py": _NAMES,
        "sparkrdma_tpu/m.py": _EMIT.replace(
            'f"w.{op}"', 'f"w.{op}" if op else f"v.{op}"'),
        "scripts/shuffle_top.py": 'metric = "bogus.metric"\n'}),
    _case("alert-clean", "alert-rule-sync", {
        "sparkrdma_tpu/obs/alerts.py": _ALERTS,
        "sparkrdma_tpu/obs/names.py": _NAMES,
        "scripts/shuffle_top.py": """
            def row(al):
                return (al.get("rule"), al.get("ts"))
        """}),
    _case("alert-undeclared-metric", "alert-rule-sync", {
        "sparkrdma_tpu/obs/alerts.py": _ALERTS.replace(
            '"pool.hits"', '"rogue.series"'),
        "sparkrdma_tpu/obs/names.py": _NAMES}),
    _case("alert-emitter-drift", "alert-rule-sync", {
        "sparkrdma_tpu/obs/alerts.py": _ALERTS.replace(
            '"ts": ts,', '"when": ts,'),
        "sparkrdma_tpu/obs/names.py": _NAMES}),
    _case("alert-cli-ghost", "alert-rule-sync", {
        "sparkrdma_tpu/obs/alerts.py": _ALERTS,
        "sparkrdma_tpu/obs/names.py": _NAMES,
        "scripts/shuffle_report.py": """
            def row(al):
                return al.get("ghost_severity")
        """}),
    _case("alert-nonliteral-metrics", "alert-rule-sync", {
        "sparkrdma_tpu/obs/alerts.py": _ALERTS + """
    def helper(metrics):
        alert_rule("derived_rule", metrics=tuple(metrics))
""",
        "sparkrdma_tpu/obs/names.py": _NAMES}),
    _case("trace-clean", "trace-schema-sync", {
        "sparkrdma_tpu/obs/trace.py": _TRACE,
        "sparkrdma_tpu/workloads/w.py": """
            def run(_trace):
                with _trace.stage("probe_join"):
                    pass
        """,
        "scripts/shuffle_report.py": """
            STAGE_ADVICE = {"probe_join": "shrink the build side"}

            def render(jb):
                out = [f"{jb.get('job')}: {jb.get('wall_s')}s"]
                for st in jb.get("stages") or []:
                    out.append((st.get("stage"), st.get("wall_s")))
                return out
        """}),
    _case("trace-ghost-fields", "trace-schema-sync", {
        "sparkrdma_tpu/obs/trace.py": _TRACE,
        "scripts/shuffle_top.py": """
            def render(jb, st):
                return (jb.get("ghost_job_field"), st.get("ghost_stage"))
        """}),
    _case("trace-advice-and-annotation", "trace-schema-sync", {
        "sparkrdma_tpu/obs/trace.py": _TRACE,
        "sparkrdma_tpu/workloads/w.py": """
            def run(_trace):
                with _trace.stage("mystery_stage"):
                    pass
        """,
        "scripts/shuffle_report.py": """
            STAGE_ADVICE = {"not_a_stage": "advice nothing can match"}
        """}),
    _case("trace-skips-without-module", "trace-schema-sync", {
        "scripts/shuffle_report.py": """
            def render(jb):
                return jb.get("anything_goes")
        """}),
    _case("plan-clean", "plan-schema-sync", {
        "sparkrdma_tpu/plan/executor.py": _PLAN_EXEC,
        "scripts/shuffle_report.py": """
            def row(pl):
                return (pl.get("rewrite"), pl.get("bytes_saved"))
        """}),
    _case("plan-emitter-drift", "plan-schema-sync", {
        "sparkrdma_tpu/plan/executor.py": _PLAN_EXEC.replace(
            '"ts": 0.0,', '"when": 0.0,')}),
    _case("plan-cli-ghost", "plan-schema-sync", {
        "sparkrdma_tpu/plan/executor.py": _PLAN_EXEC,
        "scripts/shuffle_top.py": """
            def row(pl):
                return pl.get("ghost_rows")
        """}),
    _case("plan-skips-without-module", "plan-schema-sync", {
        "scripts/shuffle_report.py": """
            def row(pl):
                return pl.get("anything_goes")
        """}),
    _case("rpc-clean", "rpc-schema-sync", {
        "sparkrdma_tpu/service/wire.py": _WIRE,
        "sparkrdma_tpu/service/client.py": _RPC_CLIENT,
        "sparkrdma_tpu/service/rpc.py": _RPC_SERVER,
        "scripts/shuffle_top.py": """
            def row(ls):
                return (ls.get("client"), ls.get("ttl_s"))
        """}),
    _case("rpc-request-drift", "rpc-schema-sync", {
        "sparkrdma_tpu/service/wire.py": _WIRE,
        "sparkrdma_tpu/service/client.py": _RPC_CLIENT.replace(
            '"args": args,', '"params": args,')}),
    _case("rpc-op-vocabulary", "rpc-schema-sync", {
        "sparkrdma_tpu/service/wire.py": _WIRE,
        "sparkrdma_tpu/service/client.py": _RPC_CLIENT.replace(
            'self._call("read")', 'self._call("raed")'),
        "sparkrdma_tpu/service/rpc.py": _RPC_SERVER.replace(
            ', "read": "_op_read"', '')}),
    _case("rpc-lease-and-cli", "rpc-schema-sync", {
        "sparkrdma_tpu/service/wire.py": _WIRE,
        "sparkrdma_tpu/service/rpc.py": _RPC_SERVER.replace(
            '"ttl_s": 0.0}', '"expires_s": 0.0}'),
        "scripts/shuffle_top.py": """
            def row(ls):
                return ls.get("liveness_flag")
        """}),
    _case("rpc-skips-without-wire", "rpc-schema-sync", {
        "scripts/shuffle_top.py": """
            def row(ls):
                return ls.get("anything_goes")
        """}),
    # -- timeline pairing ------------------------------------------------
    _case("timeline-clean", "timeline-pairing", {"sparkrdma_tpu/t.py": """
        def good(tl):
            tl.begin("a")
            tl.end("a")

        def good_record(ci):
            from x import record_active
            record_active("d", ph="B", chunk=ci)
            record_active("d", ph="E", chunk=ci)
    """}),
    _case("timeline-loop-and-open", "timeline-pairing",
          {"sparkrdma_tpu/t.py": """
        def loop_bug(tl, items):
            for it in items:
                tl.begin("b")
            tl.end("b")

        def open_span(tl):
            tl.event("c", ph="B")
    """}),
    _case("timeline-nested-def", "timeline-pairing",
          {"sparkrdma_tpu/t.py": """
        def outer(tl):
            def producer():
                tl.begin("x")
            tl.end("x")
    """}),
    _case("timeline-cm-methods-pair", "timeline-pairing",
          {"sparkrdma_tpu/t.py": """
        class Scope:
            def __enter__(self):
                self.tl.begin("job")
                return self

            def __exit__(self, *exc):
                self.tl.end("job")

            def _begin_stage(self):
                self.tl.begin("stage")

            def _end_stage(self):
                self.tl.end("stage")
    """}),
    _case("timeline-cm-leaky", "timeline-pairing",
          {"sparkrdma_tpu/t.py": """
        class Leaky:
            def __enter__(self):
                self.tl.begin("job")
                return self

            def __exit__(self, *exc):
                pass
    """}),
    # -- guarded-by ------------------------------------------------------
    _case("guarded-clean", "guarded-by", {"sparkrdma_tpu/g.py": _GUARDED}),
    _case("guarded-outside-lock", "guarded-by",
          {"sparkrdma_tpu/g.py": _GUARDED + """
        def bad(self):
            return self.n
    """}),
    _case("guarded-after-release", "guarded-by",
          {"sparkrdma_tpu/g.py": _GUARDED + """
        def tricky(self):
            with self._lock:
                self.n += 1
            self.n -= 1
    """}),
    _case("guarded-module-global", "guarded-by", {"sparkrdma_tpu/g.py": """
        import threading

        _g_lock = threading.Lock()
        _g = None       # guarded-by: _g_lock

        def set_g(v):
            global _g
            with _g_lock:
                _g = v

        def bad_read():
            return _g
    """}),
    # -- assert-safety + suppressions ------------------------------------
    _case("assert-fires", "assert-safety",
          {"sparkrdma_tpu/a.py": "assert 1 == 1\n"}),
    _case("suppression-line-and-above", "assert-safety",
          {"sparkrdma_tpu/a.py": """
        assert True  # srlint: ignore[assert-safety]
        # srlint: ignore[assert-safety] -- demo of the line-above form
        assert True
        assert False, "this one is NOT suppressed"
    """}),
    _case("suppression-other-rule", "assert-safety", {
        "sparkrdma_tpu/a.py":
            "assert True  # srlint: ignore[timeline-pairing]\n"}),
    _case("suppression-comma-list", "assert-safety", {
        "sparkrdma_tpu/a.py": "assert True  # srlint: ignore"
                              "[timeline-pairing, assert-safety]\n"}),
    # -- never-raise-io --------------------------------------------------
    _case("never-raise-clean", "never-raise-io", {"sparkrdma_tpu/io.py": """
        def good(path):   # never-raises
            try:
                with open(path, "w") as f:
                    f.write("x")
            except OSError:
                pass

        def unannotated(path):
            with open(path, "w") as f:
                f.write("x")
    """}),
    _case("never-raise-unguarded", "never-raise-io",
          {"sparkrdma_tpu/io.py": """
        def bad(path):   # never-raises
            with open(path, "w") as f:
                f.write("y")
    """}),
    _case("never-raise-narrow-handler", "never-raise-io",
          {"sparkrdma_tpu/io.py": """
        def sneaky(path):   # never-raises
            try:
                open(path)
            except ValueError:
                pass
    """}),
    # -- lock-order ------------------------------------------------------
    _case("lock-order-cycle", "lock-order",
          {"sparkrdma_tpu/d.py": _DEADLOCK}),
    _case("lock-order-consistent", "lock-order", {"sparkrdma_tpu/d.py": """
        import threading

        class A:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._a:
                    self.helper()

            def helper(self):
                with self._b:
                    pass
    """}),
    _case("lock-order-rlock-reentry", "lock-order",
          {"sparkrdma_tpu/r.py": _REENTER.format(ctor="RLock")}),
    _case("lock-order-lock-reentry", "lock-order",
          {"sparkrdma_tpu/r.py": _REENTER.format(ctor="Lock")}),
    _case("lock-order-suppressed", "lock-order",
          {"sparkrdma_tpu/d.py": _DEADLOCK.replace(
              "with self._b:\n                    pass",
              "with self._b:  # srlint: ignore[lock-order]\n"
              "                    pass")}),
    # -- blocking-under-lock ---------------------------------------------
    _case("blocking-direct-traced-queue", "blocking-under-lock",
          {"sparkrdma_tpu/w.py": _BLOCKING}),
    _case("blocking-suppressed", "blocking-under-lock",
          {"sparkrdma_tpu/w.py": _BLOCKING.replace(
              "time.sleep(0.1)",
              "time.sleep(0.1)  # srlint: ignore[blocking-under-lock]")}),
    _case("blocking-callee-own-lock", "blocking-under-lock",
          {"sparkrdma_tpu/w.py": """
        import threading
        import time

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self._leaf = threading.Lock()

            def caller(self):
                with self._lock:
                    self.leaf_op()

            def leaf_op(self):
                with self._leaf:
                    time.sleep(0.1)
    """}),
    # -- guarded-by-inference --------------------------------------------
    _case("inference-fires", "guarded-by-inference",
          {"sparkrdma_tpu/e.py": _ESCAPE}),
    _case("inference-annotated", "guarded-by-inference",
          {"sparkrdma_tpu/e.py": _ESCAPE.replace(
              "self.count = 0", "self.count = 0  # guarded-by: _lock")}),
    _case("inference-background-only", "guarded-by-inference",
          {"sparkrdma_tpu/e.py": _ESCAPE.replace(
              "return self.count", "return 0")}),
    # -- condition-wait-loop ---------------------------------------------
    _case("condition-wait", "condition-wait-loop",
          {"sparkrdma_tpu/c.py": _CONDWAIT}),
    # -- thread-lifecycle ------------------------------------------------
    _case("lifecycle-attr-unjoined", "thread-lifecycle",
          {"sparkrdma_tpu/t.py": _LIFECYCLE}),
    _case("lifecycle-attr-joined", "thread-lifecycle", {
        "sparkrdma_tpu/t.py": textwrap.dedent(_LIFECYCLE)
        + "    def close(self):\n        self._t.join(timeout=5)\n"}),
    _case("lifecycle-local-and-inline", "thread-lifecycle",
          {"sparkrdma_tpu/t.py": """
        import threading

        def balanced():
            t = threading.Thread(target=print)
            t.start()
            t.join()

        def fire_and_forget():
            threading.Thread(target=print, daemon=True).start()
    """}),
    _case("lifecycle-documented-daemon", "thread-lifecycle",
          {"sparkrdma_tpu/t.py": """
        import threading

        def fire_and_forget():
            # srlint: ignore[thread-lifecycle]
            threading.Thread(target=print, daemon=True).start()
    """}),
    # -- resource-leak -----------------------------------------------------
    _case("leak-lease-never-released", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def stage(pool, arr):
            lease = pool.get(arr.nbytes)
            lease.view()[...] = arr
    """}),
    _case("leak-try-finally", "resource-leak", {"sparkrdma_tpu/r.py": """
        def stage(pool, arr):
            lease = pool.get(arr.nbytes)
            try:
                lease.view()[...] = arr
            finally:
                lease.release()
    """}),
    _case("leak-open", "resource-leak", {"sparkrdma_tpu/r.py": """
        def read_ok(path):
            with open(path) as fh:
                return fh.read()

        def read_leaks(path):
            fh = open(path)
            data = fh.read()
            return data
    """}),
    _case("leak-ownership-transfer", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        class Owner:
            def grab(self, pool, n):
                self.lease = pool.get(n)       # stored on self

        def fresh(pool, n):
            lease = pool.get(n)
            return lease                       # returned to the caller

        def enqueue(pool, frames, n):
            lease = pool.get(n)
            frames.append(lease)               # handed to a container
    """}),
    _case("leak-derived-acquirer", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def fresh(pool, n):
            lease = pool.get(n)
            return lease

        def caller_leaks(pool, n):
            h = fresh(pool, n)
            h.view()

        def caller_ok(pool, n):
            h = fresh(pool, n)
            h.view()
            h.release()
    """}),
    _case("leak-window-between-acquisitions", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def double(pool, n):
            a = pool.get(n)
            b = pool.get(n)
            b.release()
            a.release()
    """}),
    _case("leak-window-guarded", "resource-leak", {"sparkrdma_tpu/r.py": """
        def double(pool, n):
            a = pool.get(n)
            try:
                b = pool.get(n)
            except MemoryError:
                a.release()
                raise
            b.release()
            a.release()
    """}),
    _case("leak-multi-tier-charge", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def multi(acct):
            acct.charge("host", 100)
            acct.charge("disk", 100)
    """}),
    _case("leak-multi-tier-rollback", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def multi(acct):
            acct.charge("host", 100)
            try:
                acct.charge("disk", 100)
            except BaseException:
                acct.release("host", 100)
                raise
    """}),
    _case("leak-charge-then-allocate", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def put(acct, host_pool, nbytes):
            acct.charge("host", nbytes)
            lease = host_pool.get(nbytes)
            return lease
    """}),
    _case("leak-charge-then-allocate-rollback", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def put(acct, host_pool, nbytes):
            acct.charge("host", nbytes)
            try:
                lease = host_pool.get(nbytes)
            except BaseException:
                acct.release("host", nbytes)
                raise
            return lease
    """}),
    _case("leak-device-balanced", "resource-leak", {"sparkrdma_tpu/r.py": """
        def round_trip(store, shape, sharding):
            buf = store.acquire_device(shape, "u32", sharding)
            buf.block_until_ready()
            store.release_device(buf, sharding)
    """}),
    _case("leak-device-unreleased", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def round_trip(store, shape, sharding):
            buf = store.acquire_device(shape, "u32", sharding)
            buf.block_until_ready()
    """}),
    _case("leak-admission-ticket", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def read_with(adm, tenant):
            with adm.admit(tenant):
                return 1

        def read_manual(adm, tenant):
            t = adm.admit(tenant)
            t.release()

        def read_leaks(adm, tenant):
            t = adm.admit(tenant)
            return 1
    """}),
    _case("leak-discarded", "resource-leak", {"sparkrdma_tpu/r.py": """
        def warm(pool, n):
            pool.get(n)
    """}),
    _case("leak-discarded-suppressed", "resource-leak",
          {"sparkrdma_tpu/r.py": """
        def warm(pool, n):
            # deliberate warm-up allocation, freed at pool close
            # srlint: ignore[resource-leak]
            pool.get(n)
    """}),
    # -- teardown-completeness -------------------------------------------
    _case("teardown-leaky", "teardown-completeness",
          {"sparkrdma_tpu/svc.py": _TEARDOWN_LEAKY}),
    _case("teardown-fixed", "teardown-completeness",
          {"sparkrdma_tpu/svc.py": _TEARDOWN_LEAKY.replace(
              'self.label = ""', 'self.label = ""\n            '
                                 'self.store.close()')}),
    _case("teardown-helper-and-injection", "teardown-completeness",
          {"sparkrdma_tpu/svc.py": """
        class Journal:
            def __init__(self, path):
                self.path = path

            def close(self):
                pass

        class Indirect:
            def __init__(self, path, pool):
                self.journal = Journal(path)
                self.pool = pool          # injected: injector owns it

            def _teardown(self):
                self.journal.close()

            def stop(self):
                self._teardown()
    """}),
    # -- native ABI --------------------------------------------------------
    _case("abi-clean", "abi-sync", {_CPP: _CPP_OK, _PY: _PY_OK}),
    _case("abi-flipped-width", "abi-sync", {
        _CPP: _CPP_OK, _PY: _PY_OK.replace("ctypes.c_size_t",
                                           "ctypes.c_int")}),
    _case("abi-pointer-restype", "abi-sync", {
        _CPP: _CPP_OK, _PY: _PY_OK.replace(
            "        lib.sr_pool_create.restype = ctypes.c_void_p\n", "")}),
    _case("abi-arity", "abi-sync", {_CPP: _CPP_OK, _PY: _PY_OK.replace(
        " ctypes.c_void_p,\n                                      "
        "ctypes.c_size_t", " ctypes.c_void_p")}),
    _case("abi-missing-argtypes", "abi-sync", {
        _CPP: _CPP_OK, _PY: _PY_OK.replace(
            "        lib.sr_pool_create.argtypes = []\n", "")}),
    _case("abi-stale-declaration", "abi-sync", {
        _CPP: _CPP_OK, _PY: _PY_OK.replace(
            "        return lib",
            "        lib.sr_gone.restype = ctypes.c_int\n"
            "        lib.sr_gone.argtypes = []\n"
            "        return lib")}),
    _case("abi-undeclared-export", "abi-sync", {
        _CPP: _CPP_OK.replace(
            "}  // extern \"C\"",
            "int sr_extra(size_t n) { return (int)n; }\n\n    }"),
        _PY: _PY_OK}),
    _case("abi-skips-without-anchors", "abi-sync",
          {"sparkrdma_tpu/other.py": "X = 1\n"}),
    _case("abi-gate-unprobed", "abi-gate", {
        _CPP: _CPP_OK, _PY: _PY_GATED, "sparkrdma_tpu/user.py": """
            def encode(lib, data):
                return lib.sr_encode_rows(data)
        """}),
    _case("abi-gate-probed", "abi-gate", {
        _CPP: _CPP_OK, _PY: _PY_GATED, "sparkrdma_tpu/user.py": """
            def via_helper(lib, data):
                if codec_available(lib):
                    return lib.sr_encode_rows(data)
                return None

            def via_flag(lib, data):
                if getattr(lib, "sr_has_codec", False):
                    return lib.sr_encode_rows(data)
                return None

            def via_wrapper(lib, data):
                # a helper-of-the-helper still counts (transitive)
                if native_ready(lib):
                    return lib.sr_encode_rows(data)
                return None

            def native_ready(lib):
                return codec_available(lib)
        """}),
    _case("abi-gate-ungated", "abi-gate", {
        _CPP: _CPP_OK, _PY: _PY_GATED, "sparkrdma_tpu/user.py": """
            def make_pool(lib):
                return lib.sr_pool_create()
        """}),
]


def _port_rel(rel: str) -> str:
    """A reference fixture path as the port's (package and test-module
    names swapped)."""
    if rel.startswith("sparkrdma_tpu/"):
        return PKG + rel[len("sparkrdma_tpu"):]
    if rel.startswith("tests/test_"):
        return "tests/test_torch_" + rel[len("tests/test_"):]
    return rel


def _swap_text(text: str, ref_root: Path, port_root: Path,
               tests_rule: bool) -> str:
    """A reference finding's text as the port's should read."""
    text = text.replace(str(ref_root), "\0ROOT\0")
    text = re.sub(r"sparkrdma_tpu(?!_torch)", PKG, text)
    if tests_rule:
        text = re.sub(r"\btest_(?!torch_)", "test_torch_", text)
    return text.replace("\0ROOT\0", str(port_root))


@pytest.mark.parametrize("select,files", PARITY_CASES)
def test_parity_with_reference(tmp_path, select, files):
    from sparkrdma_tpu.lint import run_rules as ref_run_rules

    ref_root = repo(tmp_path / "ref", files)
    port_root = repo(tmp_path / "port",
                     {_port_rel(k): v for k, v in files.items()})
    ref = ref_run_rules(ref_root, select=[select])
    port = run_rules(port_root, select=[select])
    tests_rule = select.startswith("tests-")

    def swap(s):
        return _swap_text(s, ref_root, port_root, tests_rule)

    want = [(f.rule, _port_rel(f.path), f.line, swap(f.message), swap(f.obj))
            for f in ref]
    got = [(f.rule, f.path, f.line, f.message, f.obj) for f in port]
    assert got == want


def test_parity_table_covers_every_reference_rule():
    """Every rule has at least one parity case, and the ids, kinds and
    docs of the two registries are the same (package name swapped)."""
    from sparkrdma_tpu.lint import all_rules as ref_all_rules

    covered = {p.values[0] for p in PARITY_CASES}
    ref_rules = ref_all_rules()
    assert covered == {r.id for r in ref_rules}
    port = {r.id: r for r in all_rules()}
    assert sorted(port) == [r.id for r in ref_rules]
    for r in ref_rules:
        assert port[r.id].kind == r.kind
        assert port[r.id].doc == r.doc.replace("tests/test_",
                                               "tests/test_torch_")


# ---------------------------------------------------------------------
# the port's idioms: clean fixtures and bad twins
# ---------------------------------------------------------------------

_P_CPP = f"{PKG}/native/staging.cpp"
_P_PY = f"{PKG}/hbm/host_staging.py"

_DICT_TABLE = """
    import ctypes

    _V, _S = ctypes.c_void_p, ctypes.c_size_t
    _LONG = ctypes.c_long
    _LONG_P = ctypes.POINTER(ctypes.c_long)
    #: every entry point: name -> (argtypes, restype)
    _SIGNATURES = {
        "sr_pool_create": ([], _V),
        "sr_write_file": ([ctypes.c_char_p, _V, _S], _LONG),
        "sr_pool_stats": ([_V, _LONG_P], None),
    }

    def _declare(lib):
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        return lib
"""


def test_idiom_abi_dict_table_clean(tmp_path):
    root = repo(tmp_path, {_P_CPP: _CPP_OK, _P_PY: _DICT_TABLE})
    assert run_rules(root, select=["abi-sync"]) == []


@pytest.mark.parametrize("old,new,expect", [
    # a wrong type in an entry
    ("[ctypes.c_char_p, _V, _S]", "[ctypes.c_char_p, _V, ctypes.c_int]",
     ["sr_write_file parameter 2 is size_t in C but argtypes[2] is c_int "
      "(expected c_size_t)"]),
    # an alias bound to the wrong width
    ("_LONG = ctypes.c_long", "_LONG = ctypes.c_int",
     ["sr_write_file returns long in C but restype is c_int (expected "
      "c_long)"]),
    # an entry one argument short
    ("[_V, _LONG_P]", "[_V]",
     ["sr_pool_stats takes 2 parameter(s) in C but argtypes lists 1"]),
    # an entry with no export
    ('"sr_pool_stats": ([_V, _LONG_P], None),',
     '"sr_pool_stats": ([_V, _LONG_P], None),\n'
     '        "sr_gone": ([], _V),',
     ["sr_gone is declared in host_staging.py but staging.cpp exports "
      "no such symbol"]),
    # an export with no entry
    ('        "sr_pool_create": ([], _V),\n', "",
     ["sr_pool_create is exported from staging.cpp but host_staging.py "
      "never declares"]),
    # a loop that never sets restype: a pointer return truncates
    ("            fn.restype = res\n", "",
     ["sr_pool_create returns void* in C but has no restype — ctypes "
      "defaults to c_int (a 64-bit pointer truncated to c_int)",
      "sr_write_file returns long in C but has no restype"]),
    # a table nothing applies
    ("        for name, (args, res) in _SIGNATURES.items():\n"
     "            fn = getattr(lib, name)\n"
     "            fn.argtypes = args\n"
     "            fn.restype = res\n", "",
     ["sr_pool_create takes 0 parameter(s) in C but has no argtypes",
      "sr_pool_stats takes 2 parameter(s) in C but has no argtypes"]),
])
def test_idiom_abi_dict_table_bad_twins(tmp_path, old, new, expect):
    assert old in _DICT_TABLE
    root = repo(tmp_path, {_P_CPP: _CPP_OK,
                           _P_PY: _DICT_TABLE.replace(old, new)})
    got = run_rules(root, select=["abi-sync"])
    assert rules_of(got) and set(rules_of(got)) == {"abi-sync"}
    for e in expect:
        assert e in msgs_of(got), msgs_of(got)


_KERNEL_CU = """
    // a kernel library: a struct passed by value, long long, void**
    struct Tab {
      void* base[4];
    };

    extern "C" {

    static int helper(int d) { return d; }

    int sr_k(const void* in, Tab t, long long n, void** out,
             void* stream) {
      return helper(0);
    }

    }  // extern "C"
"""

_KERNEL_PY = """
    import ctypes


    class Tab(ctypes.Structure):
        _fields_ = [("base", ctypes.c_void_p * 4)]


    _P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _PP = ctypes.POINTER(ctypes.c_void_p)
    SIGNATURES = {
        "k": {
            "sr_k": ([_P, Tab, _L, _PP, _P], _I),
        },
    }


    def library(cdll, name):
        for fn, (args, res) in SIGNATURES.get(name, {}).items():
            f = getattr(cdll, fn)
            f.argtypes = args
            f.restype = res
        return cdll
"""


def test_idiom_abi_kernel_table_clean(tmp_path):
    root = repo(tmp_path, {f"{PKG}/csrc/k.cu": _KERNEL_CU,
                           f"{PKG}/_build.py": _KERNEL_PY})
    assert run_rules(root, select=["abi-sync"]) == []


@pytest.mark.parametrize("rel,old,new,expect", [
    ("_build.py", "[_P, Tab, _L, _PP, _P]",
     "[_P, Tab, ctypes.c_long, _PP, _P]",
     "sr_k parameter 2 is long long in C but argtypes[2] is c_long "
     "(expected c_longlong)"),
    ("_build.py", "[_P, Tab, _L, _PP, _P]", "[_P, Tab, _L, _P, _PP]",
     "sr_k parameter 4 is void* in C but argtypes[4] is "
     "POINTER(c_void_p) (expected c_void_p)"),
    ("_build.py", "[_P, Tab, _L, _PP, _P]", "[_P, _P, _L, _PP, _P]",
     "sr_k parameter 1 is struct Tab passed by value in C but "
     "argtypes[1] is c_void_p (expected the ctypes.Structure Tab)"),
    ("_build.py", "ctypes.c_void_p * 4", "ctypes.c_void_p * 8",
     "ctypes.Structure Tab field 0 is ('base', c_void_p * 8) but struct "
     "Tab in k.cu has void* base[4]"),
    ("csrc/k.cu", "void* base[4];", "void* base[4];\n      int count;",
     "ctypes.Structure Tab has 1 field(s) but struct Tab in k.cu has 2"),
    ("_build.py", '"k": {', '"k2": {',
     "sr_k is exported from k.cu but _build.py never declares"),
    ("csrc/k.cu", "int sr_k(", "int sr_kk(",
     "sr_k is declared in _build.py but k.cu exports no such symbol"),
    ("_build.py", "            f.restype = res\n", "",
     "sr_k returns int in C but has no restype"),
])
def test_idiom_abi_kernel_table_bad_twins(tmp_path, rel, old, new, expect):
    files = {f"{PKG}/csrc/k.cu": _KERNEL_CU, f"{PKG}/_build.py": _KERNEL_PY}
    key = f"{PKG}/{rel}"
    assert old in files[key]
    files[key] = files[key].replace(old, new)
    got = run_rules(repo(tmp_path, files), select=["abi-sync"])
    assert rules_of(got) and set(rules_of(got)) == {"abi-sync"}
    assert expect in msgs_of(got), msgs_of(got)


_CONF_LOOP = """
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class ShuffleConf:
        alpha: int = 4
        gamma: int = 0
        delta: float = 0.0
        beta: str = "x"

        def __post_init__(self):
            if self.alpha <= 0:
                raise ValueError("alpha must be positive")
            for name in ("gamma", "delta"):
                if getattr(self, name) < 0:
                    raise ValueError(f"{name} must be >= 0")
"""

_CONF_LOOP_README = _CONF_README.replace(
    "| `beta` | tag |", "| `beta` | tag |\n    | `gamma` | g |\n"
                       "    | `delta` | d |")

_CONF_LOOP_USE = ("def f(conf):\n    return (conf.alpha + len(conf.beta)"
                  " + conf.gamma + conf.delta)\n")


def test_idiom_config_loop_clean(tmp_path):
    root = repo(tmp_path, {f"{PKG}/config.py": _CONF_LOOP,
                           "README.md": _CONF_LOOP_README,
                           f"{PKG}/use.py": _CONF_LOOP_USE})
    assert run_rules(root, select=["config-key-sync"]) == []


@pytest.mark.parametrize("old,new,unvalidated", [
    # a name missing from the validation tuple
    ('("gamma", "delta")', '("gamma",)', ["delta"]),
    # a loop that names the fields but never reads them by name
    ("getattr(self, name) < 0", "self.alpha < 0", ["delta", "gamma"]),
])
def test_idiom_config_loop_bad_twins(tmp_path, old, new, unvalidated):
    root = repo(tmp_path, {f"{PKG}/config.py": _CONF_LOOP.replace(old, new),
                           "README.md": _CONF_LOOP_README,
                           f"{PKG}/use.py": _CONF_LOOP_USE})
    got = run_rules(root, select=["config-key-sync"])
    assert sorted(re.findall(
        r"numeric ShuffleConf field '(\w+)' is never touched",
        msgs_of(got))) == unvalidated
    assert len(got) == len(unvalidated)


_FAMILY_NAMES = _NAMES.replace('{"w.*"}', '{"serde.*_bytes", '
                                           '"serde.columnar.*_bytes"}')

_FAMILY_EMIT = """
    def _count(family, op, nbytes, reg):
        reg.counter(f"{family}.{op}_bytes").inc(nbytes)

    def encode(reg, tl, n):
        reg.counter("pool.hits").inc()
        reg.gauge("g.x").set(1)
        reg.histogram("h.x").observe(2)
        tl.counter("t.x", 3)
        _count("serde", "encode", n, reg)

    def encode_cols(reg, n):
        _count("serde.columnar", "encode", n, reg)
"""


def test_idiom_counter_family_clean(tmp_path):
    root = repo(tmp_path, {f"{PKG}/obs/names.py": _FAMILY_NAMES,
                           f"{PKG}/api/serde.py": _FAMILY_EMIT})
    assert run_rules(root, select=["counter-name-sync"]) == []


def test_idiom_counter_family_bad_twins(tmp_path):
    # an undeclared family fires at its call site
    root = repo(tmp_path / "a", {
        f"{PKG}/obs/names.py": _FAMILY_NAMES,
        f"{PKG}/api/serde.py": _FAMILY_EMIT + """
    def encode_rogue(reg, n):
        _count("rogue", "encode", n, reg)
"""})
    got = run_rules(root, select=["counter-name-sync"])
    assert len(got) == 1
    assert ".counter('rogue.encode_bytes') emits a metric name not " \
        "declared" in got[0].message
    lines = (root / f"{PKG}/api/serde.py").read_text().splitlines()
    assert lines[got[0].line - 1].strip() == \
        '_count("rogue", "encode", n, reg)'
    # a declared family nothing calls with is a stale wildcard
    root = repo(tmp_path / "b", {
        f"{PKG}/obs/names.py": _FAMILY_NAMES,
        f"{PKG}/api/serde.py": _FAMILY_EMIT.replace(
            '_count("serde.columnar", "encode", n, reg)', "pass")})
    got = run_rules(root, select=["counter-name-sync"])
    assert len(got) == 1
    assert "wildcard 'serde.columnar.*_bytes' but no f-string emission" \
        in got[0].message
    # a caller that passes a variable: read as the reference reads it
    root = repo(tmp_path / "c", {
        f"{PKG}/obs/names.py": _FAMILY_NAMES,
        f"{PKG}/api/serde.py": _FAMILY_EMIT + """
    def encode_any(reg, fam, n):
        _count(fam, "encode", n, reg)
"""})
    got = run_rules(root, select=["counter-name-sync"])
    assert "matches wildcard shape '*.*_bytes' which is not declared" \
        in msgs_of(got)


_SITES_FAULTS = 'SITES = ("serde.encode", "serde.decode", "a.b")\n'

_SITES_CALLER = """
    from x import faults

    def _fire_codec(site):
        if faults.fire(site) == "fail":
            faults.fire(site)

    def encode():
        faults.fire("a.b")
        _fire_codec("serde.encode")

    def decode():
        _fire_codec("serde.decode")
"""


def test_idiom_fault_site_param_clean(tmp_path):
    root = repo(tmp_path, {f"{PKG}/faults.py": _SITES_FAULTS,
                           f"{PKG}/api/serde.py": _SITES_CALLER})
    assert run_rules(root, select=["fault-site-sync"]) == []


def test_idiom_fault_site_param_bad_twins(tmp_path):
    # a caller passing a site not in SITES, and the site it replaced
    # left unfired
    root = repo(tmp_path / "a", {
        f"{PKG}/faults.py": _SITES_FAULTS,
        f"{PKG}/api/serde.py": _SITES_CALLER.replace(
            '_fire_codec("serde.decode")', '_fire_codec("serde.bogus")')})
    got = run_rules(root, select=["fault-site-sync"])
    msgs = msgs_of(got)
    assert len(got) == 2
    assert "fires unregistered fault site 'serde.bogus'" in msgs
    assert "registers 'serde.decode' but no faults.fire" in msgs
    bogus = [f for f in got if "serde.bogus" in f.message][0]
    lines = (root / f"{PKG}/api/serde.py").read_text().splitlines()
    assert lines[bogus.line - 1].strip() == '_fire_codec("serde.bogus")'
    # a caller passing a variable resolves nothing: both codec sites
    # read as unfired
    root = repo(tmp_path / "b", {
        f"{PKG}/faults.py": _SITES_FAULTS,
        f"{PKG}/api/serde.py": _SITES_CALLER + """
    def other(s):
        _fire_codec(s)
"""})
    got = run_rules(root, select=["fault-site-sync"])
    assert sorted(re.findall(r"registers '([a-z.]+)'", msgs_of(got))) == \
        ["serde.decode", "serde.encode"]


# ---------------------------------------------------------------------
# ABI: copies of the real tables
# ---------------------------------------------------------------------

_ABI_REAL = ["_build.py", "csrc/bucket_scatter.cu", "csrc/merge_path.cu",
             "csrc/partition_counts.cu", "csrc/ring_exchange.cu",
             "hbm/host_staging.py", "native/staging.cpp"]


@pytest.fixture
def abi_copy(tmp_path):
    for rel in _ABI_REAL:
        dst = tmp_path / PKG / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / PKG / rel, dst)
    return tmp_path


def _mutate(root, rel, old, new):
    p = root / PKG / rel
    text = p.read_text()
    assert text.count(old) == 1, old
    p.write_text(text.replace(old, new))


def test_abi_real_tables_are_read_and_clean(abi_copy):
    from sparkrdma_tpu_torch.lint.core import LintContext
    from sparkrdma_tpu_torch.lint.rules_abi import abi_model

    assert run_rules(abi_copy, select=["abi-sync", "abi-gate"]) == []
    pairs = {p.c_rel: p for p in abi_model(LintContext(abi_copy)).pairs}
    # every export of both pairs is compared with its table entry
    assert sorted(pairs) == [f"{PKG}/csrc/bucket_scatter.cu",
                             f"{PKG}/csrc/merge_path.cu",
                             f"{PKG}/csrc/partition_counts.cu",
                             f"{PKG}/csrc/ring_exchange.cu",
                             f"{PKG}/native/staging.cpp"]
    assert sorted(pairs[f"{PKG}/csrc/merge_path.cu"].cfuncs) == \
        ["sr_merge_splits", "sr_merge_stage"]
    counts = pairs[f"{PKG}/csrc/partition_counts.cu"]
    assert sorted(counts.cfuncs) == sorted(counts.decls) == [
        "sr_partition_counts"]
    assert len(counts.cfuncs["sr_partition_counts"].params) == 15
    scatter = pairs[f"{PKG}/csrc/bucket_scatter.cu"]
    assert sorted(scatter.cfuncs) == sorted(scatter.decls) == [
        "sr_bucket_scatter"]
    assert len(scatter.cfuncs["sr_bucket_scatter"].params) == 21
    ring = pairs[f"{PKG}/csrc/ring_exchange.cu"]
    assert sorted(ring.cfuncs) == sorted(ring.decls) == [
        "sr_ipc_close", "sr_ipc_export", "sr_ipc_open", "sr_ring_push",
        "sr_window_alloc", "sr_window_free"]
    assert len(ring.cfuncs["sr_ring_push"].params) == 13
    assert ring.cfuncs["sr_ring_push"].params[1] == ("PeerTable", 0)
    staging = pairs[f"{PKG}/native/staging.cpp"]
    assert len(staging.cfuncs) == len(staging.decls) == 21
    assert all(not d.unparsed and d.argtypes is not None
               for p in pairs.values() for d in p.decls.values())


@pytest.mark.parametrize("rel,old,new,expect", [
    # sr_merge_splits' n declared int instead of long long
    ("_build.py",
     '"sr_merge_splits": ([_P, _P, _I, _L, _L, _L, _I, _P], _I)',
     '"sr_merge_splits": ([_P, _P, _I, _I, _L, _L, _I, _P], _I)',
     "sr_merge_splits parameter 3 is long long in C but argtypes[3] is "
     "c_int (expected c_longlong)"),
    # sr_bucket_scatter's records a partition declared int
    ("_build.py",
     '"sr_bucket_scatter": ([_P, _L, _L, _L,',
     '"sr_bucket_scatter": ([_P, _L, _L, _I,',
     "sr_bucket_scatter parameter 3 is long long in C but argtypes[3] "
     "is c_int (expected c_longlong)"),
    # sr_partition_counts' row stride declared int instead of long long
    ("_build.py",
     '"sr_partition_counts": ([_P, _L, _L, _L,',
     '"sr_partition_counts": ([_P, _I, _L, _L,',
     "sr_partition_counts parameter 1 is long long in C but argtypes[1] "
     "is c_int (expected c_longlong)"),
    # sr_ipc_close dropped from the table
    ("_build.py", '        "sr_ipc_close": ([_I, _P], _I),\n', "",
     "sr_ipc_close is exported from ring_exchange.cu but _build.py never "
     "declares its restype/argtypes"),
    # a field added to PeerTable
    ("_build.py", '_fields_ = [("base", ctypes.c_void_p * 8)]',
     '_fields_ = [("base", ctypes.c_void_p * 8), ("n", ctypes.c_int)]',
     "ctypes.Structure PeerTable has 2 field(s) but struct PeerTable in "
     "ring_exchange.cu has 1"),
    # the staging table: a size_t argument declared c_int64
    ("hbm/host_staging.py", '"sr_pool_get": ([_V, _S], _V),',
     '"sr_pool_get": ([_V, _I64], _V),',
     "sr_pool_get parameter 1 is size_t in C but argtypes[1] is c_int64 "
     "(expected c_size_t)"),
    # the staging table: a pointer return declared c_int
    ("hbm/host_staging.py", '"sr_alloc": ([_S], _V),',
     '"sr_alloc": ([_S], _INT),',
     "sr_alloc returns void* in C but restype is c_int (expected "
     "c_void_p)"),
])
def test_abi_real_table_mutations_fire(abi_copy, rel, old, new, expect):
    _mutate(abi_copy, rel, old, new)
    got = run_rules(abi_copy, select=["abi-sync"])
    assert len(got) == 1, msgs_of(got)
    assert got[0].rule == "abi-sync" and expect in got[0].message


# ---------------------------------------------------------------------
# engine: crash reporting, unknown rules, rendering
# ---------------------------------------------------------------------

def test_crashed_rule_reports_itself(tmp_path):
    @lint_core.rule("tmp-crash-rule", "always crashes (test only)")
    def _crash(ctx):
        raise RuntimeError("boom from test rule")
    try:
        got = run_rules(tmp_path, select=["tmp-crash-rule"])
        assert rules_of(got) == ["tmp-crash-rule"]
        assert "boom from test rule" in got[0].message
        assert got[0].path == "<srlint>"
    finally:
        lint_core._REGISTRY.pop("tmp-crash-rule")


def test_duplicate_rule_id_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        lint_core.rule("assert-safety", "imposter")(lambda ctx: [])


def test_unknown_rule_select_raises(tmp_path):
    with pytest.raises(KeyError, match="unknown srlint rule"):
        run_rules(tmp_path, select=["no-such-rule"])


def test_finding_render_shape():
    f = Finding("r-id", "pkg/mod.py", 7, "msg")
    assert f.render() == "pkg/mod.py:7: [r-id] msg"
    assert Finding("r-id", "pkg", 0, "msg").render() == "pkg: [r-id] msg"


def test_surface_is_the_port():
    """Package rules read sparkrdma_tpu_torch/ only, test rules read
    tests/test_torch_*.py only."""
    ctx = lint_core.LintContext(REPO)
    pkg = {sf.rel.split("/")[0] for sf in ctx.package_files()}
    assert pkg == {PKG}
    assert f"{PKG}/lint/rules_abi.py" in {sf.rel for sf in
                                          ctx.package_files()}
    tests = [sf.path.name for sf in ctx.test_files()]
    assert "test_torch_lint.py" in tests
    assert all(n.startswith("test_torch_") for n in tests)


# ---------------------------------------------------------------------
# CLI + the real repo
# ---------------------------------------------------------------------

CLI = [sys.executable, str(REPO / "scripts" / "torch_srlint.py")]


@pytest.mark.slow
def test_cli_select_json_and_exit_codes(tmp_path):
    root = repo(tmp_path, {f"{PKG}/a.py": "assert True\n"})
    res = subprocess.run(
        CLI + ["--root", str(root), "--select", "assert-safety", "--json"],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    payload = json.loads(res.stdout)
    assert payload["rules"] == ["assert-safety"]
    assert [f["rule"] for f in payload["findings"]] == ["assert-safety"]
    assert payload["findings"][0]["path"] == f"{PKG}/a.py"
    from sparkrdma_tpu_torch.lint import get_rule
    assert all(f["kind"] == get_rule(f["rule"]).kind
               for f in payload["findings"])
    res = subprocess.run(CLI + ["--select", "no-such-rule"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and "unknown rule" in res.stderr
    res = subprocess.run(CLI + ["--list-rules"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0
    from sparkrdma_tpu.lint import all_rules as ref_all_rules
    assert [ln.split()[0] for ln in res.stdout.strip().splitlines()] == \
        [r.id for r in ref_all_rules()]


@pytest.mark.slow
def test_cli_changed_mode(tmp_path):
    root = repo(tmp_path, {
        f"{PKG}/a.py": "assert True\n",
        f"{PKG}/b.py": "X = 1\n",
    })
    git = ["git", "-C", str(root), "-c", "user.email=t@t",
           "-c", "user.name=t"]
    subprocess.run(git + ["init", "-q"], check=True, timeout=60)
    subprocess.run(git + ["add", "-A"], check=True, timeout=60)
    subprocess.run(git + ["commit", "-qm", "seed"], check=True,
                   timeout=60)
    cli = CLI + ["--root", str(root), "--select", "assert-safety"]
    # a clean tree short-circuits to success
    res = subprocess.run(cli + ["--changed"], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "no changed files" in res.stdout
    # touching only the clean file filters the a.py finding out
    (root / f"{PKG}/b.py").write_text("X = 2\n")
    res = subprocess.run(cli + ["--changed"], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    # touching the flagged file surfaces its finding again
    (root / f"{PKG}/a.py").write_text("assert True  # still\n")
    res = subprocess.run(cli + ["--changed"], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 1
    assert f"{PKG}/a.py" in res.stdout
    # a git range works the same way
    res = subprocess.run(cli + ["--changed", "HEAD"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    # exit 2 when the range is garbage, matching usage-error convention
    res = subprocess.run(cli + ["--changed", "no..such..range"],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2


@pytest.mark.slow
def test_cli_dot_export(tmp_path):
    root = repo(tmp_path, {f"{PKG}/d.py": _DEADLOCK})
    res = subprocess.run(
        CLI + ["--root", str(root), "--select", "lock-order", "--dot"],
        capture_output=True, text=True, timeout=120)
    # the cycle fixture still exits 1 (findings go to stderr), but the
    # DOT graph on stdout must stay parseable
    assert res.returncode == 1
    assert "potential deadlock" in res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0] == "digraph lock_order {" and lines[-1] == "}"
    nodes = {ln.strip() for ln in lines if "[kind=" in ln}
    assert {'"A._a" [kind="Lock"];', '"A._b" [kind="Lock"];'} <= nodes
    assert any('"A._a" -> "A._b"' in ln and "label=" in ln
               for ln in lines)
    assert any('"A._b" -> "A._a"' in ln for ln in lines)


@pytest.mark.slow
def test_cli_runs_where_torch_is_missing(tmp_path):
    """The CLI loads the lint package without the port's ``__init__``:
    with ``import torch`` made to fail, the package rules still run."""
    shadow = tmp_path / "shadow"
    shadow.mkdir()
    (shadow / "torch.py").write_text(
        'raise ImportError("torch is missing here")\n')
    root = repo(tmp_path / "r", {f"{PKG}/a.py": "assert True\n"})
    res = subprocess.run(
        CLI + ["--root", str(root), "--select", "assert-safety"],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(shadow)})
    assert res.returncode == 1, res.stderr
    assert f"{PKG}/a.py:1: [assert-safety]" in res.stdout


def test_real_repo_is_srlint_clean():
    """The meta-test: the port must stay clean under its own linter —
    every rule, zero findings (modulo in-source suppressions, each with
    its reason). No wall-clock bound: the time is printed."""
    assert len(all_rules()) == 23, \
        "rule count drifted — update this pin and the README's port " \
        "section together"
    t0 = time.perf_counter()
    findings = run_rules(REPO)
    wall = time.perf_counter() - t0
    print(f"port srlint: 23 rules over {REPO} in {wall:.2f} s")
    assert findings == [], "\n".join(f.render() for f in findings)
