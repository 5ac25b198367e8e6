"""Test-hygiene rules over the port's ``tests/test_torch_*.py``.

These keep the tier-1 suite honest: an unimportable test module would
otherwise shrink the dot count silently under
``--continue-on-collection-errors``, and a subprocess-launching module
without a ``slow`` marker would run under ``-m 'not slow'``.
"""

from __future__ import annotations

import importlib.util
import sys
import traceback
from typing import List

from .core import Finding, LintContext, rule


def _import_error(path) -> str:
    """Exec one test module in-process; return a traceback string or ''."""
    name = f"_srlint_import_{path.stem}"
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        # conftest defines fixtures, not imports, so plain module exec
        # reproduces pytest's collection-time import faithfully
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return ""
    except BaseException:
        return traceback.format_exc(limit=3)
    finally:
        sys.modules.pop(name, None)


@rule("tests-importable",
      "every tests/test_torch_*.py imports cleanly under JAX_PLATFORMS=cpu",
      kind="import")
def check_tests_importable(ctx: LintContext) -> List[Finding]:
    tests_dir = ctx.root / "tests"
    if not tests_dir.is_dir():
        return []
    modules = ctx.test_files()
    if not modules:
        return [Finding("tests-importable", "tests", 0,
                        "no test modules found", obj="tests")]
    findings = []
    sys.path.insert(0, str(ctx.root))
    try:
        for sf in modules:
            err = _import_error(sf.path)
            if err:
                findings.append(Finding(
                    "tests-importable", sf.rel, 0, err,
                    obj=sf.path.name))
    finally:
        try:
            sys.path.remove(str(ctx.root))
        except ValueError:
            pass
    return findings


@rule("tests-slow-marker",
      "subprocess-launching test modules carry pytest.mark.slow",
      kind="slow-marker")
def check_tests_slow_marker(ctx: LintContext) -> List[Finding]:
    findings = []
    for sf in ctx.test_files():
        launches = ("mp_worker" in sf.text
                    or "subprocess.Popen" in sf.text
                    or "subprocess.run" in sf.text)
        if launches and "pytest.mark.slow" not in sf.text:
            findings.append(Finding(
                "tests-slow-marker", sf.rel, 0,
                f"{sf.path.name} launches subprocesses but has no "
                "pytest.mark.slow marker — it would run under "
                "-m 'not slow'",
                obj=sf.path.name))
    return findings
