#!/usr/bin/env python3
"""srlint for the port — run the static-analysis rules over
``sparkrdma_tpu_torch/`` and its tests.

Usage:
    python scripts/torch_srlint.py                 # all rules, human output
    python scripts/torch_srlint.py --list-rules    # one rule per line
    python scripts/torch_srlint.py --select a,b    # only the named rules
    python scripts/torch_srlint.py --json          # machine-readable findings
    python scripts/torch_srlint.py --select lock-order --dot   # DOT graph
    python scripts/torch_srlint.py --changed       # working-tree files only
    python scripts/torch_srlint.py --changed main..HEAD        # a git range
    python scripts/torch_srlint.py --root DIR      # another checkout

The flags, output and exit codes are ``scripts/srlint.py``'s: exit 0
when no finding survives suppression, 1 otherwise, 2 for usage errors
(an unknown rule id, a ``--changed`` range git refuses). Human output is
one ``path:line: [rule-id] message`` block per finding; ``--json``
emits ``{"root": ..., "rules": [...], "findings": [...]}`` (each finding
carries its rule's ``kind``). ``--changed`` runs every rule (they are
whole-repo analyses) and reports only the findings in the changed files.

The rules live in ``sparkrdma_tpu_torch/lint/``, stdlib only. This
script loads that package by its path, without the port's
``__init__`` (which imports torch), so it runs where torch or the card
is missing; only ``tests-importable``, which imports the port's test
modules, needs what they import.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
LINT_DIR = REPO / "sparkrdma_tpu_torch" / "lint"
#: the name the lint package is loaded under here (not the package's
#: own, so importing it never runs ``sparkrdma_tpu_torch/__init__.py``)
_MODULE = "_torch_srlint"


def load_lint():
    """The port's lint package, loaded from ``LINT_DIR``."""
    if _MODULE in sys.modules:
        return sys.modules[_MODULE]
    spec = importlib.util.spec_from_file_location(
        _MODULE, LINT_DIR / "__init__.py",
        submodule_search_locations=[str(LINT_DIR)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_MODULE] = mod
    spec.loader.exec_module(mod)
    return mod


def _changed_files(root: str, rev_range: str) -> set:
    """Repo-relative paths touched in the working tree (no range) or in
    ``git diff <range>``; raises CalledProcessError outside a repo."""
    if rev_range:
        out = subprocess.run(
            ["git", "diff", "--name-only", rev_range], cwd=root,
            capture_output=True, text=True, check=True).stdout
        return {line.strip() for line in out.splitlines() if line.strip()}
    out = subprocess.run(
        ["git", "status", "--porcelain"], cwd=root,
        capture_output=True, text=True, check=True).stdout
    paths = set()
    for line in out.splitlines():
        if len(line) < 4:
            continue
        path = line[3:]
        if " -> " in path:          # rename: lint the new name
            path = path.split(" -> ", 1)[1]
        paths.add(path.strip().strip('"'))
    return paths


def main(argv=None) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    lint = load_lint()

    ap = argparse.ArgumentParser(
        prog="torch_srlint",
        description="static-analysis rules for sparkrdma_tpu_torch")
    ap.add_argument("--list-rules", action="store_true",
                    help="list registered rules and exit")
    ap.add_argument("--select", metavar="RULES",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--root", default=str(REPO),
                    help="repo root to lint (default: this repo)")
    ap.add_argument("--dot", action="store_true",
                    help="print the lock acquisition graph as Graphviz "
                         "DOT on stdout (findings go to stderr)")
    ap.add_argument("--changed", nargs="?", const="", default=None,
                    metavar="RANGE",
                    help="report only findings in files touched in the "
                         "working tree (no value) or in the given git "
                         "diff range; exits 0 early when none changed")
    args = ap.parse_args(argv)

    rules = lint.all_rules()
    if args.list_rules:
        if args.as_json:
            print(json.dumps({"rules": [
                {"id": r.id, "doc": r.doc, "kind": r.kind}
                for r in rules]}, indent=2))
        else:
            width = max(len(r.id) for r in rules)
            for r in rules:
                print(f"{r.id:<{width}}  {r.doc}")
        return 0

    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
        known = {r.id for r in rules}
        unknown = [s for s in select if s not in known]
        if unknown:
            print(f"torch_srlint: unknown rule(s): {', '.join(unknown)} "
                  f"(try --list-rules)", file=sys.stderr)
            return 2

    changed = None
    if args.changed is not None:
        try:
            changed = _changed_files(args.root, args.changed)
        except (subprocess.CalledProcessError, OSError) as exc:
            print(f"torch_srlint: --changed failed: {exc}",
                  file=sys.stderr)
            return 2
        if not changed:
            print("torch_srlint: no changed files, nothing to lint")
            return 0

    findings = lint.run_rules(args.root, select=select)
    if changed is not None:
        # rule crashes ("<srlint>") always survive the filter — a broken
        # lint must fail loudly no matter which files changed
        findings = [f for f in findings
                    if f.path in changed or f.path == "<srlint>"]
    if args.dot:
        print(lint.rules_concurrency.render_lock_dot(args.root))
        for f in findings:
            print(f.render(), file=sys.stderr)
        return 1 if findings else 0
    if args.as_json:
        print(json.dumps({
            "root": str(args.root),
            "rules": sorted({r.id for r in rules}
                            if select is None else select),
            "findings": [{"rule": f.rule,
                          "kind": lint.get_rule(f.rule).kind,
                          "path": f.path, "line": f.line,
                          "message": f.message} for f in findings],
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        ran = len(rules) if select is None else len(select)
        status = "clean" if not findings else f"{len(findings)} finding(s)"
        print(f"torch_srlint: {ran} rule(s), {status}",
              file=sys.stderr if findings else sys.stdout)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
