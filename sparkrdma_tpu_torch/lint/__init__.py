"""srlint for the port — the reference's static-analysis rules, reading
``sparkrdma_tpu_torch/``.

The same engine, registry, suppression comments and 23 rules as
``sparkrdma_tpu.lint``, with the same ids, docs, kinds and messages.
The enforcement surface is the port's own: every
``sparkrdma_tpu_torch/**/*.py`` and every ``tests/test_torch_*.py``.
The CLIs under ``scripts/`` that the sync rules read
(``shuffle_report.py``, ``shuffle_top.py``, ``shuffle_trace.py``) are
the reference's own readers, which read the port's journals too, so the
rules hold the port's schemas against them.

Where the port writes a sound construct in another form than the
reference, the port's rule reads that form as well, and fires on it as
strictly:

- ``abi-sync`` reads ctypes tables written as a dict of
  ``"sr_x": (argtypes, restype)`` applied in a loop
  (``hbm/host_staging.py``'s ``_SIGNATURES``, ``_build.py``'s
  ``SIGNATURES`` of one dict per ``csrc/<name>.cu``), compares
  ``long long``, ``void**`` and ``ctypes.Structure`` arguments passed
  by value, and holds both pairs (the host staging library and the
  CUDA kernels) against their ``extern "C"`` blocks;
- ``config-key-sync`` counts the names of a ``for name in (...):``
  loop over ``getattr(self, name)`` in ``__post_init__`` as validated;
- ``counter-name-sync`` and ``fault-site-sync`` resolve an f-string
  hole or a ``faults.fire(site)`` argument that is a parameter of the
  enclosing function to the literals every caller passes.

Entry points:

- ``python scripts/torch_srlint.py`` — the CLI (the reference's flags:
  ``--root``, ``--list-rules``, ``--select``, ``--json``, ``--dot``,
  ``--changed``); it loads this package without the port's
  ``__init__``, so it runs where torch is missing;
- :func:`sparkrdma_tpu_torch.lint.run_rules` — run programmatically
  against any repo root (``tests/test_torch_lint.py`` points it at
  synthetic mini-repos, and pins the real tree clean).

Suppression: append ``# srlint: ignore[rule-id]`` (comma-separate for
several rules) to the flagged line, or put it on a comment line directly
above, and leave the reason next to it.

The package is stdlib only and imports its own modules relatively: it
parses the port's sources and never imports them.
"""

from .core import (Finding, LintContext, Rule, all_rules, get_rule, rule,
                   run_rules)

# importing the rule modules registers their rules
from . import rules_tests    # noqa: F401  (registration)
from . import rules_sync     # noqa: F401
from . import rules_timeline  # noqa: F401
from . import rules_safety   # noqa: F401
from . import rules_concurrency  # noqa: F401
from . import rules_resources  # noqa: F401
from . import rules_abi      # noqa: F401

__all__ = ["Finding", "LintContext", "Rule", "all_rules", "get_rule",
           "rule", "run_rules"]
