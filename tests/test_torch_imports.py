"""The port stands alone: no module of ``sparkrdma_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package, not
even its JAX-free modules. An AST scan, so conditional and function-
local imports count too."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "sparkrdma_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "sparkrdma_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_sources_found():
    assert len(SOURCES) > 10 and all(p.is_file() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_imports(path):
    bad = [f"{path.name}:{line} imports {name}"
           for line, name in _imports(path) if _forbidden(name)]
    assert not bad, bad


def test_scanner_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from sparkrdma_tpu.config import x\n"
                     "import jax.numpy as jnp\nimport sparkrdma_tpu_torch\n")
    assert sorted(n for _, n in _imports(probe) if _forbidden(n)) == \
        ["jax.numpy", "sparkrdma_tpu.config"]
