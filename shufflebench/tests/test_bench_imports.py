"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import subprocess
import sys

from shufflebench import registry, run

HERE = registry.HERE


def test_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import shufflebench.run, shufflebench.reference, "
            "shufflebench.cell, shufflebench.control, shufflebench.trace;"
            "import sparkrdma_tpu_torch.api.shuffle_manager;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(registry.ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    tops = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert "sparkrdma_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN), tops & set(run.FORBIDDEN)


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["sparkrdma_tpu_torch.api", "torch"]) == []
    assert run.forbidden_modules(["sparkrdma_tpu.api", "jax.numpy",
                                  "jaxlib"]) == ["jax", "jaxlib",
                                                 "sparkrdma_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    """``reference.py`` and the checks import only the standard library,
    torch and the reference itself."""
    files = [HERE / "reference.py"] + sorted((HERE / "checks").glob("*.py"))
    for path in files:
        names = list(_imports(path))
        assert names, f"no imports read in {path.name}"
        for n in names:
            top = n.split(".")[0]
            assert top not in {"sparkrdma_tpu_torch", "sparkrdma_tpu",
                               "jax", "numpy"} and (
                top != "shufflebench" or n == "shufflebench.reference"), \
                (path.name, n)
