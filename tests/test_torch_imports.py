"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX, the JAX package (``repro``) or its
benchmarks (``benchmarks``).  Checked on
the source with ``ast``, so an import inside a function counts too."""
import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_the_port_has_files():
    assert len(FILES) > 10 and all(p.exists() for p in FILES)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(REPO)) for p in FILES])
def test_no_jax_or_repro_imports(path):
    bad = [f"{path.relative_to(REPO)}:{line}: {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, "the port imports the JAX side:\n" + "\n".join(bad)


@pytest.mark.parametrize("module,bad", [
    ("jax", True), ("jax.numpy", True), ("repro.models", True),
    ("repro", True), ("repro_torch.models", False), ("torch", False),
    ("reprox", False), ("benchmarks.serve_bench", True),
    ("repro_torch.bench", False),
])
def test_guard_classifies(module, bad):
    assert _forbidden(module) is bad


def test_guard_sees_every_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax.numpy as jnp\n"
                   "from repro.models import Model\n"
                   "def f():\n    import repro\n"
                   "    importlib.import_module('jax')\n")
    mods = [m for _, m in _imports(src)]
    assert [m for m in mods if _forbidden(m)] == [
        "jax.numpy", "repro.models", "repro", "jax"]
