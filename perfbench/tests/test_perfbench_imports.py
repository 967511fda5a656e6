"""Nothing under perfbench imports the JAX package, and the plain
references import nothing of the port: compared by top-level name whole."""

import ast
from pathlib import Path

from perfbench import harness

ROOT = Path(__file__).resolve().parents[1]


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def imported_tops(path: Path) -> set[str]:
    return {n.split(".", 1)[0] for n in imported(path)}


def test_no_module_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        assert not imported_tops(path) & set(harness.FORBIDDEN), path


def test_references_import_nothing_of_the_port():
    for path in (ROOT / "reference").rglob("*.py"):
        names = imported(path)
        assert "kubernetes_rescheduling_tpu_torch" not in imported_tops(path), path
        outside = {n for n in names if not n.startswith("perfbench.reference")}
        assert {n.split(".", 1)[0] for n in outside} <= {"__future__", "dataclasses", "numpy",
                                                         "torch"}, (path, names)


def test_forbidden_modules_compares_whole_top_level_names():
    loaded = ["kubernetes_rescheduling_tpu_torch", "kubernetes_rescheduling_tpu_torch.ops",
              "jaxtyping", "flaxen", "kubernetes_rescheduling_tpu.core", "jax.numpy", "numpy"]
    assert harness.forbidden_modules(loaded) == ["jax.numpy", "kubernetes_rescheduling_tpu.core"]
