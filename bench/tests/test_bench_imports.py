"""No file of the benchmark imports JAX or the JAX reference package
(top-level names compared whole: `repro_torch` is the port, `repro` the
reference), and the plain references import nothing of the port."""
import ast

from bench.harness import core

BARRED = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_reference_package():
    files = sorted(core.BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not imported(path) & BARRED, path


def test_the_references_import_nothing_of_the_port():
    for path in (core.BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in imported(path), path


def test_names_are_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torchlike", types.ModuleType("x"))
    assert core.barred_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert core.barred_modules() == ["repro"]
