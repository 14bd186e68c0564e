"""No file of the benchmark imports JAX or the JAX package, compared by
whole top-level module names, and the plain reference imports nothing of
the program."""

from __future__ import annotations

import ast
import sys

from bench_helpers import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "joshupscale_tpu"}


def imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = set(imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = set(imports(path))
        assert "joshupscale_torch" not in tops, path
        assert tops <= {"__future__", "typing", "torch"}, (path, tops)


def test_run_names_what_it_finds(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "joshupscale_torch_extra", object())
    found = run.forbidden_modules()
    assert "jaxlib.xla_client" in found
    # the port's name begins with the JAX package's: compared whole
    assert "joshupscale_torch_extra" not in found
    assert not any(m.startswith("joshupscale_torch")
                   for m in run.forbidden_modules())
