"""What the benchmark may load: no module under ``bench/`` imports JAX,
the JAX package (``repro``) or the smoke run (``chip_smoke``), each
compared by its whole top-level name (``repro_torch`` is not ``repro``);
and no reference imports the program (``repro_torch``) or the harness."""
import ast
import importlib.util
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "chip_smoke"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_nor_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_references_import_nothing_of_the_program():
    refs = sorted((BENCH / "reference").glob("*.py"))
    assert len(refs) >= 3
    for path in refs:
        assert not set(_imports(path)) & {"repro_torch", "benchkit",
                                          *FORBIDDEN}, path


def test_whole_names_are_compared(monkeypatch):
    spec = importlib.util.spec_from_file_location("bench_run_imports",
                                                  BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fake = {"repro_torch": None, "repro_torch.models.lm": None,
            "jaxtyping": None, "numpy": None}
    monkeypatch.setattr(mod.sys, "modules", fake)
    assert mod.forbidden_modules() == []
    fake.update({"repro.core.controller": None, "jax.numpy": None})
    assert mod.forbidden_modules() == ["jax", "repro"]
