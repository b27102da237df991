"""Nothing the benchmark runs imports JAX or the JAX package ``repro``, with
top-level names compared whole (the port, ``repro_torch``, begins with
``repro``), or reads the JAX package's benchmark; the reference imports
nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PLAIN = {"__future__", "collections", "dataclasses", "math", "typing", "torch", "numpy"}


def _modules(where: Path) -> list[Path]:
    return sorted(p for p in where.rglob("*.py")
                  if not p.name.startswith("test_") and p.name != "conftest.py")  # fmt: skip


def _imports(path: Path) -> set[str]:
    """Top-level names of every absolute import; a relative one as ``.``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _modules(BENCH), ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_module_run_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN
    text = path.read_text()
    assert "BENCH_wirepath" not in text and "benchmarks/" not in text


@pytest.mark.parametrize("path", _modules(BENCH / "reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= PLAIN | {"."}


def test_the_run_names_the_jax_package_whole():
    from perfbench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.core", "torch", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.core"]) == ["repro"]
    assert run.forbidden_modules(["jax._src", "flax", "jaxlib"]) == ["flax", "jax", "jaxlib"]
