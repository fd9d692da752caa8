"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under ``perfbench/`` (top-level module names compared whole, since
the port's name begins with the JAX package's), and nothing of the port in
the reference or the frozen input generators."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "p_div_gnn_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py"))
                         + sorted((BENCH / "inputs").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_and_inputs_import_no_program(path):
    names = top_level_imports(path)
    assert "p_div_gnn_tpu_torch" not in names
    assert not {n for n in names if n == "perfbench"} or all(
        "harness" not in line for line in path.read_text().splitlines()
        if line.startswith(("from perfbench", "import perfbench")))


def test_top_level_names_compare_whole():
    assert "p_div_gnn_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "p_div_gnn_tpu.models".split(".")[0] in FORBIDDEN
