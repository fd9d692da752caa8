"""The port stands alone: no file of p_div_gnn_tpu_torch/, nor
chip_smoke.py, nor the card-side test file, imports JAX, flax, msgpack,
yaml, pandas or anything of the JAX package (the machine with the card has
none of them). Module names are matched whole, so the port's own name,
which begins with the JAX package's, is allowed. The kernel sources
(csrc/*.cu) and the headers they share (csrc/*.cuh) include no PyTorch
header, and the sources export the plain C interface that
ops/cuda_build.py loads with ctypes; so does the native graph library's
source (csrc/graphcore.cpp), which graphs/native.py loads. ``torch.distributed``
and matplotlib are imported lazily, inside functions, so the package imports
without them (the card's machine has no matplotlib)."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "pandas", "p_div_gnn_tpu"}
FILES = sorted((ROOT / "p_div_gnn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_port_cuda.py"]
SOURCES = sorted((ROOT / "p_div_gnn_tpu_torch" / "csrc").glob("*.cu"))
HEADERS = sorted((ROOT / "p_div_gnn_tpu_torch" / "csrc").glob("*.cuh"))


def imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_forbidden_matches_whole_module_names():
    assert forbidden("p_div_gnn_tpu") and forbidden("p_div_gnn_tpu.graphs.batching")
    assert forbidden("jax.numpy") and forbidden("yaml")
    assert not forbidden("p_div_gnn_tpu_torch.ops.fused_edge3")
    assert not forbidden("jaxtyping") and not forbidden("torch")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_side_module(path):
    bad = sorted(m for m in imported_modules(path) if forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_sources_are_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "p_div_gnn_tpu_torch/ops/fused_edge3.py",
            "p_div_gnn_tpu_torch/ops/scatter_csr.py", "p_div_gnn_tpu_torch/losses.py",
            "p_div_gnn_tpu_torch/train/loop.py", "p_div_gnn_tpu_torch/models/epd.py",
            "p_div_gnn_tpu_torch/ops/fused_edge.py", "p_div_gnn_tpu_torch/ops/scatter.py",
            "p_div_gnn_tpu_torch/ops/gather.py", "tests/test_torch_port_cuda.py",
            "p_div_gnn_tpu_torch/utils/configio.py", "p_div_gnn_tpu_torch/graphs/dataset.py",
            "p_div_gnn_tpu_torch/train/data.py", "p_div_gnn_tpu_torch/train/logging.py",
            "p_div_gnn_tpu_torch/train/runner.py", "p_div_gnn_tpu_torch/cli.py",
            "p_div_gnn_tpu_torch/models/summary.py",
            "p_div_gnn_tpu_torch/parallel/collectives.py", "p_div_gnn_tpu_torch/parallel/dp.py",
            "p_div_gnn_tpu_torch/parallel/partition.py",
            "p_div_gnn_tpu_torch/parallel/multihost.py",
            "p_div_gnn_tpu_torch/parallel/scaling.py",
            "p_div_gnn_tpu_torch/parallel/launch.py",
            "p_div_gnn_tpu_torch/datagen/fem.py", "p_div_gnn_tpu_torch/datagen/hyperelastic.py",
            "p_div_gnn_tpu_torch/datagen/generate.py", "p_div_gnn_tpu_torch/datagen/mesher.py",
            "p_div_gnn_tpu_torch/graphs/native.py", "p_div_gnn_tpu_torch/analysis/compare.py",
            "p_div_gnn_tpu_torch/analysis/plots.py", "p_div_gnn_tpu_torch/analysis/benchmark.py",
            "p_div_gnn_tpu_torch/models/torch_import.py",
            "p_div_gnn_tpu_torch/utils/precision.py",
            "p_div_gnn_tpu_torch/utils/profiling.py"} <= names
    assert {p.name for p in SOURCES} >= {
        "fused_edge3_fwd.cu", "fused_edge3_bwd.cu", "segment_sum_csr.cu",
        "fused_edge_fwd.cu", "fused_edge_bwd.cu"}


def module_level_imports(path: Path) -> set[str]:
    """The modules a file imports when it is imported (not inside a
    function)."""
    names = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", [p for p in FILES if p.name != "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_torch_distributed_lazily(path):
    """``torch.distributed`` is imported inside the functions that use it,
    so the package imports where it is unavailable."""
    assert not [m for m in module_level_imports(path) if m.startswith("torch.distributed")]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_matplotlib_lazily(path):
    """matplotlib is imported inside the functions that draw, as in the JAX
    package: the card's machine has none."""
    assert not [m for m in module_level_imports(path) if m.split(".")[0] == "matplotlib"]


def test_graph_library_source_includes_no_pytorch_header():
    text = (ROOT / "p_div_gnn_tpu_torch" / "csrc" / "graphcore.cpp").read_text()
    assert not pytorch_includes(text)
    assert 'extern "C"' in text and "pdg_faces_to_edges" in text


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_kernel_sources_include_no_pytorch_header(path):
    text = path.read_text()
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]", text, flags=re.M)
    assert includes and not [h for h in includes if h.split("/")[0] in (
        "torch", "ATen", "c10", "pybind11")], includes
    assert 'extern "C"' in text and "pdg_cuda_error_string" in text


def pytorch_includes(text: str) -> list[str]:
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)[>\"]", text, flags=re.M)
    return [h for h in includes if h.split("/")[0] in ("torch", "ATen", "c10", "pybind11")]


@pytest.mark.parametrize("path", HEADERS, ids=lambda p: p.name)
def test_kernel_headers_include_no_pytorch_header(path):
    assert not pytorch_includes(path.read_text())
