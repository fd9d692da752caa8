"""The port's analysis tools against the JAX package's
(``p_div_gnn_tpu/analysis/{compare,plots,benchmark}.py``):

- ``compare``: on a dataset written by the port's generator and inference
  folders written by the port's ``run_inference`` (two committed
  checkpoints, on the CPU), the port's ``main`` and the JAX ``main`` give
  per-sample metrics equal to rtol 1e-12 and the same top-k indices; with
  ``figures_folder`` and ``topk=2`` on the two folders both write the same
  set of file names (names only, no pixels); ``metrics_<name>.csv`` keeps
  pandas' columns;
- ``benchmark``: with ``steps=1`` and ``n_mean_steps=1`` (linear and
  Neo-Hookean) the rows have the JAX rows' columns, ``n_nodes`` and factor,
  and positive times; ``--csv_data_filename`` replots without a sweep."""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from p_div_gnn_tpu.analysis import benchmark as jax_benchmark
from p_div_gnn_tpu.analysis import compare as jax_compare
from p_div_gnn_tpu_torch import cli
from p_div_gnn_tpu_torch.analysis import benchmark, compare
from p_div_gnn_tpu_torch.datagen.generate import main as generate
from p_div_gnn_tpu_torch.inference import run_inference
from p_div_gnn_tpu_torch.utils.configio import read_csv

ROOT = Path(__file__).resolve().parents[1]
MODELS = {"P-GNN": "elast_200e_no_div", "P-DivGNN": "elast_200e_div"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inferred(tmp_path_factory):
    """A 3-mesh test set from the port's generator and one inference folder
    per model in ``MODELS``, written by the port on the CPU."""
    root = tmp_path_factory.mktemp("analysis")
    generate(n_samples=4, test_size=0.75, seed=11, dataset_path=str(root / "data"),
             max_workers=1)
    csv = root / "data/test/dataset.csv"
    folders = {}
    for name, ckpt in MODELS.items():
        folders[name] = root / name
        run_inference(csv, folders[name], ROOT / "checkpoints" / ckpt / "model_weights.ckpt",
                      periodic_graph=True, batch_size=2, latent_size=128,
                      message_passing_steps=10, device="cpu")
    return csv, folders


def test_compare_metrics_match_jax(inferred, capsys):
    csv, folders = inferred
    name, folder = "P-DivGNN", folders["P-DivGNN"]
    got = compare.main(str(csv), [str(folder)], [name])[name]
    port_out = capsys.readouterr().out
    want = jax_compare.main(str(csv), [str(folder)], [name])[name]
    assert port_out == capsys.readouterr().out
    assert list(got) == list(want.columns) == list(compare.METRIC_COLUMNS)
    assert len(got["sample"]) == len(want) == 3
    for col in want.columns:
        np.testing.assert_allclose(got[col], want[col].to_numpy(), rtol=1e-12, atol=0,
                                   err_msg=col)
    for col in ("nmse", "nmse_standardized", "div_model"):
        for k in (1, 2):
            for largest in (True, False):
                np.testing.assert_array_equal(
                    compare.topk_indices(np.asarray(got[col]), k, largest),
                    jax_compare.topk_indices(want[col].to_numpy(), k, largest))


def test_compare_writes_the_same_figures(inferred, tmp_path, monkeypatch):
    """Every figure is drawn; ``savefig`` only creates its file (the names
    are compared, not the pixels, and writing the shaded PDFs is most of
    the time)."""
    from matplotlib.figure import Figure

    monkeypatch.setattr(Figure, "savefig", lambda self, path, *a, **k: Path(path).touch())
    csv, folders = inferred
    names = list(MODELS)
    paths = [str(folders[n]) for n in names]
    compare.main(str(csv), paths, names, figures_folder=str(tmp_path / "port"), topk=2)
    jax_compare.main(str(csv), paths, names, figures_folder=str(tmp_path / "jax"), topk=2)
    files = {k: sorted(p.relative_to(tmp_path / k).as_posix()
                       for p in (tmp_path / k).rglob("*") if p.is_file())
             for k in ("port", "jax")}
    assert files["port"] == files["jax"]
    assert "metrics_P-DivGNN.csv" in files["port"] and len(files["port"]) > 20
    for k in ("cross_model_topk.json", "topk_P-GNN.json", "topk_P-DivGNN.json"):
        assert json.loads((tmp_path / "port" / k).read_text()) == json.loads(
            (tmp_path / "jax" / k).read_text()), k
    got = read_csv(tmp_path / "port/metrics_P-GNN.csv")
    want = pd.read_csv(tmp_path / "jax/metrics_P-GNN.csv")
    assert list(got) == list(want.columns)
    for col in want.columns:
        np.testing.assert_allclose(got[col], want[col].to_numpy(), rtol=1e-12, err_msg=col)


@pytest.mark.parametrize("hyperelastic", [False, True], ids=["linear", "hyperelastic"])
def test_benchmark_rows_match_jax(hyperelastic, tmp_path):
    benchmark.main(hyperelastic=hyperelastic, output_folder=str(tmp_path / "port"), steps=1,
                   n_mean_steps=1, device="cpu")
    jax_benchmark.main(hyperelastic=hyperelastic, output_folder=str(tmp_path / "jax"),
                       steps=1, n_mean_steps=1)
    got = read_csv(tmp_path / "port/benchmark_data.csv")
    want = pd.read_csv(tmp_path / "jax/benchmark_data.csv")
    assert list(got) == list(want.columns) == list(benchmark.COLUMNS)
    assert got["n_nodes"] == want["n_nodes"].tolist() == [303]
    assert got["hole_refinement_factor"] == want["hole_refinement_factor"].tolist() == [1.0]
    for col in ("gnn_gpu", "gnn_gpu_prepro", "fem"):
        assert all(t > 0 and np.isfinite(t) for t in got[col]), col
    assert (tmp_path / "port/benchmark.pdf").is_file()
    # a replot of the CSV, without a sweep
    (tmp_path / "port/benchmark.pdf").unlink()
    cli.benchmark_main(["--csv_data_filename", str(tmp_path / "port/benchmark_data.csv"),
                        "--output_folder", str(tmp_path / "port"), "--device", "cpu"])
    assert (tmp_path / "port/benchmark.pdf").is_file()


def test_benchmark_without_matplotlib_writes_the_csv_first(tmp_path, monkeypatch):
    """Where matplotlib is missing (the card's machine), ``main`` fails at the
    plot, after the CSV is written."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ModuleNotFoundError):
        benchmark.main(output_folder=str(tmp_path), steps=1, n_mean_steps=1, device="cpu")
    assert read_csv(tmp_path / "benchmark_data.csv")["n_nodes"] == [303]
