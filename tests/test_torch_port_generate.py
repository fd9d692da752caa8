"""The port's dataset generator (``datagen/generate.py::main``, the
``generate`` command) against the JAX package's, on the same arguments
(``n_samples=4``): P1 Dirichlet, Neumann, Q4 and Neo-Hookean datasets (the
last with two worker processes).

Both write the same file names; both ``dataset.csv`` tables, read with
``configio.read_csv``, have the same columns, strings (the dataset folder
aside) and floats, exactly, except the solver's outputs (``mean_stress_*``),
which take rtol 1e-10 (1e-8 Neo-Hookean); every npz key matches at the
same tolerances, ``op_div_*`` and ``node_labels`` exactly; the VTK files
read back equal."""

from pathlib import Path

import numpy as np
import pytest

from p_div_gnn_tpu.datagen.generate import main as jax_main
from p_div_gnn_tpu_torch import cli
from p_div_gnn_tpu_torch.datagen.generate import main
from p_div_gnn_tpu_torch.graphs.meshio import read_vtk
from p_div_gnn_tpu_torch.utils.configio import read_csv

CASES = {
    "dirichlet": dict(),
    "neumann": dict(bc="neumann"),
    "quad": dict(element="quad"),
    "hyperelastic": dict(hyperelastic=True, max_workers=2),
}
# the columns and npz keys the solve gives; the rest comes from the sampled
# parameters, the mesher and the operators, exactly
SOLVED_COLUMNS = {"mean_stress_x", "mean_stress_y", "mean_stress_xy", "mean_stress_x_material",
                  "mean_stress_y_material", "mean_stress_xy_material"}
SOLVED_KEYS = {"stress_field", "mean_stress", "mean_stress_material"}


def _files(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax(case, tmp_path):
    kw = dict(dict(n_samples=4, test_size=0.25, seed=2024, max_workers=1), **CASES[case])
    rtol = 1e-8 if case == "hyperelastic" else 1e-10
    jax_main(dataset_path=str(tmp_path / "jax"), **kw)
    main(dataset_path=str(tmp_path / "port"), **kw)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for split in ("train", "test"):
        got = read_csv(tmp_path / "port" / split / "dataset.csv")
        want = read_csv(tmp_path / "jax" / split / "dataset.csv")
        assert list(got) == list(want)
        assert len(got["n_nodes"]) == {"train": 3, "test": 1}[split]
        for col, values in want.items():
            if col in ("mesh_filename", "data_filename"):
                assert [v.replace(str(tmp_path / "port"), "") for v in got[col]] == [
                    v.replace(str(tmp_path / "jax"), "") for v in values]
            elif col in SOLVED_COLUMNS:
                np.testing.assert_allclose(got[col], values, rtol=rtol, atol=1e-12, err_msg=col)
            else:
                assert got[col] == values, col
        for g_npz, w_npz, g_vtk, w_vtk in zip(got["data_filename"], want["data_filename"],
                                              got["mesh_filename"], want["mesh_filename"]):
            a, b = np.load(g_npz), np.load(w_npz)
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                if k in SOLVED_KEYS:
                    np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-12, err_msg=k)
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            m, r = read_vtk(g_vtk), read_vtk(w_vtk)
            np.testing.assert_array_equal(m.points, r.points)
            np.testing.assert_array_equal(m.faces, r.faces)


def test_generate_command_writes_the_dataset(tmp_path, capsys):
    """``python -m p_div_gnn_tpu_torch.cli generate`` with the JAX CLI's flags
    (two workers); the JAX generator's asserts hold."""
    assert cli.main(["generate", "--n_samples", "3", "--test_size", "0.34", "--seed", "7",
                     "--dataset_path", str(tmp_path / "d"), "--max_workers", "2"]) == 0
    assert "Data generated in" in capsys.readouterr().out
    assert len(read_csv(tmp_path / "d/train/dataset.csv")["n_nodes"]) == 2
    assert len(read_csv(tmp_path / "d/test/dataset.csv")["n_nodes"]) == 1
    for kw in (dict(hyperelastic=True, bc="neumann"), dict(hyperelastic=True, element="quad"),
               dict(element="hex"), dict(dataset_path="")):
        with pytest.raises(AssertionError):
            main(**{"dataset_path": str(tmp_path / "x"), "n_samples": 2, **kw})
