"""The port's flat-YAML config reader and CSV tables against the calls they
stand in for: ``yaml.safe_load`` on every committed config and on the YAML
1.1 corner cases PyYAML follows (those no config uses are refused), and ``pandas.read_csv`` /
``DataFrame.to_csv(index=False)`` on a dataset table, in both directions
(values and types equal, the written text equal)."""

import math
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml

from p_div_gnn_tpu_torch.utils.configio import parse_config, read_config, read_csv, write_csv

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "scripts").glob("configs_*/*.yml"))


def _same(a, b) -> bool:
    """Equal values of equal types, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def test_the_committed_configs_are_found():
    assert len(CONFIGS) == 18


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_committed_config_reads_as_yaml_does(path):
    got, want = read_config(path), yaml.safe_load(path.read_text())
    assert list(got) == list(want)
    for k in want:
        assert _same(got[k], want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("text", [
    "a: 1e-3",  # no dot: a string in YAML 1.1
    "a: 1.0e-3", "a: 1.0e3", "a: 3.", "a: .5", "a: -.inf", "a: .NaN",
    "a: yes", "a: No", "a: on", "a: OFF", "a: True",
    "a: ~", "a: null", "a:", "a: # only a comment",
    "a: 1 # a comment", "a: b#c", "a: 0o17", "a: 0xZZ", "a: 00.5",
    "a: 1_000", "a: +5", "a: -3", "a: 0",
    "a: 'x # y'", "a: 'it''s'", 'a: "plain # text"', "a: ' padded '",
    "a: ./datasets/x y/z.csv", "1: one", "# comment\n---\na: 1\nb: two\n",
    "a: 1\na: 2",
])
def test_scalar_reads_as_yaml_does(text):
    got, want = parse_config(text), yaml.safe_load(text)
    assert list(got) == list(want)
    for k in want:
        assert _same(got[k], want[k]), (text, got[k], want[k])


@pytest.mark.parametrize("text", [
    "a:\n  b: 1", "- a", "a: [1, 2]", "a: {b: 1}", "a: &anchor 1", "a: *alias",
    "a: !!str 1", "a: |", "a: >", "a: b: c", "a: 1\n---\nb: 2", "\ta: 1",
    # YAML 1.1 forms no config uses: refused, not emulated
    "a: 2001-12-14", "a: 010", "a: 09", "a: 0x1F", "a: 0b101", "a: 1:30", "a: <<",
    'a: "q\\"x\\t\\u00e9"', '"k\\"ey": 1',
])
def test_refuses_what_is_not_a_flat_map(text):
    with pytest.raises(ValueError):
        parse_config(text)


def _frame() -> pd.DataFrame:
    rng = np.random.default_rng(0)
    return pd.DataFrame({
        "mesh_filename": [f"/data/run 1/meshes/hole_plate_mesh_{i}.vtk" for i in range(6)],
        "data_filename": ["a,b.npz", 'q"uote.npz', "c.npz", "d", "e", "f"],
        "mean_stress_x": rng.normal(size=6) * 1e3,
        "tiny": [1e-300, 1e-5, 0.1, 1e16, -0.0, 123456789.123456789],
        "hole_plate_radius": [10.0, 12.5, 15.0, 20.0, 25.0, 29.9],
        "n_nodes": [1, 2, 3, -4, 5, 0],
        "flag": [True, False, True, True, False, True],
        "with_nan": [1.0, np.nan, 2.5, 3.0, 4.0, 5.0],
    })


def test_csv_reads_what_pandas_writes(tmp_path):
    df = _frame()
    df.to_csv(tmp_path / "dataset.csv", index=False)
    table = read_csv(tmp_path / "dataset.csv")
    want = pd.read_csv(tmp_path / "dataset.csv")
    assert list(table) == list(want.columns) == list(df.columns)
    for col in want.columns:
        for a, b in zip(table[col], want[col].tolist()):
            assert _same(a, b), (col, a, b)


def test_floats_parse_as_pandas_parses_them(tmp_path):
    """pandas' default parser keeps 17 digits, leading zeros included, and
    can land one ulp from the correctly rounded double; the reader lands
    where pandas does, on 20,000 values over 600 decades and subnormals."""
    rng = np.random.default_rng(1)
    values = np.concatenate([rng.normal(size=20000) * 10.0 ** rng.integers(-300, 300, 20000),
                             [5e-324, 2.5e-310, 1.7e308, 0.14408536849992318]])
    cells = [repr(float(v)) for v in values] + ["1e5", "1.5E-3", "+3.25", "-0.5e+2",
                                                "00012.5000", ".5", "5.", "-inf", "inf"]
    (tmp_path / "x.csv").write_text("x\n" + "\n".join(cells) + "\n")
    got, want = read_csv(tmp_path / "x.csv")["x"], pd.read_csv(tmp_path / "x.csv")["x"].tolist()
    assert all(_same(a, b) for a, b in zip(got, want, strict=True))
    assert got[20003] == 0.1440853684999231 != 0.14408536849992318


def test_csv_writes_what_pandas_writes(tmp_path):
    df = _frame()
    df.to_csv(tmp_path / "pandas.csv", index=False)
    write_csv(tmp_path / "port.csv", {c: df[c].tolist() for c in df.columns})
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "pandas.csv").read_text()
    # read back and written again: the text pandas writes from what it
    # reads (its parser's ulp drift included, as a JAX inference run's
    # dataset.csv carries it)
    write_csv(tmp_path / "again.csv", read_csv(tmp_path / "port.csv"))
    pd.read_csv(tmp_path / "port.csv").to_csv(tmp_path / "pandas_again.csv", index=False)
    assert (tmp_path / "again.csv").read_text() == (tmp_path / "pandas_again.csv").read_text()
