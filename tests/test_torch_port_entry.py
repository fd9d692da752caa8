"""The port's entry points against the JAX package's, on the toy on-disk
dataset of ``tests/test_train_e2e.py::_write_toy_dataset``:

- ``run_experience``: both packages resume from ONE checkpoint the JAX
  package wrote at epoch 1 (its init after one Adam update; ``resume:
  True``, ``epochs: 3``), so both start from the same params and Adam
  state; the per-epoch losses agree at
  rtol 1e-5 (``test_torch_port_train.py``'s loss tolerance) and the two
  results folders hold the same files;
- ``run_inference`` on one checkpoint: the same files, ``dataset.csv``
  equal apart from the folder prefix, ``normalize_params.json`` equal, each
  field within the serve tolerance (rtol 2e-4 / atol 2e-5 standardized);
- the CLI in-process with ``--device cpu``: ``train`` then ``infer`` from
  YAML configs; both checkpoints load through the JAX package's
  ``load_checkpoint`` with the port's values; every JAX command is ported
  (an unknown one exits 2); the parallel modes run in one process without
  a process group."""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from p_div_gnn_tpu.graphs import MeshStressFieldDataset as JaxDataset
from p_div_gnn_tpu.inference import run_inference as jax_run_inference
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.train.checkpoint import load_checkpoint as jax_load
from p_div_gnn_tpu.train.checkpoint import save_checkpoint as jax_save
from p_div_gnn_tpu.train.data import GraphLoader as JaxLoader
from p_div_gnn_tpu.train.runner import run_experience as jax_run_experience
from p_div_gnn_tpu.train.loop import Trainer as JaxTrainer
from p_div_gnn_tpu_torch import cli
from p_div_gnn_tpu_torch.inference import run_inference
from p_div_gnn_tpu_torch.train import runner
from p_div_gnn_tpu_torch.train.checkpoint import (
    BEST_CHECKPOINT,
    LAST_CHECKPOINT,
    read_msgpack,
)
from p_div_gnn_tpu_torch.utils.configio import read_csv

from test_train_e2e import _write_toy_dataset

LOSS_RTOL, RTOL, ATOL = 1e-5, 2e-4, 2e-5
TRAIN_CFG = dict(epochs=1, batch_size=3, divergence=True, latent_size=16, divergence_penalty=10.0,
                 early_stopping_limit=5, learning_rate=1e-3, message_passing_steps=2,
                 train_all_epochs=True, monitor_divergence_in_test=True, scatter_impl="xla")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The toy models' small ops run faster on one thread than on the
    threads of a machine that the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy train and test sets, the config keys of a run on them, and
    one checkpoint the JAX package wrote at epoch 1 (its init after one
    Adam update of random gradients: non-zero moments), with the JAX
    params and optimizer state as templates."""
    root = tmp_path_factory.mktemp("toy")
    _write_toy_dataset(root / "train", n_samples=6, seed=0)
    _write_toy_dataset(root / "test", n_samples=3, seed=1)
    cfg = dict(TRAIN_CFG, dataset_train_csv=str(root / "train/dataset.csv"),
               dataset_test_csv=str(root / "test/dataset.csv"))
    train = JaxDataset(pd.read_csv(cfg["dataset_train_csv"]))
    jt = JaxTrainer(model=JaxEPD(latent_size=16, message_passing_steps=2), stats=train.stats)
    params, opt_state = jt.init(jax.random.PRNGKey(0), next(iter(JaxLoader(train.samples, 3))))
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    updates, opt_state = jt.optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    (root / "seed/weights").mkdir(parents=True)
    jax_save(root / "seed/weights" / LAST_CHECKPOINT, params, opt_state, 1, train.stats)
    return root, cfg, (params, opt_state)


def _tree(folder: Path) -> list[str]:
    """The files under ``folder``, TensorBoard event files by kind."""
    return sorted(
        "EVENTS" if p.name.startswith("events.out.tfevents") else p.relative_to(folder).as_posix()
        for p in folder.rglob("*") if p.is_file())


def _tree_with_events(folder: Path) -> list[str]:
    return sorted(
        (p.parent.relative_to(folder) / "EVENTS").as_posix()
        if p.name.startswith("events.out.tfevents") else p.relative_to(folder).as_posix()
        for p in folder.rglob("*") if p.is_file())


def test_run_experience_resumes_like_jax(toy):
    root, cfg, _ = toy
    for name in ("jax", "port"):
        shutil.copytree(root / "seed/weights", root / name / "weights")
    cfg = dict(cfg, epochs=3, resume=True)
    want = jax_run_experience(results_folder=str(root / "jax"), **cfg)
    got = runner.run_experience(results_folder=str(root / "port"), device="cpu", **cfg)
    assert len(got[0]) == len(want[0]) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=LOSS_RTOL)
    assert _tree_with_events(root / "port") == _tree_with_events(root / "jax")
    for name in (BEST_CHECKPOINT, LAST_CHECKPOINT):
        g = read_msgpack((root / "port/weights" / name).read_bytes())
        w = read_msgpack((root / "jax/weights" / name).read_bytes())
        assert g["epoch"] == w["epoch"] == 3
        assert g["optimizer_state_dict"]["0"]["count"] == w["optimizer_state_dict"]["0"]["count"]


def test_run_inference_matches_jax(toy, tmp_path):
    root, cfg, _ = toy
    kw = dict(dataset_csv=cfg["dataset_test_csv"],
              model_weights_path=str(root / "seed/weights" / LAST_CHECKPOINT),
              periodic_graph=True, batch_size=2, latent_size=16, message_passing_steps=2)
    want = jax_run_inference(results_folder=tmp_path / "jax", **kw)
    got = run_inference(results_folder=tmp_path / "port", device="cpu", **kw)
    assert len(got) == len(want) == 3
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    g_csv, w_csv = (tmp_path / "port/dataset.csv").read_text(), (
        tmp_path / "jax/dataset.csv").read_text()
    assert g_csv.replace(str(tmp_path / "port"), "") == w_csv.replace(str(tmp_path / "jax"), "")
    norm = json.loads((tmp_path / "port/normalize_params.json").read_text())
    assert norm == json.loads((tmp_path / "jax/normalize_params.json").read_text())
    for g, w in zip(got, want):
        a, b = np.load(g), np.load(w)
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k != "stress_field":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        scale = lambda f: (f - norm["mean_local_stress"]) / norm["std_local_stress"]  # noqa: E731
        np.testing.assert_allclose(scale(a["stress_field"]), scale(b["stress_field"]),
                                   rtol=RTOL, atol=ATOL)


def _yaml(path: Path, cfg: dict) -> Path:
    path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
    return path


def test_cli_trains_and_infers_on_the_cpu(toy, tmp_path):
    """``train`` writes both checkpoints, which the JAX package's
    ``load_checkpoint`` reads with the port's params, Adam count / mu / nu,
    epoch and stats; ``infer`` then predicts with the last one."""
    root, cfg, (params_t, opt_t) = toy
    train_cfg = _yaml(tmp_path / "train.yml", dict(cfg, epochs=2, device="tpu",
                                                   results_folder=tmp_path / "run"))
    assert cli.main(["train", "--config_path", str(train_cfg), "--device", "cpu"]) == 0
    assert (tmp_path / "run" / "train.yml").read_text() == train_cfg.read_text()
    for name in (BEST_CHECKPOINT, LAST_CHECKPOINT):
        path = tmp_path / "run/weights" / name
        port = read_msgpack(path.read_bytes())
        params, opt_state, epoch, stats = jax_load(path, params_t, opt_t)
        assert opt_state is not None and epoch == port["epoch"]
        assert stats.to_dict() == pytest.approx(port["stats"], rel=0)
        for got, want in ((params, port["model_state_dict"]),
                          (opt_state[0].mu, port["optimizer_state_dict"]["0"]["mu"]),
                          (opt_state[0].nu, port["optimizer_state_dict"]["0"]["nu"])):
            g, w = jax.tree.leaves(got), jax.tree.leaves(want)
            assert len(g) == len(w) > 0
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), b)
        assert int(opt_state[0].count) == int(port["optimizer_state_dict"]["0"]["count"]) == 4
    infer_cfg = _yaml(tmp_path / "infer.yml", dict(
        dataset_csv=cfg["dataset_test_csv"], results_folder=tmp_path / "inf",
        model_weights_path=tmp_path / "run/weights" / LAST_CHECKPOINT, device="tpu",
        latent_size=16, message_passing_steps=2, batch_size=3, periodic_graph=True))
    assert cli.main(["infer", "--config_path", str(infer_cfg), "--device", "cpu"]) == 0
    table = read_csv(tmp_path / "inf/dataset.csv")
    assert [Path(p).name for p in table["data_filename"]] == [
        f"hole_plate_mesh_{i}.npz" for i in range(3)]
    assert all(np.isfinite(np.load(p)["stress_field"]).all() for p in table["data_filename"])


JAX_COMMANDS = ("train", "infer", "generate", "benchmark", "compare", "scaling")


@pytest.mark.parametrize("command", [*JAX_COMMANDS, "bogus", ""])
def test_cli_commands_not_ported_exit_2(command, capsys):
    """No command exits 2: every command of the JAX CLI is ported and shows
    its usage with exit 0; only an unknown command (or none) exits 2, with
    the usage."""
    if command in JAX_COMMANDS:
        with pytest.raises(SystemExit) as exc:
            cli.main([command, "--help"])
        assert exc.value.code == 0
        assert f"pdg-torch-{command}" in capsys.readouterr().out
        return
    assert cli.main([command] if command else []) == 2
    err = capsys.readouterr().err
    assert "usage: python -m p_div_gnn_tpu_torch.cli" in err and "ROADMAP A" not in err


def test_entry_points_default_to_the_card(monkeypatch):
    import inspect

    from p_div_gnn_tpu_torch import inference
    from p_div_gnn_tpu_torch.train.data import GraphLoader

    from p_div_gnn_tpu_torch.analysis import benchmark

    for fn in (runner.run_experience, runner.main, inference.run_inference, inference.main,
               GraphLoader.__init__, benchmark.main, benchmark.sweep):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for fn in (cli.train_main, cli.infer_main, cli.benchmark_main):
        with pytest.raises(SystemExit):
            fn(["--help"])
    # the benchmark's --device defaults to the card, as train's and infer's do
    seen = {}
    monkeypatch.setattr(benchmark, "main", lambda **kw: seen.update(kw))
    cli.benchmark_main(["--steps", "1"])
    assert seen["device"] == "cuda"
    cli.benchmark_main(["--device", "cpu"])
    assert seen["device"] == "cpu"


def test_unported_parallel_modes_raise(toy, tmp_path, monkeypatch):
    """The parallel modes are ported (parallel/): without a process group
    (no torchrun variables) ``multihost`` and ``data_parallel`` train in
    this one process, as the JAX runner does with one process and one
    device; over ranks they are tests/test_torch_port_dp.py's."""
    root, cfg, _ = toy
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    config = _yaml(tmp_path / "mh.yml", dict(cfg, multihost=True, data_parallel=True,
                                              results_folder=tmp_path / "mh"))
    got = runner.main(config, device="cpu")
    want = runner.run_experience(results_folder=str(tmp_path / "one"), device="cpu", **cfg)
    assert got == want
    assert (tmp_path / "mh/weights" / LAST_CHECKPOINT).is_file()
    import torch.distributed as dist

    assert not dist.is_initialized()
