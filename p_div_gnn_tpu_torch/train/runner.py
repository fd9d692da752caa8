"""Experiment runner: YAML config → datasets → model → training.

The counterpart of ``p_div_gnn_tpu/train/runner.py:50-251``, with the same
config keys (the committed ``scripts/configs_train/*.yml`` run as they are):
dataset_train_csv, dataset_test_csv, results_folder, epochs, batch_size,
learning_rate, early_stopping_limit, divergence, divergence_penalty,
latent_size, message_passing_steps, train_all_epochs,
monitor_divergence_in_test, periodic_graph, scatter_impl, stream_dtype,
resume, cache_train_batches, skip_nonfinite_updates, seed.

The run goes to the device the caller names (``main(..., device=)``, the
CLI's ``--device``; the card by default). The config's own ``device`` key
is accepted and ignored, as in the JAX package. Left out on purpose:

- the JAX runner's fall-back to ``"xla"`` on the CPU: on CPU tensors every
  kernel wrapper of the port already runs its plain version;
- its fp32 ``EDGE_BLOCK <= 512`` guard: a TPU VMEM limit; the card's
  kernels run fp32 on the default 768-slot blocks.

``data_parallel`` trains over the process group's ranks when there are
more than one (``torchrun --nproc-per-node N -m p_div_gnn_tpu_torch.cli
train ...``): each rank on its card (``cuda:LOCAL_RANK``) with its shards of
every batch (``parallel/dp.py``), rank 0 alone writing logs and
checkpoints; ``fused2`` is single-shard and refused there, as the JAX
runner refuses it. With one rank it trains on one card, as the JAX runner
does with one device. ``data_parallel`` and ``multihost`` first join the
process group that ``torchrun`` describes (``parallel/multihost.py::
ensure_distributed``; a no-op without one).
"""

from __future__ import annotations

import contextlib
import random
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.dataset import MeshStressFieldDataset
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.models.summary import model_summary
from p_div_gnn_tpu_torch.parallel.dp import DPGraphLoader
from p_div_gnn_tpu_torch.parallel.multihost import default_backend, ensure_distributed, local_device
from p_div_gnn_tpu_torch.train.checkpoint import LAST_CHECKPOINT, load_checkpoint
from p_div_gnn_tpu_torch.train.data import GraphLoader
from p_div_gnn_tpu_torch.train.logging import MetricsWriter
from p_div_gnn_tpu_torch.train.loop import Trainer
from p_div_gnn_tpu_torch.utils.configio import Table, read_config, read_csv, table_len

SEED = 69  # `gnn_train.py:38`


def _write_dataset_histograms(table: Table, writer: MetricsWriter, tag: str) -> None:
    for col, name in [
        ("hole_plate_radius", "Hole plate radius"),
        ("mean_stress_x", "Mean stress X"),
        ("mean_stress_y", "Mean stress Y"),
        ("mean_stress_xy", "Mean stress XY"),
    ]:
        if col in table:
            writer.add_histogram(f"{tag}/{name}", np.asarray(table[col], dtype=float))


def run_experience(
    dataset_train_csv: str,
    dataset_test_csv: str,
    results_folder: str,
    epochs: int,
    batch_size: int,
    divergence: bool,
    latent_size: int,
    divergence_penalty: float,
    early_stopping_limit: int,
    learning_rate: float,
    message_passing_steps: int,
    train_all_epochs: bool = False,
    periodic_graph: bool = True,
    monitor_divergence_in_test: bool = False,
    config_path: Path | str | None = None,
    scatter_impl: str = "xla",
    stream_dtype: str = "float32",
    data_parallel: bool = False,
    resume: bool = False,
    cache_train_batches: bool = False,
    skip_nonfinite_updates: bool = False,
    seed: int = SEED,
    device: str | torch.device = "cuda",
    **_ignored: Any,
) -> tuple[list[float], list[float]]:
    group, rank, world = None, 0, 1
    if data_parallel:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            if scatter_impl == "fused2":
                raise ValueError("scatter_impl='fused2' is single-shard for now: use 'fused' "
                                 "or 'hybrid' with data_parallel")
            group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
            device = local_device(device)
    device = torch.device(device)
    lead = rank == 0  # writes the logs, the checkpoints and the console
    say = print if lead else (lambda *a, **k: None)
    random.seed(seed)
    np.random.seed(seed)

    train_table = read_csv(dataset_train_csv)
    test_table = read_csv(dataset_test_csv)
    results = Path(results_folder)
    if lead:
        with MetricsWriter(results / "Dataset stats") as w:
            _write_dataset_histograms(train_table, w, "Train Dataset")
            _write_dataset_histograms(test_table, w, "Test Dataset")
            w.add_text("Dataset train csv", dataset_train_csv)
            w.add_text("Dataset test csv", dataset_test_csv)

    say(f"Size train dataset {table_len(train_table)}")
    say(f"Size test dataset {table_len(test_table)}")
    say("Loading datasets...")
    train_ds = MeshStressFieldDataset(train_table, periodic_graph=periodic_graph)
    # the reference builds the test set with the default periodic_graph=True
    # even for non-periodic runs (`gnn_train.py:386`); kept so
    test_ds = MeshStressFieldDataset(test_table)
    pair_blocks = scatter_impl == "fused2"
    # the sender view feeds the fused / hybrid sender gathers; the xla and
    # pallas paths never read it
    sender_view = scatter_impl not in ("xla", "pallas")
    if group is not None:
        say(f"Data-parallel training over {world} ranks")
        train_loader = DPGraphLoader(train_ds.samples, batch_size, rank, world, shuffle=True,
                                     seed=seed, device=device)
        test_loader = DPGraphLoader(test_ds.samples, batch_size, rank, world, device=device)
    else:
        train_loader = GraphLoader(
            train_ds.samples, batch_size, shuffle=True, seed=seed,
            cache_groups=cache_train_batches, pair_blocks=pair_blocks,
            sender_view=sender_view, device=device,
        )
        test_loader = GraphLoader(test_ds.samples, batch_size, shuffle=False,
                                  pair_blocks=pair_blocks, sender_view=sender_view,
                                  device=device)

    model = EncodeProcessDecode(
        latent_size=latent_size,
        message_passing_steps=message_passing_steps,
        scatter_impl=scatter_impl,
        stream_dtype=stream_dtype,
        generator=torch.Generator().manual_seed(seed),
    )
    trainer = Trainer(
        model=model,
        stats=train_ds.stats,  # the TRAIN set's stats (`gnn_train.py:397-411`)
        learning_rate=learning_rate,
        divergence_penalty=divergence_penalty,
        optimize_divergence=divergence,
        monitor_divergence_in_test=monitor_divergence_in_test,
        device=device,
        skip_nonfinite_updates=skip_nonfinite_updates,
        group=group,
    )
    trainer.init()
    summary = model_summary(model)
    say(summary)
    say(f"EncodeProcessDecode params: {sum(p.numel() for p in model.parameters())}")

    start_epoch = 0
    if resume:
        ckpt_path = results / "weights" / LAST_CHECKPOINT
        if ckpt_path.exists():
            state_dict, start_epoch, trainer.stats = load_checkpoint(
                ckpt_path, model, trainer.optimizer, trainer.nonfinite)
            model.load_state_dict(state_dict)
            say(f"Resumed from {ckpt_path} at epoch {start_epoch}")

    # `Path("")` is "." (a directory): copy only a real config file
    if lead and config_path is not None and Path(config_path).is_file():
        results.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(config_path, results / Path(config_path).name)
    logs = MetricsWriter(results / "train_logs") if lead else contextlib.nullcontext()
    with logs as writer:
        if lead:
            writer.add_text("Model summary", summary)
            writer.add_text(
                "Train parameters",
                f"Batch size = {batch_size}; Learning rate = {learning_rate}; "
                f"Epochs = {epochs}; Divergence = {divergence}; "
                f"Divergence lambda = {divergence_penalty}; "
                f"Early stopping limit = {early_stopping_limit};",
            )
        return trainer.fit(
            train_loader,
            test_loader,
            epochs=epochs,
            weights_folder=results / "weights",
            writer=writer,
            early_stopping_limit=early_stopping_limit,
            train_all_epochs=train_all_epochs,
            start_epoch=start_epoch,
        )


def main(
    config_path: str | Path,
    resume_override: bool | None = None,
    device: str | torch.device = "cuda",
) -> tuple[list[float], list[float]]:
    """Train as the config at ``config_path`` says, on ``device`` (under a
    process group: ``cuda`` is each rank's ``cuda:LOCAL_RANK``)."""
    params = read_config(config_path)
    params.pop("device", None)  # the JAX package's key; the caller names the device
    params["config_path"] = Path(config_path)
    if resume_override is not None:
        params["resume"] = resume_override
    if params.pop("multihost", False) or params.get("data_parallel", False):
        ensure_distributed(backend=default_backend(device))
    return run_experience(**params, device=device)
