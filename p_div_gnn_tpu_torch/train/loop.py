"""The training loop — the counterpart of ``p_div_gnn_tpu/train/loop.py``
(``Trainer``: the step, the eval metrics, skipping non-finite updates and
``fit``).

The trainer takes any model of the port with that model's objective
(``objective``): P-DivGNN's ``EncodeProcessDecode`` with
``pdivgnn_objective``, the default, or MeshGraphNets with
``models/meshgraphnets.py::objective``. P-DivGNN's loss standardizes the
target, not the prediction (the model runs with ``scale_output=False``),
and is ``batch_loss``: mean per-graph NMSE plus λ·mean divergence penalty
when ``optimize_divergence``. The update is Adam
with the reference's torch defaults, which ``optax.adam`` matches: betas
(0.9, 0.999), eps 1e-8 added outside the square root, bias correction.
A model trained as published with another optimiser sets ``betas``,
``weight_decay`` (decoupled, as ``optax.adamw``: AdamW in place of Adam)
and ``clip_norm`` (the gradients scaled to at most that global norm
before the update, as ``optax.clip_by_global_norm``, on the device: the
norm is never read by the host); GraphCast trains so.

``fit`` runs the JAX loop's epochs: train steps over the prefetched train
loader, eval over the test loader, the metrics summed on the device and
read once per epoch, the scalars logged, the best-on-test and last-epoch
checkpoints written every epoch, early stopping unless
``train_all_epochs``, and ``start_epoch`` to resume.

``group`` is the JAX ``mesh=`` mode: data parallelism over a process group
(``parallel/dp.py``). Each rank runs the same ``Trainer`` on its own shards
(``DPGraphLoader``); the loss and the eval metrics are the whole batch's on
every rank, the gradients are averaged over the ranks before Adam (and
before the finite check, so every rank skips the same steps), rank 0 alone
writes the checkpoints, in the single-card format, and every rank may read
them back to resume.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable

import torch
from torch import nn

from p_div_gnn_tpu_torch.graphs.container import GraphBatch, NormStats
from p_div_gnn_tpu_torch.losses import batch_loss, per_graph_divergence
from p_div_gnn_tpu_torch.parallel.collectives import Group, barrier, pmean_, psum, rank
from p_div_gnn_tpu_torch.train.checkpoint import (
    BEST_CHECKPOINT,
    LAST_CHECKPOINT,
    save_checkpoint,
    set_adam_state,
)
from p_div_gnn_tpu_torch.train.data import prefetch
from p_div_gnn_tpu_torch.train.logging import MetricsWriter
from p_div_gnn_tpu_torch.utils.profiling import span

_INT32_MAX = 2**31 - 1
# a model's objective: (trainer, batch on the device, training) -> (total,
# {term: value}); with training False, the terms eval reports
Objective = Callable[["Trainer", GraphBatch, bool],
                     tuple[torch.Tensor, dict[str, torch.Tensor]]]


def pdivgnn_objective(trainer: "Trainer", batch: GraphBatch,
                      training: bool) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """P-DivGNN's objective with the trainer's ``stats``, penalty and
    ``group``: in training ``batch_loss`` (terms "nmse", "divergence"); in
    eval the NMSE, and the divergence added when
    ``monitor_divergence_in_test``, as the JAX ``_eval_metrics`` reports
    them."""
    stats, group = trainer.stats, trainer.group
    if stats is None:
        raise ValueError("P-DivGNN's objective needs the trainer's stats")
    pred = trainer.model(batch, stats, scale_input=True, scale_output=False, group=group)
    target = (batch.local_stress - stats.mean_local_stress) / stats.std_local_stress
    if training:
        return batch_loss(batch, pred, target, divergence_penalty=trainer.divergence_penalty,
                          optimize_divergence=trainer.optimize_divergence, group=group)
    total, aux = batch_loss(batch, pred, target, 0.0, False, group=group)
    if trainer.monitor_divergence_in_test:
        gmask = batch.graph_mask.to(pred.dtype)
        div_sum = psum((per_graph_divergence(batch, pred) * gmask).sum(), group)
        n_real = psum(gmask.sum(), group)
        aux["divergence"] = div_sum / torch.clamp(n_real, min=1.0)
        total = total + aux["divergence"]
    return total, aux


@dataclass
class Trainer:
    """Trainer of a model of the port on one device, or on this rank's
    shards under ``group`` (the module docstring). The model is moved to
    ``device`` (the card unless the caller asks for the CPU) and every
    batch, host-packed or already there, goes to it too. ``objective`` is
    the model's training objective, P-DivGNN's by default, which reads
    ``stats`` and the divergence settings. ``fit`` logs P-DivGNN's terms and
    ``save`` writes P-DivGNN's checkpoint.

    ``skip_nonfinite_updates`` does what ``optax.apply_if_finite`` does
    around Adam: a step whose gradients hold an inf or a NaN leaves the
    parameters, the moments and the step count as they were, and counts
    itself in ``nonfinite`` (``notfinite_count`` consecutive,
    ``total_notfinite`` in all, ``last_finite``), all on the device, so a
    step never waits for the host. After ``_max_consecutive_nonfinite``
    such steps in a row the update would be applied, as optax gives up;
    ``fit`` aborts the run at half of that, after saving the last
    checkpoint (whose parameters are then still finite).

    ``flatten_optimizer`` is the JAX trainer's ``optax.flatten(adam)``: Adam
    over one concatenated parameter vector, whose updates are those of the
    per-parameter Adam entry for entry. Here the update is torch's Adam as
    without it; what changes is the checkpoint's optimizer layout (one
    ``mu`` and one ``nu`` vector, ``train/checkpoint.py``), which reads and
    writes the JAX trainer's flattened checkpoints."""

    model: nn.Module
    stats: NormStats | None = None  # P-DivGNN's normalisers, read by its objective
    learning_rate: float = 1e-3
    divergence_penalty: float = 1.0
    optimize_divergence: bool = True
    monitor_divergence_in_test: bool = False
    device: str | torch.device = "cuda"
    skip_nonfinite_updates: bool = False
    _max_consecutive_nonfinite: int = 100
    group: Group | None = None  # data parallelism over this process group
    flatten_optimizer: bool = False  # optax.flatten(adam)'s checkpoint layout
    objective: Objective = pdivgnn_objective
    betas: tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0  # decoupled, as AdamW's
    clip_norm: float | None = None  # the gradients' largest global norm

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)
        self.model.to(self.device)
        self.optimizer: torch.optim.AdamW | None = None
        self.nonfinite: dict[str, torch.Tensor] | None = None
        self.steps_taken = 0  # train_step calls, the id of the step's span

    def init(self) -> torch.optim.AdamW:
        """Fresh AdamW state (Adam where ``weight_decay`` is 0) over the
        model's parameters (step 0, zero moments, as optax's ``adam.init``)
        and zeroed non-finite counters. With ``skip_nonfinite_updates`` on
        the card the step count lives on the device (``capturable``), so a
        skipped step can keep it without a sync."""
        capturable = self.skip_nonfinite_updates and self.device.type == "cuda"
        # torch's AdamW is its Adam with the decay decoupled, which it skips
        # at a decay of 0: the defaults take Adam's update bit for bit
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=self.learning_rate, betas=self.betas, eps=1e-8,
            weight_decay=self.weight_decay, capturable=capturable)
        for p in self.model.parameters():
            set_adam_state(self.optimizer, p, 0, torch.zeros_like(p), torch.zeros_like(p))
        if self.skip_nonfinite_updates:
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            self.nonfinite = {"notfinite_count": zero.clone(), "total_notfinite": zero.clone(),
                              "last_finite": torch.ones((), dtype=torch.bool, device=self.device)}
        return self.optimizer

    def loss(self, batch: GraphBatch) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(total, terms) of the training objective."""
        return self.objective(self, batch.to(self.device), True)

    def loss_and_grads(
        self, batch: GraphBatch
    ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        """The loss terms (with "total") and the gradient of every parameter
        by name (averaged over the ranks under ``group``), leaving ``.grad``
        set; parameters are not updated."""
        self.model.zero_grad(set_to_none=True)
        with span("step.forward", device=True):
            total, aux = self.loss(batch)
        with span("step.backward", device=True):
            total.backward()
            pmean_([p.grad for p in self.model.parameters()], self.group)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total"] = total.detach()
        grads = {n: p.grad for n, p in self.model.named_parameters()}
        return aux, grads

    def train_step(self, batch: GraphBatch) -> dict[str, torch.Tensor]:
        """One forward, backward and Adam update; returns the loss terms
        of the parameters before the update. Traced as ``step`` around
        ``step.forward`` (the model and the loss), ``step.backward``
        (autograd, remat's recompute included, and the gradients' mean
        under ``group``) and ``step.optimizer`` (the clipping where
        ``clip_norm`` is set, and the update), each with its device time
        (``utils/profiling.py``)."""
        if self.optimizer is None:
            self.init()
        with span("step", step=self.steps_taken):
            self.steps_taken += 1
            aux, _ = self.loss_and_grads(batch)
            with span("step.optimizer", device=True):
                if self.clip_norm is not None:
                    clip_by_global_norm(self.model.parameters(), self.clip_norm)
                if self.nonfinite is None:
                    self.optimizer.step()
                else:
                    self._step_if_finite()
        return aux

    def _step_if_finite(self) -> None:
        """optax.apply_if_finite around Adam, on the device: the update runs,
        and where the gradients were not all finite (and the consecutive
        count has not passed the limit) the parameters, moments and step
        count get their old values back."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        finite = torch.stack([torch.isfinite(p.grad).all() for p in params]).all()
        nf = self.nonfinite
        count = torch.where(finite, torch.zeros_like(nf["notfinite_count"]),
                            _safe_increment(nf["notfinite_count"]))
        apply = finite | (count > self._max_consecutive_nonfinite)
        tensors = [p.data for p in params] + [
            self.optimizer.state[p][k] for p in params for k in ("step", "exp_avg", "exp_avg_sq")]
        before = [t.clone() for t in tensors]
        self.optimizer.step()
        for t, old in zip(tensors, before):
            t.copy_(torch.where(apply.to(t.device), t, old))
        nf["total_notfinite"].copy_(torch.where(finite, nf["total_notfinite"],
                                                _safe_increment(nf["total_notfinite"])))
        nf["notfinite_count"].copy_(count)
        nf["last_finite"].copy_(finite)

    @torch.no_grad()
    def eval_step(self, batch: GraphBatch) -> dict[str, torch.Tensor]:
        """The objective's eval terms (with "total") of the current
        parameters."""
        total, aux = self.objective(self, batch.to(self.device), False)
        aux["total"] = total
        return aux

    def save(self, path: str | Path, epoch: int) -> None:
        """The JAX package's checkpoint of the model, Adam and the stats
        (under ``group``: written by rank 0, read by none before it is
        complete)."""
        if self.optimizer is None:
            self.init()
        if rank(self.group) == 0:
            save_checkpoint(path, self.model, self.optimizer, epoch, self.stats,
                            self.nonfinite, flat=self.flatten_optimizer)
        barrier(self.group)

    def _nonfinite_abort_check(self, weights_folder: Path, epoch: int) -> None:
        """Abort once the consecutive non-finite count reaches half the
        give-up limit: between two checks (every limit/2 steps and at each
        epoch's end) it grows by at most limit/2, so the run stops before
        an update with non-finite gradients could be applied, and the last
        checkpoint it saves is finite. Reads the count (one sync)."""
        threshold = self._max_consecutive_nonfinite // 2
        nf_run = int(self.nonfinite["notfinite_count"])
        if nf_run >= threshold:
            self.save(weights_folder / LAST_CHECKPOINT, epoch + 1)
            raise RuntimeError(
                f"training diverged: {nf_run} consecutive nonfinite updates — aborting "
                "before apply_if_finite gives up and applies a NaN update")

    def fit(
        self,
        train_loader: Iterable[GraphBatch],
        test_loader: Iterable[GraphBatch],
        epochs: int,
        weights_folder: str | Path,
        writer: MetricsWriter | None = None,
        early_stopping_limit: int = 10,
        train_all_epochs: bool = False,
        verbose: bool = True,
        start_epoch: int = 0,
    ) -> tuple[list[float], list[float]]:
        """Train; returns the per-epoch train and test losses. A fresh run
        (``start_epoch == 0``) fails on an existing ``weights_folder``, as
        the reference's ``mkdir(exist_ok=False)``; ``start_epoch > 0``
        resumes into it."""
        if self.optimizer is None:
            self.init()
        weights_folder = Path(weights_folder)
        lead = rank(self.group) == 0  # writes the folder, logs and prints
        verbose = verbose and lead
        if lead:
            weights_folder.mkdir(parents=True, exist_ok=start_epoch > 0)
        best_loss = sys.float_info.max
        train_losses: list[float] = []
        test_losses: list[float] = []
        early_stopping_counter = 0
        epoch = start_epoch
        half = self._max_consecutive_nonfinite // 2
        for epoch in range(start_epoch, epochs):
            if not train_all_epochs and early_stopping_counter >= early_stopping_limit:
                if verbose:
                    print("Training early stopped")
                break
            # summed on the device and read once per epoch: a read per step
            # would make every step wait for the card
            zero = torch.zeros((), device=self.device)
            tr_nmse, tr_div, tr_total = zero.clone(), zero.clone(), zero.clone()
            n_tr = 0
            for batch in prefetch(train_loader, self.device):
                aux = self.train_step(batch)
                tr_nmse += aux["nmse"]
                tr_total += aux["total"]
                if self.optimize_divergence:
                    tr_div += aux["divergence"]
                n_tr += 1
                # a liveness line that counts steps issued, without a sync
                if verbose and n_tr % 100 == 0:
                    print(f"  epoch {epoch + 1}: {n_tr} steps dispatched", flush=True)
                if self.skip_nonfinite_updates and n_tr % half == 0:
                    self._nonfinite_abort_check(weights_folder, epoch)
            te_div, te_total = zero.clone(), zero.clone()
            n_te = 0
            for batch in test_loader:
                aux = self.eval_step(batch)
                te_total += aux["total"]
                if self.monitor_divergence_in_test:
                    te_div += aux["divergence"]
                n_te += 1
            tr_nmse, tr_div, tr_total, te_div, te_total = (
                float(tr_nmse), float(tr_div), float(tr_total), float(te_div), float(te_total))
            if self.skip_nonfinite_updates:
                nf_run = int(self.nonfinite["notfinite_count"])
                nf_total = int(self.nonfinite["total_notfinite"])
                if nf_total and verbose:
                    print(f"  nonfinite updates skipped: {nf_total} total, "
                          f"{nf_run} consecutive", flush=True)
                if writer is not None and lead and nf_total:
                    writer.add_scalar("Steps skipped (nonfinite)", nf_total, epoch + 1)
                self._nonfinite_abort_check(weights_folder, epoch)

            train_loss = tr_total / max(n_tr, 1)
            test_loss = te_total / max(n_te, 1)
            if writer is not None and lead:
                writer.add_scalar("Loss/MSE Train", tr_nmse / max(n_tr, 1), epoch + 1)
                writer.add_scalar("Loss/Loss Train", train_loss, epoch + 1)
                writer.add_scalar("Loss/MSE Test", test_loss, epoch + 1)
                if self.optimize_divergence:
                    writer.add_scalar("Loss/Divergence Train", tr_div / max(n_tr, 1), epoch + 1)
                if self.monitor_divergence_in_test:
                    writer.add_scalar("Loss/Divergence test value", te_div / max(n_te, 1),
                                      epoch + 1)
                writer.flush()
            if test_loss < best_loss:
                self.save(weights_folder / BEST_CHECKPOINT, epoch + 1)
                best_loss = test_loss
                early_stopping_counter = 0
                if verbose:
                    print(f"Checkpoint saved at {weights_folder / BEST_CHECKPOINT}")
            else:
                early_stopping_counter += 1
            if verbose:
                print(f"Epoch: {epoch + 1} / {epochs}, \nTotal train Loss : {train_loss}"
                      f"\nMSE train Loss : {tr_nmse / max(n_tr, 1)} \nTest Loss : {test_loss}",
                      flush=True)
            train_losses.append(train_loss)
            test_losses.append(test_loss)
            # fresh every epoch, so an interrupted run resumes from it
            self.save(weights_folder / LAST_CHECKPOINT, epoch + 1)
        # as the JAX loop: after an early stop, numbered one past the last
        # trained epoch
        self.save(weights_folder / LAST_CHECKPOINT, epoch + 1)
        return train_losses, test_losses


def clip_by_global_norm(params: Iterable[nn.Parameter], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` on the gradients in place: each scaled
    by ``max_norm / max(norm, max_norm)``, ``norm`` the global norm of all of
    them, computed and applied on the device without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / torch.clamp(norm, min=max_norm))


def _safe_increment(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` saturating at the int32 maximum (optax's safe_increment)."""
    return torch.where(x < _INT32_MAX, x + 1, x)
