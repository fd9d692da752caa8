"""The training step — the counterpart of the step half of
``p_div_gnn_tpu/train/loop.py`` (``Trainer``: ``init``, ``_loss_fn``,
``_train_step_impl``, ``_eval_metrics``).

The loss standardizes the target, not the prediction (the model runs with
``scale_output=False``), and is ``batch_loss``: mean per-graph NMSE plus
λ·mean divergence penalty when ``optimize_divergence``. The update is Adam
with the reference's torch defaults, which ``optax.adam`` matches: betas
(0.9, 0.999), eps 1e-8 added outside the square root, bias correction. The
epoch loop, checkpoint writing, skipping non-finite updates and data
parallelism are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from p_div_gnn_tpu_torch.graphs.container import GraphBatch, NormStats
from p_div_gnn_tpu_torch.losses import batch_loss, per_graph_divergence
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode


@dataclass
class Trainer:
    """Single-device trainer of an ``EncodeProcessDecode``. The model is
    moved to ``device`` (the card unless the caller asks for the CPU) and
    every batch, host-packed or already there, goes to it too."""

    model: EncodeProcessDecode
    stats: NormStats
    learning_rate: float = 1e-3
    divergence_penalty: float = 1.0
    optimize_divergence: bool = True
    monitor_divergence_in_test: bool = False
    device: str | torch.device = "cuda"

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)
        self.model.to(self.device)
        self.optimizer: torch.optim.Adam | None = None

    def init(self) -> torch.optim.Adam:
        """Fresh Adam state over the model's parameters."""
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        return self.optimizer

    def _target(self, batch: GraphBatch) -> torch.Tensor:
        return (batch.local_stress - self.stats.mean_local_stress) / self.stats.std_local_stress

    def loss(self, batch: GraphBatch) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(total, {"nmse", "divergence"}) of the training objective."""
        batch = batch.to(self.device)
        pred = self.model(batch, self.stats, scale_input=True, scale_output=False)
        return batch_loss(
            batch, pred, self._target(batch),
            divergence_penalty=self.divergence_penalty,
            optimize_divergence=self.optimize_divergence,
        )

    def loss_and_grads(
        self, batch: GraphBatch
    ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        """The loss terms (with "total") and the gradient of every parameter
        by name, leaving ``.grad`` set; parameters are not updated."""
        self.model.zero_grad(set_to_none=True)
        total, aux = self.loss(batch)
        total.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total"] = total.detach()
        grads = {n: p.grad for n, p in self.model.named_parameters()}
        return aux, grads

    def train_step(self, batch: GraphBatch) -> dict[str, torch.Tensor]:
        """One forward, backward and Adam update; returns the loss terms
        of the parameters before the update."""
        if self.optimizer is None:
            self.init()
        aux, _ = self.loss_and_grads(batch)
        self.optimizer.step()
        return aux

    @torch.no_grad()
    def eval_step(self, batch: GraphBatch) -> dict[str, torch.Tensor]:
        """NMSE (and the divergence when ``monitor_divergence_in_test``) of
        the current parameters, as the JAX ``_eval_metrics`` reports them."""
        batch = batch.to(self.device)
        pred = self.model(batch, self.stats, scale_input=True, scale_output=False)
        total, aux = batch_loss(batch, pred, self._target(batch), 0.0, False)
        if self.monitor_divergence_in_test:
            gmask = batch.graph_mask.to(pred.dtype)
            div_sum = (per_graph_divergence(batch, pred) * gmask).sum()
            aux["divergence"] = div_sum / torch.clamp(gmask.sum(), min=1.0)
            total = total + aux["divergence"]
        aux["total"] = total
        return aux
