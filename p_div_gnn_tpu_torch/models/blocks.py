"""Building blocks: torch-Linear-initialised dense layers with flax's
(in, out) kernel layout, graph-mode LayerNorm and the MLP block — the
counterparts of ``p_div_gnn_tpu/models/blocks.py``.

Under sharding (``group``) the graph-LN statistics span every rank's rows.

Parameter names follow the flax tree (``lin0/kernel``, ``ln/weight``) so a
JAX checkpoint maps 1:1 onto the state_dict (``models/params.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from p_div_gnn_tpu_torch.ops.layernorm import masked_graph_layernorm
from p_div_gnn_tpu_torch.parallel.collectives import Group


def uniform_param(shape: tuple[int, ...], bound: float, generator: torch.Generator) -> nn.Parameter:
    """U(-bound, bound), torch.nn.Linear's default init for kernel and bias."""
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class TorchDense(nn.Module):
    """Dense layer ``x @ kernel + bias`` with kernel (in, out)."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.kernel = uniform_param((in_features, features), bound, generator)
        self.bias = uniform_param((features,), bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class GraphLayerNorm(nn.Module):
    """PyG graph-mode LayerNorm (whole-tensor stats), mask-aware."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                group: Group | None = None) -> torch.Tensor:
        return masked_graph_layernorm(x, mask, self.weight, self.bias, eps=self.eps,
                                      group=group)


class MLPBlock(nn.Module):
    """Linear→ReLU→Linear(→ReLU→graph-LN) — the reference's Sequential
    blocks (`models.py:194-208,260-274`)."""

    def __init__(
        self,
        in_features: int,
        latent_size: int,
        generator: torch.Generator,
        out_size: int | None = None,
        layer_norm: bool = True,
    ):
        super().__init__()
        out = out_size or latent_size
        self.lin0 = TorchDense(in_features, latent_size, generator)
        self.lin1 = TorchDense(latent_size, out, generator)
        self.ln = GraphLayerNorm(out) if layer_norm else None

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                group: Group | None = None) -> torch.Tensor:
        out = self.lin1(torch.relu(self.lin0(x)))
        if self.ln is None:
            return out
        if mask is None:
            raise ValueError("graph-LN needs a row mask")
        return self.ln(torch.relu(out), mask, group)
