"""The plain reference of MeshGraphNets (Pfaff et al., ICLR 2021,
arXiv:2010.03409; deepmind-research ``meshgraphnets/core_model.py`` and
``cfd_model.py``, the ``cylinder_flow`` model), written from the published
equations in plain PyTorch over the meshes' own arrays: real nodes and
edges only, no padding, no node reordering, no kernels, no program code.

- Node input ``[velocity (2), one_hot(node_type, 9)]``, edge input
  ``[p_s − p_r (2), |p_s − p_r|]``, target the velocity change; each
  normalised by its per-feature mean and std (``normalisers``).
- ``mlp``: Linear → ReLU → ... → Linear over ``layers`` linear layers, then
  ``torch.nn.functional.layer_norm`` per row (eps 1e-5), except on the
  decoder.
- A block: ``e' = MLP_e(cat[x_s, x_r, e])``; ``x' = MLP_n(cat[x, Σ_{edges
  into r} e'])`` with ``index_add_``; ``x += x'``, ``e += e'``; every block
  with its own weights.
- Loss: the mean over NORMAL (0) and OUTFLOW (5) nodes of Σ over the 2
  components of (target_normalised − output)².

Parameters are taken by the port's names (``blocks.<k>.edge_mlp.lin0.kernel``
(in, out), ``...ln.weight``), in the dtype to compute in: the benchmark
runs it in fp64 with TF32 off. With ``remat`` each block is recomputed in
the backward (``torch.utils.checkpoint``), so that it fits on the card
beside nothing else.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
STD_EPS = 1e-8  # normalization.Normalizer's std_epsilon
NORMAL, OUTFLOW = 0, 5
VELOCITY = 2  # the node input's leading velocity columns; the node type's one-hot follows


@dataclass
class MGNBatch:
    """The meshes of one batch, concatenated in their own node order."""

    node_inputs: torch.Tensor  # (N, 11) raw [velocity, one-hot node type]
    pos: torch.Tensor  # (N, 2) mesh positions
    senders: torch.Tensor  # (E,) i64
    receivers: torch.Tensor  # (E,) i64
    targets: torch.Tensor  # (N, 2) raw velocity change


def edge_inputs(pos: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor) -> torch.Tensor:
    """(E, 3) ``[p_s − p_r, |p_s − p_r|]``."""
    rel = pos[senders] - pos[receivers]
    return torch.cat([rel, rel.norm(dim=-1, keepdim=True)], dim=-1)


def normalisers(node_inputs: list[torch.Tensor], edge_feats: list[torch.Tensor],
                targets: list[torch.Tensor]) -> dict[str, torch.Tensor]:
    """Per-feature mean and std (biased, at least ``STD_EPS``) of the node
    inputs, edge features and targets over the given meshes, in fp64."""
    out = {}
    for key, parts in (("node", node_inputs), ("edge", edge_feats), ("target", targets)):
        x = torch.cat([p.double() for p in parts])
        out[f"{key}_mean"] = x.mean(0)
        out[f"{key}_std"] = x.std(0, unbiased=False).clamp(min=STD_EPS)
    return out


def mlp(p: dict, prefix: str, x: torch.Tensor, layers: int, layer_norm: bool) -> torch.Tensor:
    for i in range(layers):
        x = x @ p[f"{prefix}.lin{i}.kernel"] + p[f"{prefix}.lin{i}.bias"]
        if i < layers - 1:
            x = torch.relu(x)
    if not layer_norm:
        return x
    return F.layer_norm(x, (x.shape[-1],), p[f"{prefix}.ln.weight"], p[f"{prefix}.ln.bias"],
                        LN_EPS)


def block(p: dict, k: int, layers: int, x: torch.Tensor, e: torch.Tensor,
          senders: torch.Tensor, receivers: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    e_new = mlp(p, f"blocks.{k}.edge_mlp", torch.cat([x[senders], x[receivers], e], dim=-1),
                layers, True)
    summed = torch.zeros_like(x).index_add_(0, receivers, e_new)
    x_new = mlp(p, f"blocks.{k}.node_mlp", torch.cat([x, summed], dim=-1), layers, True)
    return x + x_new, e + e_new


def forward(p: dict, batch: MGNBatch, stats: dict, blocks: int, hidden_layers: int = 2,
            remat: bool = False) -> torch.Tensor:
    """(N, 2) normalised velocity change."""
    dt = p["decoder.lin0.kernel"].dtype
    layers = hidden_layers + 1
    s = {k: v.to(dt) for k, v in stats.items()}
    x_in = (batch.node_inputs.to(dt) - s["node_mean"]) / s["node_std"]
    e_in = (edge_inputs(batch.pos.to(dt), batch.senders, batch.receivers)
            - s["edge_mean"]) / s["edge_std"]
    x = mlp(p, "node_encoder", x_in, layers, True)
    e = mlp(p, "edge_encoder", e_in, layers, True)
    for k in range(blocks):
        args = (p, k, layers, x, e, batch.senders, batch.receivers)
        if remat and torch.is_grad_enabled():
            x, e = checkpoint(block, *args, use_reentrant=False)
        else:
            x, e = block(*args)
    return mlp(p, "decoder", x, layers, False)


def loss(p: dict, batch: MGNBatch, stats: dict, blocks: int, hidden_layers: int = 2,
         remat: bool = False) -> torch.Tensor:
    """The mean over the NORMAL and OUTFLOW nodes of the squared error of
    the normalised target, summed over its components."""
    out = forward(p, batch, stats, blocks, hidden_layers, remat)
    dt = out.dtype
    target = (batch.targets.to(dt) - stats["target_mean"].to(dt)) / stats["target_std"].to(dt)
    types = batch.node_inputs[:, VELOCITY:]
    mask = (types[:, NORMAL] > 0) | (types[:, OUTFLOW] > 0)
    return ((target - out) ** 2).sum(-1)[mask].mean()
