"""The plain reference of P-DivGNN (Encode-Process-Decode, the paper's
model, DOI 10.1002/nme.70193): its forward pass, its loss (per-graph NMSE
plus the weighted divergence penalty), its gradients by autograd and Adam,
in plain PyTorch over the meshes' own arrays: no padding, no node
reordering, no kernels, no program code.

- Node features ``[σ̄xx, σ̄yy, σ̄xy, pos_x, pos_y, node_type]``, edge
  feature the node distance (0 on periodic links), each standardised by
  the scalar statistics.
- Encoders ``Linear → ReLU → Linear → ReLU → graph-LN``; one processor
  shared by every message-passing step; decoder ``Linear → ReLU →
  Linear``. Graph-LN is PyG's graph mode: the mean and the biased std of
  the whole (rows × channels) tensor, eps added to the std.
- A step: the message of edge (s → r) is ``MLP([x_r, x_s, e])`` and the
  edge update ``MLP([x_s, x_r, e])``, one MLP ``Linear(3L → L) → ReLU →
  Linear → ReLU``, each output graph-LN'ed with its own statistics and the
  one affine; ``x += LN(MLP([Σ messages into r, x_r]))``, ``e += LN(update)``.
- A batch whose macroscopic stress is all zero gives a zero field.

``stream`` names the precision of the configuration's edge streams: the
operands of the edge MLP (node rows, edge rows, its weights, the hidden
activation) and the edge outputs that are stored or summed are rounded to
it where the configuration rounds them; ``None`` keeps every value in
``dtype``. Rounding passes the gradient through unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
ADAM = (0.9, 0.999, 1e-8)


@dataclass
class RefBatch:
    """The meshes of one batch, concatenated in their own node order."""

    x_in: torch.Tensor  # (N, 6) raw node features
    senders: torch.Tensor  # (E,) i64
    receivers: torch.Tensor  # (E,) i64
    edge_w: torch.Tensor  # (E, 1) raw distances
    node_gid: torch.Tensor  # (N,) i64
    n_graphs: int
    node_type: torch.Tensor  # (N,) in {-1, 0, 1}
    div_row: torch.Tensor  # (K,) i64 node of the divergence row
    div_src: torch.Tensor  # (K,) i64 node of the column
    div_isy: torch.Tensor  # (K,) bool: column is a y dof
    div_val: torch.Tensor  # (K,) operator entries
    target: torch.Tensor | None  # (N, 3) raw stress field


def _rounder(stream: torch.dtype | None):
    if stream is None:
        return lambda t: t

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t + (t.to(stream).to(t.dtype) - t).detach()

    return rnd


def graph_layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mean = x.mean()
    std = ((x - mean) ** 2).mean().sqrt()
    return (x - mean) / (std + LN_EPS) * w + b


def _mlp(p: dict, prefix: str, x: torch.Tensor, ln: bool) -> torch.Tensor:
    h = torch.relu(x @ p[f"{prefix}.lin0.kernel"] + p[f"{prefix}.lin0.bias"])
    out = h @ p[f"{prefix}.lin1.kernel"] + p[f"{prefix}.lin1.bias"]
    if not ln:
        return out
    return graph_layernorm(torch.relu(out), p[f"{prefix}.ln.weight"], p[f"{prefix}.ln.bias"])


def _step(p: dict, rnd, x: torch.Tensor, e: torch.Tensor, batch: RefBatch,
          deg: torch.Tensor):
    s, r = batch.senders, batch.receivers
    q = "processor."
    wu, wv, we, b0 = (rnd(p[q + k]) for k in ("edge_w_u", "edge_w_v", "edge_w_e", "edge_b0"))
    w2, b2 = rnd(p[q + "edge_lin1.kernel"]), rnd(p[q + "edge_lin1.bias"])
    xs, es = rnd(x), rnd(e)
    pu, pv, ep = xs @ wu, xs @ wv, es @ we

    def tail(pre: torch.Tensor) -> torch.Tensor:
        return torch.relu(rnd(torch.relu(pre)) @ w2 + b2)

    z_msg = tail(pu[r] + pv[s] + ep + b0)
    z_upd = tail(pv[r] + pu[s] + ep + b0)
    ln_w, ln_b = p[q + "edge_ln.weight"], p[q + "edge_ln.bias"]

    def affine(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        mean = z.mean()
        std = ((z - mean) ** 2).mean().sqrt()
        alpha = ln_w / (std + LN_EPS)
        return alpha, ln_b - mean * alpha

    a1, b1 = affine(z_msg)
    a2, b2_ = affine(z_upd)
    summed = torch.zeros_like(x).index_add_(0, r, rnd(z_msg))
    aggr = summed * a1 + deg * b1  # Σ over the edges into r of LN(message)
    new_e = rnd(z_upd) * a2 + b2_
    node_h = torch.relu(aggr @ p[q + "node_w_a"] + x @ p[q + "node_w_x"] + p[q + "node_b0"])
    node_out = torch.relu(node_h @ p[q + "node_lin1.kernel"] + p[q + "node_lin1.bias"])
    new_x = graph_layernorm(node_out, p[q + "node_ln.weight"], p[q + "node_ln.bias"])
    return new_x + x, new_e + e


def forward(p: dict, batch: RefBatch, stats: dict, steps: int, scale_output: bool,
            stream: torch.dtype | None = None, remat: bool = False) -> torch.Tensor:
    """(N, 3) stress field; standardised unless ``scale_output``. ``p``
    holds the parameters by the port's names, in the dtype to compute in."""
    dt = p["processor.edge_w_u"].dtype
    rnd = _rounder(stream)
    x_in = batch.x_in.to(dt)
    ms = (x_in[:, :3] - stats["mean_mean_stress"]) / stats["std_mean_stress"]
    pos = (x_in[:, 3:5] - stats["mean_pos"]) / stats["std_pos"]
    e_in = (batch.edge_w.to(dt) - stats["mean_edge_weight"]) / stats["std_edge_weight"]
    x = _mlp(p, "node_encoder", torch.cat([ms, pos, x_in[:, 5:6]], dim=-1), ln=True)
    e = _mlp(p, "edge_encoder", e_in, ln=True)
    deg = torch.zeros((x.shape[0], 1), dtype=dt, device=x.device).index_add_(
        0, batch.receivers, torch.ones((batch.receivers.shape[0], 1), dtype=dt,
                                       device=x.device))
    for _ in range(steps):
        if remat and torch.is_grad_enabled():
            x, e = checkpoint(_step, p, rnd, x, e, batch, deg, use_reentrant=False)
        else:
            x, e = _step(p, rnd, x, e, batch, deg)
    out = _mlp(p, "node_decoder", x, ln=False)
    if scale_output:
        out = out * stats["std_local_stress"] + stats["mean_local_stress"]
    if not bool((batch.x_in[:, :3] != 0).any()):
        out = torch.zeros_like(out)
    return out


def _per_graph(values: torch.Tensor, batch: RefBatch) -> torch.Tensor:
    return torch.zeros((batch.n_graphs,) + values.shape[1:], dtype=values.dtype,
                       device=values.device).index_add_(0, batch.node_gid, values)


def loss(p: dict, batch: RefBatch, stats: dict, steps: int, divergence_penalty: float,
         stream: torch.dtype | None = None, remat: bool = False) -> torch.Tensor:
    """Mean over the graphs of the NMSE of the standardised field, plus
    ``divergence_penalty`` times the mean over the graphs of
    ``Σ_c mean_n(div_c²)``, the divergence of the predicted (standardised)
    field zeroed on both boundaries, averaged over all the graph's nodes."""
    pred = forward(p, batch, stats, steps, scale_output=False, stream=stream, remat=remat)
    dt = pred.dtype
    gt = (batch.target.to(dt) - stats["mean_local_stress"]) / stats["std_local_stress"]
    count = _per_graph(torch.ones((gt.shape[0], 1), dtype=dt, device=gt.device), batch)
    mean_gt = _per_graph(gt, batch) / count
    num = _per_graph((gt - pred) ** 2, batch)
    den = _per_graph((gt - mean_gt[batch.node_gid]) ** 2, batch)
    nmse = (num / torch.where(den == 0, torch.ones_like(den), den)).mean(-1)
    src = pred[batch.div_src]
    v0 = torch.where(batch.div_isy, src[:, 2], src[:, 0])
    v1 = torch.where(batch.div_isy, src[:, 1], src[:, 2])
    div = torch.zeros((pred.shape[0], 2), dtype=dt, device=pred.device).index_add_(
        0, batch.div_row, batch.div_val.to(dt)[:, None] * torch.stack([v0, v1], dim=-1))
    div = torch.where((batch.node_type == 0)[:, None], div, torch.zeros_like(div))
    div_pen = _per_graph(div * div, batch).sum(-1) / count[:, 0]
    return nmse.mean() + divergence_penalty * div_pen.mean()


def adam_update(p: dict, grads: dict, state: dict, lr: float) -> None:
    """One Adam step in place (betas 0.9 / 0.999, eps 1e-8 outside the
    square root, bias correction), ``state`` {name: (m, v)} and ``"t"``."""
    b1, b2, eps = ADAM
    t = state.get("t", 0) + 1
    state["t"] = t
    with torch.no_grad():
        for name, g in grads.items():
            m, v = state.get(name, (torch.zeros_like(g), torch.zeros_like(g)))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            state[name] = (m, v)
            denom = (v / (1 - b2**t)).sqrt() + eps
            p[name] -= lr / (1 - b1**t) * m / denom
