"""JAX parameters ↔ the port's weights.

The port's parameter names are the flax tree's paths with ``/`` written as
``.`` (``processor/edge_w_u`` → ``processor.edge_w_u``,
``node_encoder/lin0/kernel`` → ``node_encoder.lin0.kernel``), and the arrays
keep the flax layout (dense kernels are (in, out)), so the mapping is a
flattening, and ``params_to_jax`` is its inverse: it lays any per-parameter
tensors of the port (weights, gradients, optimizer moments) out as a flax
tree, so tests compare them with the JAX package's leaf by leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(tree: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Flatten a flax params tree of numpy arrays (with or without its
    top-level ``"params"`` key) into an ``EncodeProcessDecode`` state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node: dict[str, Any], prefix: str) -> None:
        for key, value in node.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                walk(value, name + ".")
            else:
                out[name] = torch.from_numpy(np.array(value, dtype=np.float32))

    walk(tree, "")
    return out


def jax_path(name: str) -> tuple[str, ...]:
    """The flax path of a port parameter: ``processor.edge_w_u`` →
    ``("params", "processor", "edge_w_u")``."""
    return ("params",) + tuple(name.split("."))


def params_to_jax(tensors: dict[str, torch.Tensor]) -> dict[str, Any]:
    """Nest ``{port name: tensor}`` (a state_dict, or gradients keyed by
    parameter name) into a flax-shaped tree of fp32 numpy arrays with its
    top-level ``"params"`` key."""
    tree: dict[str, Any] = {}
    for name, value in tensors.items():
        *parents, leaf = jax_path(name)
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().cpu().float().numpy()
    return tree
