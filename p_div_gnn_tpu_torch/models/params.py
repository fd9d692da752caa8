"""JAX parameters → the port's weights.

The port's parameter names are the flax tree's paths with ``/`` written as
``.`` (``processor/edge_w_u`` → ``processor.edge_w_u``,
``node_encoder/lin0/kernel`` → ``node_encoder.lin0.kernel``), and the arrays
keep the flax layout (dense kernels are (in, out)), so the mapping is a
flattening.
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
