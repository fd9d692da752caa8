"""Reference PyTorch checkpoints (``.pth``) to and from the port's model:
the counterpart of ``p_div_gnn_tpu/models/torch_import.py``.

The reference checkpoints hold a plain state_dict of the reference model's
``Sequential`` blocks plus the 8 normalization scalars (the reference's
``models.py:44-63``). The mapping onto the port's ``EncodeProcessDecode``
parameters (torch ``Linear`` weights are (out, in); the port keeps the flax
layout, dense kernels (in, out)):

  node_encoder.{0,2}.<w/b>  → node_encoder.{lin0,lin1}
  node_encoder.4.<w/b>      → node_encoder.ln            (PyG LayerNorm)
  edge_encoder.*            → edge_encoder.*
  processor.edge_net.0      → processor.edge_w_u/edge_w_v/edge_w_e (+ edge_b0)
                              (concat slots [x_i, x_j, e] split row-wise)
  processor.edge_net.2      → processor.edge_lin1
  processor.edge_net.4      → processor.edge_ln
  processor.node_net.0      → processor.node_w_a/node_w_x (+ node_b0)
                              ([aggr, x])
  processor.node_net.2/4    → processor.node_lin1 / node_ln
  node_decoder.{0,2}        → node_decoder.{lin0,lin1}

The arrays go through the flax-shaped tree of ``models/params.py``, so a
``.pth`` maps onto the same weights in both packages.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.models.params import params_from_jax, params_to_jax


def _t(w: Any) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, dtype=np.float32).T)


def _a(w: Any) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


def _np(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tree_from_state_dict(sd: dict[str, np.ndarray]) -> dict[str, Any]:
    """The reference state_dict as the flax params tree."""
    L = sd["processor.edge_net.2.weight"].shape[0]

    def block(prefix: str, has_ln: bool = True) -> dict[str, Any]:
        out = {
            "lin0": {"kernel": _t(sd[f"{prefix}.0.weight"]), "bias": _a(sd[f"{prefix}.0.bias"])},
            "lin1": {"kernel": _t(sd[f"{prefix}.2.weight"]), "bias": _a(sd[f"{prefix}.2.bias"])},
        }
        if has_ln:
            out["ln"] = {"weight": _a(sd[f"{prefix}.4.weight"]),
                         "bias": _a(sd[f"{prefix}.4.bias"])}
        return out

    ew = _t(sd["processor.edge_net.0.weight"])  # (3L, L)
    nw = _t(sd["processor.node_net.0.weight"])  # (2L, L)
    processor = {
        "edge_w_u": ew[:L],
        "edge_w_v": ew[L : 2 * L],
        "edge_w_e": ew[2 * L :],
        "edge_b0": _a(sd["processor.edge_net.0.bias"]),
        "edge_lin1": {"kernel": _t(sd["processor.edge_net.2.weight"]),
                      "bias": _a(sd["processor.edge_net.2.bias"])},
        "edge_ln": {"weight": _a(sd["processor.edge_net.4.weight"]),
                    "bias": _a(sd["processor.edge_net.4.bias"])},
        "node_w_a": nw[:L],
        "node_w_x": nw[L:],
        "node_b0": _a(sd["processor.node_net.0.bias"]),
        "node_lin1": {"kernel": _t(sd["processor.node_net.2.weight"]),
                      "bias": _a(sd["processor.node_net.2.bias"])},
        "node_ln": {"weight": _a(sd["processor.node_net.4.weight"]),
                    "bias": _a(sd["processor.node_net.4.bias"])},
    }
    return {"node_encoder": block("node_encoder"), "edge_encoder": block("edge_encoder"),
            "processor": processor, "node_decoder": block("node_decoder", has_ln=False)}


def params_from_state_dict(state: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A reference state_dict (tensors or arrays) → the port's
    ``EncodeProcessDecode`` state_dict."""
    return params_from_jax(_tree_from_state_dict({k: _np(v) for k, v in state.items()}))


def state_dict_from_params(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse: the port's state_dict → the reference-layout state_dict
    (numpy arrays; ``torch.tensor`` them before ``load_state_dict``), which
    the reference implementation loads."""
    p = params_to_jax(params)["params"]

    def block(prefix: str, m: dict[str, Any], has_ln: bool = True) -> dict[str, np.ndarray]:
        out = {
            f"{prefix}.0.weight": _t(m["lin0"]["kernel"]),
            f"{prefix}.0.bias": _a(m["lin0"]["bias"]),
            f"{prefix}.2.weight": _t(m["lin1"]["kernel"]),
            f"{prefix}.2.bias": _a(m["lin1"]["bias"]),
        }
        if has_ln:
            out[f"{prefix}.4.weight"] = _a(m["ln"]["weight"])
            out[f"{prefix}.4.bias"] = _a(m["ln"]["bias"])
        return out

    proc = p["processor"]
    sd: dict[str, np.ndarray] = {}
    sd.update(block("node_encoder", p["node_encoder"]))
    sd.update(block("edge_encoder", p["edge_encoder"]))
    sd.update(block("node_decoder", p["node_decoder"], has_ln=False))
    # (3L, L) and (2L, L) in the flax (in, out) layout → torch's (out, in)
    ew = np.concatenate([_a(proc["edge_w_u"]), _a(proc["edge_w_v"]), _a(proc["edge_w_e"])])
    nw = np.concatenate([_a(proc["node_w_a"]), _a(proc["node_w_x"])])
    sd["processor.edge_net.0.weight"] = np.ascontiguousarray(ew.T)
    sd["processor.edge_net.0.bias"] = _a(proc["edge_b0"])
    sd["processor.node_net.0.weight"] = np.ascontiguousarray(nw.T)
    sd["processor.node_net.0.bias"] = _a(proc["node_b0"])
    sd.update({
        "processor.edge_net.2.weight": _t(proc["edge_lin1"]["kernel"]),
        "processor.edge_net.2.bias": _a(proc["edge_lin1"]["bias"]),
        "processor.edge_net.4.weight": _a(proc["edge_ln"]["weight"]),
        "processor.edge_net.4.bias": _a(proc["edge_ln"]["bias"]),
        "processor.node_net.2.weight": _t(proc["node_lin1"]["kernel"]),
        "processor.node_net.2.bias": _a(proc["node_lin1"]["bias"]),
        "processor.node_net.4.weight": _a(proc["node_ln"]["weight"]),
        "processor.node_net.4.bias": _a(proc["node_ln"]["bias"]),
    })
    return sd


def save_torch_checkpoint(
    path: str | Path, params: dict[str, torch.Tensor], stats: NormStats, epoch: int = 0
) -> None:
    """Write a reference-format ``.pth`` (the reference's ``models.py:44-63``
    layout) of the port's state_dict ``params`` and ``stats``."""
    ckpt: dict[str, Any] = {
        "model_state_dict": {
            k: torch.tensor(v) for k, v in state_dict_from_params(params).items()
        },
        "optimizer_state_dict": {},
        "epoch": epoch,
    }
    for k in NormStats.__dataclass_fields__:
        ckpt[k] = torch.tensor(float(getattr(stats, k)))
    torch.save(ckpt, path)


def load_torch_checkpoint(path: str | Path) -> tuple[dict[str, torch.Tensor], NormStats, int]:
    """A reference ``.pth`` → (the port's state_dict, stats, epoch)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    params = params_from_state_dict(ckpt["model_state_dict"])
    stats = NormStats.from_dict(
        {k: float(np.asarray(_np(ckpt[k]))) for k in NormStats.__dataclass_fields__})
    return params, stats, int(ckpt["epoch"])
