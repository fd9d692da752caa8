"""Matmul precision policy: the counterpart of
``p_div_gnn_tpu/utils/precision.py``.

The JAX package passes an explicit precision to every matmul, named by
``PDG_MATMUL_PRECISION``: ``highest`` / ``float32`` (fp32, the default:
parity mode), ``high``, or ``default`` / ``bfloat16`` (bf16-class passes:
speed mode). Here the same names set torch's fp32 matmul precision for the
plain PyTorch products (and TF32 in cuDNN along with it):

- ``highest`` / ``float32`` → ``"highest"``: no TF32;
- ``high`` → ``"high"``: TF32 (or bf16x3) products;
- ``default`` / ``bfloat16`` → ``"medium"``: bf16 products allowed.

An unknown name raises ``KeyError``, as the JAX function does. The
hand-written kernels keep their own stream dtypes: the policy does not
reach them.
"""

from __future__ import annotations

import os

import torch

TORCH_PRECISION = {
    "highest": "highest",
    "float32": "highest",
    "high": "high",
    "default": "medium",
    "bfloat16": "medium",
}


def matmul_precision() -> str:
    """Read ``PDG_MATMUL_PRECISION`` (default ``highest``), set torch's fp32
    matmul precision to its counterpart and return that name."""
    name = os.environ.get("PDG_MATMUL_PRECISION", "highest").lower()
    precision = TORCH_PRECISION[name]
    torch.set_float32_matmul_precision(precision)
    torch.backends.cudnn.allow_tf32 = precision != "highest"
    return precision
