"""Serving: a checkpoint → model on the device → per-mesh stress fields.

The counterpart of the model side of ``p_div_gnn_tpu/inference.py:36-99``
(``run_inference``): load the weights and the normalization stats, pack the
request's meshes into one batch, run the batched forward with output
un-standardisation, and slice the prediction back per mesh in each mesh's
original node order. The CSV/YAML entry point around it is not ported yet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.batching import GraphSample, pack_batch, unpack_predictions
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.train.checkpoint import load_checkpoint


class Predictor:
    """Answers requests of mesh samples with predicted local stress fields."""

    def __init__(
        self,
        checkpoint: str | Path,
        latent_size: int = 128,
        message_passing_steps: int = 10,
        scatter_impl: str = "fused3",
        stream_dtype: str = "float32",
        device: str | torch.device = "cuda",
    ):
        state_dict, self.epoch, self.stats = load_checkpoint(checkpoint)
        self.device = torch.device(device)
        self.model = EncodeProcessDecode(
            latent_size=latent_size,
            message_passing_steps=message_passing_steps,
            scatter_impl=scatter_impl,
            stream_dtype=stream_dtype,
        )
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def predict(self, samples: list[GraphSample]) -> list[np.ndarray]:
        """One (N_i, 3) stress field per sample, as the JAX inference path
        computes it (RCM-ordered batch, pair-blocked for ``"fused2"``, fp32
        model)."""
        host = pack_batch(samples, reorder="rcm", sender_view=False, div_ell=False,
                          pair_blocks=self.model.scatter_impl == "fused2")
        out = self.model(host.to(self.device), self.stats)
        return unpack_predictions(host, out.cpu().numpy())
