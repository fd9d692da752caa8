"""Faults planted in the program, to show that the comparison catches them
(``calibrate.py`` reads them on the card, ``tests/`` on the CPU):

- ``state_unchanged``: the training step leaves the parameters and Adam's
  state as they were;
- ``half_batch``: the loss leaves out the second half of the batch's
  graphs and takes the mean over the rest;
- ``answer_altered``: the model's output is changed where it is made (the
  first 64 rows scaled by 1.5).

One card runs no exchange between cards, so that fault has no place here.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def planted(name: str):
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
    from p_div_gnn_tpu_torch.train import loop

    if name == "state_unchanged":
        target, attr = loop.Trainer, "train_step"
        orig = loop.Trainer.train_step

        def broken(self, batch):
            if self.optimizer is None:
                self.init()
            aux, _ = self.loss_and_grads(batch)
            return aux
    elif name == "half_batch":
        target, attr = loop, "batch_loss"
        orig = loop.batch_loss

        def broken(batch, *args, **kwargs):
            keep = torch.arange(batch.n_graphs, device=batch.graph_node_count.device)
            half = dataclasses.replace(batch, graph_node_count=torch.where(
                keep < batch.n_graphs // 2, batch.graph_node_count,
                torch.zeros_like(batch.graph_node_count)))
            return orig(half, *args, **kwargs)
    elif name == "answer_altered":
        target, attr = EncodeProcessDecode, "forward"
        orig = EncodeProcessDecode.forward

        def broken(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            scale = torch.ones_like(out)
            scale[:64] = 1.5
            return out * scale
    else:
        raise ValueError(f"unknown fault {name!r}; faults: {FAULTS}")
    setattr(target, attr, broken)
    try:
        yield
    finally:
        setattr(target, attr, orig)
