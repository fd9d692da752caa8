"""Faults planted in the program, to show that the comparison catches them
(``calibrate.py`` reads them on the card, ``tests/`` on the CPU), each at
the site that the architecture's module names (``fault_sites()``):

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

from perfbench.harness import registry

# each fault and the architecture's site it goes to
SITES = {"state_unchanged": "step", "half_batch": "loss", "answer_altered": "output"}
FAULTS = tuple(SITES)


@contextlib.contextmanager
def planted(name: str, arch: str):
    """Plant the fault ``name`` at its site of the architecture ``arch``
    (``fault_sites()`` of ``arch/<arch>.py``) for the block's duration."""
    if name not in SITES:
        raise ValueError(f"unknown fault {name!r}; faults: {FAULTS}")
    target, attr = registry.arch(arch).fault_sites()[SITES[name]]
    orig = getattr(target, attr)
    if name == "state_unchanged":
        def broken(self, batch):
            if self.optimizer is None:
                self.init()
            aux, _ = self.loss_and_grads(batch)
            return aux
    elif name == "half_batch":
        def broken(batch, *args, **kwargs):
            keep = torch.arange(batch.n_graphs, device=batch.graph_node_count.device)
            half = dataclasses.replace(batch, graph_node_count=torch.where(
                keep < batch.n_graphs // 2, batch.graph_node_count,
                torch.zeros_like(batch.graph_node_count)))
            return orig(half, *args, **kwargs)
    else:
        def broken(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            scale = torch.ones_like(out)
            scale[:64] = 1.5
            return out * scale
    setattr(target, attr, broken)
    try:
        yield
    finally:
        setattr(target, attr, orig)
