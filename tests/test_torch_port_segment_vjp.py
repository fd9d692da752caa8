"""Which paths put a -1 slot under a differentiated segment sum.

The JAX package's block-CSR segment sum (``pallas_segment_sum``) has a VJP
that gathers the cotangent at each slot's segment id
(``p_div_gnn_tpu/ops/scatter_pallas.py:162-164``): a -1 id wraps to the last
node there, where the port's counterpart gives the slot 0. The VJP runs only
where first-order training differentiates the sum itself. These tests spy on
that VJP while the JAX package takes a training gradient of each impl that
calls the sum (in Pallas interpret mode, as its own tests run it): the
``"pallas"`` receiver scatter differentiates it, over the receiver-major
layout, whose ids are never -1; the sender-side sums of ``"hybrid"``,
``"fused3"``, ``"fused"`` and ``"fused2"`` run inside VJP rules (a gradient
of a gradient would differentiate them) and are never differentiated in
training, though their ids (the sender view) hold -1 padding. So no -1 slot
reaches the VJP in training, and the port's 0 differs from nothing a
training run computes."""

import jax
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.ops import scatter_pallas
from p_div_gnn_tpu.train.loop import Trainer as JaxTrainer

from test_torch_port_fused2 import _batches as _pair_batches
from test_torch_port_model import STATS, _batches


@pytest.fixture(scope="module")
def batches():
    return {"receiver-major": _batches((0, 1), n_graphs=3)[2],
            "pair-blocked": _pair_batches((0, 1), n_graphs=3)[2],
            # two node tiles: a sender view with -1 padding slots
            "two tiles": _batches((0, 1, 2), n_graphs=4)[2]}


@pytest.mark.parametrize("impl,differentiated", [
    ("pallas", True), ("hybrid", False), ("fused3", False), ("fused", False),
    ("fused2", False)])
def test_no_minus_one_slot_under_a_differentiated_segment_sum(batches, monkeypatch, impl,
                                                              differentiated):
    batch = batches["pair-blocked" if impl == "fused2" else "receiver-major"]
    assert int(np.asarray(batch.receivers).min()) >= 0
    assert int(np.asarray(batches["two tiles"].snd_sorted).min()) == -1
    seen = []
    vjp = scatter_pallas.pallas_segment_sum.bwd

    def spy(num_nodes, segment_ids, g):
        jax.debug.callback(lambda ids: seen.append(int(np.min(ids))), segment_ids)
        return vjp(num_nodes, segment_ids, g)

    monkeypatch.setattr(scatter_pallas.pallas_segment_sum, "bwd", spy)
    model = JaxEPD(latent_size=16, message_passing_steps=2, scatter_impl=impl,
                   remat_steps=False)
    stats = JaxNormStats.from_dict(STATS)
    trainer = JaxTrainer(model=model, stats=stats, divergence_penalty=10.0)
    params = JaxEPD(latent_size=16, message_passing_steps=2).init(
        jax.random.PRNGKey(0), batch, stats)
    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(lambda p: trainer._loss_fn(p, batch)[0])(params)
        jax.block_until_ready(grads)
    jax.effects_barrier()
    assert bool(seen) == differentiated
    assert all(m >= 0 for m in seen), seen
