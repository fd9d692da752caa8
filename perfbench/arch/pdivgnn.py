"""P-DivGNN (``EncodeProcessDecode``, DOI 10.1002/nme.70193) as the
training driver (``harness/train.py``) and the yardstick see it.

Every module ``arch/<arch>.py`` keeps this contract; a configuration names
its module with the key ``"arch"`` (``harness/registry.py``):

- ``REQUIRED_KEYS``: the configuration keys the module and the driver read;
- ``draw_inputs(pool, seed)``: the targets and features over the mesh pool,
  drawn from the seed, as a dict that the driver adds to the pool, the
  seed and the loader's seed (together: ``inputs``);
- ``port_samples(inputs)``: the port's samples of the pool, in pool order;
- ``draw_weights(cfg, seed, device)``: {parameter name: fp32 tensor},
  drawn from the seed on the device, named as the port's model names them;
- ``build_program(cfg, traffic, inputs, initial, device)``: (trainer,
  loader) as the port builds them, the model loaded with the weights
  ``initial``. The trainer has ``model``, ``train_step(batch)`` returning
  the loss terms with ``"total"``, and ``optimizer``, a
  ``torch.optim.Adam`` once a step has run;
- ``reference_stats(inputs)``, ``reference_batch(inputs, ids, device)`` and
  ``reference_loss(params, batch, stats, cfg, stream)``: the plain
  reference's statistics, the batch of the pool's meshes ``ids`` and its
  loss, differentiable in ``params``;
- ``model_flops(cfg, E, N)``: (edge-stream FLOPs, other FLOPs) of one
  forward pass over E real edges and N real nodes;
- ``fault_sites()``: where ``harness/faults.py`` plants its faults, each an
  (owner, attribute) pair: ``"step"`` the trainer's step (the port's
  ``Trainer.train_step``, whose broken version takes the loss and the
  gradients by the trainer's ``loss_and_grads`` and updates nothing),
  ``"loss"`` the function that takes the batch first and returns the
  batch's loss, ``"output"`` the method that returns the model's output.
"""

from __future__ import annotations

import numpy as np

from perfbench.inputs import weights
from perfbench.reference import model as ref_model
from perfbench.reference.data import norm_stats, ref_batch

REQUIRED_KEYS = ("latent_size", "message_passing_steps", "batch_size", "scatter_impl",
                 "stream_dtype", "learning_rate", "divergence", "divergence_penalty",
                 "remat_steps")


# the magnitudes of the mean stress's components: one evenly spread set,
# the same for every seed
MEAN_STRESS = (0.5, 1.5)


def draw_inputs(pool: list[dict], seed: int) -> dict:
    """Each mesh's mean stress (3,) and stress field (N, 3), the field
    ``mean · (1 + 0.2 sin(x / 20))``, a target the model can learn.

    The 3 × len(pool) components of the mean stresses take one set of
    magnitudes, spread evenly over ``MEAN_STRESS``, in the seed's order and
    with the seed's signs. The NMSE divides each mesh's and component's
    squared error by the field's variance there, which goes with the square
    of that component: a component near nought (N(0, 1) draws one under
    1e-4 now and then) makes that one term the whole loss and the loss
    ill-conditioned in fp32, so every seed draws its magnitudes from the
    same set and none is near nought."""
    rng = np.random.default_rng([seed, 2])
    n = 3 * len(pool)
    signs = rng.choice(np.array([-1.0, 1.0]), size=n)
    means = (rng.permutation(np.linspace(*MEAN_STRESS, n)) * signs).reshape(len(pool), 3)
    targets = []
    for mesh, mean in zip(pool, means):
        field = mean[None, :] * (1.0 + 0.2 * np.sin(mesh["points"][:, :1] / 20.0))
        targets.append((mean.astype(np.float32), field.astype(np.float32)))
    return {"targets": targets}


def port_samples(inputs: dict) -> list:
    from p_div_gnn_tpu_torch.graphs.batching import GraphSample
    from p_div_gnn_tpu_torch.graphs.build import MeshGraph

    samples = []
    for mesh, (mean, field) in zip(inputs["pool"], inputs["targets"]):
        graph = MeshGraph(pos=mesh["pos"], edge_index=mesh["edge_index"],
                          edge_weight=mesh["edge_weight"], faces=mesh["faces"],
                          org_num_edges=mesh["org_num_edges"], is_periodic=True)
        samples.append(GraphSample(graph=graph, mean_stress=mean, local_stress=field,
                                   node_labels=mesh["labels"], div_data=mesh["div_data"],
                                   div_row=mesh["div_row"], div_col=mesh["div_col"]))
    return samples


def draw_weights(cfg: dict, seed: int, device) -> dict:
    return weights.initial_weights(cfg["latent_size"], seed, device)


def build_program(cfg: dict, traffic: dict, inputs: dict, initial: dict, device) -> tuple:
    """The runner's model and ``Trainer`` and a ``GraphLoader`` over the pool
    with the traffic's loader seed."""
    from p_div_gnn_tpu_torch.graphs.dataset import compute_norm_stats
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
    from p_div_gnn_tpu_torch.train.data import GraphLoader
    from p_div_gnn_tpu_torch.train.loop import Trainer

    samples = port_samples(inputs)
    model = EncodeProcessDecode(
        latent_size=cfg["latent_size"], message_passing_steps=cfg["message_passing_steps"],
        scatter_impl=cfg["scatter_impl"], stream_dtype=cfg["stream_dtype"],
        remat_steps=cfg["remat_steps"])
    model.load_state_dict(initial)
    trainer = Trainer(model=model, stats=compute_norm_stats(samples),
                      learning_rate=cfg["learning_rate"],
                      divergence_penalty=cfg["divergence_penalty"],
                      optimize_divergence=cfg["divergence"], device=device)
    trainer.init()
    loader = GraphLoader(samples, cfg["batch_size"], shuffle=True, seed=inputs["loader_seed"],
                         cache_groups=traffic["cache_groups"], sender_view=True, device=device)
    return trainer, loader


def reference_stats(inputs: dict) -> dict:
    targets = inputs["targets"]
    return norm_stats(inputs["pool"], [m for m, _ in targets], [f for _, f in targets])


def reference_batch(inputs: dict, ids, device):
    pool, targets = inputs["pool"], inputs["targets"]
    return ref_batch([pool[i] for i in ids], [targets[i][0] for i in ids],
                     [targets[i][1] for i in ids], device)


def reference_loss(params: dict, batch, stats: dict, cfg: dict, stream):
    return ref_model.loss(params, batch, stats, cfg["message_passing_steps"],
                          cfg["divergence_penalty"], stream=stream, remat=True)


def model_flops(cfg: dict, E: int, N: int) -> tuple[float, float]:
    """(edge-stream FLOPs, other FLOPs) of one forward pass: the encoders,
    per message-passing step the edge MLP (x·Wu and x·Wv once per node, per
    edge g·Wv, g·Wu, e·We and h·W2 for the message and the update) and the
    node MLP, and the decoder."""
    L, S = cfg["latent_size"], cfg["message_passing_steps"]
    stream = S * 2 * L * L * (5 * E + 2 * N)
    other = (2 * N * (6 * L + L * L) + 2 * E * (L + L * L)
             + S * 2 * 3 * L * L * N + 2 * N * (L * L + 3 * L))
    return float(stream), float(other)


def fault_sites() -> dict[str, tuple[object, str]]:
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
    from p_div_gnn_tpu_torch.train import loop

    return {"step": (loop.Trainer, "train_step"), "loss": (loop, "batch_loss"),
            "output": (EncodeProcessDecode, "forward")}
