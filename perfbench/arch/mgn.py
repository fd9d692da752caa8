"""MeshGraphNets (Pfaff et al., ICLR 2021, arXiv:2010.03409; the
``cylinder_flow`` model of deepmind-research ``meshgraphnets/``) as the
training harness (``harness/train.py``) and the yardstick see it. The
contract is ``arch/pdivgnn.py``'s docstring. (The module is ``mgn``: the
seam test takes ``arch/meshgraphnets.py`` as its example of an absent
module.)

The inputs are drawn over the pool's plate-with-hole meshes in place of
``cylinder_flow``'s trajectories: the graph is both directions of every
triangle side (no periodic links); the node types follow the plate's
sides (``node_types``); the velocity and its change are smooth fields of
the positions whose magnitudes and phases come from the seed, with the
source's training noise (σ 0.02 on NORMAL nodes, ``noise_gamma`` 1)
drawn once with them (``draw_inputs``). Positions, inputs and targets are
stored in fp32, as the source's dataset stores them; the program and the
reference read the same values.

The port's model is imported with this module, when the configuration is
read: a checkout whose port lacks it stops there, before the pool is read.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.batching import NodeFieldSample
from p_div_gnn_tpu_torch.graphs.build import MeshGraph
from p_div_gnn_tpu_torch.models import meshgraphnets as mgn
from p_div_gnn_tpu_torch.train import loop
from p_div_gnn_tpu_torch.train.data import GraphLoader

from perfbench.inputs.graph import INTERNAL_BOUNDARY, edge_distances, faces_to_edge_index
from perfbench.reference import meshgraphnets as ref

REQUIRED_KEYS = ("latent_size", "message_passing_steps", "hidden_layers", "node_inputs",
                 "edge_inputs", "outputs", "batch_size", "stream_dtype", "learning_rate",
                 "remat_steps")

# common.NodeType
NORMAL, OBSTACLE, INFLOW, OUTFLOW, WALL_BOUNDARY, NODE_TYPES = 0, 1, 4, 5, 6, 9
# the inflow speeds' magnitudes: one evenly spread set, the same for every seed
INFLOW_SPEED = (0.5, 1.5)
NOISE_SCALE = 0.02  # cylinder_flow's noise on the input velocity of NORMAL nodes
CHANGE_SCALE = 0.05  # the velocity change's amplitude, against the inflow speed


def node_types(mesh: dict) -> np.ndarray:
    """Each node's type: the hole's boundary OBSTACLE, x = min INFLOW, x =
    max OUTFLOW, y = min or max WALL_BOUNDARY (the corners too), the rest
    NORMAL."""
    x, y = mesh["points"][:, 0], mesh["points"][:, 1]
    types = np.full(len(x), NORMAL, np.int64)
    types[mesh["labels"] == INTERNAL_BOUNDARY] = OBSTACLE
    types[x == x.min()] = INFLOW
    types[x == x.max()] = OUTFLOW
    types[(y == y.min()) | (y == y.max())] = WALL_BOUNDARY
    return types


def draw_inputs(pool: list[dict], seed: int) -> dict:
    """Per mesh: the edge index, the node inputs ``[velocity, one_hot(type)]``
    (N, 11) and the targets, the velocity change (N, 2), in fp32.

    With H the plate's height and U the mesh's inflow speed (the pool's
    speeds one set spread evenly over ``INFLOW_SPEED``, in the seed's
    order), the clean velocity is ``u = U·4y(H − y)/H²·(1 + 0.2 sin(x/20 +
    φ1))``, ``v = 0.2·U·sin(πy/H)·sin(x/15 + φ2)``, zero on the obstacle, and
    its change ``0.05·U·(4y(H − y)/H²·sin(x/20 + φ3), cos(y/20 + φ4))``, the
    phases uniform from the seed. The input adds the noise on NORMAL nodes
    and the target takes it off again, as the source's training does.
    Every component's spread over the pool stays away from nought."""
    rng = np.random.default_rng([seed, 3])
    speeds = rng.permutation(np.linspace(*INFLOW_SPEED, len(pool)))
    out = {"edge_index": [], "node_inputs": [], "node_targets": []}
    for mesh, speed in zip(pool, speeds):
        pos = mesh["points"][:, :2].astype(np.float32).astype(np.float64)
        x, y = pos[:, 0], pos[:, 1]
        height = y.max() - y.min()
        profile = 4 * (y - y.min()) * (y.max() - y) / height**2
        phase = rng.uniform(0.0, 2 * np.pi, size=4)
        velocity = speed * np.stack([profile * (1 + 0.2 * np.sin(x / 20 + phase[0])),
                                     0.2 * np.sin(np.pi * (y - y.min()) / height)
                                     * np.sin(x / 15 + phase[1])], axis=1)
        types = node_types(mesh)
        velocity[types == OBSTACLE] = 0.0
        change = CHANGE_SCALE * speed * np.stack([profile * np.sin(x / 20 + phase[2]),
                                                  np.cos(y / 20 + phase[3])], axis=1)
        noise = rng.normal(0.0, NOISE_SCALE, size=velocity.shape) * (types == NORMAL)[:, None]
        inputs = np.concatenate([velocity + noise, np.eye(NODE_TYPES)[types]], axis=1)
        out["edge_index"].append(faces_to_edge_index(mesh["faces"], len(pos)))
        out["node_inputs"].append(inputs.astype(np.float32))
        out["node_targets"].append((change - noise).astype(np.float32))
    return out


def _positions(mesh: dict) -> np.ndarray:
    return mesh["points"][:, :2].astype(np.float32)


def port_samples(inputs: dict) -> list:
    samples = []
    for mesh, ei, node_in, target in zip(inputs["pool"], inputs["edge_index"],
                                         inputs["node_inputs"], inputs["node_targets"]):
        pos, n = _positions(mesh), len(node_in)
        graph = MeshGraph(pos=pos, edge_index=ei, edge_weight=edge_distances(pos, ei),
                          faces=mesh["faces"], org_num_edges=int(ei.shape[1]))
        samples.append(NodeFieldSample(
            graph=graph, mean_stress=np.zeros(3, np.float32),
            local_stress=np.zeros((n, 3), np.float32), node_labels=mesh["labels"],
            div_data=np.zeros(0, np.float32), div_row=np.zeros(0, np.int64),
            div_col=np.zeros(0, np.int64), node_inputs=node_in, node_targets=target))
    return samples


def parameter_spec(cfg: dict) -> list[tuple[str, tuple[int, int] | tuple[int], int | str]]:
    """(name, shape, init) of every parameter, named as the port names them:
    init is a kernel's fan-in, or "ones" / "zeros"."""
    L, layers = cfg["latent_size"], cfg["hidden_layers"]
    spec: list = []

    def mlp(prefix: str, n_in: int, out: int, layer_norm: bool = True) -> None:
        widths = [L] * layers + [out]
        for i, (fan, width) in enumerate(zip([n_in] + widths, widths)):
            spec.extend([(f"{prefix}.lin{i}.kernel", (fan, width), fan),
                         (f"{prefix}.lin{i}.bias", (width,), "zeros")])
        if layer_norm:
            spec.extend([(f"{prefix}.ln.weight", (out,), "ones"),
                         (f"{prefix}.ln.bias", (out,), "zeros")])

    mlp("node_encoder", cfg["node_inputs"], L)
    mlp("edge_encoder", cfg["edge_inputs"], L)
    for k in range(cfg["message_passing_steps"]):
        mlp(f"blocks.{k}.edge_mlp", 3 * L, L)
        mlp(f"blocks.{k}.node_mlp", 2 * L, L)
    mlp("decoder", L, cfg["outputs"], layer_norm=False)
    return spec


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """Sonnet's init from the seed, on the device, in one draw: every
    kernel truncated normal (±2 σ) with σ = 1/√fan_in, biases 0, LayerNorm
    scale 1 and offset 0."""
    spec = parameter_spec(cfg)
    total = sum(math.prod(shape) for _, shape, init in spec if isinstance(init, int))
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.nn.init.trunc_normal_(torch.empty(total, device=device), 0.0, 1.0, -2.0, 2.0,
                                       generator=gen)
    out, at = {}, 0
    for name, shape, init in spec:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = (draw[at:at + n] / math.sqrt(init)).reshape(shape)
            at += n
    return out


def build_program(cfg: dict, traffic: dict, inputs: dict, initial: dict, device) -> tuple:
    """The port's ``MeshGraphNets`` with the pool's fixed normalisers, a
    ``Trainer`` on its objective, and a ``GraphLoader`` over the pool with
    the traffic's loader seed."""
    if cfg["edge_inputs"] != mgn.EDGE_FEATURES or cfg["remat_steps"]:
        raise ValueError("MeshGraphNets takes 3 edge inputs and runs without remat")
    if cfg["stream_dtype"] != "float32":
        raise ValueError("MeshGraphNets runs its streams in float32")
    samples = port_samples(inputs)
    model = mgn.MeshGraphNets(
        latent_size=cfg["latent_size"], message_passing_steps=cfg["message_passing_steps"],
        hidden_layers=cfg["hidden_layers"], node_features=cfg["node_inputs"],
        out_features=cfg["outputs"], stats=mgn.compute_mgn_stats(samples))
    model.load_state_dict(initial)
    trainer = loop.Trainer(model=model, learning_rate=cfg["learning_rate"],
                           objective=mgn.objective, device=device)
    trainer.init()
    loader = GraphLoader(samples, cfg["batch_size"], shuffle=True, seed=inputs["loader_seed"],
                         cache_groups=traffic["cache_groups"], sender_view=True, device=device)
    return trainer, loader


def _edge_features(inputs: dict) -> list[torch.Tensor]:
    return [ref.edge_inputs(torch.as_tensor(_positions(m)).double(), *torch.as_tensor(ei))
            for m, ei in zip(inputs["pool"], inputs["edge_index"])]


def reference_stats(inputs: dict) -> dict:
    return ref.normalisers([torch.as_tensor(a) for a in inputs["node_inputs"]],
                           _edge_features(inputs),
                           [torch.as_tensor(a) for a in inputs["node_targets"]])


def reference_batch(inputs: dict, ids, device):
    """The meshes ``ids`` concatenated in their own node order."""
    node_in, pos, snd, rcv, tgt = [], [], [], [], []
    off = 0
    for i in ids:
        ei = inputs["edge_index"][i]
        node_in.append(inputs["node_inputs"][i])
        pos.append(_positions(inputs["pool"][i]))
        snd.append(ei[0] + off)
        rcv.append(ei[1] + off)
        tgt.append(inputs["node_targets"][i])
        off += len(inputs["node_inputs"][i])

    def t(parts: list) -> torch.Tensor:
        return torch.as_tensor(np.concatenate(parts), device=device)

    return ref.MGNBatch(node_inputs=t(node_in).double(), pos=t(pos).double(),
                        senders=t(snd).long(), receivers=t(rcv).long(),
                        targets=t(tgt).double())


def reference_loss(params: dict, batch, stats: dict, cfg: dict, stream):
    if stream is not None:
        raise ValueError("the MeshGraphNets reference has no stream rounding")
    return ref.loss(params, batch, {k: v.to(batch.pos.device) for k, v in stats.items()},
                    cfg["message_passing_steps"], cfg["hidden_layers"], remat=True)


def model_flops(cfg: dict, E: int, N: int) -> tuple[float, float]:
    """(edge-stream FLOPs, other FLOPs) of one forward pass in the published
    concat form, whatever the program computes: per block the edge MLP over
    ``[x_s, x_r, e]`` (3L·L + L·L + L·L a real edge) and the node MLP over
    ``[x, Σ e']`` (2L·L + L·L + L·L a real node); the encoders and the
    decoder besides."""
    L, S, h = cfg["latent_size"], cfg["message_passing_steps"], cfg["hidden_layers"]

    def mlp(n_in: int, out: int) -> int:
        widths = [L] * h + [out]
        return 2 * sum(a * b for a, b in zip([n_in] + widths, widths))

    stream = S * E * mlp(3 * L, L)
    other = (S * N * mlp(2 * L, L) + N * mlp(cfg["node_inputs"], L)
             + E * mlp(cfg["edge_inputs"], L) + N * mlp(L, cfg["outputs"]))
    return float(stream), float(other)


def fault_sites() -> dict[str, tuple[object, str]]:
    return {"step": (loop.Trainer, "train_step"), "loss": (mgn, "mgn_loss"),
            "output": (mgn.MeshGraphNets, "forward")}
