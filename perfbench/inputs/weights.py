"""Initial weights of P-DivGNN from the seed, made on the device in one
draw: every dense kernel and bias uniform in ±1/√fan_in (torch.nn.Linear's
default), the processor's split first layers with the fan-in of their
concatenation (3L for the edge MLP, 2L for the node MLP), every graph-LN
weight 1 and bias 0. Names and (in, out) layouts are the port's."""

from __future__ import annotations

import math

import torch

NODE_FEATURES, EDGE_FEATURES, OUT_FEATURES = 6, 1, 3


def parameter_spec(L: int) -> list[tuple[str, tuple[int, ...], float | str]]:
    """(name, shape, init): init is the uniform bound, or "ones" / "zeros"."""
    spec: list[tuple[str, tuple[int, ...], float | str]] = []

    def dense(prefix: str, n_in: int, n_out: int) -> None:
        bound = 1.0 / math.sqrt(n_in)
        spec.extend([(f"{prefix}.kernel", (n_in, n_out), bound), (f"{prefix}.bias", (n_out,), bound)])

    def ln(prefix: str) -> None:
        spec.extend([(f"{prefix}.weight", (L,), "ones"), (f"{prefix}.bias", (L,), "zeros")])

    for name, n_in in (("node_encoder", NODE_FEATURES), ("edge_encoder", EDGE_FEATURES)):
        dense(f"{name}.lin0", n_in, L)
        dense(f"{name}.lin1", L, L)
        ln(f"{name}.ln")
    edge_bound, node_bound = 1.0 / math.sqrt(3 * L), 1.0 / math.sqrt(2 * L)
    spec.extend([(f"processor.edge_w_{k}", (L, L), edge_bound) for k in "uve"])
    spec.append(("processor.edge_b0", (L,), edge_bound))
    dense("processor.edge_lin1", L, L)
    ln("processor.edge_ln")
    spec.extend([(f"processor.node_w_{k}", (L, L), node_bound) for k in "ax"])
    spec.append(("processor.node_b0", (L,), node_bound))
    dense("processor.node_lin1", L, L)
    ln("processor.node_ln")
    dense("node_decoder.lin0", L, L)
    dense("node_decoder.lin1", L, OUT_FEATURES)
    return spec


def initial_weights(L: int, seed: int, device: torch.device | str) -> dict[str, torch.Tensor]:
    """{name: fp32 tensor on ``device``} drawn from ``seed`` in one call."""
    spec = parameter_spec(L)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2 - 1
    out, at = {}, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = (draw[at:at + n] * init).reshape(shape)
        at += n
    return out
