"""The edge update of an interaction network, one step's edge MLP over an
edge set's live slots as one differentiable function: MeshGraphNets'
(``models/meshgraphnets.py``) and GraphCast's (``models/graphcast.py``).
It has no counterpart in the JAX package.

For each slot r < n, with the node projections ``p_s = x_s·W_s`` of the
sender set's rows and ``p_r = x_r·W_r`` of the receiver set's
(torch.matmul, before the call; the two sets may be one), the activation
``act`` (ReLU or SiLU) and the MLP's later layers ``layers = (W1, b1, ...,
Wk, bk)``:

    h0 = p_s[senders[r]] + p_r[receivers[r]] + e[r]·W_e + b0
    a(i-1) = act(h(i-1));  h(i) = a(i-1)·Wi + bi  (i = 1..k);  y = h(k)
    e' = LayerNorm(y; gamma, beta, eps 1e-5) · mask[r]

``edge_update`` returns ``(e', e + e')``. CUDA tensors run its forward as
one hand-written kernel (``csrc/mgn_edge_fwd.cu``, counted in
``cuda_build.launches["mgn_edge_fwd"]`` and, while a profiler session is
open, in the counter ``mgn.edge_fused_rows``, n a call); it takes
MeshGraphNets' published MLP (k = 2 hidden layers, ReLU) at L = 128 over
one node set, fp32, contiguous 16-byte-aligned tensors, and raises on
anything else. CPU tensors run the plain composition
``edge_update_reference``, the very operations autograd ran before the
kernel. There is no fallback from one to the other. ``plain_edge_update``
takes the same arguments and runs the plain composition on either device,
at any width, depth and activation, for two node sets of their own sizes:
the route of a model whose MLP the kernel was not built for (GraphCast's
L = 512 SiLU MLP), chosen by that model.

The backward is plain PyTorch on both routes, the ATen operations autograd
runs for the composition, on what the forward saved: for ReLU ``a0`` ..
``a(k-1)``, for SiLU the pre-activations ``h0`` .. ``h(k-1)`` (each ``a``
computed again from its ``h``, one pass, in place of keeping both), ``y``
and y's row mean and rstd (the kernel writes them), ``e`` and the weights;
it releases each of those activations once used, as autograd releases a
node's saved tensors, so the step's peak memory stays where it was. The
sender rows' gradient is the segment sum (#3) over the edge set's sender
view in run order (``ops/gather.py::sender_gather_one``'s backward), sized
by the sender set, the receiver rows' the segment sum over the
receiver-major layout, whose receivers' slots are consecutive, sized by the
receiver set; a padding slot's cotangent is zero, as its mask makes it.
Without the sender view the function is forward-only and raises when a
gradient would be needed.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from p_div_gnn_tpu_torch.ops import cuda_build
from p_div_gnn_tpu_torch.ops.gather import SenderView, _refuse_without_view
from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum
from p_div_gnn_tpu_torch.utils.profiling import count

WIDTH = 128  # the kernel's L: MeshGraphNets' latent width
DEPTH = 2  # the kernel's hidden layers: the published MLP's
LN_EPS = 1e-5
# what the kernel keeps for the backward: a0, a1, y, mean, rstd
SAVED = 5
TERMS = 3  # bf16 terms of an fp32 weight in the kernel's split products
ACTIVATIONS = {"relu": torch.relu, "silu": torch.nn.functional.silu}


def edge_update_reference(
    p_s: torch.Tensor, p_r: torch.Tensor, e: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor,
    layers: Sequence[torch.Tensor], gamma: torch.Tensor, beta: torch.Tensor,
    mask: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
    activation: str = "relu",
) -> tuple[torch.Tensor, torch.Tensor, tuple[torch.Tensor, ...]]:
    """Plain PyTorch version: (e', e + e', (s0, .., s(k-1), y, mean, rstd)),
    each s the activation's output for ReLU, its input for SiLU."""
    act = ACTIVATIONS[activation]
    h = p_s.index_select(0, senders) + p_r.index_select(0, receivers) + e @ w_e + b0
    acts = []
    for w, b in zip(layers[::2], layers[1::2]):
        a = act(h)
        acts.append(a if activation == "relu" else h)
        h = a @ w + b
    out, mean, rstd = torch.native_layer_norm(h, (h.shape[1],), gamma, beta, LN_EPS)
    e_new = out * mask
    return e_new, e + e_new, (*acts, h, mean, rstd)


def _check(tensors: dict[str, torch.Tensor], n: int, Np: int) -> None:
    shapes = {"p_s": (Np, WIDTH), "p_r": (Np, WIDTH), "e": (n, WIDTH), "w_e": (WIDTH, WIDTH),
              "w1": (WIDTH, WIDTH), "w2": (WIDTH, WIDTH), "mask": (n, 1), "senders": (n,),
              "receivers": (n,)}
    dev = tensors["e"].device
    for name, t in tensors.items():
        index = name in ("senders", "receivers")
        if t.dtype != (torch.int32 if index else torch.float32):
            raise ValueError(f"mgn_edge_update: {name} must be {'int32' if index else 'float32'}")
        if t.shape != shapes.get(name, (WIDTH,)):
            raise ValueError(f"mgn_edge_update: {name} must be {shapes.get(name, (WIDTH,))}, "
                             f"got {tuple(t.shape)} (the kernel is built for L = {WIDTH})")
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("mgn_edge_update: tensors must be contiguous, 16-byte aligned "
                             "and on one device")
    if n < 1:
        raise ValueError("mgn_edge_update: no edge slots")


def _edge_update_cuda(p_s, p_r, e, w_e, b0, layers, gamma, beta, mask, senders, receivers,
                      saves: bool, activation: str = "relu"):
    """The kernel: (e', e + e', (a0, a1, y, mean, rstd) or None)."""
    if len(layers) != 2 * DEPTH or activation != "relu":
        raise ValueError(f"mgn_edge_update: the kernel is built for MLPs of {DEPTH} hidden "
                         f"ReLU layers, got {len(layers) // 2} of {activation}")
    w1, b1, w2, b2 = layers
    n, Np = e.shape[0], p_s.shape[0]
    _check({"p_s": p_s, "p_r": p_r, "e": e, "w_e": w_e, "b0": b0, "w1": w1, "b1": b1, "w2": w2,
            "b2": b2, "gamma": gamma, "beta": beta, "mask": mask, "senders": senders,
            "receivers": receivers}, n, Np)
    built = cuda_build.library("mgn_edge_fwd")
    with torch.cuda.device(e.device):
        n_parts = int(built.lib.pdg_mgn_edge_fwd_parts())
    if n_parts < 1:
        raise RuntimeError("mgn_edge_fwd: cannot read the card's SM count")
    rows = lambda: torch.empty((n, WIDTH), dtype=torch.float32, device=e.device)  # noqa: E731
    stat = lambda: torch.empty((n, 1), dtype=torch.float32, device=e.device)  # noqa: E731
    e_new, e_sum = rows(), rows()
    saved = (rows(), rows(), rows(), stat(), stat()) if saves else None
    # the three weights' bf16 terms, which the launch writes and streams
    wsplit = torch.empty((3, TERMS, WIDTH, WIDTH), dtype=torch.int16, device=e.device)
    cuda_build.launch("mgn_edge_fwd", "pdg_mgn_edge_fwd", p_s, p_r, e, senders, receivers, mask,
                      w_e, b0, w1, b1, w2, b2, gamma, beta, e_new, e_sum,
                      *(saved or (None,) * SAVED), wsplit, n, WIDTH, n_parts)
    count("mgn.edge_fused_rows", n)
    return e_new, e_sum, saved


class _EdgeUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mask, layout, saves, activation, plain, p_s, p_r, e, w_e, b0, gamma, beta,
                *layers):
        senders, receivers = layout[:2]
        args = (p_s, p_r, e, w_e, b0, layers, gamma, beta, mask, senders, receivers)
        kind = cuda_build.device_kind("mgn_edge_update", mask, senders, receivers, p_s, p_r, e,
                                      w_e, b0, gamma, beta, *layers)
        if kind == "cuda" and not plain:
            e_new, e_sum, saved = _edge_update_cuda(*args, saves, activation)
        else:
            e_new, e_sum, saved = edge_update_reference(*args, activation)
        if saves:
            ctx.save_for_backward(e, mask, w_e, gamma, beta, *layers[::2])
            # the activations go on ctx, so the backward can release each
            # as soon as it is used, as autograd releases a node's saved
            # tensors after the node's backward
            ctx.saved = list(saved)
        ctx.layout, ctx.num_nodes = layout, (p_s.shape[0], p_r.shape[0])
        ctx.activation = activation
        # an unused output's gradient stays None (the last block's e + e'),
        # not an (n, L) tensor of zeros
        ctx.set_materialize_grads(False)
        return e_new, e_sum

    @staticmethod
    def backward(ctx, g_new, g_sum):
        e, mask, w_e, gamma, beta, *weights = ctx.saved_tensors
        *acts, y, mean, rstd = ctx.saved
        ctx.saved = None
        _, receivers, block_tile, view, tile = ctx.layout
        g = g_new if g_sum is None else g_sum if g_new is None else g_new + g_sum
        dh, dgamma, dbeta = torch.ops.aten.native_layer_norm_backward(
            g * mask, y, [y.shape[1]], mean, rstd, gamma, beta, [True, True, True])
        del g, y, mean, rstd
        d_layers: list[torch.Tensor] = []
        for w in reversed(weights):
            s = acts.pop()
            if ctx.activation == "relu":
                d_layers[:0] = (s.t() @ dh, dh.sum(0))
                dh = torch.ops.aten.threshold_backward(dh @ w.t(), s, 0)
            else:
                d_layers[:0] = (torch.nn.functional.silu(s).t() @ dh, dh.sum(0))
                dh = torch.ops.aten.silu_backward(dh @ w.t(), s)
            del s
        dw_e, db0 = e.t() @ dh, dh.sum(0)
        de = dh @ w_e.t() if g_sum is None else g_sum + dh @ w_e.t()
        perm, sorted_senders, snd_block_tile = view
        n_s, n_r = ctx.num_nodes
        dp_s = csr_segment_sum(dh, sorted_senders, snd_block_tile, n_s, tile, perm=perm)
        dp_r = csr_segment_sum(dh, receivers, block_tile, n_r, tile)
        return (None, None, None, None, None, dp_s.to(dh.dtype), dp_r.to(dh.dtype), de, dw_e, db0,
                dgamma, dbeta, *d_layers)


def edge_update(
    p_s: torch.Tensor,  # (N_s, L) x_s·W_s, the sender slot's projection of the sender set
    p_r: torch.Tensor,  # (N_r, L) x_r·W_r, the receiver slot's projection of the receiver set
    e: torch.Tensor,  # (n, L) edge latents of the live slots
    w_e: torch.Tensor,  # (L, L) the edge slot's first-layer weight
    b0: torch.Tensor,  # (L,)
    layers: Sequence[torch.Tensor],  # (W1, b1, ..., Wk, bk): (L, L) and (L,) each
    gamma: torch.Tensor,  # (L,) LayerNorm scale
    beta: torch.Tensor,  # (L,) LayerNorm offset
    mask: torch.Tensor,  # (n, 1) 1 on real edges, 0 on padding slots
    senders: torch.Tensor,  # (n,) i32
    receivers: torch.Tensor,  # (n,) i32, the receiver-major layout
    block_tile: torch.Tensor,  # (n / block,) i32 node tile per edge block
    view: SenderView | None,  # (snd_run_perm, snd_run_sorted, snd_block_tile), over the senders
    tile: int,  # node tile of the layout (GraphBatch.tile)
    activation: str = "relu",  # a key of ACTIVATIONS
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(e', e + e')`` of every live slot (the module's docstring),
    differentiable in every tensor but the mask and the layout; on the card
    MeshGraphNets' kernel."""
    return _apply(False, p_s, p_r, e, w_e, b0, layers, gamma, beta, mask, senders, receivers,
                  block_tile, view, tile, activation)


def plain_edge_update(*args, **kwargs) -> tuple[torch.Tensor, torch.Tensor]:
    """``edge_update`` through the plain composition on either device (the
    module's docstring), with the same arguments."""
    return _apply(True, *args, **kwargs)


def _apply(plain: bool, p_s, p_r, e, w_e, b0, layers, gamma, beta, mask, senders, receivers,
           block_tile, view, tile, activation: str = "relu"):
    floats = (p_s, p_r, e, w_e, b0, gamma, beta, *layers)
    saves = torch.is_grad_enabled() and any(t.requires_grad for t in floats)
    if view is None and saves:
        _refuse_without_view("mgn_edge_update", *floats)
    if activation not in ACTIVATIONS:
        raise ValueError(f"mgn_edge_update: unknown activation {activation!r}, expected one of "
                         f"{sorted(ACTIVATIONS)}")
    return _EdgeUpdate.apply(mask, (senders, receivers, block_tile, view, tile), saves,
                             activation, plain, *floats)
