"""The wide variant of the six fused edge-step kernels: the launch side of
``csrc/wide_tile.cuh``, which each fused source exposes as
``pdg_<name>_wide``.

A fused kernel's wrapper runs a width above 256 here (``ops/widths.py``
pads it to a multiple of the strip, 64): the step's tensors go to the
kernel in one ``WideStep`` struct, with fp32 scratch rows (n, L) for the
values that cross between its launches (h1, h2, dy, dpre, ...), fp64
column partials and, in the backwards, fp64 weight-grad partials over at
most ``MAX_SPLITS`` slot ranges. A width whose scratch the card's memory
cannot hold raises PyTorch's ``OutOfMemoryError`` at the allocation.
"""

from __future__ import annotations

import ctypes

import torch

from p_div_gnn_tpu_torch.ops import cuda_build
from p_div_gnn_tpu_torch.ops.segment import slot_outputs

# csrc/wide_tile.cuh: slots of a CTA's tile, slot ranges of a weight grad
WM = 32
MAX_SPLITS = 32
SPLIT_SLOTS = 1024  # slots per weight-grad range, until MAX_SPLITS ranges
# the step's modes (wide::Mode)
F3, V2, P2 = 0, 1, 2

_PTRS = ("na", "nb", "ga", "gb", "e", "wu", "wv", "we", "w2", "wuT", "wvT", "weT", "w2T",
         "b0", "b2", "z_upd", "dz", "dr", "dm", "slot", "rcv", "snd", "gid",
         "h1", "h2", "s1", "s2", "s3", "s4", "s5", "part", "wpart",
         "z_out", "r_out", "r_out2", "m_out", "dg", "dg1", "dg2", "de", "w_out")
_INTS = ("n", "L", "Np", "Ep", "n_graphs", "splits")


class WideStep(ctypes.Structure):
    """csrc/wide_tile.cuh's ``WideStep``, field for field."""
    _fields_ = [(f, ctypes.c_void_p) for f in _PTRS] + [(f, ctypes.c_int64) for f in _INTS]


def _launch(name: str, sd: torch.dtype, dev: torch.device, tensors: dict, **sizes: int) -> None:
    """One launch of ``pdg_<name>_wide``, counted under ``name``."""
    step = WideStep(**{k: t.data_ptr() for k, t in tensors.items() if t is not None}, **sizes)
    cuda_build.launch(name, f"pdg_{name}_wide", int(sd == torch.bfloat16), ctypes.addressof(step),
                      device=dev)


def forward(name: str, sd: torch.dtype, n: int, Np: int, Ep: int, n_graphs: int,
            inputs: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z_upd (Ep, L) stream dtype, R (Np, L), M (8, L)) of a wide forward
    over n entries; ``inputs`` names the WideStep fields the mode reads.
    z_upd is zeroed from slot n on before the launch: the F3 and V2 modes
    write only the first n slots (``segment.live_slots``)."""
    L = inputs["b0"].shape[0]
    dev = inputs["b0"].device
    h = torch.empty((3, n, L), dtype=torch.float32, device=dev)
    out = {
        "z_out": slot_outputs(n, 1, Ep, L, sd, dev)[0],
        "r_out": torch.empty((Np, L), dtype=torch.float32, device=dev),
        "m_out": torch.empty((8, L), dtype=torch.float32, device=dev),
    }
    scratch = {"h1": h[0], "h2": h[1], "s1": h[2],
               "part": torch.empty((-(-n // WM), 4, L), dtype=torch.float64, device=dev)}
    _launch(name, sd, dev, {**inputs, **scratch, **out}, n=n, L=L, Np=Np, Ep=Ep,
            n_graphs=n_graphs, splits=1)
    return out["z_out"], out["r_out"], out["m_out"]


def backward(name: str, mode: int, sd: torch.dtype, n: int, Np: int, Ep: int, n_graphs: int,
             inputs: dict) -> dict:
    """A wide backward over n entries: its outputs by WideStep field (r_out,
    r_out2, m_out (db2, db0), dg, dg1, dg2, de, w_out (dW2, dWe[, dWu,
    dWv])), those the mode writes; the per-slot ones are zeroed from slot
    n on before the launch, as in ``forward``."""
    L = inputs["b0"].shape[0]
    dev = inputs["b0"].device
    rows = torch.empty((7, n, L), dtype=torch.float32, device=dev)
    splits = max(1, min(MAX_SPLITS, -(-n // SPLIT_SLOTS)))
    scratch = dict(zip(("h1", "h2", "s1", "s2", "s3", "s4", "s5"), rows.unbind(0)))
    scratch["part"] = torch.empty((-(-n // WM), 2, L), dtype=torch.float64, device=dev)
    scratch["wpart"] = torch.empty((splits, L, L), dtype=torch.float64, device=dev)
    out = {
        "r_out": torch.empty((Np, L), dtype=torch.float32, device=dev),
        "m_out": torch.empty((2, L), dtype=torch.float32, device=dev),
        "w_out": torch.empty((4 if mode == F3 else 2, L, L), dtype=torch.float32, device=dev),
    }
    if mode == F3:
        out.update(zip(("dg", "de"), slot_outputs(n, 2, Ep, L, sd, dev)))
    else:
        out.update(zip(("dg1", "dg2", "de"), slot_outputs(n, 3, Ep, L, sd, dev)),
                   r_out2=torch.empty((Np, L), dtype=torch.float32, device=dev))
    _launch(name, sd, dev, {**inputs, **scratch, **out}, n=n, L=L, Np=Np, Ep=Ep,
            n_graphs=n_graphs, splits=splits)
    return out
