"""Latent widths of the fused kernels: each tile kernel is built for a few
widths L (its tiles are laid out for them), and its wrapper runs any other
L <= 256 at the next width it is built for, with the widened columns,
weight rows and weight columns zero. Above 256 the wrapper runs the
kernel's wide variant (``csrc/wide_tile.cuh``, ``ops/wide.py``), which
tiles the output columns in strips of 64 and runs every k sum over the
whole width: an L that is not a multiple of 64 is zero-padded to the next
one the same way.

The zero padding changes no output, in either stream dtype and in either
kind of kernel: a padded column's pre-activation, h, z, dy and dpre are
all +0 (every product into it has a zero weight, and its bias is 0); each
sum over k adds the padded k after the real ones, and each of those
addends is an exact zero (in the wide variant too: its chains run k in
order over the padded width, and the strip a padded column falls in is
computed like any other); the moment and weight-grad entries of the padded
rows and columns are sliced away. So the padded call is the kernel's own
result at the narrower width, not an approximation and not a plain-version
fallback. No configuration of the repo uses a width other than 128.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the widest any tile kernel is built for; wider runs the wide variant
MAX_WIDTH = 256
# the wide variant's column strip (csrc/wide_tile.cuh WN)
WIDE_STRIP = 64


def padded_width(L: int, widths: tuple[int, ...], who: str) -> int:
    """The width a call at L runs at: the smallest width in ``widths``
    (the tile kernel's builds) that is at least ``L``, or above them the
    next multiple of WIDE_STRIP (the wide variant)."""
    if L < 1:
        raise ValueError(f"{who}: L={L} is not a width")
    for w in sorted(widths):
        if w >= L:
            return w
    return -(-L // WIDE_STRIP) * WIDE_STRIP


def wide_strips(Lp: int) -> int:
    """The column strips of the wide variant at the run width ``Lp``; 0
    where a tile build takes it."""
    return Lp // WIDE_STRIP if Lp > MAX_WIDTH else 0


def pad_width(t: torch.Tensor, Lp: int, dims: tuple[int, ...] = (-1,)) -> torch.Tensor:
    """``t`` with each dimension in ``dims`` zero-padded at its end to
    ``Lp``, contiguous; ``t`` itself where nothing is padded."""
    pads = [0] * (2 * t.dim())
    for d in dims:
        d %= t.dim()
        pads[2 * (t.dim() - 1 - d) + 1] = Lp - t.shape[d]
    if not any(pads):
        return t
    return F.pad(t, pads).contiguous()


def unpad(t: torch.Tensor, L: int, dims: tuple[int, ...] = (-1,)) -> torch.Tensor:
    """``t`` cut back to ``L`` along each dimension in ``dims``, contiguous."""
    for d in dims:
        t = t.narrow(d, 0, L)
    return t.contiguous()


# what is padded in a tensor of a kernel call: "c" its last dimension (rows
# of L values: node and edge rows, biases, dM), "w" both (an (L, L)
# weight), "-" nothing (indices)
_DIMS = {"c": (-1,), "w": (0, 1)}


def pad_args(tensors, spec: str, Lp: int) -> list:
    """Each tensor padded to ``Lp`` as its letter in ``spec`` says."""
    return [t if k == "-" else pad_width(t, Lp, _DIMS[k])
            for t, k in zip(tensors, spec, strict=True)]


def unpad_args(tensors, spec: str, L: int) -> tuple:
    """Each tensor cut back to ``L`` as its letter in ``spec`` says."""
    return tuple(t if k == "-" else unpad(t, L, _DIMS[k])
                 for t, k in zip(tensors, spec, strict=True))
