"""Rounding model of the fused3 backward's weight-grad sums.

    python scripts/port_wgrad_rounding.py [--slots 255744] [--entries 256]

Each weight-grad entry is a sum over every edge slot of a product of two
fp32 values. The script draws products of the flagship's magnitudes
(h = relu(N(0, 4)) against dy = N(0, 9) that is zero on half the slots,
as the backward meets them with unit-variance inputs and N(0, 1/L)
weights) and sums them as the CUDA kernel could: slots cut into 64
chunks, fp32 fused multiply-adds over groups of G slots, the group sums
added in fp64. It prints, for each G, the rms and largest absolute error
against the exact (fp64) sum, and the largest share of an elementwise
rtol = atol = 2e-4 allowance. G = the whole chunk is one fp32 chain per
chunk; G = 1 rounds each product alone (the floor of fp32 products).
numpy only; it runs in about 15 s on one CPU core.
"""

from __future__ import annotations

import argparse

import numpy as np


def grouped_sum(a: np.ndarray, b: np.ndarray, group: int, chunk: int) -> np.ndarray:
    """Σ_i a[i]·b[i] per column: fp32 FMA chains of ``group`` slots (one
    rounding per step: the product is exact in fp64), fp64 across them."""
    total = np.zeros(a.shape[1])
    for lo in range(0, a.shape[0], chunk):
        hi = min(a.shape[0], lo + chunk)
        for g0 in range(lo, hi, group):
            acc = np.zeros(a.shape[1], np.float32)
            for i in range(g0, min(hi, g0 + group)):
                acc = (acc + a[i].astype(np.float64) * b[i]).astype(np.float32)
            total += acc
    return total


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=255744, help="edge slots (flagship Ep)")
    ap.add_argument("--entries", type=int, default=256, help="weight-grad entries drawn")
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    shape = (args.slots, args.entries)
    a = np.maximum(rng.normal(0, 2, shape), 0).astype(np.float32)
    b = (rng.normal(0, 3, shape) * (rng.random(shape) < 0.5)).astype(np.float32)
    exact = (a.astype(np.float64) * b).sum(0)
    chunk = -(-args.slots // args.chunks)
    print(f"{args.slots} slots, {args.entries} entries, {args.chunks} chunks of {chunk}; "
          f"median |sum| {np.median(np.abs(exact)):.1f}")
    for group in (1, 8, 32, chunk):
        err = np.abs(grouped_sum(a, b, group, chunk) - exact)
        share = (err / (2e-4 * (1 + np.abs(exact)))).max()
        print(f"fp32 groups of {group} slots: rms {np.sqrt((err ** 2).mean()):.3e}, "
              f"max {err.max():.3e}, largest share of the 2e-4 allowance {share:.3f}; "
              f"an entry near zero is allowed 2e-4")


if __name__ == "__main__":
    main()
