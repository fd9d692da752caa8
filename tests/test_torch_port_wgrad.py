"""The weight-grad pass's plain version (ops/wgrad.py), which the CPU path
of ``wgrad_pass`` runs and the card tests hold the kernels to: Σ AᵀB per
weight grad over the listed (A, B) stream pairs in fp64, an indexed
stream's rows read at the given indices and zero outside the stream. The
kernels themselves run on the card (tests/test_torch_port_cuda.py,
``test_wgrad_pass_matches_fp64_sum_on_cuda``)."""

import numpy as np
import torch

from p_div_gnn_tpu_torch.ops import wgrad


def _streams(seed: int, n: int, n_idx: int, L: int = 8):
    rng = np.random.default_rng(seed)
    a, b, x = (torch.from_numpy(rng.normal(size=(r, L))) for r in (n, n, n_idx))
    idx = torch.from_numpy(rng.integers(-2, n_idx + 2, size=n).astype(np.int32))
    return a, b, x, idx


def test_plain_pass_sums_pairs_and_indexed_rows_on_cpu():
    a, b, x, idx = _streams(1, 37, 11)
    got = wgrad.wgrad_pass([a, b, x], [False, False, True], idx, [[(0, 1), (2, 1)], [(2, 2)]])
    xr = torch.stack([x[i] if 0 <= i < x.shape[0] else torch.zeros(x.shape[1])
                      for i in idx.tolist()])
    want = torch.stack([a.T @ b + xr.T @ b, xr.T @ xr]).float()
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_plain_pass_stops_at_n_rows_on_cpu():
    a, b, x, idx = _streams(2, 40, 9)
    got = wgrad.wgrad_pass([a, b, x], [False, False, True], idx, [[(0, 1)], [(2, 0)]],
                           n_rows=23)
    want = wgrad.wgrad_pass([a[:23], b[:23], x], [False, False, True], idx[:23],
                            [[(0, 1)], [(2, 0)]])
    assert torch.equal(got, want)


def test_plain_pass_sums_bf16_streams_in_fp64_on_cpu():
    """bf16 streams (one term each on the card) are summed from their bf16
    values in fp64, a weight grad's pairs added in list order."""
    a, b, x, idx = _streams(3, 29, 7)
    a, b, x = (t.to(torch.bfloat16) for t in (a, b, x))
    got = wgrad.wgrad_pass([a, b, x], [False, False, True], idx, [[(0, 1)], [(2, 1), (0, 0)]])
    xr = torch.stack([x[i].double() if 0 <= i < x.shape[0] else torch.zeros(x.shape[1],
                                                                            dtype=torch.float64)
                      for i in idx.tolist()])
    a, b = a.double(), b.double()
    want = torch.stack([a.T @ b, xr.T @ b + a.T @ a]).float()
    assert got.dtype == torch.float32 and got.shape == (2, 8, 8)
    torch.testing.assert_close(got, want, rtol=1e-7, atol=1e-7)
