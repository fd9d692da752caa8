"""The parallel tier's collectives (``parallel/collectives.py``) over 2 gloo
ranks against a single-process computation of the same function: each
one's forward, and its backward, which is the transpose JAX gives it
(``psum`` ↔ all-reduce of the cotangent, the tiled ``all_to_all`` ↔ the
same exchange of the cotangent, ``all_gather`` ↔ a sum-reduce-scatter);
the issue-then-wait ``start_all_to_all``; ``pmean_`` of gradients; and
identity with no group. Rank r's input is row r of one seeded draw, and the
loss on rank r is ``sum(y_r * ct_r)``: the gradient of ``x_r`` is
``Σ_s d(y_s · ct_s)/dx_r``, which the test forms by hand. fp32 sums of two
terms are exact to rounding: tolerance rtol 1e-6 / atol 1e-6 (psum64:
exact)."""

import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from p_div_gnn_tpu_torch.parallel import collectives
from p_div_gnn_tpu_torch.parallel.launch import run_ranks

D, SEED = 2, 5
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def got():
    return run_ranks(ranks.collectives_rank, D, SEED)


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(SEED)
    xs = rng.normal(size=(D, D, 3, 5)).astype(np.float32)
    cts = rng.normal(size=(D, D, 3, 5)).astype(np.float32)
    return xs, cts


@pytest.mark.parametrize("name", ["psum", "psum64"])
def test_psum_and_its_transpose(got, draws, name):
    xs, cts = draws
    y = xs.sum(0)
    for r in range(D):
        out, grad = got[r][name]
        if name == "psum64":
            np.testing.assert_array_equal(out, xs.astype(np.float64).sum(0).astype(np.float32))
        else:
            np.testing.assert_allclose(out, y, **TOL)
        # every rank's loss reads the sum: dx_r = Σ_s ct_s
        np.testing.assert_allclose(grad, cts.sum(0), **TOL)


def test_all_to_all_and_its_transpose(got, draws):
    xs, cts = draws
    for r in range(D):
        out, grad = got[r]["all_to_all"]
        # block o of rank r's result is block r of rank o's input
        np.testing.assert_array_equal(out, xs[:, r])
        # block s of x_r went to rank s as its block r
        np.testing.assert_array_equal(grad, cts[:, r])


def test_all_gather_and_its_transpose(got, draws):
    xs, cts = draws
    for r in range(D):
        out, grad = got[r]["all_gather"]
        np.testing.assert_array_equal(out, xs[:, 0])
        # x_r[0] is block r of every rank's result: dx_r[0] = Σ_s ct_s[r]
        want = np.zeros_like(xs[r])
        want[0] = cts[:, r].sum(0)
        np.testing.assert_allclose(grad, want, **TOL)


def test_start_all_to_all_then_wait(got, draws):
    xs, cts = draws
    for r in range(D):
        out, grad, local = got[r]["start_all_to_all"]
        np.testing.assert_array_equal(out, xs[:, r])
        np.testing.assert_array_equal(grad, cts[:, r])
        assert local == pytest.approx(float(2 * xs[r].sum()), rel=1e-6)


def test_pmean_of_gradients(got, draws):
    xs, _ = draws
    for r in range(D):
        for i, g in enumerate(got[r]["pmean_"]):
            np.testing.assert_allclose(g, xs[:, i].mean(0), **TOL)
            np.testing.assert_array_equal(g, got[0]["pmean_"][i])


def test_ranks_return_tensors_by_value(got):
    """run_ranks brings a rank's CPU tensor back after the rank has exited."""
    for r in range(D):
        assert got[r]["tensor"].tolist() == [float(r)] * 3


def test_no_group_is_the_identity(got):
    assert all(got[r]["identity"] for r in range(D))
    x = torch.randn(3, 4, requires_grad=True)
    assert collectives.psum(x, None) is x and collectives.all_to_all(x, None) is x
    assert collectives.psum64(x, None) is x
    np.testing.assert_array_equal(collectives.all_gather(x, None).detach(), x.detach()[None])
    grads = [torch.ones(2)]
    collectives.pmean_(grads, None)
    assert grads[0].tolist() == [1.0, 1.0]
    assert collectives.world_size(None) == 1 and collectives.rank(None) == 0
    assert not collectives.staged_through_host(x, None)
