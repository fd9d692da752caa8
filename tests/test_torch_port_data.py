"""The port's data path against the JAX package's, on the toy on-disk dataset
that ``tests/test_train_e2e.py::_write_toy_dataset`` writes (both packages
read the same files): the mesh and sample writers (byte-equal files),
``MeshStressFieldDataset`` (array-equal samples, NormStats within 1e-6),
``pack_batch`` with the loader's capacities and bucket ladders (array-equal),
and ``GraphLoader`` (array-equal batches in the same order over three
epochs, for each of its modes), then ``prefetch``."""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from p_div_gnn_tpu.graphs import MeshStressFieldDataset as JaxDataset
from p_div_gnn_tpu.graphs import batching as jax_batching
from p_div_gnn_tpu.graphs import meshio as jax_meshio
from p_div_gnn_tpu.train.data import GraphLoader as JaxLoader
from p_div_gnn_tpu_torch.graphs import batching, meshio
from p_div_gnn_tpu_torch.graphs.dataset import MeshStressFieldDataset
from p_div_gnn_tpu_torch.train.data import GraphLoader, prefetch
from p_div_gnn_tpu_torch.utils.configio import read_csv

from test_torch_port_graphs import _to_jax_sample
from test_train_e2e import _write_toy_dataset
from toy_meshes import grid_mesh_with_hole


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    _write_toy_dataset(root, n_samples=7, seed=3)
    return root / "dataset.csv"


def _assert_samples_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            _assert_samples_equal(a, b)
        elif b is None or isinstance(b, (int, float)):
            assert a == b, f.name
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_batches_equal(got, want):
    assert (got.n_graphs, got.tile) == (want.n_graphs, want.tile)
    for name in got.array_fields():
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        a, b = _host(a), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_writers_match_jax_byte_for_byte(tmp_path):
    mesh = grid_mesh_with_hole(5, 5, width=100.0, hole_cell=(1, 1))
    rng = np.random.default_rng(0)
    arrays = dict(stress_field=rng.normal(size=(mesh.n_points, 3)).astype(np.float32),
                  node_labels=np.arange(mesh.n_points))
    for binary in (True, False):
        meshio.write_vtk(tmp_path / "port.vtk", mesh, binary=binary)
        jax_meshio.write_vtk(tmp_path / "jax.vtk", mesh, binary=binary)
        assert (tmp_path / "port.vtk").read_bytes() == (tmp_path / "jax.vtk").read_bytes()
        back = meshio.read_vtk(tmp_path / "port.vtk")
        np.testing.assert_array_equal(back.points, mesh.points)
        np.testing.assert_array_equal(back.faces, mesh.faces)
    meshio.save_sample_npz(tmp_path / "port.npz", **arrays)
    loaded = meshio.load_sample_npz(tmp_path / "port.npz")
    ref = jax_meshio.load_sample_npz(tmp_path / "port.npz")
    assert loaded.keys() == ref.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(loaded[k], arrays[k])


@pytest.mark.parametrize("periodic", [True, False])
def test_dataset_matches_jax(toy, periodic):
    got = MeshStressFieldDataset(read_csv(toy), periodic_graph=periodic)
    want = JaxDataset(pd.read_csv(toy), periodic_graph=periodic)
    assert len(got) == len(want) == 7
    for a, b in zip(got.samples, want.samples):
        _assert_samples_equal(a, b)
    g, w = got.stats.to_dict(), want.stats.to_dict()
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)


def test_dataset_pool_loads_the_rows_in_order(tmp_path, monkeypatch):
    """From POOL_MIN_ROWS rows on, the rows load in a spawned process pool,
    in row order: the same samples as the serial load."""
    _write_toy_dataset(tmp_path, n_samples=4, seed=5)
    table = read_csv(tmp_path / "dataset.csv")
    big = {k: v * 16 for k, v in table.items()}  # 64 rows
    monkeypatch.setenv("PDG_LOAD_WORKERS", "2")
    pooled = MeshStressFieldDataset(big)
    monkeypatch.setenv("PDG_LOAD_WORKERS", "0")
    serial = MeshStressFieldDataset(big)
    assert len(pooled) == 64
    for a, b in zip(pooled.samples, serial.samples):
        _assert_samples_equal(a, b)
    assert pooled.stats == serial.stats


@pytest.mark.parametrize("pair_blocks", [False, True])
def test_pack_batch_capacities_match_jax(toy, pair_blocks):
    """Explicit capacities, and node / edge bucket ladders, as the JAX
    packer lays them out; the default ladder is the JAX loader's."""
    samples = MeshStressFieldDataset(read_csv(toy)).samples[:3]
    ref = [_to_jax_sample(s) for s in samples]
    assert batching.default_node_buckets() == jax_batching.default_node_buckets()
    for kw in (dict(pad_nodes=1024, pad_edges=4000, pad_div=2048),
               dict(node_buckets=(512, 1024, 2048), edge_buckets=(1000, 5000))):
        got = batching.pack_batch(samples, n_graphs=4, pair_blocks=pair_blocks,
                                  reorder="rcm", **kw)
        want = jax_batching.pack_batch(ref, n_graphs=4, pair_blocks=pair_blocks,
                                       reorder="rcm", **kw)
        _assert_batches_equal(got, want)


def test_pack_batch_refuses_short_capacities(toy):
    samples = MeshStressFieldDataset(read_csv(toy)).samples[:2]
    n = sum(s.num_nodes for s in samples)
    with pytest.raises(ValueError, match="padding node"):
        batching.pack_batch(samples, pad_nodes=n)
    with pytest.raises(ValueError, match="below the content"):
        batching.pack_batch(samples, pad_div=8)


LOADER_MODES = {
    "shuffle": dict(shuffle=True, seed=5),
    "cache_groups": dict(shuffle=True, seed=5, cache_groups=True),
    "pair_blocks": dict(shuffle=True, seed=2, pair_blocks=True),
    "no_sender_view": dict(shuffle=True, seed=1, sender_view=False),
    "eval": dict(shuffle=False),
}


@pytest.mark.parametrize("mode", LOADER_MODES)
def test_loader_matches_jax(toy, mode):
    """Three epochs of batches from both loaders, array-equal and in the
    same order (the cached modes yield device batches after packing)."""
    kw = LOADER_MODES[mode]
    samples = MeshStressFieldDataset(read_csv(toy)).samples
    got = GraphLoader(samples, 3, device="cpu", **kw)
    want = JaxLoader([_to_jax_sample(s) for s in samples], 3, **kw)
    assert len(got) == len(want) == 3
    for epoch in range(3):
        pairs = list(zip(got, want, strict=True))
        for a, b in pairs:
            _assert_batches_equal(a, b)
        cached = bool(kw.get("cache_groups") or not kw["shuffle"])
        assert all(isinstance(a.pos, torch.Tensor) for a, _ in pairs) == cached


def test_prefetch_moves_batches_and_raises_the_loaders_error(toy):
    samples = MeshStressFieldDataset(read_csv(toy)).samples
    loader = GraphLoader(samples, 3, shuffle=True, seed=5, device="cpu")
    want = list(GraphLoader(samples, 3, shuffle=True, seed=5, device="cpu"))
    got = list(prefetch(loader, "cpu", depth=1))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.is_on("cpu") and a.snd_run_perm is not None
        _assert_batches_equal(a, b)

    def broken():
        yield want[0]
        raise RuntimeError("loader failed")

    it = prefetch(broken(), "cpu")
    assert next(it).is_on("cpu")
    with pytest.raises(RuntimeError, match="loader failed"):
        next(it)


def _loader_step_inputs(toy, step, L=16, seed=0):
    """A batch packed at the loader's capacities (its spare edge capacity
    after the last real slot) and random inputs of the fused3 or the v2
    edge step on it."""
    samples = MeshStressFieldDataset(read_csv(toy)).samples
    b = GraphLoader(samples, len(samples), device="cpu")._pack(range(len(samples))).to("cpu")
    gen = torch.Generator().manual_seed(seed)
    Np, Ep = b.num_nodes_padded, b.num_edges_padded
    rand = lambda *s, scale=1.0: torch.randn(*s, generator=gen) * scale  # noqa: E731
    w = lambda: rand(L, L, scale=L**-0.5)  # noqa: E731
    snd = b.senders.long()
    if step == "fused3":
        x = rand(Np, L)
        return b, (x, x[snd], rand(Ep, L), w(), w(), w(), rand(L), w(), rand(L))
    a_u, a_v = rand(Np, L), rand(Np, L)
    return b, (a_u, a_v, a_v[snd], a_u[snd], rand(Ep, L), w(), rand(L), w(), rand(L))


def test_live_slots_of_a_loader_batch(toy):
    from p_div_gnn_tpu_torch.ops.segment import live_slots

    b, _ = _loader_step_inputs(toy, "fused3")
    gid, Ep = b.edge_gid, b.num_edges_padded
    block = Ep // b.edge_block_tile.shape[0]
    last_real = int(torch.nonzero(gid < b.n_graphs).max())
    n = live_slots(gid, b.n_graphs, block)
    assert n == -(-(last_real + 1) // block) * block and n % block == 0
    assert Ep - n > Ep // 3  # the loader's spare capacity, all after the live slots
    assert (gid[n:] == b.n_graphs).all()
    assert live_slots(gid, b.n_graphs, block) == n and gid._pdg_live_slots[1] == n
    assert live_slots(torch.full((8,), 3, dtype=torch.int32), 3, 4) == 4  # all padding
    assert live_slots(torch.zeros(8, dtype=torch.int32), 3, 4) == 8  # no padding


@pytest.mark.parametrize("step", ["fused3", "v2"])
def test_padding_after_the_live_slots_changes_no_output(toy, step):
    """What the fused3 and v2 wrappers rely on to run their kernels over
    the live slots only: the plain forward and backward on those slots give
    the full layout's R, M, node and weight gradients, and the full
    layout's per-slot outputs (z_upd; dg and de) are zero after them."""
    from p_div_gnn_tpu_torch.ops import fused_edge, fused_edge3
    from p_div_gnn_tpu_torch.ops.segment import live_slots

    fwd, bwd = {
        "fused3": (fused_edge3.fused_edge_step3_reference,
                   fused_edge3.fused_edge_step3_backward_reference),
        "v2": (fused_edge.fused_edge_step_reference,
               fused_edge.fused_edge_step_backward_reference)}[step]
    b, args = _loader_step_inputs(toy, step)
    Ep = b.num_edges_padded
    n = live_slots(b.edge_gid, b.n_graphs, Ep // b.edge_block_tile.shape[0])
    rcv, gid = b.receivers, b.edge_gid
    cut = lambda t: t[:n] if t.shape[0] == Ep else t  # noqa: E731
    full = fwd(*args, rcv, gid, b.n_graphs)
    live = fwd(*map(cut, args), rcv[:n], gid[:n], b.n_graphs)
    assert not full[0][n:].any()
    torch.testing.assert_close(live[0], full[0][:n], rtol=0, atol=0)
    for a, w in zip(live[1:], full[1:]):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(1)
    cots = (full[0], torch.randn(full[0].shape, generator=gen),
            torch.randn(full[1].shape, generator=gen),
            torch.randn(8, full[0].shape[1], generator=gen))
    g_full = bwd(*args, rcv, gid, b.n_graphs, *cots)
    g_live = bwd(*map(cut, args), rcv[:n], gid[:n], b.n_graphs, *map(cut, cots))
    for k, (a, w) in enumerate(zip(g_live, g_full)):
        if w.shape[0] == Ep:  # a per-slot output
            assert not w[n:].any(), k
            w = w[:n]
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5, msg=f"output {k}")
