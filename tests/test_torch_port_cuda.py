"""The port's CUDA kernels against their plain PyTorch versions on the card:
the fused3 edge step's forward (its parts, its layout check, two calls
bit-equal) and backward, the block-CSR segment sum, the
v2 ("fused") edge step's forward and backward, the pair segment sum and the
pair-blocked ("fused2") edge step's forward and backward; every fused
kernel at widths it is not built for (zero-padded), the redesigned v2 and
pair-blocked forwards and backwards at each width they are built for (two
calls bit-equal, the forwards' fp32 z_upd bit-equal to the plain version)
and the split receiver layout the v2 kernels refuse; the fused3 and v2
kernels on a batch at GraphLoader's bucketed capacities; MeshGraphNets'
training steps on such a batch, whose edge stream stops at its last real
slot (no host sync in a second step; the step of a batch without spare
edge capacity, to 1e-6 relative) and runs its edge updates in their
kernel, and that kernel against its plain version there; GraphCast's
training step on a small typed graph (two node sets, three edge sets, the
edge updates on their plain route with #3's sums sized by each set)
against the same step on the CPU; an edge-partitioned
fused3 train step over two ranks (#1-#3 on a shard's extended layout)
against the single-card step; a set made by the port's generator served
through ``cli.infer_main`` on fused3 against xla. It imports neither
JAX nor the JAX package, so it runs where the card is (that machine has no
JAX; skip the repo's conftest there):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Without a card the tests skip. chip_smoke.py makes the same checks at the
flagship shapes. Tolerances: the JAX package's fused3 op tolerances
(tests/test_fused3_op.py:65-70 forward and :87-95 gradients in fp32,
:128-131 the segment sum and bf16), and for the v2 step the JAX package's
v2 op tolerances (tests/test_fused_op.py:86-91 forward, :116-120
gradients), which the fused2 step shares, as rtol = atol."""

import numpy as np
import pytest
import torch

from p_div_gnn_tpu_torch.graphs.batching import (
    blockify_edges,
    blockify_edges_pair,
    build_sender_view,
)
from p_div_gnn_tpu_torch.graphs.container import EDGE_BLOCK, NODE_TILE, sender_run_order
from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge, fused_edge3, scatter_csr

T = torch.from_numpy
# slots per chunk of the segment sum kernel (csrc/segment_sum_csr.cu
# RUN_CHUNK): a longer run is split across chunks
RUN_CHUNK = 64
# slots per edge step of the fused3 backward's tile kernel
# (csrc/fused_edge3_bwd.cu M)
BWD_STEP = 32


def _segment_problem(seed: int, n_tiles: int, L: int):
    """Rows and the block-CSR segment sum's two callers' layouts over random
    receiver-sorted edges of ``n_tiles`` node tiles: "sender", the sender
    view in run order with its permutation (the sender gather's backward;
    the receiver layout's padding slots all send from the last node, whose
    run is the longest), and "receiver", the receiver layout without one
    (the pallas scatter). Each layout is (receivers, block_tile, perm) as
    CPU tensors; rows are (Ep, L) fp32 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    num_nodes = n_tiles * NODE_TILE
    E = 6 * num_nodes
    snd_b, rcv_b, _, _, _, block_tile = blockify_edges(
        senders=rng.integers(0, num_nodes, size=E),
        receivers=np.sort(rng.integers(0, num_nodes, size=E)),
        edge_weight=np.ones(E, np.float32), edge_gid=np.zeros(E, np.int64),
        num_nodes=num_nodes, n_graphs=1,
    )
    perm, srt, sbt = (T(v) for v in build_sender_view(snd_b, num_nodes))
    run_perm, run_sorted = sender_run_order(perm, srt, sbt)
    rows = T(rng.normal(size=(len(rcv_b), L)).astype(np.float32))
    return rows, {"sender": (run_sorted, sbt, run_perm),
                  "receiver": (T(rcv_b.astype(np.int32)), T(block_tile.astype(np.int32)), None)}


def _longest_run(receivers: torch.Tensor) -> int:
    """Slots in the longest run of one receiver (-1 slots left out)."""
    r = receivers.cpu()
    change = torch.ones(len(r), dtype=torch.bool)
    change[1:] = r[1:] != r[:-1]
    starts = torch.nonzero(change).flatten()
    lengths = torch.diff(torch.cat([starts, torch.tensor([len(r)])]))
    return int(lengths[r[starts] >= 0].max())


def _edge_problem(seed: int, n_tiles: int, L: int, edge_block: int = EDGE_BLOCK,
                  empty_tile: int | None = None, degree: int = 6):
    """Random receiver-sorted edges (``degree`` per node) in the
    block-aligned CSR layout (blocks of ``edge_block`` slots), with a second
    graph's worth of padding slots; numpy inputs for both packages. With
    ``empty_tile``, no real edge receives in that node tile, whose one block
    is then all padding."""
    rng = np.random.default_rng(seed)
    num_nodes = n_tiles * NODE_TILE
    E = degree * num_nodes
    rcv = np.sort(rng.integers(0, num_nodes, size=E))
    snd = rng.integers(0, num_nodes, size=E)
    if empty_tile is not None:
        keep = rcv // NODE_TILE != empty_tile
        rcv, snd = rcv[keep], snd[keep]
        E = len(rcv)
    snd_b, rcv_b, _, gid_b, _, block_tile = blockify_edges(
        senders=snd, receivers=rcv, edge_weight=np.ones(E, np.float32),
        edge_gid=np.zeros(E, np.int64), num_nodes=num_nodes, n_graphs=1,
        edge_block=edge_block,
    )
    Ep = len(rcv_b)
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    x = f32(num_nodes, L)
    arrays = {
        "x": x, "g_x": x[snd_b], "e": f32(Ep, L),
        "w_u": f32(L, L, scale=L**-0.5), "w_v": f32(L, L, scale=L**-0.5),
        "w_e": f32(L, L, scale=L**-0.5), "b0": f32(L),
        "w2": f32(L, L, scale=L**-0.5), "b2": f32(L),
    }
    idx = {"receivers": rcv_b.astype(np.int32), "edge_gid": gid_b.astype(np.int32),
           "block_tile": block_tile.astype(np.int32)}
    return arrays, idx


def _mgn_edge_problem(seed: int, n_tiles: int = 2, empty_tile: int | None = 1) -> list:
    """MeshGraphNets' edge update inputs at L = 128 on ``_edge_problem``'s
    layout (with ``empty_tile``, a node tile whose block, 12 of the
    kernel's 64-slot tiles, holds only padding), as CPU tensors in
    ``mgn_edge.edge_update_reference``'s order: p_s, p_r, e, w_e, b0,
    (w1, b1, w2, b2), gamma, beta, mask (the real slots), senders,
    receivers."""
    L = 128
    arrays, idx = _edge_problem(seed, n_tiles, L, empty_tile=empty_tile)
    rng = np.random.default_rng(seed + 2000)
    Np, Ep = arrays["x"].shape[0], arrays["e"].shape[0]
    f32 = lambda *s, scale=1.0: T((rng.normal(size=s) * scale).astype(np.float32))  # noqa: E731
    w = lambda: f32(L, L, scale=L**-0.5)  # noqa: E731
    mask = T((idx["edge_gid"] < 1).astype(np.float32))[:, None]
    senders = T(rng.integers(0, Np, size=Ep).astype(np.int32))
    return [f32(Np, L), f32(Np, L), f32(Ep, L), w(), f32(L), (w(), f32(L), w(), f32(L)),
            1 + f32(L, scale=0.1), f32(L, scale=0.1), mask, senders, T(idx["receivers"])]


def _v2_problem(seed: int, n_tiles: int, L: int, empty_tile: int | None = None):
    """The inputs of the v2 edge step on ``_edge_problem``'s layout: node
    projections a_u, a_v ~ N(0, 1) and their sender gathers g_v = a_v[snd],
    g_u = a_u[snd]; numpy arrays for both packages."""
    arrays, idx = _edge_problem(seed, n_tiles, L, empty_tile=empty_tile)
    rng = np.random.default_rng(seed + 1000)
    Np, Ep = arrays["x"].shape[0], arrays["g_x"].shape[0]
    a_u = rng.normal(size=(Np, L)).astype(np.float32)
    a_v = rng.normal(size=(Np, L)).astype(np.float32)
    snd = rng.integers(0, Np, size=Ep)
    v2 = {"a_u": a_u, "a_v": a_v, "g_v": a_v[snd], "g_u": a_u[snd]}
    v2.update({k: arrays[k] for k in ("e", "w_e", "b0", "w2", "b2")})
    return v2, idx


def _pair_problem(seed: int, n_tiles: int, L: int, stray: bool = True,
                  empty_tile: int | None = None):
    """Random receiver-sorted edges, each sender within about one node tile
    of its receiver, in the pair-blocked layout (several sender tiles per
    receiver tile, padding slots), with the inputs of the fused2 edge step:
    proj_u, proj_v ~ N(0, 1), e ~ N(0, 1), weights ~ N(0, 1/L), biases ~
    N(0, 1). With ``stray`` and several tiles, one real slot's receiver and
    another's sender are moved out of their block's tiles (the layout never
    does that; the kernels must read zero there). Numpy arrays for both
    packages; ``idx`` holds the layout and its sender view. With
    ``empty_tile``, no real edge receives in that node tile."""
    rng = np.random.default_rng(seed)
    num_nodes = n_tiles * NODE_TILE
    E = 4 * num_nodes
    rcv = np.sort(rng.integers(0, num_nodes, size=E))
    shift = rng.integers(-1, 2, size=E) * NODE_TILE
    snd = np.clip(rcv + shift + rng.integers(-40, 40, size=E), 0, num_nodes - 1)
    if empty_tile is not None:
        keep = rcv // NODE_TILE != empty_tile
        rcv, snd = rcv[keep], snd[keep]
        E = len(rcv)
    snd_b, rcv_b, _, gid_b, _, block_tile, block_snd_tile = blockify_edges_pair(
        senders=snd, receivers=rcv, edge_weight=np.ones(E, np.float32),
        edge_gid=np.zeros(E, np.int64), num_nodes=num_nodes, n_graphs=1,
    )
    if stray and n_tiles > 1:
        real = np.flatnonzero(gid_b == 0)
        i, j = real[len(real) // 3], real[2 * len(real) // 3]
        rcv_b[i] = (rcv_b[i] + NODE_TILE) % num_nodes
        snd_b[j] = (snd_b[j] + NODE_TILE) % num_nodes
    Ep = len(rcv_b)
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    arrays = {
        "proj_u": f32(num_nodes, L), "proj_v": f32(num_nodes, L), "e": f32(Ep, L),
        "w_e": f32(L, L, scale=L**-0.5), "b0": f32(L),
        "w2": f32(L, L, scale=L**-0.5), "b2": f32(L),
    }
    perm, srt, sbt = build_sender_view(snd_b, num_nodes)
    idx = {"receivers": rcv_b.astype(np.int32), "senders": snd_b.astype(np.int32),
           "edge_gid": gid_b.astype(np.int32), "block_tile": block_tile,
           "block_snd_tile": block_snd_tile, "snd_perm": perm, "snd_sorted": srt,
           "snd_block_tile": sbt}
    return arrays, idx


@pytest.mark.parametrize("L", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_reference_on_cuda(dtype, L):
    """Four node tiles, one without a real edge (its block is all padding),
    at each width the kernel is built for (128: the tile kernels of every
    configuration; bf16 at 256 runs the FMA kernel); the kernel's parts
    (one per SM) are several, a receiver run crosses a part's nominal end
    (its CTA's split moves that end to the run's end), and a real receiver
    has a tail of padding slots, as blockify_edges writes it. In fp32 z_upd
    equals the plain version exactly (the same FMA chains), R and M hold at
    the JAX op tolerances; in bf16 all three hold at 3e-2. The launch count
    rises by one per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays, idx = _edge_problem(5, 4, L=L, empty_tile=2)
    rcv_np, gid_np = idx["receivers"], idx["edge_gid"]
    n_parts = int(cuda_build.library("fused_edge3_fwd").lib.pdg_fused_edge3_fwd_parts())
    nominal = np.arange(1, n_parts) * -(-len(rcv_np) // n_parts)
    nominal = nominal[nominal < len(rcv_np)]
    assert len(nominal) > 1, "several parts"
    assert (rcv_np[nominal] == rcv_np[nominal - 1]).any(), "a run crosses a part's nominal end"
    tile_of_block = idx["block_tile"]
    assert 2 not in tile_of_block[np.flatnonzero(
        (gid_np.reshape(len(tile_of_block), -1) == 0).any(axis=1))], "tile 2 is all padding"
    tail = (gid_np[:-1] == 0) & (gid_np[1:] == 1) & (rcv_np[:-1] == rcv_np[1:])
    assert tail.any(), "a real receiver has a tail of padding slots"
    args = [T(a).to("cuda", dtype) for a in arrays.values()]
    rcv, gid, bt = (T(idx[k]).cuda() for k in ("receivers", "edge_gid", "block_tile"))
    before = cuda_build.launches["fused_edge3_fwd"]
    got = fused_edge3.fused_edge_step3(*args, rcv, (gid, bt), 1, NODE_TILE)
    assert cuda_build.launches["fused_edge3_fwd"] == before + 1
    want = fused_edge3.fused_edge_step3_reference(*args, rcv, gid, 1)
    if dtype == torch.float32:
        assert torch.equal(got[0], want[0])
    tols = (1e-5, 1e-4, 1e-3) if dtype == torch.float32 else (3e-2,) * 3
    for a, b, tol in zip(got, want, tols):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_two_calls_are_bit_equal_on_cuda(dtype):
    """The fused3 forward sums R and M in a fixed order: two calls on four
    node tiles (the first without a real edge), L = 128, give bit-equal
    z_upd, R and M."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays, idx = _edge_problem(15, 4, L=128, empty_tile=0)
    args = [T(a).to("cuda", dtype) for a in arrays.values()]
    rcv, gid, bt = (T(idx[k]).cuda() for k in ("receivers", "edge_gid", "block_tile"))
    got = [fused_edge3.fused_edge_step3(*args, rcv, (gid, bt), 1, NODE_TILE) for _ in range(2)]
    for a, b in zip(*got):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


def _split_run_inputs(seed: int) -> tuple:
    """The fused3 edge step's inputs (fp32, on the card) on a pair-blocked
    layout of three node tiles, L = 128, which splits a receiver's slots
    over several blocks: (args, receivers, edge_gid, block_tile)."""
    from p_div_gnn_tpu_torch.ops.segment import runs_are_consecutive

    arrays, idx = _pair_problem(seed, 3, L=128, stray=False)
    rcv, gid, bt = (T(np.asarray(idx[k], np.int32)).cuda()
                    for k in ("receivers", "edge_gid", "block_tile"))
    Np, L = 3 * NODE_TILE, 128
    assert not runs_are_consecutive(rcv, Np)
    rng = np.random.default_rng(seed + 1)
    x = T(rng.normal(size=(Np, L)).astype(np.float32)).cuda()
    g_x = x[T(np.asarray(idx["senders"], np.int64)).cuda()]
    w = [T((rng.normal(size=(L, L)) * L**-0.5).astype(np.float32)).cuda() for _ in range(4)]
    b0, b2 = (T(rng.normal(size=L).astype(np.float32)).cuda() for _ in range(2))
    e = T(arrays["e"]).cuda()
    return (x, g_x, e, w[0], w[1], w[2], b0, w[3], b2), rcv, gid, bt


def test_kernel_refuses_split_receiver_runs_on_cuda():
    """The fused3 forward writes each receiver's R row once, from one run:
    on a pair-blocked layout, which splits a receiver's slots over several
    blocks, it raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, rcv, gid, bt = _split_run_inputs(16)
    before = cuda_build.launches["fused_edge3_fwd"]
    with pytest.raises(ValueError, match="not consecutive"):
        fused_edge3.fused_edge_step3(*args, rcv, (gid, bt), 1, NODE_TILE)
    assert cuda_build.launches["fused_edge3_fwd"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_reference_on_cuda(dtype):
    """Three node tiles, L = 128, nonzero cotangents on z_upd, R and M; the
    launch count rises by one per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays, idx = _edge_problem(6, 3, L=128)
    args = [T(a).to("cuda", dtype) for a in arrays.values()]
    rcv, gid, bt = (T(idx[k]).cuda() for k in ("receivers", "edge_gid", "block_tile"))
    z_upd, _, _ = fused_edge3.fused_edge_step3_reference(*args, rcv, gid, 1)
    rng = np.random.default_rng(7)
    Np, L = arrays["x"].shape
    dz = T(rng.normal(size=z_upd.shape).astype(np.float32)).to("cuda", dtype)
    dr = T(rng.normal(size=(Np, L)).astype(np.float32)).cuda()
    dm = T(rng.normal(size=(8, L)).astype(np.float32)).cuda()
    before = cuda_build.launches["fused_edge3_bwd"]
    got = fused_edge3.fused_edge_step3_backward(*args, rcv, (gid, bt), 1, NODE_TILE,
                                                z_upd, dz, dr, dm)
    assert cuda_build.launches["fused_edge3_bwd"] == before + 1
    want = fused_edge3.fused_edge_step3_backward_reference(*args, rcv, gid, 1,
                                                           z_upd, dz, dr, dm)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_matches_reference_on_cuda(dtype):
    """The sender view of three node tiles in run order, L = 128, rows read
    through the permutation; the launch count rises by one per call. The
    same view in the JAX package's order, whose senders' slots are not
    consecutive, is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(8)
    num_nodes = 3 * NODE_TILE
    E = 6 * num_nodes
    view = [T(v) for v in build_sender_view(rng.integers(0, num_nodes, size=E), num_nodes)]
    perm, srt = (t.cuda() for t in sender_run_order(*view))
    sbt = view[2].cuda()
    rows = T(rng.normal(size=(E, 128)).astype(np.float32)).to("cuda", dtype)
    before = cuda_build.launches["segment_sum_csr"]
    got = scatter_csr.csr_segment_sum(rows, srt, sbt, num_nodes, NODE_TILE, perm=perm)
    assert cuda_build.launches["segment_sum_csr"] == before + 1
    want = scatter_csr.csr_segment_sum_reference(rows, srt, num_nodes, perm)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    jax_perm, jax_srt = view[0].cuda(), view[1].cuda()
    with pytest.raises(ValueError, match="not consecutive"):
        scatter_csr.csr_segment_sum(rows, jax_srt, sbt, num_nodes, NODE_TILE, perm=jax_perm)
    assert cuda_build.launches["segment_sum_csr"] == before + 1


@pytest.mark.parametrize("layout", ["sender", "receiver"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_runs_are_split_and_deterministic_on_cuda(dtype, layout):
    """Both callers' layouts over three node tiles, L = 128, with and without
    the permutation: one receiver's run is longer than a chunk, so it is
    summed in pieces; two calls give bit-equal sums, within the tolerance of
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows, layouts = _segment_problem(10, 3, L=128)
    rcv, bt, perm = (None if t is None else t.cuda() for t in layouts[layout])
    assert _longest_run(rcv) > RUN_CHUNK
    rows = rows.to("cuda", dtype)
    num_nodes = 3 * NODE_TILE
    before = cuda_build.launches["segment_sum_csr"]
    got = [scatter_csr.csr_segment_sum(rows, rcv, bt, num_nodes, NODE_TILE, perm=perm)
           for _ in range(2)]
    assert cuda_build.launches["segment_sum_csr"] == before + 2
    assert torch.equal(got[0], got[1])
    want = scatter_csr.csr_segment_sum_reference(rows, rcv, num_nodes, perm)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got[0], want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_steps_and_determinism_on_cuda(dtype):
    """The fused3 backward over three node tiles, L = 128, in blocks of 250
    slots, so no tile's slot count is a multiple of the kernel's edge step;
    the tiles' padding receivers have runs longer than an edge step. Two
    calls give bit-equal outputs, within the tolerance of the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays, idx = _edge_problem(11, 3, L=128, edge_block=250)
    counts = np.bincount(idx["block_tile"], minlength=3) * 250
    assert (counts % BWD_STEP != 0).any()
    args = [T(a).to("cuda", dtype) for a in arrays.values()]
    rcv, gid, bt = (T(idx[k]).cuda() for k in ("receivers", "edge_gid", "block_tile"))
    assert _longest_run(rcv) > BWD_STEP
    z_upd, _, _ = fused_edge3.fused_edge_step3_reference(*args, rcv, gid, 1)
    rng = np.random.default_rng(12)
    Np, L = arrays["x"].shape
    dz = T(rng.normal(size=z_upd.shape).astype(np.float32)).to("cuda", dtype)
    dr = T(rng.normal(size=(Np, L)).astype(np.float32)).cuda()
    dm = T(rng.normal(size=(8, L)).astype(np.float32)).cuda()
    got = [fused_edge3.fused_edge_step3_backward(*args, rcv, (gid, bt), 1, NODE_TILE,
                                                 z_upd, dz, dr, dm) for _ in range(2)]
    want = fused_edge3.fused_edge_step3_backward_reference(*args, rcv, gid, 1,
                                                           z_upd, dz, dr, dm)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    for a, b, c in zip(got[0], got[1], want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), rtol=tol, atol=tol)


def test_backward_kernel_refuses_split_receiver_runs_on_cuda():
    """The fused3 backward writes each receiver's dx row once, from one run:
    on a pair-blocked layout, which splits a receiver's slots over several
    blocks, it raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, rcv, gid, bt = _split_run_inputs(13)
    Np, Ep, L = 3 * NODE_TILE, rcv.shape[0], 128
    z_upd = torch.zeros((Ep, L), device="cuda")
    dz = torch.ones((Ep, L), device="cuda")
    dr = torch.ones((Np, L), device="cuda")
    dm = torch.zeros((8, L), device="cuda")
    before = cuda_build.launches["fused_edge3_bwd"]
    with pytest.raises(ValueError, match="not consecutive"):
        fused_edge3.fused_edge_step3_backward(*args, rcv, (gid, bt), 1, NODE_TILE,
                                              z_upd, dz, dr, dm)
    assert cuda_build.launches["fused_edge3_bwd"] == before


def test_remat_steps_give_the_same_gradients_on_cuda():
    """The fused3 training step through the kernels, with and without
    per-step rematerialization (torch.utils.checkpoint re-runs the forward
    kernel in the backward): the kernels are deterministic, so the
    gradients are bit-equal. Two meshes, L = 128, two message-passing
    steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
    from p_div_gnn_tpu_torch.train.loop import Trainer

    batch = build_workload(n_graphs=2, seed=0)[0].to("cuda")
    grads = []
    for remat in (False, True):
        model = EncodeProcessDecode(128, 2, scatter_impl="fused3", remat_steps=remat,
                                    generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, NormStats.ones(), divergence_penalty=10.0)
        before = cuda_build.launches["fused_edge3_fwd"]
        _, g = trainer.loss_and_grads(batch)
        assert cuda_build.launches["fused_edge3_fwd"] - before == (4 if remat else 2)
        grads.append(g)
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def _on_cuda(arrays, idx, dtype):
    args = [T(a).to("cuda", dtype) for a in arrays.values()]
    return args, tuple(T(idx[k]).cuda() for k in ("receivers", "edge_gid", "block_tile"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v2_kernel_matches_reference_on_cuda(dtype):
    """The v2 forward over three node tiles, L = 128; the launch count rises
    by one per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, (rcv, gid, bt) = _on_cuda(*_v2_problem(5, 3, L=128), dtype)
    before = cuda_build.launches["fused_edge_fwd"]
    got = fused_edge.fused_edge_step(*args, rcv, (gid, bt), 1, NODE_TILE)
    assert cuda_build.launches["fused_edge_fwd"] == before + 1
    want = fused_edge.fused_edge_step_reference(*args, rcv, gid, 1)
    tols = (1e-5, 1e-4, 1e-3) if dtype == torch.float32 else (3e-2,) * 3
    for a, b, tol in zip(got, want, tols):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v2_backward_kernel_matches_reference_on_cuda(dtype):
    """The v2 backward over three node tiles, L = 128, nonzero cotangents on
    z_upd, R and M; the launch count rises by one per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, (rcv, gid, bt) = _on_cuda(*_v2_problem(6, 3, L=128), dtype)
    z_upd, _, _ = fused_edge.fused_edge_step_reference(*args, rcv, gid, 1)
    rng = np.random.default_rng(7)
    Np, L = args[0].shape
    dz = T(rng.normal(size=z_upd.shape).astype(np.float32)).to("cuda", dtype)
    dr = T(rng.normal(size=(Np, L)).astype(np.float32)).cuda()
    dm = T(rng.normal(size=(8, L)).astype(np.float32)).cuda()
    before = cuda_build.launches["fused_edge_bwd"]
    got = fused_edge.fused_edge_step_backward(*args, rcv, (gid, bt), 1, NODE_TILE,
                                              z_upd, dz, dr, dm)
    assert cuda_build.launches["fused_edge_bwd"] == before + 1
    want = fused_edge.fused_edge_step_backward_reference(*args, rcv, gid, 1, z_upd, dz, dr, dm)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def test_pair_segment_sum_kernel_matches_reference_on_cuda():
    """Two fp32 streams over the sender view of three node tiles in run
    order, L = 128, read through the permutation; the launch count rises by
    one per call. The same view in the JAX package's order, whose senders'
    slots are not consecutive, is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(9)
    num_nodes = 3 * NODE_TILE
    E = 6 * num_nodes
    view = [T(v) for v in build_sender_view(rng.integers(0, num_nodes, size=E), num_nodes)]
    perm, srt = (t.cuda() for t in sender_run_order(*view))
    sbt = view[2].cuda()
    a, b = (T(rng.normal(size=(E, 128)).astype(np.float32)).cuda() for _ in range(2))
    before = cuda_build.launches["segment_sum_csr_pair"]
    got = scatter_csr.csr_segment_sum_pair(a, b, srt, sbt, num_nodes, NODE_TILE, perm=perm)
    assert cuda_build.launches["segment_sum_csr_pair"] == before + 1
    want = scatter_csr.csr_segment_sum_pair_reference(a, b, srt, num_nodes, perm)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="not consecutive"):
        scatter_csr.csr_segment_sum_pair(a, b, view[1].cuda(), sbt, num_nodes, NODE_TILE,
                                         perm=view[0].cuda())
    assert cuda_build.launches["segment_sum_csr_pair"] == before + 1


def _pair_sum_views(L: int) -> dict:
    """The pair sum's two callers' layouts, each a sender view in run order
    with its permutation over two streams of rows (Ep, L) fp32: "fused",
    the receiver-major layout's (the pair sender gather's backward; its
    padding slots all send from the last node), and "fused2", the
    pair-blocked layout's (the fused2 backward's sender-side sums). Values
    (a, b, run_sorted, snd_block_tile, run_perm, num_nodes) on the card."""
    views = {}
    rows, layouts = _segment_problem(12, 3, L)
    rcv, sbt, perm = layouts["sender"]
    views["fused"] = (rows, torch.flip(rows, (0,)).contiguous(), rcv, sbt, perm, 3 * NODE_TILE)
    _, idx = _pair_problem(12, 3, L=4, stray=False)
    run_perm, run_sorted = sender_run_order(*(T(np.asarray(idx[k])) for k in (
        "snd_perm", "snd_sorted", "snd_block_tile")))
    rng = np.random.default_rng(13)
    Ep = len(idx["receivers"])
    a, b = (T(rng.normal(size=(Ep, L)).astype(np.float32)) for _ in range(2))
    views["fused2"] = (a, b, run_sorted, T(np.asarray(idx["snd_block_tile"])), run_perm,
                       3 * NODE_TILE)
    return {k: tuple(t.cuda() if isinstance(t, torch.Tensor) else t for t in v)
            for k, v in views.items()}


@pytest.mark.parametrize("L", [6, 128, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_sum_redesign_on_both_views_on_cuda(dtype, L):
    """The redesigned pair sum (#4) on both callers' sender views in run
    order, at L = 6 (columns padded to 8), 128 and 600, fp32 and bf16 rows
    read as stored: within the segment-sum tolerance of the plain version
    (which casts the rows), one launch a call, two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for view, (a, b, srt, sbt, perm, num_nodes) in _pair_sum_views(L).items():
        a, b = a.to(dtype), b.to(dtype)
        before = cuda_build.launches["segment_sum_csr_pair"]
        got = [scatter_csr.csr_segment_sum_pair(a, b, srt, sbt, num_nodes, NODE_TILE, perm=perm)
               for _ in range(2)]
        assert cuda_build.launches["segment_sum_csr_pair"] == before + 2, view
        want = scatter_csr.csr_segment_sum_pair_reference(a, b, srt, num_nodes, perm)
        for x, y, z in zip(got[0], got[1], want):
            assert x.dtype == torch.float32 and x.shape == (num_nodes, L)
            assert torch.equal(x, y), view
            torch.testing.assert_close(x, z, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_at_width_18_on_cuda(dtype):
    """The segment sum (#3) at L = 18 (columns padded to 20) on both
    callers' layouts: within the tolerance of the plain version, one launch
    a call, two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows, layouts = _segment_problem(14, 3, L=18)
    rows = rows.to("cuda", dtype)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for layout in layouts.values():
        rcv, bt, perm = (None if t is None else t.cuda() for t in layout)
        before = cuda_build.launches["segment_sum_csr"]
        got = [scatter_csr.csr_segment_sum(rows, rcv, bt, 3 * NODE_TILE, NODE_TILE, perm=perm)
               for _ in range(2)]
        assert cuda_build.launches["segment_sum_csr"] == before + 2
        assert torch.equal(got[0], got[1]) and got[0].shape == (3 * NODE_TILE, 18)
        want = scatter_csr.csr_segment_sum_reference(rows, rcv, 3 * NODE_TILE, perm)
        torch.testing.assert_close(got[0], want, rtol=tol, atol=tol)


def test_fused_v2_training_step_is_deterministic_on_cuda():
    """The "fused" training step through its three kernels, twice from the
    same weights: every kernel sums in a fixed order, so the gradients are
    bit-equal; each step launches each kernel once per message-passing
    step. Two meshes, L = 128, two message-passing steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
    from p_div_gnn_tpu_torch.train.loop import Trainer

    batch = build_workload(n_graphs=2, seed=0)[0].to("cuda")
    counters = ("fused_edge_fwd", "fused_edge_bwd", "segment_sum_csr_pair")
    grads = []
    for _ in range(2):
        model = EncodeProcessDecode(128, 2, scatter_impl="fused", remat_steps=False,
                                    generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, NormStats.ones(), divergence_penalty=10.0)
        before = [cuda_build.launches[k] for k in counters]
        _, g = trainer.loss_and_grads(batch)
        assert [cuda_build.launches[k] - b for k, b in zip(counters, before)] == [2, 2, 2]
        grads.append(g)
    for name, g in grads[0].items():
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, grads[1][name]), name


def _pair_on_cuda(arrays, idx, dtype):
    """The fused2 step's inputs on the card, with the sender view in run
    order (as ``GraphBatch.to`` derives it: the pair sum's kernel needs
    each sender's slots consecutive)."""
    args = [T(a).to("cuda", dtype) for a in arrays.values()]
    ix = {k: T(np.array(v)).cuda() for k, v in idx.items()}
    run_perm, run_sorted = sender_run_order(ix["snd_perm"], ix["snd_sorted"],
                                            ix["snd_block_tile"])
    aux = (ix["edge_gid"], ix["block_tile"], ix["block_snd_tile"], run_perm, run_sorted,
           ix["snd_block_tile"])
    return args, ix["receivers"], ix["senders"], aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_kernel_matches_reference_on_cuda(dtype):
    """The fused2 forward over three node tiles of the pair-blocked layout,
    L = 128, with a slot whose receiver and one whose sender lie outside
    their block's tiles; the launch count rises by one per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, rcv, snd, aux = _pair_on_cuda(*_pair_problem(5, 3, L=128), dtype)
    before = cuda_build.launches["fused_edge2_fwd"]
    got = fused_edge.fused_edge_step2(*args, rcv, snd, aux, 1, NODE_TILE)
    assert cuda_build.launches["fused_edge2_fwd"] == before + 1
    want = fused_edge.fused_edge_step2_reference(*args, rcv, snd, aux, 1, NODE_TILE)
    tols = (1e-5, 1e-4, 1e-3) if dtype == torch.float32 else (3e-2,) * 3
    for a, b, tol in zip(got, want, tols):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_backward_kernel_matches_reference_on_cuda(dtype):
    """The fused2 backward kernel over three node tiles, L = 128, nonzero
    cotangents on z_upd, R and M, against its plain version; then the whole
    VJP (the kernel and the pair segment sum over the sender view) against
    the plain VJP. Each kernel's launch count rises by one per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, rcv, snd, aux = _pair_on_cuda(*_pair_problem(6, 3, L=128), dtype)
    z_upd, _, _ = fused_edge.fused_edge_step2_reference(*args, rcv, snd, aux, 1, NODE_TILE)
    rng = np.random.default_rng(7)
    Np, L = args[0].shape
    dz = T(rng.normal(size=z_upd.shape).astype(np.float32)).to("cuda", dtype)
    dr = T(rng.normal(size=(Np, L)).astype(np.float32)).cuda()
    dm = T(rng.normal(size=(8, L)).astype(np.float32)).cuda()
    cots = (z_upd, dz, dr, dm)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    before = cuda_build.launches["fused_edge2_bwd"]
    got = fused_edge.fused_edge2_bwd(*args, rcv, snd, aux, 1, NODE_TILE, *cots)
    assert cuda_build.launches["fused_edge2_bwd"] == before + 1
    want = fused_edge.fused_edge2_bwd_reference(*args, rcv, snd, aux, 1, NODE_TILE, *cots)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    pair_before = cuda_build.launches["segment_sum_csr_pair"]
    got = fused_edge.fused_edge_step2_backward(*args, rcv, snd, aux, 1, NODE_TILE, *cots)
    assert cuda_build.launches["segment_sum_csr_pair"] == pair_before + 1
    assert cuda_build.launches["fused_edge2_bwd"] == before + 2
    want = fused_edge.fused_edge_step2_backward_reference(*args, rcv, snd, aux, 1, NODE_TILE,
                                                          *cots)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def test_fused2_training_step_is_deterministic_on_cuda():
    """The "fused2" training step through its three kernels on a
    pair-blocked batch, twice from the same weights: the gradients are
    bit-equal and finite; each step launches each kernel once per
    message-passing step. Two meshes, L = 128, two message-passing steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
    from p_div_gnn_tpu_torch.train.loop import Trainer

    batch = build_workload(n_graphs=2, seed=0, pair_blocks=True)[0].to("cuda")
    counters = ("fused_edge2_fwd", "fused_edge2_bwd", "segment_sum_csr_pair")
    grads = []
    for _ in range(2):
        model = EncodeProcessDecode(128, 2, scatter_impl="fused2", remat_steps=False,
                                    generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, NormStats.ones(), divergence_penalty=10.0)
        before = [cuda_build.launches[k] for k in counters]
        _, g = trainer.loss_and_grads(batch)
        assert [cuda_build.launches[k] - b for k, b in zip(counters, before)] == [2, 2, 2]
        grads.append(g)
    for name, g in grads[0].items():
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, grads[1][name]), name


# --- widths (ROADMAP C1) and the redesigned v2 backwards (#6, #8)

FWD_TOLS = {torch.float32: (1e-5, 1e-4, 1e-3), torch.bfloat16: (3e-2,) * 3}
BWD_TOLS = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def _cots(seed: int, Ep: int, Np: int, L: int, dtype):
    rng = np.random.default_rng(seed)
    dz = T(rng.normal(size=(Ep, L)).astype(np.float32)).to("cuda", dtype)
    dr = T(rng.normal(size=(Np, L)).astype(np.float32)).cuda()
    dm = T(rng.normal(size=(8, L)).astype(np.float32)).cuda()
    return dz, dr, dm


def _kernel_case(kernel: str, L: int, dtype, seed: int = 5, n_tiles: int = 3,
                 empty_tile: int | None = None):
    """One fused kernel on the card at width L against its plain version:
    (kernel name, call, plain, tolerances); ``call()`` launches the kernel
    through its wrapper, ``plain()`` runs the plain version on the same
    inputs. With ``empty_tile`` (the v2 and pair-blocked steps), no real
    edge receives in that node tile."""
    if kernel.startswith("fused3"):
        args, (rcv, gid, bt) = _on_cuda(*_edge_problem(seed, n_tiles, L=L), dtype)
        if kernel == "fused3_fwd":
            return ("fused_edge3_fwd",
                    lambda: fused_edge3.fused_edge_step3(*args, rcv, (gid, bt), 1, NODE_TILE),
                    lambda: fused_edge3.fused_edge_step3_reference(*args, rcv, gid, 1),
                    FWD_TOLS[dtype])
        z, _, _ = fused_edge3.fused_edge_step3_reference(*args, rcv, gid, 1)
        cots = (z, *_cots(seed + 1, z.shape[0], args[0].shape[0], L, dtype))
        return ("fused_edge3_bwd",
                lambda: fused_edge3.fused_edge_step3_backward(*args, rcv, (gid, bt), 1,
                                                              NODE_TILE, *cots),
                lambda: fused_edge3.fused_edge_step3_backward_reference(*args, rcv, gid, 1,
                                                                        *cots),
                (BWD_TOLS[dtype],) * 9)
    if kernel.startswith("v2"):
        args, (rcv, gid, bt) = _on_cuda(*_v2_problem(seed, n_tiles, L=L,
                                                     empty_tile=empty_tile), dtype)
        if kernel == "v2_fwd":
            return ("fused_edge_fwd",
                    lambda: fused_edge.fused_edge_step(*args, rcv, (gid, bt), 1, NODE_TILE),
                    lambda: fused_edge.fused_edge_step_reference(*args, rcv, gid, 1),
                    FWD_TOLS[dtype])
        z, _, _ = fused_edge.fused_edge_step_reference(*args, rcv, gid, 1)
        cots = (z, *_cots(seed + 1, z.shape[0], args[0].shape[0], L, dtype))
        return ("fused_edge_bwd",
                lambda: fused_edge.fused_edge_step_backward(*args, rcv, (gid, bt), 1, NODE_TILE,
                                                            *cots),
                lambda: fused_edge.fused_edge_step_backward_reference(*args, rcv, gid, 1, *cots),
                (BWD_TOLS[dtype],) * 9)
    args, rcv, snd, aux = _pair_on_cuda(*_pair_problem(seed, n_tiles, L=L,
                                                       empty_tile=empty_tile), dtype)
    if kernel == "pair_fwd":
        return ("fused_edge2_fwd",
                lambda: fused_edge.fused_edge_step2(*args, rcv, snd, aux, 1, NODE_TILE),
                lambda: fused_edge.fused_edge_step2_reference(*args, rcv, snd, aux, 1,
                                                              NODE_TILE),
                FWD_TOLS[dtype])
    z, _, _ = fused_edge.fused_edge_step2_reference(*args, rcv, snd, aux, 1, NODE_TILE)
    cots = (z, *_cots(seed + 1, z.shape[0], args[0].shape[0], L, dtype))
    return ("fused_edge2_bwd",
            lambda: fused_edge.fused_edge2_bwd(*args, rcv, snd, aux, 1, NODE_TILE, *cots),
            lambda: fused_edge.fused_edge2_bwd_reference(*args, rcv, snd, aux, 1, NODE_TILE,
                                                         *cots),
            (BWD_TOLS[dtype],) * 9)


KERNELS = ("fused3_fwd", "fused3_bwd", "v2_fwd", "v2_bwd", "pair_fwd", "pair_bwd")


def _held(kernel, call, plain, tols):
    before = cuda_build.launches[kernel]
    got = call()
    assert cuda_build.launches[kernel] == before + 1
    want = plain()
    for a, b, tol in zip(got, want, tols, strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    return got, want


@pytest.mark.parametrize("L", [16, 96])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_other_widths_through_padding_on_cuda(dtype, kernel, L):
    """ROADMAP C1: each fused kernel at a width it is not built for (the
    backwards' and fused3's 16 and 96, run at 64 and 128 with zero columns)
    matches its plain version at the JAX op tolerances, with one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _held(*_kernel_case(kernel, L, dtype))


@pytest.mark.parametrize("L", [64, 128, 256])
@pytest.mark.parametrize("kernel", ["v2_fwd", "pair_fwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v2_forward_kernels_widths_and_determinism_on_cuda(dtype, kernel, L):
    """The redesigned v2 (#5) and pair-blocked (#7) forwards at each width
    they are built for (bf16 at 64 and 128 on the tensor cores, at 256 on
    the FMA chains), over four node tiles, one without a real edge (#5: its
    block is all padding): several parts (one per SM), a receiver run across
    a part's nominal end (#5), receivers met in several runs of their tile
    and a slot whose receiver and one whose sender lie outside their
    block's tiles (#7). In fp32 z_upd equals the plain version exactly (the
    same FMA chains); every output holds at the JAX op tolerances; two
    calls are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.ops.segment import runs_are_consecutive

    counter, call, plain, tols = _kernel_case(kernel, L, dtype, seed=8, n_tiles=4,
                                              empty_tile=2)
    if kernel == "v2_fwd":
        _, idx = _v2_problem(8, 4, L=L, empty_tile=2)
        rcv = idx["receivers"]
        n_parts = int(cuda_build.library("fused_edge_fwd").lib.pdg_fused_edge_fwd_parts())
        nominal = np.arange(1, n_parts) * -(-len(rcv) // n_parts)
        nominal = nominal[nominal < len(rcv)]
        assert len(nominal) > 1, "several parts"
        assert (rcv[nominal] == rcv[nominal - 1]).any(), "a run crosses a part's nominal end"
    else:
        _, idx = _pair_problem(8, 4, L=L, empty_tile=2)
        assert not runs_are_consecutive(T(idx["receivers"]), 4 * NODE_TILE), "split runs"
    got, want = _held(counter, call, plain, tols)
    if dtype == torch.float32:
        assert torch.equal(got[0], want[0])
    for a, b in zip(got, call()):
        assert torch.equal(a, b)


def test_v2_forward_kernel_refuses_split_receiver_runs_on_cuda():
    """The v2 forward writes each receiver's R row once, from one run: on a
    pair-blocked layout, which splits a receiver's slots over several
    blocks, it raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, idx = _pair_problem(13, 3, L=128, stray=False)
    rng = np.random.default_rng(15)
    Np, Ep, L = 3 * NODE_TILE, len(idx["receivers"]), 128
    f32 = lambda *s: T(rng.normal(size=s).astype(np.float32)).cuda()  # noqa: E731
    args = (f32(Np, L), f32(Np, L), f32(Ep, L), f32(Ep, L), f32(Ep, L), f32(L, L), f32(L),
            f32(L, L), f32(L))
    rcv, gid, bt = (T(np.asarray(idx[k], np.int32)).cuda()
                    for k in ("receivers", "edge_gid", "block_tile"))
    before = cuda_build.launches["fused_edge_fwd"]
    with pytest.raises(ValueError, match="not consecutive"):
        fused_edge.fused_edge_step(*args, rcv, (gid, bt), 1, NODE_TILE)
    assert cuda_build.launches["fused_edge_fwd"] == before


@pytest.mark.parametrize("L", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_other_widths_on_cuda(dtype, L):
    """The fused3 backward (#2) built at L = 64 (64-slot edge steps) and 256
    (16-slot steps, the split weights from a ring) against its plain
    version over three node tiles; two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counter, call, plain, tols = _kernel_case("fused3_bwd", L, dtype, seed=6)
    got, _ = _held(counter, call, plain, tols)
    for a, b in zip(got, call()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L", [64, 128, 256])
@pytest.mark.parametrize("kernel", ["v2_bwd", "pair_bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v2_backward_kernels_widths_and_determinism_on_cuda(dtype, kernel, L):
    """The redesigned v2 (#6) and pair-blocked (#8) backwards at each width
    they are built for, over three node tiles: several parts, a receiver run
    across a part's nominal end (#6), a receiver met in several runs of its
    tile (#8, the layout's split runs), a slot whose receiver and one whose
    sender lie outside their block's tiles (#8); every output within the
    JAX op tolerance of the plain version, two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.ops.segment import runs_are_consecutive

    counter, call, plain, tols = _kernel_case(kernel, L, dtype, seed=6)
    if kernel == "v2_bwd":
        _, idx = _v2_problem(6, 3, L=L)
        rcv = idx["receivers"]
        nominal = np.arange(1, -(-len(rcv) // 512)) * 512
        assert (rcv[nominal] == rcv[nominal - 1]).any(), "a run crosses a part's nominal end"
    else:
        _, idx = _pair_problem(6, 3, L=L)
        assert not runs_are_consecutive(T(idx["receivers"]), 3 * NODE_TILE), "split runs"
    got, _ = _held(counter, call, plain, tols)
    for a, b in zip(got, call()):
        assert torch.equal(a, b)


# the weight-grad pass's stream sets: #2's four weight grads (dW2, dWe,
# dWu, dWv over h1, dy1, h2, dy2, e, dps, dpre1, dpre2, g and x[r]), and
# the v2 backwards' two (dW2, dWe, with #8's e rows at listed slots)
WGRAD_SETS = {
    "fused3": ([[(0, 1), (2, 3)], [(4, 5)], [(9, 6), (8, 7)], [(9, 7), (8, 6)]], 9),
    "v2": ([[(0, 1), (2, 3)], [(4, 5)]], 4),
}


@pytest.mark.parametrize("streams", ["fused3", "v2"])
@pytest.mark.parametrize("L", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_pass_matches_fp64_sum_on_cuda(dtype, L, streams):
    """The weight-grad pass alone (ops/wgrad.py) against Σ AᵀB in fp64:
    4 weight grads of 2, 1, 2, 2 pairs or 2 of 2 and 1, over 20,011 rows (no
    multiple of a 32-row item, nor of a chunk), one stream read at indices
    that include -1 and values past its end (zero rows); each entry within
    1e-5 of Σ|A|ᵀ|B| (the three-term split drops products below 2^-24 of
    it, the tensor cores' k16 sums truncate near 2^-23), two calls
    bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.ops import wgrad

    pairs, indexed = WGRAD_SETS[streams]
    n, n_idx = 20_011, 3_001
    rng = np.random.default_rng(L + 7 * (dtype == torch.bfloat16) + len(pairs))
    f = lambda rows: T(rng.normal(size=(rows, L)).astype(np.float32)).to("cuda", dtype)  # noqa: E731
    n_src = 1 + max(max(a, b) for m in pairs for a, b in m)
    src = [f(n_idx if k == indexed else n) for k in range(n_src)]
    at_idx = [k == indexed for k in range(n_src)]
    idx_np = rng.integers(0, n_idx, size=n).astype(np.int32)
    idx_np[::97] = -1
    idx_np[5::89] = n_idx + rng.integers(0, 5, size=len(idx_np[5::89]))
    idx = T(idx_np).cuda()
    got = [wgrad.wgrad_pass(src, at_idx, idx, pairs) for _ in range(2)]
    assert torch.equal(got[0], got[1])
    want = wgrad.wgrad_pass_reference(src, at_idx, idx, pairs, n)
    scale = wgrad.wgrad_pass_reference([s.abs() for s in src], at_idx, idx, pairs, n)
    assert scale.min() > 0
    worst = float(((got[0] - want).abs() / scale).max())
    assert worst < 1e-5, f"{worst:.3e} of Σ|A|ᵀ|B|"


def test_v2_backward_kernel_refuses_split_receiver_runs_on_cuda():
    """The v2 backward writes each receiver's da rows once, from one run: on
    a pair-blocked layout, which splits a receiver's slots over several
    blocks, it raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays, idx = _pair_problem(13, 3, L=128, stray=False)
    rng = np.random.default_rng(14)
    Np, Ep, L = 3 * NODE_TILE, len(idx["receivers"]), 128
    f32 = lambda *s: T(rng.normal(size=s).astype(np.float32)).cuda()  # noqa: E731
    args = (f32(Np, L), f32(Np, L), f32(Ep, L), f32(Ep, L), f32(Ep, L), f32(L, L), f32(L),
            f32(L, L), f32(L))
    rcv, gid, bt = (T(np.asarray(idx[k], np.int32)).cuda()
                    for k in ("receivers", "edge_gid", "block_tile"))
    cots = (torch.zeros((Ep, L), device="cuda"), f32(Ep, L), f32(Np, L), f32(8, L))
    before = cuda_build.launches["fused_edge_bwd"]
    with pytest.raises(ValueError, match="not consecutive"):
        fused_edge.fused_edge_step_backward(*args, rcv, (gid, bt), 1, NODE_TILE, *cots)
    assert cuda_build.launches["fused_edge_bwd"] == before


@pytest.mark.parametrize("L", [320, 512])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_wide_widths_on_cuda(dtype, kernel, L):
    """Each fused kernel above 256 runs its wide variant
    (csrc/wide_tile.cuh) and matches its plain version at the JAX op
    tolerances, with one launch; two calls are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counter, call, plain, tols = _kernel_case(kernel, L, dtype, n_tiles=2)
    got, _ = _held(counter, call, plain, tols)
    for a, b in zip(got, call()):
        assert torch.equal(a, b)


def test_fused3_training_step_at_width_64_on_cuda():
    """ROADMAP C1's symptom: a fused3 model at latent 64 takes a train step
    on the card through all three of its kernels, with finite gradients
    within 2e-4 (relative, per parameter) of the plain xla path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _fused3_training_step_matches_xla(64)


def test_fused3_training_step_at_width_384_on_cuda():
    """The same at latent 384, through the kernels' wide variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _fused3_training_step_matches_xla(384)


def _fused3_training_step_matches_xla(latent: int) -> None:
    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
    from p_div_gnn_tpu_torch.train.loop import Trainer

    batch = build_workload(n_graphs=2, seed=0)[0].to("cuda")
    grads = {}
    for impl in ("fused3", "xla"):
        model = EncodeProcessDecode(latent, 2, scatter_impl=impl, remat_steps=False,
                                    generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, NormStats.ones(), divergence_penalty=10.0)
        before = [cuda_build.launches["fused_edge3_fwd"],
                  cuda_build.launches["fused_edge3_bwd"]]
        terms, grads[impl] = trainer.loss_and_grads(batch)
        after = [cuda_build.launches["fused_edge3_fwd"],
                 cuda_build.launches["fused_edge3_bwd"]]
        assert [a - b for a, b in zip(after, before)] == ([2, 2] if impl == "fused3" else [0, 0])
        assert torch.isfinite(terms["total"])
    for name, g in grads["fused3"].items():
        ref = grads["xla"][name]
        assert torch.isfinite(g).all(), name
        assert float((g - ref).norm()) <= 2e-4 * float(ref.norm()) + 1e-12, name


# --- the loader's bucketed batches

@pytest.mark.parametrize("kernel", ["fused3_fwd", "fused3_bwd", "v2_fwd", "v2_bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_a_loader_batch_on_cuda(dtype, kernel):
    """A batch at GraphLoader's bucketed capacities gives its spare edge
    capacity to its last node tile: one padding run at its last node
    (~18,000 slots for two flagship meshes), which the kernels' run-aligned
    parts would hand to one CTA. The fused3 and v2 wrappers run their
    kernels up to the last real slot only (``ops/segment.py::live_slots``)
    and match the plain versions over every slot, with one launch; two
    calls are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.datagen.workload import build_samples
    from p_div_gnn_tpu_torch.train.data import GraphLoader

    b = GraphLoader(build_samples(2, seed=0), 2, device="cuda")._pack(range(2)).to("cuda")
    assert _longest_run(b.receivers) > 10_000
    rng = np.random.default_rng(3)
    L, Np, Ep = 128, b.num_nodes_padded, b.num_edges_padded
    f32 = lambda *s, scale=1.0: T((rng.normal(size=s) * scale).astype(np.float32))  # noqa: E731
    w = lambda: f32(L, L, scale=L**-0.5)  # noqa: E731
    x = f32(Np, L)
    snd = b.senders.cpu().long()
    if kernel.startswith("fused3"):
        names = ("fused_edge3_fwd", "fused_edge3_bwd")
        step, reference = fused_edge3.fused_edge_step3, fused_edge3.fused_edge_step3_reference
        bwd = fused_edge3.fused_edge_step3_backward
        bwd_reference = fused_edge3.fused_edge_step3_backward_reference
        inputs = (x, x[snd], f32(Ep, L), w(), w(), w(), f32(L), w(), f32(L))
    else:
        names = ("fused_edge_fwd", "fused_edge_bwd")
        step, reference = fused_edge.fused_edge_step, fused_edge.fused_edge_step_reference
        bwd = fused_edge.fused_edge_step_backward
        bwd_reference = fused_edge.fused_edge_step_backward_reference
        a_u, a_v = f32(Np, L), f32(Np, L)
        inputs = (a_u, a_v, a_v[snd], a_u[snd], f32(Ep, L), w(), f32(L), w(), f32(L))
    args = [t.to("cuda", dtype) for t in inputs]
    rcv, gid, bt, G = b.receivers, b.edge_gid, b.edge_block_tile, b.n_graphs
    if kernel.endswith("fwd"):
        case = (names[0], lambda: step(*args, rcv, (gid, bt), G, b.tile),
                lambda: reference(*args, rcv, gid, G), FWD_TOLS[dtype])
    else:
        z, _, _ = reference(*args, rcv, gid, G)
        cots = (z, *_cots(4, Ep, Np, L, dtype))
        case = (names[1], lambda: bwd(*args, rcv, (gid, bt), G, b.tile, *cots),
                lambda: bwd_reference(*args, rcv, gid, G, *cots), (BWD_TOLS[dtype],) * 9)
    got, _ = _held(*case)
    for a, c in zip(got, case[1]()):
        assert torch.equal(a, c)


def test_meshgraphnets_steps_on_a_loader_batch_on_cuda():
    """MeshGraphNets (latent 128, 15 blocks) trains on a GraphLoader batch of
    two benchmark meshes, whose spare edge capacity lies after its last
    real slot. The edge stream runs on the live slots: the second step
    reads no layout from the device (``host_sync.*`` 0; the live slots and
    #3's run checks are kept with the batch), every block's edge MLP runs
    over the live slots in the edge update's kernel (``mgn.edge_fused_rows``
    15 · n, one ``mgn_edge_fwd`` launch a block and step), and the first
    step's loss and gradients match those of the same meshes packed with no
    spare edge capacity (1e-6 relative, per parameter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from p_div_gnn_tpu_torch.datagen.workload import build_samples
    from p_div_gnn_tpu_torch.graphs.batching import NodeFieldSample, pack_batch
    from p_div_gnn_tpu_torch.models import meshgraphnets as mgn
    from p_div_gnn_tpu_torch.train.data import GraphLoader
    from p_div_gnn_tpu_torch.train.loop import Trainer
    from p_div_gnn_tpu_torch.utils import profiling

    rng = np.random.default_rng(7)
    samples = []
    for s in build_samples(2, seed=0):
        types = np.eye(mgn.NODE_TYPES)[rng.integers(0, mgn.WALL_BOUNDARY + 1, s.num_nodes)]
        velocity = rng.normal(size=(s.num_nodes, mgn.VELOCITY))
        samples.append(NodeFieldSample(
            **{f.name: getattr(s, f.name) for f in dataclasses.fields(s)},
            node_inputs=np.concatenate([velocity, types], axis=1).astype(np.float32),
            node_targets=rng.normal(size=(s.num_nodes, mgn.OUT_FEATURES)).astype(np.float32)))
    spare = GraphLoader(samples, 2, device="cuda")._pack(range(2)).to("cuda")
    tight = pack_batch(samples, n_graphs=2, pad_nodes=spare.num_nodes_padded,
                       reorder="rcm").to("cuda")
    n = mgn.live_edges(spare).n
    assert mgn.live_edges(tight).n == n
    assert tight.num_edges_padded < spare.num_edges_padded and n < spare.num_edges_padded
    stats = mgn.compute_mgn_stats(samples)

    def first_step(batch):
        model = mgn.MeshGraphNets(stats=stats, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model=model, learning_rate=1e-4, objective=mgn.objective,
                          device="cuda")
        trainer.init()
        loss = float(trainer.train_step(batch)["total"])
        return trainer, loss, {k: p.grad.clone() for k, p in model.named_parameters()}

    before = cuda_build.launches["mgn_edge_fwd"]
    trainer, loss, grads = first_step(spare)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        trainer.train_step(spare)
        torch.cuda.synchronize()
    rec = profiling.recorded()
    S = trainer.model.message_passing_steps
    assert rec.counted("host_sync") == 0, rec.counters
    assert rec.counters["mgn.edge_rows"] == S * n
    # every block's edge update ran the kernel: one launch each
    assert rec.counters["mgn.edge_fused_rows"] == S * n
    assert cuda_build.launches["mgn_edge_fwd"] - before == 2 * S
    _, want_loss, want = first_step(tight)
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss)
    for name, g in want.items():
        assert torch.isfinite(grads[name]).all(), name
        assert float((grads[name] - g).norm()) <= 1e-6 * float(g.norm()), name


def _mgn_edge_on_a_loader_batch():
    """MeshGraphNets' edge update inputs on a GraphLoader batch of two
    benchmark meshes (L = 128, the batch's live slots, random rows and
    weights), on the card: (differentiable inputs p_s, p_r, e, w_e, b0, w1,
    b1, w2, b2, gamma, beta; mask; layout)."""
    from p_div_gnn_tpu_torch.datagen.workload import build_samples
    from p_div_gnn_tpu_torch.models import meshgraphnets as mgn
    from p_div_gnn_tpu_torch.train.data import GraphLoader

    b = GraphLoader(build_samples(2, seed=0), 2, device="cuda")._pack(range(2)).to("cuda")
    edges = mgn.live_edges(b)
    assert edges.n < b.num_edges_padded
    rng = np.random.default_rng(11)
    L, Np = 128, b.num_nodes_padded
    f32 = lambda *s, scale=1.0: T(  # noqa: E731
        (rng.normal(size=s) * scale).astype(np.float32)).cuda()
    w = lambda: f32(L, L, scale=L**-0.5)  # noqa: E731
    floats = [f32(Np, L), f32(Np, L), f32(edges.n, L), w(), f32(L), w(), f32(L), w(), f32(L),
              1 + f32(L, scale=0.1), f32(L, scale=0.1)]
    layout = (edges.senders, edges.receivers, edges.block_tile, edges.view, edges.tile)
    return floats, edges.mask.float()[:, None], layout


def _mgn_grouped(floats) -> tuple:
    """``mgn_edge.edge_update``'s tensors from the flat inputs: the later
    layers' weights and biases as one sequence."""
    return (*floats[:5], tuple(floats[5:9]), *floats[9:])


# MeshGraphNets' edge update kernel (bf16x6 split products on the tensor
# cores) against its plain version (cuBLAS's fp32 FMA chains): outputs to
# chip_smoke's MGN_EDGE_TOL (1e-5, rtol = atol), whose comment gives the
# reason; the Function's gradients, its plain backward run on the kernel's
# saved tensors against autograd through the plain composition, each to
# 1e-5 of its norm (the saved rows differ by ulps, which the backward's
# sums carry at the same relative size; a ReLU gate flipped at a value
# within an ulp of nought moves one entry).
MGN_EDGE_TOL, MGN_EDGE_GRAD_TOL = 1e-5, 1e-5


def test_mgn_edge_kernel_matches_plain_on_a_loader_batch_on_cuda():
    """The edge update's kernel on a GraphLoader batch's live slots: e',
    e + e' and what it saves (a0, a1, y, mean, rstd) against the plain
    version; two calls bit-equal; one launch a call; the Function's
    gradients against autograd through the plain composition."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.ops import mgn_edge
    from p_div_gnn_tpu_torch.ops.gather import sender_gather_one

    floats, mask, layout = _mgn_edge_on_a_loader_batch()
    snd, rcv, block_tile, view, tile = layout
    args = (*_mgn_grouped([t.detach() for t in floats]), mask, snd, rcv)
    before = cuda_build.launches["mgn_edge_fwd"]
    got = [mgn_edge._edge_update_cuda(*args, saves=True) for _ in range(2)]
    assert cuda_build.launches["mgn_edge_fwd"] == before + 2
    got = [(new, total, *saved) for new, total, saved in got]
    want = mgn_edge.edge_update_reference(*args)
    for a, b, c in zip(got[0], got[1], (*want[:2], *want[2])):
        assert torch.equal(a, b)
        assert a.shape == c.shape and a.dtype == c.dtype
        torch.testing.assert_close(a, c, rtol=MGN_EDGE_TOL, atol=MGN_EDGE_TOL)

    for t in floats:
        t.requires_grad_(True)
    out = mgn_edge.edge_update(*_mgn_grouped(floats), mask, *layout)
    p_s, p_r, e, w_e, b0, w1, b1, w2, b2, gamma, beta = floats
    pre = sender_gather_one(p_s, snd, view, tile) + p_r.index_select(0, rcv) + e @ w_e + b0
    y = torch.relu(torch.relu(pre) @ w1 + b1) @ w2 + b2
    e_new = torch.nn.functional.layer_norm(y, (128,), gamma, beta, mgn_edge.LN_EPS) * mask
    plain = (e_new, e + e_new)
    rng = np.random.default_rng(12)
    cots = [T(rng.normal(size=t.shape).astype(np.float32)).cuda() for t in out]
    g_got = torch.autograd.grad(out, floats, cots)
    g_want = torch.autograd.grad(plain, floats, cots)
    names = ("p_s", "p_r", "e", "w_e", "b0", "w1", "b1", "w2", "b2", "gamma", "beta")
    for name, a, b in zip(names, g_got, g_want):
        assert torch.isfinite(a).all(), name
        assert float((a - b).norm()) <= MGN_EDGE_GRAD_TOL * float(b.norm()), name


# --- the parallel tier: an edge-partitioned step over two ranks

def _partitioned_rank(rank, world, group, plan, state):
    """One fused3 fp32 edge-partitioned train step on this rank's shard:
    its loss terms, the gradients averaged over the ranks and the launches
    of #1-#3. NCCL puts rank r on card r; gloo puts every rank on card 0."""
    import torch.distributed as dist

    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode, Halo
    from p_div_gnn_tpu_torch.parallel.dp import shard_of
    from p_div_gnn_tpu_torch.parallel.partition import make_partitioned_train_step

    dev = torch.device("cuda", rank if dist.get_backend(group) == "nccl" else 0)
    model = EncodeProcessDecode(128, 2, scatter_impl="fused3", remat_steps=False)
    model.load_state_dict(state)
    model.to(dev)
    step = make_partitioned_train_step(model, NormStats.ones(), torch.optim.Adam(
        model.parameters(), lr=1e-3), group, divergence_penalty=10.0, optimize_divergence=True)
    stacked, send_idx = plan
    counters = ("fused_edge3_fwd", "fused_edge3_bwd", "segment_sum_csr")
    before = [cuda_build.launches[k] for k in counters]
    aux = step(shard_of(stacked, rank).to(dev), Halo(torch.as_tensor(send_idx[rank]).to(dev),
                                                     group))
    return {"aux": {k: float(v) for k, v in aux.items()},
            "launches": [cuda_build.launches[k] - b for k, b in zip(counters, before)],
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()}}


def test_partitioned_fused3_step_over_two_ranks_on_cuda():
    """Two meshes of the benchmark split over two ranks (NCCL with two
    cards, else gloo with both ranks on card 0, as chip_smoke.py chooses):
    #1-#3 run on each shard's extended [local ++ ghost] layout, twice a
    step each, and the step gives the single-card step's loss terms (rtol
    5e-4, divergence 5e-3: tests/test_partition.py) and gradients (2e-4
    relative, per parameter)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
    from p_div_gnn_tpu_torch.parallel.launch import run_ranks
    from p_div_gnn_tpu_torch.parallel.partition import partition_batch
    from p_div_gnn_tpu_torch.train.loop import Trainer

    host = build_workload(n_graphs=2, seed=0)[0]
    model = EncodeProcessDecode(128, 2, scatter_impl="fused3", remat_steps=False,
                                generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    want, grads = Trainer(model, NormStats.ones(), divergence_penalty=10.0).loss_and_grads(
        host.to("cuda"))
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    ranks = run_ranks(_partitioned_rank, 2, partition_batch(host, 2), state, backend=backend)
    for r in ranks:
        assert r["launches"] == [2, 2, 2]
        for k, rtol in (("total", 5e-4), ("nmse", 5e-4), ("divergence", 5e-3)):
            assert abs(r["aux"][k] - float(want[k])) <= rtol * abs(float(want[k])), k
        for name, g in grads.items():
            got = r["grads"][name].to(g.device)
            assert torch.isfinite(got).all(), name
            assert float((got - g).norm()) <= 2e-4 * float(g.norm()) + 1e-12, name


def test_generated_set_served_through_the_cli_on_cuda(tmp_path):
    """A 4-mesh set made by the port's generator (``cli.generate_main``, two
    workers) and served through ``cli.infer_main`` with fused3 from the
    committed ``elast_200e_div`` checkpoint and its inference config: #1
    launches 10 times for the one batch, and every field matches
    ``Predictor`` on the plain xla path at the serve tolerance (rtol 2e-4 /
    atol 2e-5 standardized)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    from pathlib import Path

    from p_div_gnn_tpu_torch import cli
    from p_div_gnn_tpu_torch.graphs.dataset import MeshStressFieldDataset
    from p_div_gnn_tpu_torch.inference import Predictor
    from p_div_gnn_tpu_torch.utils.configio import read_config, read_csv

    root = Path(__file__).resolve().parents[1]
    cli.generate_main(["--dataset_path", str(tmp_path / "data"), "--n_samples", "5",
                       "--test_size", "0.8", "--seed", "3", "--max_workers", "2"])
    csv = tmp_path / "data/test/dataset.csv"
    cfg = read_config(root / "scripts/configs_inference/config_inference_div.yml")
    weights = root / "checkpoints/elast_200e_div" / Path(cfg["model_weights_path"]).name
    cfg.update(dataset_csv=str(csv), results_folder=str(tmp_path / "inf"),
               model_weights_path=str(weights), scatter_impl="fused3")
    config = tmp_path / "infer.yml"
    config.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
    before = cuda_build.launches["fused_edge3_fwd"]
    cli.infer_main(["--config_path", str(config)])
    assert cuda_build.launches["fused_edge3_fwd"] - before == cfg["message_passing_steps"]
    samples = MeshStressFieldDataset(read_csv(csv)).samples
    assert len(samples) == 4
    want = Predictor(weights, scatter_impl="xla").predict(samples)
    norm = json.loads((tmp_path / "inf/normalize_params.json").read_text())
    z = lambda f: (f - norm["mean_local_stress"]) / norm["std_local_stress"]  # noqa: E731
    for path, w in zip(read_csv(tmp_path / "inf/dataset.csv")["data_filename"], want,
                       strict=True):
        np.testing.assert_allclose(z(np.load(path)["stress_field"]), z(w), rtol=2e-4,
                                   atol=2e-5)


def test_graphcast_train_step_on_cuda():
    """GraphCast (L = 128, SiLU, 2 processor steps) on a 10° grid and mesh
    levels 1-2: one AdamW step with clipping on the card against the same
    step on the CPU (the plain segment sums there): the loss to 1e-5 and
    each gradient to 1e-4 of its norm, relative; #3 launched 3 times an
    interaction step, MeshGraphNets' kernel never (GraphCast's edge updates
    run ``mgn_edge.plain_edge_update``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from p_div_gnn_tpu_torch.graphs.grid_mesh import grid_mesh_graph
    from p_div_gnn_tpu_torch.graphs.typed import TypedSample
    from p_div_gnn_tpu_torch.models import graphcast as gc
    from p_div_gnn_tpu_torch.train.loop import Trainer

    graph = grid_mesh_graph(10.0, [1, 2], 0.6)
    n, n_padded = graph.nodes["grid"].n, graph.nodes["grid"].n_padded
    rng = np.random.default_rng(26)
    x, y = np.zeros((n_padded, gc.INPUTS), np.float32), np.zeros((n_padded, gc.TARGETS),
                                                                 np.float32)
    x[:n], y[:n] = rng.normal(size=(n, gc.INPUTS)), rng.normal(size=(n, gc.TARGETS))
    sample = TypedSample(graph, x, y, np.array([n], np.int32))
    steps, readings = 2, {}
    for device in ("cpu", "cuda"):
        model = gc.GraphCast(latent_size=128, message_passing_steps=steps,
                             stats=gc.compute_graphcast_stats([sample]),
                             generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model=model, objective=gc.objective, device=device, betas=(0.9, 0.95),
                          weight_decay=0.1, clip_norm=32.0)
        before = dict(cuda_build.launches)
        loss = float(trainer.train_step(sample)["total"])
        launched = {k: v - before.get(k, 0) for k, v in cuda_build.launches.items()
                    if v != before.get(k, 0)}
        readings[device] = (loss, {k: p.grad.double().cpu()
                                   for k, p in model.named_parameters()}, launched)
    (want, g_want, _), (got, g_got, launched) = readings["cpu"], readings["cuda"]
    assert launched == {"segment_sum_csr": 3 * (steps + 2)}
    assert abs(got - want) <= 1e-5 * abs(want)
    for name, g in g_want.items():
        assert float((g_got[name] - g).norm()) <= 1e-4 * max(float(g.norm()), 1e-30), name
