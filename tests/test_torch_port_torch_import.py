"""The port's ``.pth`` import and export (``models/torch_import.py``)
against the JAX package's (``p_div_gnn_tpu/models/torch_import.py``):

- a ``.pth`` written by the JAX ``save_torch_checkpoint`` loads into the
  port, whose forward matches the JAX forward of the same weights at rtol
  2e-4 / atol 2e-5 on standardized outputs (``test_torch_port_model.py``'s
  tolerance);
- a ``.pth`` written by the port loads in JAX with bit-equal weights and
  stats, and back into the port unchanged;
- the reference's key names (``processor.edge_net.4.bias``, ...) and
  arrays are exactly JAX's."""

from pathlib import Path

import jax
import numpy as np
import torch

from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.models import torch_import as jax_ti
from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.models import torch_import
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.models.params import params_to_jax
from p_div_gnn_tpu_torch.train.checkpoint import load_checkpoint

from test_torch_port_model import STATS, _batches

CKPT = Path(__file__).resolve().parents[1] / "checkpoints/elast_200e_div/model_weights.ckpt"
RTOL, ATOL = 2e-4, 2e-5


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_pth_loads_into_the_port(tmp_path):
    _, host, ref = _batches((0, 1), n_graphs=3)
    jstats = JaxNormStats.from_dict(STATS)
    jmodel = JaxEPD(latent_size=16, message_passing_steps=3, remat_steps=False)
    params = jmodel.init(jax.random.PRNGKey(1), ref, jstats)
    jax_ti.save_torch_checkpoint(tmp_path / "w.pth", params, jstats, epoch=7)
    want = np.asarray(jmodel.apply(params, ref, jstats, scale_output=False))

    state_dict, stats, epoch = torch_import.load_torch_checkpoint(tmp_path / "w.pth")
    assert epoch == 7
    j_params, j_stats, _ = jax_ti.load_torch_checkpoint(tmp_path / "w.pth")
    assert stats.to_dict() == j_stats.to_dict()
    model = EncodeProcessDecode(latent_size=16, message_passing_steps=3).eval()
    model.load_state_dict(state_dict)
    with torch.no_grad():
        got = model(host.to("cpu"), stats, scale_output=False).numpy()
    real = host.node_gid < host.n_graphs
    np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)
    # the same arrays JAX's import gives
    a, b = _leaves(params_to_jax(state_dict)), _leaves(j_params)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_pth_loads_in_jax_bit_equal(tmp_path):
    state_dict, _, stats = load_checkpoint(CKPT)
    torch_import.save_torch_checkpoint(tmp_path / "p.pth", state_dict, stats, epoch=200)
    params, j_stats, epoch = jax_ti.load_torch_checkpoint(tmp_path / "p.pth")
    assert epoch == 200
    want = {k: float(np.float32(v)) for k, v in stats.to_dict().items()}
    assert j_stats.to_dict() == want
    a, b = _leaves(params), _leaves(params_to_jax(state_dict))
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back, back_stats, back_epoch = torch_import.load_torch_checkpoint(tmp_path / "p.pth")
    assert back_epoch == 200 and back_stats.to_dict() == want
    assert back.keys() == state_dict.keys()
    for k in state_dict:
        assert torch.equal(back[k], state_dict[k]), k


def test_reference_key_names_are_jax_s():
    state_dict, _, _ = load_checkpoint(CKPT)
    got = torch_import.state_dict_from_params(state_dict)
    params = params_to_jax(state_dict)
    want = jax_ti.state_dict_from_params(params)
    assert list(got) == list(want)
    assert "processor.edge_net.4.bias" in got and "node_decoder.2.weight" in got
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the import is the inverse of the export
    again = torch_import.params_from_state_dict(got)
    for k in state_dict:
        assert torch.equal(again[k], state_dict[k]), k
