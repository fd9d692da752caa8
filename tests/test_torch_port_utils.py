"""The port's precision policy and profiling helpers against the JAX
package's (``p_div_gnn_tpu/utils/{precision,profiling}.py``):

- ``matmul_precision`` reads ``PDG_MATMUL_PRECISION`` with the JAX names,
  maps each onto torch's fp32 matmul precision (``highest`` / ``float32``
  → "highest", TF32 off, the default; ``high`` → "high"; ``default`` /
  ``bfloat16`` → "medium"), and raises on an unknown name as JAX does;
- ``compiled_stats`` of one matmul gives JAX's flops; ``timeit`` and
  ``trace`` run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_div_gnn_tpu.utils import precision as jax_precision
from p_div_gnn_tpu.utils import profiling as jax_profiling
from p_div_gnn_tpu_torch.utils import precision, profiling

EXPECTED = {"highest": ("highest", jax.lax.Precision.HIGHEST),
            "float32": ("highest", jax.lax.Precision.HIGHEST),
            "high": ("high", jax.lax.Precision.HIGH),
            "default": ("medium", jax.lax.Precision.DEFAULT),
            "bfloat16": ("medium", jax.lax.Precision.DEFAULT)}


@pytest.fixture
def restore_precision():
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    yield
    torch.set_float32_matmul_precision(before[0])
    torch.backends.cudnn.allow_tf32 = before[1]


@pytest.mark.parametrize("name", [*EXPECTED, "HIGH", None])
def test_matmul_precision_names_match_jax(name, monkeypatch, restore_precision):
    if name is None:
        monkeypatch.delenv("PDG_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("PDG_MATMUL_PRECISION", name)
    torch_name, jax_name = EXPECTED[(name or "highest").lower()]
    assert jax_precision.matmul_precision() == jax_name
    assert precision.matmul_precision() == torch_name
    assert torch.get_float32_matmul_precision() == torch_name
    assert torch.backends.cuda.matmul.allow_tf32 == (torch_name != "highest")
    assert torch.backends.cudnn.allow_tf32 == (torch_name != "highest")


def test_unknown_precision_raises_as_jax(monkeypatch, restore_precision):
    monkeypatch.setenv("PDG_MATMUL_PRECISION", "tf32")
    with pytest.raises(KeyError):
        jax_precision.matmul_precision()
    with pytest.raises(KeyError):
        precision.matmul_precision()


def test_the_model_keeps_tf32_off_by_default(monkeypatch, restore_precision):
    """The model applies the policy when it is imported (``models/epd.py``
    calls ``matmul_precision``); by default TF32 stays off."""
    import inspect

    from p_div_gnn_tpu_torch.models import epd

    assert "\nmatmul_precision()\n" in inspect.getsource(epd)
    monkeypatch.delenv("PDG_MATMUL_PRECISION", raising=False)
    torch.set_float32_matmul_precision("high")
    assert epd.matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("shape", [(8, 16, 4), (33, 7, 65)])
def test_compiled_stats_flops_match_jax(shape):
    m, k, n = shape
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(m, k)).astype(np.float32), rng.normal(size=(k, n)).astype(np.float32)
    got = profiling.compiled_stats(torch.matmul, torch.from_numpy(a), torch.from_numpy(b))
    want = jax_profiling.compiled_stats(jnp.matmul, jnp.asarray(a), jnp.asarray(b))
    assert got["flops"] == want["flops"] == 2.0 * m * k * n
    assert got["bytes_accessed"] == -1.0


def test_timeit_and_trace(tmp_path):
    a = torch.randn(16, 16)
    t = profiling.timeit(torch.matmul, a, a, iters=3, warmup=1)
    assert t["iters"] == 3 and t["total_s"] > 0 and t["mean_s"] == t["total_s"] / 3
    with profiling.trace(tmp_path / "trace") as prof:
        torch.matmul(a, a)
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert events["traceEvents"]
