"""The port's precision policy against the JAX package's
(``p_div_gnn_tpu/utils/precision.py``), and its profiler trace:

- ``matmul_precision`` reads ``PDG_MATMUL_PRECISION`` with the JAX names,
  maps each onto torch's fp32 matmul precision (``highest`` / ``float32``
  → "highest", TF32 off, the default; ``high`` → "high"; ``default`` /
  ``bfloat16`` → "medium"), and raises on an unknown name as JAX does;
- ``profiling.trace`` writes a trace of the block's operators
  (``tests/test_torch_port_tracing.py`` holds its spans)."""

import json

import jax
import pytest
import torch

from p_div_gnn_tpu.utils import precision as jax_precision
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


def test_timeit_and_trace(tmp_path):
    """``trace`` writes the block's operators (the module times nothing by
    itself any more: a trace gives every time)."""
    a = torch.randn(16, 16)
    with profiling.trace(tmp_path / "trace") as prof:
        torch.matmul(a, a)
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "aten::mm" for e in events["traceEvents"])
