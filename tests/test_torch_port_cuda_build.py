"""The seam between the port's Python and its CUDA sources
(``ops/cuda_build.py``), on the CPU: every ``pdg_*`` entry point binds from
its C definition, the launch functions to the signatures the wrappers were
written against, an unknown C type raises, ``-D`` defines name their own
library, ``using`` swaps the loader, and ``launch`` passes tensors, null
pointers and sizes, counts a launch and raises on an error code (a g++
build of a toy source stands in for nvcc's). The six fused edge steps'
input contract (``fused_edge.check_step_inputs``) refuses each kind of bad
call."""

import contextlib
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
I, I64, P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p


def _launch_args(n_ptr: int, n_int: int) -> list:
    """A launch function's arguments: the stream dtype flag, pointers,
    sizes, the stream."""
    return [I] + [P] * n_ptr + [I64] * n_int + [P]


# what the wrappers stated by hand before the signatures came from the sources
SIGNATURES = {
    "pdg_fused_edge3_fwd": ("fused_edge3_fwd", _launch_args(16, 5), I),
    "pdg_fused_edge3_fwd_parts": ("fused_edge3_fwd", [], I64),
    "pdg_fused_edge3_fwd_needs_wfma": ("fused_edge3_fwd", [I, I64], I),
    "pdg_fused_edge3_bwd": ("fused_edge3_bwd", _launch_args(28, 5), I),
    "pdg_fused_edge3_bwd_parts": ("fused_edge3_bwd", [I64], I64),
    "pdg_fused_edge3_bwd_chunks": ("fused_edge3_bwd", [I64], I64),
    "pdg_wgrad_chunks": ("fused_edge3_bwd", [I64, I64], I64),
    "pdg_fused_edge3_bwd_wgrad": ("fused_edge3_bwd", [I, P, P, I, P, I64, I, P, P, P, P, P, I64,
                                                      I64, I64, P], I),
    "pdg_fused_edge_fwd": ("fused_edge_fwd", _launch_args(16, 5), I),
    "pdg_fused_edge_fwd_smem": ("fused_edge_fwd", [I, I64, I], I64),
    "pdg_fused_edge_bwd": ("fused_edge_bwd", _launch_args(27, 5), I),
    "pdg_fused_edge_bwd_smem": ("fused_edge_bwd", [I, I64, I], I64),
    "pdg_fused_edge2_fwd": ("fused_edge2_fwd", _launch_args(16, 6), I),
    "pdg_fused_edge2_fwd_parts": ("fused_edge2_fwd", [], I64),
    "pdg_fused_edge2_fwd_needs_wfma": ("fused_edge2_fwd", [I, I64], I),
    "pdg_fused_edge2_bwd": ("fused_edge2_bwd", _launch_args(27, 6), I),
    "pdg_fused_edge2_bwd_parts": ("fused_edge2_bwd", [I64], I64),
    "pdg_fused_edge2_bwd_chunks": ("fused_edge2_bwd", [I64], I64),
    "pdg_segment_sum_csr": ("segment_sum_csr", _launch_args(6, 4), I),
    "pdg_segment_sum_csr_pair": ("segment_sum_csr", _launch_args(7, 4), I),
    "pdg_segment_sum_csr_chunk_slots": ("segment_sum_csr", [], I64),
    "pdg_fused_edge3_fwd_wide": ("fused_edge3_fwd", [I, P, P], I),
    "pdg_fused_edge2_bwd_wide": ("fused_edge2_bwd", [I, P, P], I),
    "pdg_part_clock": ("fused_edge_fwd", [P, I64], I),
}


@pytest.mark.parametrize("name", SOURCES)
def test_every_entry_point_binds(name):
    """Every pdg_* name the source or its local headers mention before a
    parenthesis (outside comments) is a definition that binds, and the
    error string every source exports returns a C string."""
    sigs = cuda_build.signatures(name)
    source = cuda_build.CSRC_DIR / f"{name}.cu"
    mentioned = set()
    for path in [source, *cuda_build.local_headers(source)]:
        text = re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.S)
        mentioned |= set(re.findall(r"\b(pdg_\w+)\s*\(", text))
    assert mentioned and mentioned <= set(sigs), sorted(mentioned - set(sigs))
    assert sigs["pdg_cuda_error_string"] == ([I], ctypes.c_char_p)
    assert f"pdg_{name}" in sigs


@pytest.mark.parametrize("entry", sorted(SIGNATURES))
def test_signature_is_the_one_the_wrappers_were_written_for(entry):
    name, argtypes, restype = SIGNATURES[entry]
    assert cuda_build.signatures(name)[entry] == (argtypes, restype)
    if restype is I and argtypes[-1:] == [P]:
        assert cuda_build.source_of(entry) == name


@pytest.mark.parametrize("definition", [
    "int pdg_bad(float scale, void* stream) { return 0; }",
    "double pdg_bad(int n) { return 0.0; }",
])
def test_an_unknown_c_type_raises(definition, tmp_path, monkeypatch):
    (tmp_path / "bad.cu").write_text(f'extern "C" {{\n{definition}\n}}\n')
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    with pytest.raises(ValueError, match="pdg_bad"):
        cuda_build.signatures("bad")


def test_defines_name_their_own_library():
    base = cuda_build.library_path("fused_edge3_fwd")
    mma = cuda_build.library_path("fused_edge3_fwd", ("PDG_WITHOUT=WITHOUT_MMA",))
    fma = cuda_build.library_path("fused_edge3_fwd", ("PDG_WITHOUT=WITHOUT_FMA",))
    assert len({base, mma, fma}) == 3
    assert mma == cuda_build.library_path("fused_edge3_fwd", ("PDG_WITHOUT=WITHOUT_MMA",))
    assert all(p.parent == cuda_build.BUILD_DIR and p.name.startswith("fused_edge3_fwd-")
               for p in (base, mma, fma))


def test_using_swaps_the_loader_and_forgets_its_libraries():
    calls = []

    def stub(name, defines):
        calls.append((name, defines))
        return f"{name}{defines}"

    with cuda_build.using(stub):
        assert cuda_build.library("segment_sum_csr") == "segment_sum_csr()"
        assert cuda_build.library("segment_sum_csr") == "segment_sum_csr()"
        assert cuda_build.library("segment_sum_csr", ("A=1",)) == "segment_sum_csr('A=1',)"
    assert calls == [("segment_sum_csr", ()), ("segment_sum_csr", ("A=1",))]
    assert cuda_build._loader is cuda_build.load_cuda_library
    assert not cuda_build._libraries


TOY = r"""
#include <stdint.h>
extern "C" {
// y = scale * x (+ 1 where `extra` is given) over n values
int pdg_toy(int scale, const float* x, float* y, const void* extra, int64_t n, void* stream) {
  if (stream == nullptr) return 7;
  if (n < 0) return 9;
  for (int64_t i = 0; i < n; ++i) y[i] = scale * x[i] + (extra ? 1.f : 0.f);
  return 0;
}
int64_t pdg_toy_rows(int64_t n) { return 2 * n; }
#if PDG_TOY_EXTRA
int pdg_toy_extra(int x) { return x; }
#endif
const char* pdg_cuda_error_string(int err) { return err == 9 ? "negative size" : "other"; }
}
"""


def test_launch_through_a_substituted_library(tmp_path, monkeypatch):
    """A launch passes tensors as pointers, None as a null pointer, sizes
    as int64 and the device's current stream; it counts one launch of its
    kernel, and an error code raises with the library's message and counts
    none. The entry point left out by the build is skipped, and an int64
    result is not cut to 32 bits."""
    (tmp_path / "toy.cu").write_text(TOY)
    lib = tmp_path / "toy.so"
    subprocess.run([shutil.which("g++"), "-x", "c++", "-shared", "-fPIC", "-o", str(lib),
                    str(tmp_path / "toy.cu")], check=True)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    stream = type("Stream", (), {"cuda_stream": 0x5EED0000BEEF})()
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: stream)
    x = torch.arange(6, dtype=torch.float32)
    y = torch.zeros(6)
    with cuda_build.using(lambda name, defines: cuda_build.open_library(lib, name)):
        built = cuda_build.library("toy")
        assert not hasattr(built.lib, "pdg_toy_extra")
        assert built.lib.pdg_toy_rows(2**40) == 2**41
        before = cuda_build.launches["toy"]
        cuda_build.launch("toy", "pdg_toy", 3, x, y, None, 6)
        assert torch.equal(y, 3 * x)
        cuda_build.launch("toy", "pdg_toy", 2, x, y, x, 4)
        assert torch.equal(y, torch.tensor([1.0, 3, 5, 7, 12, 15]))
        with pytest.raises(RuntimeError, match="pdg_toy launch failed: negative size"):
            cuda_build.launch("toy", "pdg_toy", 1, x, y, None, -1)
        assert cuda_build.launches["toy"] == before + 2


def test_argtypes_are_stated_only_by_the_seam():
    """No wrapper, script or chip_smoke.py states a ctypes signature: the C
    sources are its only statement (ops/cuda_build.py binds them)."""
    files = [*(ROOT / "p_div_gnn_tpu_torch" / "ops").glob("*.py"),
             *(ROOT / "scripts").glob("port_*.py"), ROOT / "chip_smoke.py"]
    stating = [f.name for f in files
               if f.name != "cuda_build.py" and re.search(r"argtypes|restype", f.read_text())]
    assert not stating


def _step(L=8, Np=16, Ep=32, n_blocks=4):
    """A valid fused3 backward call's tensors, spec "nsswwwbwbiitssrm"."""
    f = lambda *shape: torch.zeros(shape)  # noqa: E731
    i = lambda n: torch.zeros(n, dtype=torch.int32)  # noqa: E731
    return [f(Np, L), f(Ep, L), f(Ep, L), f(L, L), f(L, L), f(L, L), f(L), f(L, L), f(L),
            i(Ep), i(Ep), i(n_blocks), f(Ep, L), f(Ep, L), f(Np, L), f(8, L)]


BAD = {
    "stream dtype": lambda t: [x.double() if x.dtype == torch.float32 else x for x in t],
    "weights must be torch.float32, the stream dtype": lambda t: t[:3] + [t[3].double()] + t[4:],
    "dR must be torch.float32": lambda t: t[:14] + [t[14].double()] + t[15:],
    "slot indices must be torch.int32": lambda t: t[:9] + [t[9].long()] + t[10:],
    "contiguous": lambda t: t[:1] + [torch.zeros(8, 32).t()] + t[2:],
    r"slot streams must be \(Ep, L\)": lambda t: t[:2] + [torch.zeros(31, 8)] + t[3:],
    r"weights must be \(L, L\)": lambda t: t[:7] + [torch.zeros(8, 9)] + t[8:],
    r"dM must be \(8, L\)": lambda t: t[:15] + [torch.zeros(7, 8)],
    "whole blocks": lambda t: t[:11] + [torch.zeros(5, dtype=torch.int32)] + t[12:],
}


def test_step_contract_accepts_a_valid_call():
    assert fused_edge.check_step_inputs(
        "step", (64, 128, 256), 8, (7, 1), "nsswwwbwbiitssrm", *_step()) == (16, 32, 8, 64)


@pytest.mark.parametrize("fault", list(BAD))
def test_step_contract_refuses(fault):
    with pytest.raises(ValueError, match=f"step: .*{fault}"):
        fused_edge.check_step_inputs("step", (64, 128, 256), 8, (7, 1), "nsswwwbwbiitssrm",
                                     *BAD[fault](_step()))


@pytest.mark.parametrize("fault", ["tile", "sender tiles"])
def test_step_contract_refuses_a_layout(fault):
    """Np must be whole node tiles; the pair-blocked steps' two block tile
    arrays must have one entry a block each."""
    t = _step()
    if fault == "tile":
        with pytest.raises(ValueError, match="not a multiple of tile=5"):
            fused_edge.check_step_inputs("step", (64,), 5, (7, 1), "nsswwwbwbiitssrm", *t)
    else:
        with pytest.raises(ValueError, match=r"block tile arrays must be \(NB,\)"):
            fused_edge.check_step_inputs("step", (64,), 8, (5, 2), "nswbwbiiitt", t[0], t[1],
                                         t[3], t[6], t[7], t[8], t[9], t[9], t[10], t[11],
                                         torch.zeros(3, dtype=torch.int32))
