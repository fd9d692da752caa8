"""Where the fused3 backward's time goes on the card: each sub-kernel's
device time with one part of its work taken out.

    PYTHONPATH=. python scripts/port_bwd_ablation.py

Builds ``p_div_gnn_tpu_torch/csrc/fused_edge3_bwd.cu`` as it is ("base") and
in variants with one part removed by a text edit of a copy, all with the
port's nvcc flags, into ``build/port_bwd_ablation/``: the weight-grad
kernel without its MMAs, without splitting the staged rows into bf16 terms,
without fetching them; the tile kernel without its tensor-core products,
without its FMA chains (and the shared loads that feed them). Each runs
chip_smoke.py's backward kernel phase inputs (the flagship training batch,
generator seed 1) in fp32 and bf16 streams, three calls under
``torch.profiler``, and prints each sub-kernel's mean device time in ms. The variants compute wrong values; only their
times are read. Needs a CUDA card and nvcc.

The variants are text edits of the kernel source as committed with this
script: once that text changes, the script stops with "source text not
found", and its edits must be made to follow the new text.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from p_div_gnn_tpu_torch.datagen.workload import build_workload  # noqa: E402
from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge3  # noqa: E402

OUT = ROOT / "build" / "port_bwd_ablation"
SUBS = ("prepare_weights_kernel", "step3_bwd_tile_kernel", "step3_bwd_wgrad_kernel",
        "step3_bwd_reduce_kernel")
# variant: (text of the source, its replacement) edits
VARIANTS = {
    "base": [],
    "wgrad without MMAs": [
        ("mma_bf16_16816(NT > 1 ? t16[mi][nj] : part[mi][nj], af[ta][mi], bf[nj][0],\n"
         "                             bf[nj][1]);", "{}")],
    "wgrad without the term split": [
        ("if (in_a) put4<NT, AW>(a_s, WG * AW, row, col, v);",
         "if (v.x == 1234.5f) a_s[tid] = 1;"),
        ("else put4<NT, L>(b_s, WG * L, row, col, v);", "")],
    "wgrad without fetching": [
        ("cp_async16_zfill(dst + (in_a ? 0 : WG * AW) + row * width + col, src != nullptr ? src : x,\n"
         "                         src != nullptr);", "(void)src;")],
    "tile without tensor cores": [
        ("      mma_chunk<NT, L, NA>(acc, op, res + (static_cast<int64_t>(w) * NT * L + k0) * L, L * L, k0);",
         "      {}"),
        ("      mma_chunk<NT, L, NA>(acc, op, wc, KC * L, k0);", "      {}")],
    "tile without FMA chains": [
        ("acc[c]->v[i][j] = fmaf(av[i], bv[j], acc[c]->v[i][j]);", "(void)av; (void)bv;")],
}


def build_variants() -> dict[str, Path]:
    src = (cuda_build.CSRC_DIR / "fused_edge3_bwd.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.local_headers(cuda_build.CSRC_DIR / "fused_edge3_bwd.cu"):
        (OUT / header.name).write_text(header.read_text())
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs, libs = {}, {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: source text not found: {old[:60]}")
            text = text.replace(old, new)
        cu = OUT / f"variant{i}.cu"
        cu.write_text(text)
        libs[name] = OUT / f"variant{i}.so"
        procs[name] = subprocess.Popen([cuda_build.find_nvcc(), *flags, "-o", str(libs[name]),
                                        str(cu)])
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed on variant {name!r}")
    return libs


def load(path: Path) -> cuda_build.CudaLibrary:
    lib = ctypes.CDLL(str(path))
    lib.pdg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pdg_cuda_error_string.restype = ctypes.c_char_p
    fn = lib.pdg_fused_edge3_bwd
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 28 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for count in (lib.pdg_fused_edge3_bwd_parts, lib.pdg_fused_edge3_bwd_chunks):
        count.argtypes = [ctypes.c_int64]
        count.restype = ctypes.c_int64
    return cuda_build.CudaLibrary(lib, path, 0.0, "")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants()
    batch = build_workload(chip_smoke.N_MESHES, seed=0)[0].to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    base = chip_smoke.edge_step_inputs(batch, gen)
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, chip_smoke.LATENT
    dz, dr, dm = (torch.randn(s, generator=gen, device="cuda") for s in ((Ep, L), (Np, L), (8, L)))
    aux = (batch.edge_gid, batch.edge_block_tile)
    for name, path in libs.items():
        built = load(path)
        fused_edge3._bwd_library = lambda built=built: built
        for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            args = [base[k].to(sd).contiguous() for k in base]
            z_upd = fused_edge3.fused_edge_step3_reference(
                *args, batch.receivers, batch.edge_gid, batch.n_graphs)[0]
            dz_sd = dz.to(sd)

            def call():
                fused_edge3.fused_edge_step3_backward(
                    *args, batch.receivers, aux, batch.n_graphs, batch.tile, z_upd, dz_sd, dr, dm)

            for _ in range(2):
                call()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
            times = {sub: 0.0 for sub in SUBS}
            for e in prof.key_averages():
                for sub in SUBS:
                    if sub in e.key:
                        times[sub] += e.device_time_total / 3e3
            print(f"{name} {sd_name}: " + " ".join(f"{k} {v:.3f}" for k, v in times.items())
                  + f" ms; sum {sum(times.values()):.3f} ms", flush=True)


if __name__ == "__main__":
    main()
