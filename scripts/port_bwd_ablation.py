"""Where the fused3 backward's time goes on the card: each sub-kernel's
device time with one part of its work taken out.

    PYTHONPATH=. python scripts/port_bwd_ablation.py

Builds ``p_div_gnn_tpu_torch/csrc/fused_edge3_bwd.cu`` as it is ("base") and
in variants with one part of its work taken out by a preprocessor switch
(``-DPDG_WITHOUT=<part>``, a name of ``csrc/fused3_tile.cuh``'s ``enum Part``),
all with the port's nvcc flags, into ``build/port_bwd_ablation/``: the
weight-grad kernel without its MMAs, without splitting the staged rows into
bf16 terms, without fetching them; the tile kernel without its tensor-core
MMAs, without its FMA chains (and the shared loads that feed them). Each
runs chip_smoke.py's backward kernel phase inputs (the flagship training
batch, generator seed 1) in fp32 and bf16 streams, three calls under
``torch.profiler``, and prints each sub-kernel's mean device time in ms.
The variants compute wrong values; only their times are read. Needs a CUDA
card and nvcc.
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
# variant: the part it is built without (csrc/fused3_tile.cuh, enum Part)
VARIANTS = {
    "base": None,
    "wgrad without MMAs": "WITHOUT_WG_MMA",
    "wgrad without the term split": "WITHOUT_WG_SPLIT",
    "wgrad without fetching": "WITHOUT_WG_FETCH",
    "tile without MMAs": "WITHOUT_MMA",
    "tile without FMA chains": "WITHOUT_FMA",
}


def build_variants(kernel: str = "fused_edge3_bwd", variants: dict = VARIANTS,
                   out: Path = OUT, extra: dict | None = None) -> dict[str, Path]:
    """Builds csrc/<kernel>.cu once per variant into out/variant<i>.so, with
    -DPDG_WITHOUT=<its part> (none for None) and the variant's ``extra``
    flags, in parallel."""
    source = cuda_build.CSRC_DIR / f"{kernel}.cu"
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs, libs = {}, {}
    for i, (name, part) in enumerate(variants.items()):
        defs = [] if part is None else [f"-DPDG_WITHOUT={part}"]
        defs += (extra or {}).get(name, [])
        libs[name] = out / f"variant{i}.so"
        procs[name] = subprocess.Popen([cuda_build.find_nvcc(), *flags, *defs, "-o",
                                        str(libs[name]), str(source)])
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
