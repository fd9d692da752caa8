"""Dump what nvcc made of the port's kernel sources: ptxas' registers,
shared memory and spills per kernel, and the SASS of each kernel function.

    PYTHONPATH=. python scripts/port_sass.py segment_sum_csr fused_edge3_bwd
        [--out build/sass]

Each named ``p_div_gnn_tpu_torch/csrc/<name>.cu`` is built as the port builds
it (``ops/cuda_build.py``: nvcc, sm_90a, ``-Xptxas -v``). ``cuobjdump -sass``
of the library goes to ``<out>/<name>.sass``; the script prints ptxas'
lines and, for every kernel function of the dump, its instruction count and
the count of each opcode family that sets its speed: tensor-core MMAs
(``HGMMA`` for wgmma, ``HMMA`` for mma.sync), ``LDSM`` (ldmatrix),
asynchronous copies (``LDGSTS``), global loads by width (``LDG.E``, ``.64``,
``.128``), shared loads and stores, double-precision adds (``DADD``), FMAs
(``FFMA``), conversions (``F2F``) and mbarrier operations (``SYNCS``); for
the segment sum's
``run_chunk_kernel`` also the order of its global loads and DADDs. Needs
nvcc and cuobjdump (the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from p_div_gnn_tpu_torch.ops.cuda_build import find_nvcc, library  # noqa: E402

FAMILIES = ("HGMMA", "HMMA", "LDSM", "LDGSTS", "LDG.E.128", "LDG.E.64", "LDG.E", "LDS", "STS",
            "STG", "DADD", "DFMA", "FFMA", "F2F", "SHFL", "BAR", "SYNCS")


def opcode_counts(body: list[str]) -> Counter:
    """Counts of FAMILIES over one function's SASS lines (an instruction is
    counted under the first family its opcode starts with)."""
    counts: Counter = Counter()
    for line in body:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not m:
            continue
        op = m.group(1)
        counts["instructions"] += 1
        for fam in FAMILIES:
            if op == fam or op.startswith(fam + "."):
                counts[fam] += 1
                break
    return counts


def split_functions(sass: str) -> dict[str, list[str]]:
    funcs: dict[str, list[str]] = {}
    current = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            funcs[current] = []
        elif current is not None:
            funcs[current].append(line)
    return funcs


def load_order(body: list[str]) -> str:
    """The function's global loads (L), double adds (D) and branches (B) in
    program order, with repeats counted ("L8 D32" = 8 loads, then 32 DADDs):
    shows whether an unrolled step issues its loads before their uses."""
    seq = []
    for line in body:
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not m:
            continue
        op = m.group(1)
        tag = "L" if op.startswith("LDG") else "D" if op.startswith("DADD") else \
            "B" if op.startswith("BRA") else None
        if tag is None:
            continue
        if seq and seq[-1][0] == tag:
            seq[-1][1] += 1
        else:
            seq.append([tag, 1])
    return " ".join(f"{t}{n}" for t, n in seq)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="+", help="csrc/<name>.cu sources")
    ap.add_argument("--out", default="build/sass", help="directory of the SASS dumps")
    args = ap.parse_args()
    nvcc = find_nvcc()
    if nvcc is None:
        print("port_sass: nvcc not found", file=sys.stderr)
        return 1
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).with_name("cuobjdump"))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in args.names:
        built = library(name)
        print(f"== {name}: {built.path.name}")
        for line in built.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas: {line.strip()}")
        sass = subprocess.run([cuobjdump, "-sass", str(built.path)], capture_output=True,
                              text=True, check=True).stdout
        (out / f"{name}.sass").write_text(sass)
        for func, body in split_functions(sass).items():
            c = opcode_counts(body)
            print(f"sass {func}: " + " ".join(f"{k}={c[k]}" for k in ("instructions",) + FAMILIES
                                             if c[k]))
            if "run_chunk_kernel" in func:
                print(f"sass {func} load order: {load_order(body)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
