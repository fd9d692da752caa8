"""The JAX package's figures for ``chip_smoke.py``'s ``tools`` phase: the
headline table of ``compare`` on the datasets that phase generates,
computed on the CPU by the JAX package.

    PYTHONPATH=. JAX_PLATFORMS=cpu python scripts/port_compare_reference.py \
        [--workdir build/compare_reference] [--max_workers 4]

For each dataset of ``chip_smoke.TOOLS_COMPARE`` (the elastic and the
hyperelastic set, made with ``chip_smoke.TOOLS_GENERATE``'s arguments) it
runs the JAX generator (``p_div_gnn_tpu/datagen/generate.py::main``), the
JAX inference on the plain ``xla`` path (``p_div_gnn_tpu/inference.py::
run_inference``) of each committed checkpoint of ``chip_smoke.TOOLS_MODELS``
with its committed inference config (dataset, results folder and weights
pointed at the work directory), and the JAX ``compare``
(``p_div_gnn_tpu/analysis/compare.py::main``). It prints, per dataset and
model, the means of the standardized NMSE, R², Div(model) and Div(FEM), and
the test set's mesh and node counts, as the JSON that
``chip_smoke.COMPARE_REFERENCE`` holds. The work directory
is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=str(ROOT / "build" / "compare_reference"))
    p.add_argument("--max_workers", type=int, default=4)
    args = p.parse_args()

    import numpy as np
    import pandas as pd
    import yaml

    import chip_smoke
    from p_div_gnn_tpu.analysis.compare import main as compare
    from p_div_gnn_tpu.datagen.generate import main as generate
    from p_div_gnn_tpu.inference import run_inference

    work = Path(args.workdir)
    shutil.rmtree(work, ignore_errors=True)
    figures = {}
    try:
        for kind in chip_smoke.TOOLS_COMPARE:
            generate(dataset_path=str(work / kind), max_workers=args.max_workers,
                     **chip_smoke.TOOLS_GENERATE[kind])
            folders = {}
            for name, config, data in chip_smoke.TOOLS_MODELS:
                if data != kind:
                    continue
                cfg = yaml.safe_load((ROOT / "scripts/configs_inference" / config).read_text())
                cfg.update(dataset_csv=str(work / kind / "test/dataset.csv"),
                           results_folder=str(work / "infer" / name),
                           model_weights_path=str(chip_smoke.checkpoint_of(cfg, name)))
                run_inference(**cfg)
                folders[name] = str(work / "infer" / name)
            tables = compare(str(work / kind / "test/dataset.csv"), list(folders.values()),
                             list(folders))
            figures[kind] = {name: {k: float(np.mean(t[col])) for k, col in
                                    chip_smoke.COMPARE_COLUMNS.items()}
                             for name, t in tables.items()}
            nodes = pd.read_csv(work / kind / "test/dataset.csv")["n_nodes"]
            figures[kind]["test_set"] = {"meshes": int(len(nodes)), "nodes": int(nodes.sum())}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(figures, indent=1))


if __name__ == "__main__":
    main()
