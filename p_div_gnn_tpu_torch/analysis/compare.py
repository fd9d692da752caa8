"""Results comparison and metrics: the copy of
``p_div_gnn_tpu/analysis/compare.py`` (the ``compare`` command), with
``utils/configio.py``'s tables (``{column: values}`` dicts) in place of
pandas DataFrames. It runs on the host only (numpy, scipy); figures use
matplotlib, imported inside the functions that draw.

Per test sample and per model inference folder it computes:
- NMSE (raw and standardized) between predicted and ground-truth stress
  fields;
- R² per sample;
- divergence scalars of FEM and model fields, raw and standardized, and
  per-node divergence-norm fields (external boundary only zeroed);
then prints the mean Loss / Divergence summary the paper reports and,
with ``figures_folder``, writes ``metrics_<name>.csv`` (pandas' columns),
histograms and the top-k field figures.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Any

import numpy as np

from p_div_gnn_tpu_torch.graphs.labels import NodeType
from p_div_gnn_tpu_torch.graphs.meshio import load_sample_npz
from p_div_gnn_tpu_torch.utils.configio import Table, read_csv, table_len, write_csv

METRIC_COLUMNS = ("sample", "nmse", "nmse_standardized", "r2", "div_fem", "div_model",
                  "div_fem_standardized", "div_model_standardized")


def nmse(gt: np.ndarray, pred: np.ndarray) -> float:
    """Per-sample NMSE, the training criterion's numpy twin
    (`compare_results.py:333-347`)."""
    mean_gt = gt.mean(axis=0)
    mse = ((gt - pred) ** 2).sum(axis=0)
    norm = ((gt - mean_gt) ** 2).sum(axis=0)
    return float((mse / norm).mean())


def r2_score(gt: np.ndarray, pred: np.ndarray) -> float:
    ss_res = ((gt - pred) ** 2).sum()
    ss_tot = ((gt - gt.mean(axis=0)) ** 2).sum()
    return float(1.0 - ss_res / ss_tot)


def standardize(x: np.ndarray, mean: float, std: float) -> np.ndarray:
    return (x - mean) / std


def build_div_matrix(data: dict) -> Any:
    import scipy.sparse as sp

    shape = tuple(int(v) for v in data["op_div_matrix_shape"])
    return sp.coo_matrix(
        (
            data["op_div_matrix_data"],
            (data["op_div_matrix_row_indices"], data["op_div_matrix_col_indices"]),
        ),
        shape=shape,
    ).tocsr()


def divergence_scalar(
    stress: np.ndarray, div_mat: Any, node_labels: np.ndarray
) -> float:
    """Training-loss twin: both boundary types zeroed, squared, node-mean,
    component-sum (`compare_results.py:647-673` / `gnn_train.py:60-92`)."""
    n = stress.shape[0]
    S = np.stack(
        [
            np.concatenate([stress[:, 0], stress[:, 2]]),
            np.concatenate([stress[:, 2], stress[:, 1]]),
        ],
        axis=1,
    )
    div = div_mat[:, : 2 * n] @ S
    div[node_labels == NodeType.EXTERNAL_BOUNDARY] = 0
    div[node_labels == NodeType.INTERNAL_BOUNDARY] = 0
    return float(np.sum(np.mean(div**2, axis=0)))


def divergence_norm_field(
    stress: np.ndarray, div_mat: Any, node_labels: np.ndarray
) -> np.ndarray:
    """Per-node |div| field for plotting; ONLY the external boundary is
    zeroed (`compare_results.py:122-141`)."""
    n = stress.shape[0]
    S = np.stack(
        [
            np.concatenate([stress[:, 0], stress[:, 2]]),
            np.concatenate([stress[:, 2], stress[:, 1]]),
        ],
        axis=1,
    )
    div = div_mat[:, : 2 * n] @ S
    div[node_labels == NodeType.EXTERNAL_BOUNDARY] = 0
    return np.linalg.norm(div, axis=1)


def evaluate_model_folder(
    gt_df: Table,
    inference_folder: str | Path,
) -> Table:
    """Per-sample metrics for one model's inference outputs, a table of
    ``METRIC_COLUMNS``."""
    inference_folder = Path(inference_folder)
    pred_df = read_csv(inference_folder / "dataset.csv")
    norm_params = json.loads(
        (inference_folder / "normalize_params.json").read_text()
    )
    mean_ls = norm_params["mean_local_stress"]
    std_ls = norm_params["std_local_stress"]

    rows = []
    for i in range(table_len(gt_df)):
        gt_data = load_sample_npz(gt_df["data_filename"][i])
        pred_data = load_sample_npz(pred_df["data_filename"][i])
        gt = np.asarray(gt_data["stress_field"], np.float64)
        pred = np.asarray(pred_data["stress_field"], np.float64)
        labels = np.asarray(gt_data["node_labels"])
        D = build_div_matrix(gt_data)
        gt_std = standardize(gt, mean_ls, std_ls)
        pred_std = standardize(pred, mean_ls, std_ls)
        rows.append(
            {
                "sample": i,
                "nmse": nmse(gt, pred),
                "nmse_standardized": nmse(gt_std, pred_std),
                "r2": r2_score(gt, pred),
                "div_fem": divergence_scalar(gt, D, labels),
                "div_model": divergence_scalar(pred, D, labels),
                "div_fem_standardized": divergence_scalar(gt_std, D, labels),
                "div_model_standardized": divergence_scalar(
                    pred_std, D, labels
                ),
            }
        )
    return {k: [r[k] for r in rows] for k in METRIC_COLUMNS}


def topk_indices(values: np.ndarray, k: int, largest: bool) -> np.ndarray:
    """`compare_results.py:705-710`."""
    order = np.argsort(values)
    return order[-k:][::-1] if largest else order[:k]


def main(
    dataset_csv: str,
    inference_folders: list[str],
    model_names: list[str] | None = None,
    figures_folder: str | None = None,
    topk: int = 0,
) -> dict[str, Table]:
    gt_df = read_csv(dataset_csv)
    if model_names is None:
        model_names = [Path(f).name or Path(f).parent.name
                       for f in inference_folders]
    results: dict[str, Table] = {}
    for name, folder in zip(model_names, inference_folders):
        metrics = evaluate_model_folder(gt_df, folder)
        results[name] = metrics
        # the paper's headline summary (`compare_results.py:1325-1339`)
        print(f"Model {name}")
        print(f"  Mean Loss (NMSE std) {np.mean(metrics['nmse_standardized'])}")
        print(f"  Mean Loss (NMSE raw) {np.mean(metrics['nmse'])}")
        print(f"  Mean R2 {np.mean(metrics['r2'])}")
        print(
            "  Mean Divergence model (std) "
            f"{np.mean(metrics['div_model_standardized'])}"
        )
        print(
            "  Mean Divergence FEM (std) "
            f"{np.mean(metrics['div_fem_standardized'])}"
        )
        if figures_folder:
            out = Path(figures_folder)
            out.mkdir(parents=True, exist_ok=True)
            write_csv(out / f"metrics_{name}.csv", metrics)
            _histograms(metrics, name, out)
            if topk:
                _topk_report(metrics, name, out, topk)
                render_topk_fields(gt_df, folder, name, out)
    if figures_folder and topk and len(model_names) >= 2:
        render_cross_model_figures(
            gt_df,
            results,
            dict(zip(model_names, inference_folders)),
            baseline_name=model_names[0],
            proposed_name=model_names[1],
            figures_folder=Path(figures_folder),
            topk=topk,
        )
    return results


def nmse_element_wise(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Per-node NMSE fields, (N, 3)
    (`compare_results.py:352-364` `normalized_mse_loss_element_wise`)."""
    mean_gt = gt.mean(axis=0)
    return (gt - pred) ** 2 / ((gt - mean_gt) ** 2).sum(axis=0)


@functools.lru_cache(maxsize=8)
def _model_folder_meta(folder: str) -> tuple:
    """Cached per-folder dataset.csv + normalize_params.json reads (the
    figure fan-out hits each folder many times)."""
    pred_df = read_csv(Path(folder) / "dataset.csv")
    norm = json.loads((Path(folder) / "normalize_params.json").read_text())
    return pred_df, norm


def _load_model_sample(folder: Path, i: int) -> tuple[np.ndarray, dict]:
    pred_df, norm = _model_folder_meta(str(folder))
    data = load_sample_npz(pred_df["data_filename"][i])
    return np.asarray(data["stress_field"], np.float64), norm


def render_cross_model_figures(
    gt_df: Table,
    results: dict[str, Table],
    folders: dict[str, str | Path],
    baseline_name: str,
    proposed_name: str,
    figures_folder: Path,
    topk: int,
    figures_per_kind: int = 2,
) -> dict[str, list[int]]:
    """The paper's cross-model sample fan-out
    (`compare_results.py:1341-1433` + `_plot_sample_comparisons`
    `:923-1054`): per selected sample, a 3×3 stress figure (baseline /
    proposed / FEM, model rows on the FEM color range), a 2×3 element-wise
    NMSE figure (proposed clamped to the baseline range), a 1×3
    divergence-norm row (all on the FEM range), and per-component
    FEM-vs-model distribution histograms.

    Sample selection (standardized metrics, like the reference):
    - ``best_divergence``: Div(proposed) < Div(FEM), lowest proposed
      divergence first — only when the proposed model optimizes divergence
      ("Div" in its name, `compare_results.py:1369`);
    - ``worst_k`` / ``best_k`` by the proposed model's NMSE;
    - ``highest_k_differences`` by |NMSE(baseline) − NMSE(proposed)|.
    """
    from p_div_gnn_tpu_torch.analysis.plots import (
        plot_two_histograms,
        plot_two_model_divergence,
        plot_two_model_nmse,
        plot_two_model_stress,
    )
    from p_div_gnn_tpu_torch.graphs.meshio import read_vtk

    mb, mp = results[baseline_name], results[proposed_name]
    loss_b = np.asarray(mb["nmse_standardized"])
    loss_p = np.asarray(mp["nmse_standardized"])

    picks: dict[str, np.ndarray] = {}
    if "Div" in proposed_name:
        div_p = np.asarray(mp["div_model_standardized"])
        div_fem = np.asarray(mp["div_fem_standardized"])
        better = np.where(div_p < div_fem)[0]
        order = better[np.argsort(div_p[better])]
        picks["best_divergence"] = order[:topk]
    picks["worst_k_predictions"] = topk_indices(loss_p, topk, largest=True)
    picks["best_k_predictions"] = topk_indices(loss_p, topk, largest=False)
    picks["highest_k_differences"] = topk_indices(
        np.abs(loss_b - loss_p), topk, largest=True
    )

    index: dict[str, list[int]] = {k: v.tolist() for k, v in picks.items()}
    figures_folder.mkdir(parents=True, exist_ok=True)
    (figures_folder / "cross_model_topk.json").write_text(
        json.dumps(
            {"baseline": baseline_name, "proposed": proposed_name, **index},
            indent=2,
        )
    )

    for kind, idxs in picks.items():
        root = figures_folder / kind
        for sub in ("stress_fields", "nmse", "divergence_fields",
                    "distributions"):
            (root / sub).mkdir(parents=True, exist_ok=True)
        for rank, i in enumerate(np.asarray(idxs)[:figures_per_kind]):
            i = int(i)
            mesh = read_vtk(gt_df["mesh_filename"][i])
            pts, faces = mesh.points[:, :2], mesh.faces
            gdata = load_sample_npz(gt_df["data_filename"][i])
            gt = np.asarray(gdata["stress_field"], np.float64)
            labels = np.asarray(gdata["node_labels"])
            D = build_div_matrix(gdata)
            sb, norm_b = _load_model_sample(Path(folders[baseline_name]), i)
            sp, norm_p = _load_model_sample(Path(folders[proposed_name]), i)
            tag = f"topk{rank + 1}_sample_{i}"
            plot_two_model_stress(
                pts, faces, sb, sp, gt, baseline_name, proposed_name,
                root / "stress_fields" / f"{tag}.pdf",
            )
            plot_two_model_nmse(
                pts, faces,
                nmse_element_wise(gt, sb), nmse_element_wise(gt, sp),
                baseline_name, proposed_name,
                root / "nmse" / f"{tag}.pdf",
            )
            # standardized divergence-norm fields, like the reference's
            # `divergence_fields_standard` (`compare_results.py:1100-1140`).
            # ALL THREE panels (baseline, proposed, FEM) are standardized
            # in ONE shared frame — the baseline folder's normalize_params,
            # exactly like the reference — so the within-figure comparison
            # is apples-to-apples. (Per-model frames are still used for the
            # NMSE/distribution figures, matching evaluate_model_folder.)
            std_b = lambda s: standardize(
                s, norm_b["mean_local_stress"], norm_b["std_local_stress"]
            )
            std_p = lambda s: standardize(
                s, norm_p["mean_local_stress"], norm_p["std_local_stress"]
            )
            plot_two_model_divergence(
                pts, faces,
                divergence_norm_field(std_b(sb), D, labels),
                divergence_norm_field(std_b(sp), D, labels),
                divergence_norm_field(std_b(gt), D, labels),
                baseline_name, proposed_name,
                root / "divergence_fields" / f"{tag}.pdf",
            )
            for c, comp in enumerate(("XX", "YY", "XY")):
                for name, s, std_of in (
                    (baseline_name, sb, std_b), (proposed_name, sp, std_p)
                ):
                    plot_two_histograms(
                        std_of(gt)[:, c], std_of(s)[:, c], "FEM", name,
                        f"Distribution Stress {comp}",
                        root / "distributions"
                        / f"{tag}_distribution_{comp}_{name}.pdf",
                    )
    return index


def _histograms(metrics: Table, name: str, out: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 3.5))
    for ax, col in zip(axes, ["nmse_standardized", "r2",
                              "div_model_standardized"]):
        ax.hist(metrics[col], bins=40)
        ax.set_title(f"{name}: {col}")
        ax.grid(True, ls="--", lw=0.5)
    fig.tight_layout()
    fig.savefig(out / f"hist_{name}.pdf")
    plt.close(fig)


def _topk_report(metrics: Table, name: str, out: Path, k: int) -> None:
    nmse_values = np.asarray(metrics["nmse"])
    report = {
        "best": topk_indices(nmse_values, k, largest=False).tolist(),
        "worst": topk_indices(nmse_values, k, largest=True).tolist(),
        "best_divergence": np.flatnonzero(
            np.asarray(metrics["div_model"]) < np.asarray(metrics["div_fem"])
        ).tolist()[:k],
    }
    (out / f"topk_{name}.json").write_text(json.dumps(report, indent=2))


def render_topk_fields(
    gt_df: Table,
    inference_folder: str | Path,
    name: str,
    out: Path,
    topk_per_kind: int = 2,
) -> None:
    """Best/worst per-sample field-comparison figures (the paper's sample
    fan-out, `compare_results.py:1341-1433`)."""
    from p_div_gnn_tpu_torch.analysis.plots import plot_sample_comparison
    from p_div_gnn_tpu_torch.graphs.meshio import read_vtk

    metrics = evaluate_model_folder(gt_df, inference_folder)
    pred_df = read_csv(Path(inference_folder) / "dataset.csv")
    picks = {
        "best": topk_indices(np.asarray(metrics["nmse"]), topk_per_kind,
                             largest=False),
        "worst": topk_indices(np.asarray(metrics["nmse"]), topk_per_kind,
                              largest=True),
    }
    for kind, idxs in picks.items():
        for rank, i in enumerate(idxs):
            mesh = read_vtk(gt_df["mesh_filename"][int(i)])
            gt = np.asarray(
                load_sample_npz(gt_df["data_filename"][int(i)])["stress_field"]
            )
            gdata = load_sample_npz(gt_df["data_filename"][int(i)])
            pred = np.asarray(
                load_sample_npz(pred_df["data_filename"][int(i)])["stress_field"]
            )
            D = build_div_matrix(gdata)
            div = divergence_norm_field(
                pred, D, np.asarray(gdata["node_labels"])
            )
            plot_sample_comparison(
                mesh.points[:, :2], mesh.faces, gt, pred, div,
                out / f"fields_{name}_{kind}{rank}_sample{int(i)}.pdf",
            )
