"""Figure tooling: the copy of ``p_div_gnn_tpu/analysis/plots.py``.

matplotlib, imported inside each function that draws (the card's machine
has none), draws:
- per-node stress / NMSE / divergence-norm fields on the triangulated mesh
  (tripcolor);
- the periodic-mesh illustration: node-type coloring plus dashed virtual
  stubs for the periodic boundary links.
"""

from __future__ import annotations

from typing import Any

from pathlib import Path

import numpy as np


def _tri(points2d: np.ndarray, faces: np.ndarray):
    import matplotlib.tri as mtri

    return mtri.Triangulation(points2d[:, 0], points2d[:, 1], faces)


def plot_field(
    points2d: np.ndarray,
    faces: np.ndarray,
    values: np.ndarray,
    title: str = "",
    output_file: str | Path | None = None,
    cmap: str = "viridis",
    ax: Any=None,
) -> Any:
    """One scalar field on the mesh (counterpart of the pyvista panels)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    own = ax is None
    if own:
        fig, ax = plt.subplots(figsize=(5, 5))
    tpc = ax.tripcolor(_tri(points2d, faces), values, shading="gouraud",
                       cmap=cmap)
    ax.set_aspect("equal")
    ax.set_title(title)
    ax.figure.colorbar(tpc, ax=ax, shrink=0.8)
    if own and output_file:
        ax.figure.tight_layout()
        ax.figure.savefig(output_file)
        plt.close(ax.figure)
    return ax


def plot_sample_comparison(
    points2d: np.ndarray,
    faces: np.ndarray,
    gt_stress: np.ndarray,
    pred_stress: np.ndarray,
    div_field: np.ndarray | None = None,
    output_file: str | Path | None = None,
) -> None:
    """Multi-panel GT / prediction / abs-error (+divergence) figure
    (`compare_results.py:923-1054`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    comps = ["xx", "yy", "xy"]
    rows = 3 + (1 if div_field is not None else 0)
    fig, axes = plt.subplots(rows, 3, figsize=(13, 3.6 * rows))
    for c in range(3):
        plot_field(points2d, faces, gt_stress[:, c],
                   f"FEM $\\sigma_{{{comps[c]}}}$", ax=axes[0][c])
        plot_field(points2d, faces, pred_stress[:, c],
                   f"GNN $\\sigma_{{{comps[c]}}}$", ax=axes[1][c])
        plot_field(points2d, faces, np.abs(gt_stress[:, c] - pred_stress[:, c]),
                   "abs error", cmap="magma", ax=axes[2][c])
    if div_field is not None:
        for c in range(3):
            axes[3][c].axis("off")
        plot_field(points2d, faces, div_field, r"$\|div(\sigma)\|$",
                   cmap="magma", ax=axes[3][1])
        axes[3][1].axis("on")
    fig.tight_layout()
    if output_file:
        fig.savefig(output_file)
        plt.close(fig)
    return fig


def plot_periodic_mesh(
    points2d: np.ndarray,
    faces: np.ndarray,
    node_labels: np.ndarray,
    output_file: str | Path | None = None,
    stub_fraction: float = 0.06,
) -> None:
    """Periodic-mesh illustration (C20, `plot_periodic_mesh.py:59-200`):
    mesh wireframe, nodes colored by NodeType, and dashed stubs indicating
    the virtual periodic links leaving each boundary node."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from p_div_gnn_tpu_torch.graphs.periodic import periodic_boundary_pairs

    fig, ax = plt.subplots(figsize=(6.5, 6.5))
    ax.triplot(_tri(points2d, faces), color="0.7", lw=0.5, zorder=1)
    colors = {-1: "tab:red", 0: "0.4", 1: "tab:blue"}
    names = {-1: "internal boundary", 0: "internal", 1: "external boundary"}
    for lab in (-1, 0, 1):
        sel = node_labels == lab
        ax.scatter(points2d[sel, 0], points2d[sel, 1], s=14 if lab else 4,
                   c=colors[lab], label=names[lab], zorder=3)
    senders, receivers = periodic_boundary_pairs(points2d)
    span = points2d.max(0) - points2d.min(0)
    stub = stub_fraction * float(span.max())
    for s, r in zip(senders, receivers):
        d = points2d[r] - points2d[s]
        nrm = np.linalg.norm(d)
        if nrm == 0:
            continue
        d = d / nrm * stub
        ax.plot(
            [points2d[s, 0], points2d[s, 0] + d[0]],
            [points2d[s, 1], points2d[s, 1] + d[1]],
            "--", color="tab:green", lw=0.8, zorder=2,
        )
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title("Periodic mesh graph (virtual periodic links dashed)")
    fig.tight_layout()
    if output_file:
        fig.savefig(output_file)
        plt.close(fig)
    return fig


def plot_fields_row(
    points2d: np.ndarray,
    faces: np.ndarray,
    fields: dict,
    output_file: str | Path | None = None,
    clim: list | None = None,
    cmap: str = "jet",
    axes: Any=None,
) -> None:
    """One 1×3 row of scalar fields with per-panel color limits — the
    matplotlib twin of the reference's pyvista row renderer
    (`compare_results.py:144-205`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    own = axes is None
    if own:
        fig, axes = plt.subplots(1, 3, figsize=(13, 4.2))
    tri = _tri(points2d, faces)
    for i, (name, vals) in enumerate(fields.items()):
        kw = {}
        if clim is not None and clim[i] is not None:
            kw = {"vmin": clim[i][0], "vmax": clim[i][1]}
        tpc = axes[i].tripcolor(tri, vals, shading="gouraud", cmap=cmap, **kw)
        axes[i].set_aspect("equal")
        axes[i].set_title(name, fontsize=10)
        axes[i].set_axis_off()
        cb = axes[i].figure.colorbar(tpc, ax=axes[i], shrink=0.75,
                                     orientation="horizontal", format="%.2e")
        cb.ax.locator_params(nbins=3)  # reference uses n_labels=3
    if own and output_file:
        axes[0].figure.tight_layout()
        axes[0].figure.savefig(output_file)
        plt.close(axes[0].figure)
    return axes


def plot_two_model_stress(
    points2d: np.ndarray,
    faces: np.ndarray,
    stress_baseline: np.ndarray,
    stress_proposed: np.ndarray,
    stress_fem: np.ndarray,
    baseline_name: str,
    proposed_name: str,
    output_file: str | Path,
) -> None:
    """3×3 cross-model stress figure (`plot_baseline_proposed_fem`,
    `compare_results.py:278-330`): baseline / proposed rows clamped to the
    FEM per-component color range, FEM row free."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fem_clim = [(c.min(), c.max()) for c in stress_fem.T]
    fig, axes = plt.subplots(3, 3, figsize=(13, 12))
    comps = ["XX", "YY", "XY"]
    for row, (name, data, clim) in enumerate(
        [
            (baseline_name, stress_baseline, fem_clim),
            (proposed_name, stress_proposed, fem_clim),
            ("FEM", stress_fem, None),
        ]
    ):
        fields = {
            f"{name} Stress {c}": data[:, i] for i, c in enumerate(comps)
        }
        plot_fields_row(points2d, faces, fields, clim=clim, axes=axes[row])
    fig.tight_layout()
    fig.savefig(output_file)
    plt.close(fig)


def plot_two_model_nmse(
    points2d: np.ndarray,
    faces: np.ndarray,
    nmse_baseline: np.ndarray,  # (N, 3) element-wise NMSE fields
    nmse_proposed: np.ndarray,
    baseline_name: str,
    proposed_name: str,
    output_file: str | Path,
) -> None:
    """2×3 element-wise NMSE comparison
    (`plot_difference_baseline_proposed_fem`, `compare_results.py:208-253`):
    the proposed row is clamped to the baseline's per-component range so
    improvements read as darker panels."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    base_clim = [(c.min(), c.max()) for c in nmse_baseline.T]
    fig, axes = plt.subplots(2, 3, figsize=(13, 8))
    comps = ["XX", "YY", "XY"]
    for row, (name, data, clim) in enumerate(
        [
            (baseline_name, nmse_baseline, None),
            (proposed_name, nmse_proposed, base_clim),
        ]
    ):
        fields = {
            f"{name} NMSE Stress {c}": data[:, i]
            for i, c in enumerate(comps)
        }
        plot_fields_row(points2d, faces, fields, clim=clim, axes=axes[row])
    fig.tight_layout()
    fig.savefig(output_file)
    plt.close(fig)


def plot_two_model_divergence(
    points2d: np.ndarray,
    faces: np.ndarray,
    div_baseline: np.ndarray,  # (N,) |div| fields
    div_proposed: np.ndarray,
    div_fem: np.ndarray,
    baseline_name: str,
    proposed_name: str,
    output_file: str | Path,
) -> None:
    """1×3 divergence-norm field row, all panels on the FEM color range
    (`plot_baseline_proposed_fem_divergence_fields`,
    `compare_results.py:256-275`)."""
    fem_clim = (div_fem.min(), div_fem.max())
    plot_fields_row(
        points2d,
        faces,
        {
            f"{baseline_name} Divergence Field": div_baseline,
            f"{proposed_name} Divergence Field": div_proposed,
            "FEM Divergence Field": div_fem,
        },
        output_file=output_file,
        clim=[fem_clim] * 3,
        cmap="jet",
    )


def plot_two_histograms(
    data1: np.ndarray,
    data2: np.ndarray,
    label1: str,
    label2: str,
    title: str,
    output_file: str | Path,
    bins: int = 50,
) -> None:
    """Overlaid per-component stress distributions
    (`plot_two_histograms`, used by `compare_results.py:1004-1046`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 4))
    ax.hist(data1, bins=bins, density=True, alpha=1.0, label=label1)
    ax.hist(data2, bins=bins, density=True, alpha=0.5, label=label2)
    ax.set_title(title)
    ax.set_ylabel("Density")
    ax.legend()
    fig.tight_layout()
    fig.savefig(output_file)
    plt.close(fig)
