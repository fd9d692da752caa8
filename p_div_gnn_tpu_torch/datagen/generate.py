"""Dataset generation: the copy of ``p_div_gnn_tpu/datagen/generate.py``
(the ``generate`` command), with ``utils/configio.py``'s CSV writer in place
of pandas. It runs on the host only (numpy, scipy, a process pool).

It writes the on-disk contract of the JAX package's generator, so the two
packages' datasets are interchangeable: ``{train,test}/dataset.csv`` (the
same columns in the same order), ``meshes/hole_plate_mesh_<i>.vtk`` and
``fields/hole_plate_mesh_<i>.npz`` with keys stress_field, mean_stress,
mean_strain, mean_stress_material, op_div_matrix_{data,col_indices,
row_indices,shape}, op_mean_stress, node_labels.

Sampling distributions and parameters are the JAX package's: plate
100×100, padding factor 0.01, strain ∈ (−0.05, 0.05), global refinement ∈
(5, 10), hole refinement factor ∈ (3, 10), min radius 5; hyperelastic:
strain ∈ (−0.15, 0.15). A sample whose Neo-Hookean solve fails is printed
and skipped. The worker processes are spawned, not forked, so a caller that
holds a CUDA context or threads can run the generator.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np

from p_div_gnn_tpu_torch.datagen.mesher import (
    hole_plate_mesh,
    hole_plate_mesh_quad,
    is_periodic_mesh,
)
from p_div_gnn_tpu_torch.datagen.opdiv import (
    compute_op_div_matrix,
    compute_op_mean_stress,
)
from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
from p_div_gnn_tpu_torch.graphs.meshio import write_vtk
from p_div_gnn_tpu_torch.utils.configio import Table, write_csv


@dataclasses.dataclass
class DatasetParameters:
    mesh_filename: str
    data_filename: str
    mean_stress_x: float
    mean_stress_y: float
    mean_stress_xy: float
    mean_strain_x: float
    mean_strain_y: float
    mean_strain_xy: float
    mean_stress_x_material: float
    mean_stress_y_material: float
    mean_stress_xy_material: float
    hole_plate_center_x: float
    hole_plate_center_y: float
    hole_plate_radius: float
    plate_width: float
    plate_height: float
    global_mesh_refinement_size: float
    hole_mesh_refinement_factor: float
    n_nodes: int
    n_elements: int
    seed: int


def _compute_random_center_hole_points(
    rng, plate_height, plate_width, padding_factor, n_samples, min_radius=5.0
):
    padding = plate_width * padding_factor
    spacing = min_radius + 2 * padding
    cx = rng.uniform(spacing, plate_width - spacing, n_samples)
    cy = rng.uniform(spacing, plate_height - spacing, n_samples)
    return np.stack([cx, cy])


def _compute_random_hole_radius(
    rng, center_points, plate_height, plate_width, padding_factor, min_radius=5.0
):
    padding = plate_height * padding_factor
    cx, cy = center_points
    max_r = np.min(
        np.stack(
            [
                (plate_height - padding) - cy,
                cy - padding,
                (plate_width - padding) - cx,
                cx - padding,
            ]
        ),
        axis=0,
    )
    n = center_points.shape[1]
    return rng.uniform(np.repeat(min_radius + padding, n), max_r, size=n)


def sample_parameters(
    rng: np.random.Generator,
    n_samples: int,
    plate_width_height: float = 100.0,
    padding_factor: float = 0.01,
    strain_range: tuple[float, float] = (-0.05, 0.05),
    global_mesh_refinement_range: tuple[float, float] = (5.0, 10.0),
    hole_mesh_refinement_factor_range: tuple[float, float] = (3.0, 10.0),
) -> np.ndarray:
    strains = rng.uniform(*strain_range, size=(n_samples, 3))
    centers = _compute_random_center_hole_points(
        rng, plate_width_height, plate_width_height, padding_factor, n_samples
    )
    radii = _compute_random_hole_radius(
        rng, centers, plate_width_height, plate_width_height, padding_factor
    )
    glob = rng.uniform(*global_mesh_refinement_range, size=n_samples)
    holef = rng.uniform(*hole_mesh_refinement_factor_range, size=n_samples)
    return np.vstack(
        [strains[:, 0], strains[:, 1], strains[:, 2], centers[0], centers[1],
         radii, glob, holef]
    ).T


def split_train_test(data: np.ndarray, test_size: float, rng: np.random.Generator) -> tuple:
    total = data.shape[0]
    n_test = int(total * test_size)
    remove = rng.choice(np.arange(total), size=n_test, replace=False)
    test = data[remove]
    train = np.delete(data, remove, axis=0)
    return train, test


def generate_one_sample(args: tuple) -> dict[str, Any] | None:
    """One sample's mesh, solve and files; its ``dataset.csv`` row, or None
    when its Neo-Hookean solve failed."""
    (
        row,
        index,
        plate_wh,
        meshes_folder,
        fields_folder,
        seed,
        hyperelastic,
        bc,
        element,
    ) = args
    (sx, sy, sxy, cx, cy, radius, glob, holef) = row
    mesher = hole_plate_mesh if element == "tri" else hole_plate_mesh_quad
    mesh = mesher(
        width=plate_wh,
        height=plate_wh,
        radius=radius,
        hole_center=(cx, cy),
        hole_refinement_factor=holef,
        global_mesh_refinement_size=glob,
        seed=seed + index,
    )
    pts = mesh.points[:, :2]
    assert is_periodic_mesh(pts), "Mesh is not periodic"

    if hyperelastic:
        from p_div_gnn_tpu_torch.datagen.hyperelastic import (
            solve_periodic_rve_neohookean,
        )

        try:
            res = solve_periodic_rve_neohookean(pts, mesh.faces, sx, sy, sxy)
        except Exception as exc:  # failed NR solves are skipped (C17,
            # `generate_dataset_hyperelast.py:501-509`)
            print(f"sample {index}: nonlinear solve failed ({exc}); skipped")
            return None
        # divergence operator on the DEFORMED mesh, post-solve
        # (`generate_dataset_hyperelast.py:352`)
        op_div = compute_op_div_matrix(pts + res.displacement, mesh.faces)
    elif bc == "neumann":
        # stress-controlled variant (`compute_mechanical_fields_neumann`,
        # generate_dataset.py:306-410). The sampled strain triple is mapped
        # to an imposed mean stress through the homogeneous plane-stress law
        # σ = D·ε so both modes share the reference's strain ranges.
        from p_div_gnn_tpu_torch.datagen.fem import (
            plane_stress_D,
            solve_periodic_rve_neumann,
        )

        sig = plane_stress_D(1e5, 0.3) @ np.array([sx, sy, sxy])
        res = solve_periodic_rve_neumann(pts, mesh.faces, *sig)
        op_div = compute_op_div_matrix(pts, mesh.faces)
    else:
        assert bc == "dirichlet", f"unknown bc {bc!r}"
        from p_div_gnn_tpu_torch.datagen.fem import solve_periodic_rve

        res = solve_periodic_rve(pts, mesh.faces, sx, sy, sxy)
        op_div = compute_op_div_matrix(pts, mesh.faces)

    sample_name = f"hole_plate_mesh_{int(index)}"
    mesh_fn = (meshes_folder / f"{sample_name}.vtk").as_posix()
    data_fn = (fields_folder / f"{sample_name}.npz").as_posix()
    write_vtk(mesh_fn, mesh)
    node_labels = compute_node_labels(mesh)
    np.savez(
        data_fn,
        stress_field=res.stress_nodes.astype(np.float64),
        mean_stress=np.asarray(res.mean_stress),
        mean_strain=np.array((sx, sy, sxy)),
        mean_stress_material=np.asarray(res.mean_stress_material),
        op_div_matrix_data=op_div.data,
        op_div_matrix_col_indices=op_div.col,
        op_div_matrix_row_indices=op_div.row,
        op_div_matrix_shape=np.array(op_div.shape),
        op_mean_stress=compute_op_mean_stress(pts, mesh.faces),
        node_labels=node_labels,
    )
    params = DatasetParameters(
        mesh_filename=mesh_fn,
        data_filename=data_fn,
        mean_stress_x=float(res.mean_stress[0]),
        mean_stress_y=float(res.mean_stress[1]),
        mean_stress_xy=float(res.mean_stress[2]),
        mean_strain_x=float(sx),
        mean_strain_y=float(sy),
        mean_strain_xy=float(sxy),
        mean_stress_x_material=float(res.mean_stress_material[0]),
        mean_stress_y_material=float(res.mean_stress_material[1]),
        mean_stress_xy_material=float(res.mean_stress_material[2]),
        hole_plate_center_x=float(cx),
        hole_plate_center_y=float(cy),
        hole_plate_radius=float(radius),
        plate_width=float(plate_wh),
        plate_height=float(plate_wh),
        global_mesh_refinement_size=float(glob),
        hole_mesh_refinement_factor=float(holef),
        n_nodes=mesh.n_points,
        n_elements=mesh.n_cells,
        seed=seed,
    )
    return dataclasses.asdict(params)


def generate_and_save_samples(
    data: np.ndarray,
    plate_width_height: float,
    dataset_folder: Path,
    seed: int,
    max_workers: int,
    hyperelastic: bool,
    bc: str = "dirichlet",
    element: str = "tri",
) -> Table:
    meshes_folder = dataset_folder / "meshes"
    fields_folder = dataset_folder / "fields"
    meshes_folder.mkdir(parents=True, exist_ok=False)
    fields_folder.mkdir(parents=True, exist_ok=False)
    tasks = [
        (row, i, plate_width_height, meshes_folder, fields_folder, seed,
         hyperelastic, bc, element)
        for i, row in enumerate(data)
    ]
    if max_workers and max_workers > 1:
        spawn = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=max_workers, mp_context=spawn) as ex:
            rows = list(ex.map(generate_one_sample, tasks))
    else:
        rows = [generate_one_sample(t) for t in tasks]
    rows = [r for r in rows if r is not None]
    if not rows:  # pandas.concat of no frames raises too
        raise ValueError("no sample was generated")
    return {k: [r[k] for r in rows] for k in rows[0]}


def main(
    n_samples: int = 1000,
    test_size: float = 0.25,
    seed: int = 69,
    dataset_path: str = "",
    max_workers: int | None = None,
    hyperelastic: bool = False,
    bc: str = "dirichlet",
    element: str = "tri",
) -> None:
    assert dataset_path, "Must specify dataset path"
    assert not (hyperelastic and bc != "dirichlet"), (
        "bc='neumann' is a linear-elastic capability (the reference defines "
        "it only in generate_dataset.py, not the hyperelastic generator)"
    )
    assert element in ("tri", "quad"), f"unknown element {element!r}"
    assert not (hyperelastic and element == "quad"), (
        "quad elements are a linear-elastic capability (the reference's "
        "quad mesher, generate_dataset_hyperelast.py:106-161, is unused by "
        "its own pipeline; our Q4 assembly covers the linear solvers)"
    )
    if max_workers is None:
        max_workers = multiprocessing.cpu_count()
    plate_wh = 100.0
    strain_range = (-0.15, 0.15) if hyperelastic else (-0.05, 0.05)
    rng = np.random.default_rng(seed=seed)
    data = sample_parameters(
        rng, n_samples, plate_wh, strain_range=strain_range
    )
    train, test = split_train_test(data, test_size, rng)
    print(f"Dataset folder {dataset_path}; seed {seed}")
    print(f"N train samples {len(train)}; N test samples {len(test)}")
    for kind, part in zip(("train", "test"), (train, test)):
        folder = Path(dataset_path) / kind
        folder.mkdir(parents=True, exist_ok=False)
        table = generate_and_save_samples(
            part, plate_wh, folder, seed, max_workers, hyperelastic,
            bc=bc, element=element,
        )
        write_csv(folder / "dataset.csv", table)
