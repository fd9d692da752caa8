"""Inference: a checkpoint → model on the device → per-mesh stress fields.

The counterpart of ``p_div_gnn_tpu/inference.py:27-105``. ``Predictor``
answers requests of host samples: it packs the request's meshes into one
batch, runs the batched forward with output un-standardisation and slices
the prediction back per mesh in each mesh's original node order.
``run_inference`` is the ``pdg-infer`` path: a ``dataset.csv`` → the
dataset → an unshuffled loader whose batches stay on the device → the
forward → each prediction written as a copy of its sample's npz with
``stress_field`` replaced, then the new ``dataset.csv`` and
``normalize_params.json``.
"""

from __future__ import annotations

import itertools
import json
import shutil
from pathlib import Path

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.batching import GraphSample, pack_batch, unpack_predictions
from p_div_gnn_tpu_torch.graphs.dataset import MeshStressFieldDataset
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.train.checkpoint import load_checkpoint
from p_div_gnn_tpu_torch.train.data import GraphLoader
from p_div_gnn_tpu_torch.utils.configio import read_config, read_csv, write_csv
from p_div_gnn_tpu_torch.utils.profiling import span


class Predictor:
    """Answers requests of mesh samples with predicted local stress fields."""

    def __init__(
        self,
        checkpoint: str | Path,
        latent_size: int = 128,
        message_passing_steps: int = 10,
        scatter_impl: str = "fused3",
        stream_dtype: str = "float32",
        device: str | torch.device = "cuda",
    ):
        state_dict, self.epoch, self.stats = load_checkpoint(checkpoint)
        self.device = torch.device(device)
        self.model = EncodeProcessDecode(
            latent_size=latent_size,
            message_passing_steps=message_passing_steps,
            scatter_impl=scatter_impl,
            stream_dtype=stream_dtype,
        )
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self._requests = itertools.count()

    @torch.no_grad()
    def predict(self, samples: list[GraphSample]) -> list[np.ndarray]:
        """One (N_i, 3) stress field per sample, as the JAX inference path
        computes it (RCM-ordered batch, pair-blocked for ``"fused2"``, fp32
        model). Traced as ``serve.pack``, ``serve.copy_in``,
        ``serve.forward`` (with its device time), ``serve.copy_out`` and
        ``serve.unpack``, which share the request's id
        (``utils/profiling.py``)."""
        request = next(self._requests)
        with span("serve.pack", request=request):
            host = pack_batch(samples, reorder="rcm", sender_view=False, div_ell=False,
                              pair_blocks=self.model.scatter_impl == "fused2")
        with span("serve.copy_in", request=request):
            batch = host.to(self.device)
        with span("serve.forward", device=True, request=request):
            out = self.model(batch, self.stats)
        with span("serve.copy_out", request=request):
            pred = out.cpu().numpy()
        with span("serve.unpack", request=request):
            return unpack_predictions(host, pred)


def copy_data_file_and_replace_local_stress_field(
    original_data_path: str, target_data_path: str, local_stress_field: np.ndarray
) -> None:
    """Write ``target_data_path`` as a copy of the sample npz at
    ``original_data_path`` with its ``stress_field`` replaced."""
    shutil.copyfile(original_data_path, target_data_path)
    with np.load(original_data_path) as data:
        org_data = dict(data)
    org_data["stress_field"] = np.asarray(local_stress_field)
    np.savez(target_data_path, **org_data)


def run_inference(
    dataset_csv: str | Path,
    results_folder: str | Path,
    model_weights_path: str | Path,
    periodic_graph: bool,
    batch_size: int,
    latent_size: int,
    message_passing_steps: int,
    config_path: Path | str | None = None,
    scatter_impl: str = "xla",
    device: str | torch.device = "cuda",
) -> list[str]:
    """Predict every row of ``dataset_csv`` with the checkpoint at
    ``model_weights_path`` on ``device``; writes ``fields/*.npz``,
    ``dataset.csv`` and ``normalize_params.json`` under ``results_folder``
    and returns the written field paths."""
    table = read_csv(dataset_csv)
    results_folder = Path(results_folder)
    results_folder.mkdir(parents=True, exist_ok=True)
    if config_path:
        shutil.copyfile(config_path, results_folder / Path(config_path).name)
    print("Loading datasets...")
    dataset = MeshStressFieldDataset(table, periodic_graph=periodic_graph)
    loader = GraphLoader(dataset.samples, batch_size, shuffle=False, device=device)

    state_dict, _, stats = load_checkpoint(model_weights_path)
    model = EncodeProcessDecode(
        latent_size=latent_size,
        message_passing_steps=message_passing_steps,
        scatter_impl=scatter_impl,
    )
    model.load_state_dict(state_dict)
    model.to(device).eval()

    fields_folder = results_folder / "fields"
    fields_folder.mkdir(exist_ok=True, parents=True)
    predicted: list[str] = []
    print("Running inferences...")
    for batch in loader:
        with torch.no_grad():
            pred = model(batch.to(device), stats, scale_input=True, scale_output=True)
        for stress in unpack_predictions(batch, pred.cpu().numpy()):
            mesh_id = len(predicted)
            path = (fields_folder / f"hole_plate_mesh_{mesh_id}.npz").as_posix()
            copy_data_file_and_replace_local_stress_field(
                table["data_filename"][mesh_id], path, stress)
            predicted.append(path)

    out = dict(table)
    out["data_filename"] = predicted
    write_csv(results_folder / "dataset.csv", out)
    with open(results_folder / "normalize_params.json", "w") as fh:
        json.dump({"mean_local_stress": float(stats.mean_local_stress),
                   "std_local_stress": float(stats.std_local_stress)}, fh)
    return predicted


def main(config_path: str | Path, device: str | torch.device = "cuda") -> list[str]:
    """Run inference as the config at ``config_path`` says, on ``device``
    (the config's own ``device`` key is accepted and ignored)."""
    params = read_config(config_path)
    params.pop("device", None)
    params["config_path"] = Path(config_path)
    return run_inference(**params, device=device)
