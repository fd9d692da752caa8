"""The seams through which a later change adds an architecture or a traffic
kind as new files only: a copy of the benchmark takes a toy architecture
(``arch/toygnn.py``: a two-block plain GNN with its own weights, trainer
and reference) and a toy traffic kind (``harness/toykind.py``), each with
its configuration, traffic, limits and cell, and runs them through its own
registry; a configuration without ``arch``, or naming an absent module,
fails with a message that names the missing file."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import registry

TOY_ARCH = '''"""A toy architecture for the seam test: two message-passing blocks with
their own weights, m = relu(W_e [x_s, x_r, e]), x += relu(W_n [x, sum m]),
on the raw node features, trained on the squared error of the field."""

import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.inputs.pool import sine_targets
from perfbench.reference.data import ref_batch

REQUIRED_KEYS = ("latent_size", "blocks", "batch_size", "learning_rate", "stream_dtype")


def layers(cfg):
    """(name, fan in, fan out) of each dense layer."""
    L, B = cfg["latent_size"], cfg["blocks"]
    inner = [(f"{kind}{k}", n_in, L) for k in range(B)
             for kind, n_in in (("edge", 2 * L + 1), ("node", 2 * L))]
    return [("enc", 6, L)] + inner + [("dec", L, 3)]


def forward(p, x_in, senders, receivers, edge_w, edge_mask, blocks):
    x_in = torch.cat([x_in[:, :3], x_in[:, 3:5] * 0.01, x_in[:, 5:]], 1)
    x = torch.relu(F.linear(x_in, p["enc_w"], p["enc_b"]))
    for k in range(blocks):
        m = torch.relu(F.linear(torch.cat([x[senders], x[receivers], edge_w], 1),
                                p[f"edge{k}_w"], p[f"edge{k}_b"])) * edge_mask
        agg = torch.zeros_like(x).index_add_(0, receivers, m)
        x = x + torch.relu(F.linear(torch.cat([x, agg], 1), p[f"node{k}_w"], p[f"node{k}_b"]))
    return F.linear(x, p["dec_w"], p["dec_b"])


class ToyGNN(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.blocks = cfg["blocks"]
        for name, n_in, n_out in layers(cfg):
            self.register_parameter(f"{name}_w", torch.nn.Parameter(torch.empty(n_out, n_in)))
            self.register_parameter(f"{name}_b", torch.nn.Parameter(torch.empty(n_out)))

    def forward(self, batch):
        x_in = torch.cat([batch.mean_stress, batch.pos, batch.node_type], 1)
        real = (batch.edge_gid < batch.n_graphs)[:, None].to(x_in.dtype)
        return forward(dict(self.named_parameters()), x_in, batch.senders.long(),
                       batch.receivers.long(), batch.edge_weight, real, self.blocks)


def toy_loss(batch, pred):
    real = batch.node_gid < batch.n_graphs
    return ((pred - batch.local_stress)[real] ** 2).mean()


class ToyTrainer:
    def __init__(self, model, lr, device):
        self.model, self.lr, self.optimizer = model.to(device), lr, None

    def init(self):
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def loss_and_grads(self, batch):
        self.model.zero_grad(set_to_none=True)
        total = toy_loss(batch, self.model(batch))
        total.backward()
        return {"total": total.detach()}, None

    def train_step(self, batch):
        if self.optimizer is None:
            self.init()
        aux, _ = self.loss_and_grads(batch)
        self.optimizer.step()
        return aux


def draw_inputs(pool, seed):
    return {"targets": sine_targets(pool, seed)}


def port_samples(inputs):
    from p_div_gnn_tpu_torch.graphs.batching import GraphSample
    from p_div_gnn_tpu_torch.graphs.build import MeshGraph

    return [GraphSample(
        graph=MeshGraph(pos=m["pos"], edge_index=m["edge_index"], edge_weight=m["edge_weight"],
                        faces=m["faces"], org_num_edges=m["org_num_edges"], is_periodic=True),
        mean_stress=mean, local_stress=field, node_labels=m["labels"],
        div_data=np.zeros(0, np.float32), div_row=np.zeros(0, np.int64),
        div_col=np.zeros(0, np.int64))
        for m, (mean, field) in zip(inputs["pool"], inputs["targets"])]


def draw_weights(cfg, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, n_in, n_out in layers(cfg):
        bound = 1.0 / math.sqrt(n_in)
        w = (torch.rand(n_out * (n_in + 1), generator=gen, device=device) * 2 - 1) * bound
        out[f"{name}_w"], out[f"{name}_b"] = w[:n_out * n_in].reshape(n_out, n_in), w[n_out * n_in:]
    return out


def build_program(cfg, traffic, inputs, initial, device):
    from p_div_gnn_tpu_torch.train.data import GraphLoader

    model = ToyGNN(cfg)
    model.load_state_dict(initial)
    loader = GraphLoader(port_samples(inputs), cfg["batch_size"], shuffle=True,
                         seed=inputs["loader_seed"], cache_groups=traffic["cache_groups"],
                         device=device)
    return ToyTrainer(model, cfg["learning_rate"], device), loader


def reference_stats(inputs):
    return {}


def reference_batch(inputs, ids, device):
    pool, targets = inputs["pool"], inputs["targets"]
    return ref_batch([pool[i] for i in ids], [targets[i][0] for i in ids],
                     [targets[i][1] for i in ids], device)


def reference_loss(params, batch, stats, cfg, stream):
    dt = params["enc_w"].dtype
    pred = forward(params, batch.x_in.to(dt), batch.senders, batch.receivers,
                   batch.edge_w.to(dt), 1.0, cfg["blocks"])
    return ((pred - batch.target.to(dt)) ** 2).mean()


def model_flops(cfg, E, N):
    L, B = cfg["latent_size"], cfg["blocks"]
    return (float(B * 2 * E * (2 * L + 1) * L),
            float(2 * N * 6 * L + B * 2 * N * 2 * L * L + 2 * N * L * 3))


def fault_sites():
    return {"step": (ToyTrainer, "train_step"), "loss": (sys.modules[__name__], "toy_loss"),
            "output": (ToyGNN, "forward")}
'''

TOY_KIND = '''"""A toy traffic kind for the seam test: it runs nothing and reports a
fixed rate."""

UNIT = "step"


def run(cfg, traffic, seed, seconds, trace, device, t_start, workers=None, pool=None):
    return {"toy_rate": float(traffic["rate"]), "setup_s": 0.5, "memory_peak_bytes": 0,
            "attempted": 1, "failed": 0, "numbers": {"toy_gap": 0.0}, "units": [], "spans": {}}


def calibration_rows(cfg, traffic, seed, seconds, do_control, do_faults):
    yield "program", {"toy_gap": 0.0}
'''

POOL = {"meshes": 6, "plate": [100.0, 100.0], "radius": [15.0, 30.0],
        "hole_refinement_factor": 2.0, "global_mesh_refinement_size": 12.0,
        "divergence_operator": False}

# run in the copy: its registry, its driver, its run.py
CHECK = '''import json
import sys
import time
from pathlib import Path

COPY, REPO, OUT = sys.argv[1:4]
sys.path[:0] = [COPY, REPO]


def main():
    import torch

    from perfbench.harness import common, registry
    from perfbench.harness.compare import judged, limits
    from perfbench.harness.faults import planted

    res = {"bench": str(registry.BENCH)}
    work = registry.cell("toy.train")
    cfg, traffic = registry.config(work), registry.traffic(work["traffic"])
    driver = registry.driver(traffic["kind"])
    out = driver.run(cfg, traffic, 2**31 + 5, 0.5, False, "cpu", time.perf_counter(), workers=1)
    res["sound"] = judged(out["numbers"], limits("toy.train"))
    res["attempted"], res["failed"] = out["attempted"], out["failed"]
    with planted("answer_altered", "toygnn"):
        out = driver.run(cfg, traffic, 2**31 + 5, 0.5, False, "cpu", time.perf_counter(),
                         workers=1)
    res["altered"] = judged(out["numbers"], limits("toy.train"))
    res["flops"] = registry.arch("toygnn").model_flops(cfg, 10, 5)

    # run.py's own lookup of the kind, past the card's checks
    import importlib.util

    common.require_cards = lambda count: None
    torch.cuda.get_device_name = lambda index=0: "no card"
    spec = importlib.util.spec_from_file_location("toy_run", Path(COPY) / "perfbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    res["rc"] = run.main(["--workload", "toy.kind", "--seed", "7", "--seconds", "1",
                          "--trace", "0"])
    Path(OUT).write_text(json.dumps(res))


if __name__ == "__main__":
    main()
'''


def copy_benchmark(dest: Path) -> dict:
    """The benchmark's files alone in ``dest``; returns its BENCHMARK.json."""
    shutil.copytree(registry.BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", dest)
    return json.loads((dest / "BENCHMARK.json").read_text())


def write(path: Path, data) -> None:
    path.write_text(data if isinstance(data, str) else json.dumps(data, indent=1))


def test_a_new_architecture_and_kind_are_files_only(tmp_path):
    bench = copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    pb = tmp_path / "perfbench"
    write(pb / "arch" / "toygnn.py", TOY_ARCH)
    write(pb / "harness" / "toykind.py", TOY_KIND)
    write(pb / "configs" / "toygnn.json",
          {"name": "toygnn", "arch": "toygnn", "latent_size": 8, "blocks": 2, "batch_size": 2,
           "learning_rate": 1e-3, "stream_dtype": "float32", "kernels": [], "reduced": []})
    write(pb / "traffic" / "toy-train.json",
          {"kind": "train", "pool": POOL, "cache_groups": True, "warmup_steps": 1,
           "trace_steps": 2, "loader_seed": 69})
    write(pb / "traffic" / "toy-kind.json", {"kind": "toykind", "pool": POOL, "rate": 7})
    write(pb / "limits" / "toy.train.json",
          {"cell": "toy.train", "numbers": {"loss1_gap": {"limit": 1e-5},
                                            "grad_gap": {"limit": 1e-4},
                                            "update_gap": {"limit": 0.03}}})
    write(pb / "limits" / "toy.kind.json",
          {"cell": "toy.kind", "numbers": {"toy_gap": {"limit": 0.0}}})
    bench["configs"].append({"name": "toygnn", "source": "https://arxiv.org/abs/2010.03409",
                             "file": "perfbench/configs/toygnn.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"] += [
        {"name": "toy.train", "config": "toygnn", "traffic": "toy-train", "chips": 1,
         "why": "toy"},
        {"name": "toy.kind", "config": "toygnn", "traffic": "toy-kind", "chips": 1,
         "why": "toy"}]
    bench["end_to_end"].append({"name": "toy_rate", "unit": "steps/s", "better": "higher",
                                "bound": 0.02, "source": "host_clock",
                                "workloads": ["toy.kind"]})
    write(tmp_path / "BENCHMARK.json", bench)
    write(tmp_path / "check_seam.py", CHECK)
    assert all(p.read_bytes() == data for p, data in before.items())  # nothing edited

    proc = subprocess.run(
        [sys.executable, str(tmp_path / "check_seam.py"), str(tmp_path), str(registry.ROOT),
         str(tmp_path / "seam.json")],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads((tmp_path / "seam.json").read_text())
    assert res["bench"] == str(pb.resolve())  # the copy's registry found the copy's files
    correct, checks = res["sound"]
    assert correct, checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert not res["altered"][0], res["altered"]  # planted at the toy's own site
    assert res["flops"] == [2 * 2 * 10 * 17 * 8, 2 * 5 * 6 * 8 + 2 * 2 * 5 * 16 * 8 + 2 * 5 * 8 * 3]
    assert res["rc"] == 0
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["toy_rate"] == {"value": 7.0, "unit": "steps/s"}
    assert set(line["metrics"]) == {"toy_rate", "setup_s"}


@pytest.mark.parametrize("case", ["no_arch_key", "absent_module", "missing_required_key"])
def test_config_names_its_architecture(case, tmp_path):
    data = json.loads((registry.BENCH / "configs" / "pdivgnn-fp32.json").read_text())
    if case == "no_arch_key":
        del data["arch"]
        wanted = [str(tmp_path / "cfg.json"), '"arch"', str(registry.BENCH / "arch")]
    elif case == "absent_module":
        data["arch"] = "meshgraphnets"
        wanted = [str(registry.BENCH / "arch" / "meshgraphnets.py")]
    else:
        del data["divergence_penalty"]
        wanted = [str(tmp_path / "cfg.json"), "divergence_penalty", "arch/pdivgnn.py"]
    write(tmp_path / "cfg.json", data)
    with pytest.raises(SystemExit) as err:
        registry.config({"config_file": tmp_path / "cfg.json"})
    assert all(w in str(err.value) for w in wanted), str(err.value)


def test_absent_traffic_kind_names_its_file():
    with pytest.raises(SystemExit, match="harness/replay.py"):
        registry.driver("replay")
