"""The comparisons that decide ``correct``: the numbers a run's outputs
give against the plain reference's, each held to the limit that
``limits/<cell>.json`` sets for it (from the readings in PERF.md).

Training: the first step's loss, the first gradient as Adam holds it
after step 1 (exp_avg / (1 - β1)) and the parameters' change over the
first three steps, the norms compared leaf by leaf. Serving: the served
stress fields of a sample of the window's requests.
"""

from __future__ import annotations

import json

import torch

from perfbench.harness.registry import BENCH

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone, and is left out of the change's comparison
NEGLIGIBLE_GRAD = 1e-3
# the control: the nearest precision below each stream precision a configuration states
CONTROL = {"float32": "tf32", "bfloat16": "float8_e4m3fn"}


def control_args(cfg: dict) -> dict:
    """The reference's arguments that put it one precision below ``cfg``'s."""
    if CONTROL[cfg["stream_dtype"]] == "tf32":
        return {"dtype": torch.float32, "tf32": True}
    return {"dtype": torch.float64, "stream": getattr(torch, CONTROL[cfg["stream_dtype"]])}


def limits(cell: str) -> dict[str, float]:
    return {k: v["limit"] for k, v in json.loads(
        (BENCH / "limits" / f"{cell}.json").read_text())["numbers"].items()}


def _norms(leaves: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def _gaps(prog: dict[str, float], ref: dict[str, float], kept: list[str]) -> dict[str, float]:
    """Each kept leaf's gap between the two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(torch.tensor([ref[k] for k in kept]).median())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept}


def _kept(ref_grad: dict[str, float]) -> list[str]:
    med = float(torch.tensor(list(ref_grad.values())).median())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE_GRAD * med]


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog`` and ``ref``: {"losses": [3 floats], "grad": {leaf: tensor},
    "delta": {leaf: tensor}}. A missing or non-finite reading is inf.

    - ``loss1_gap``: the first step's loss, relative;
    - ``grad_gap``: the first gradient, the worst leaf's gap of norms;
    - ``update_gap``: the change over the three steps, the worst leaf's
      gap of norms.

    The later steps' losses are not compared: Adam's first update moves
    every entry by about the learning rate in the sign of its gradient, so
    an entry whose gradient is nought to rounding moves the other way on
    one side, and the losses that follow swing from seed to seed (PERF.md
    gives both readings)."""
    out = {"loss1_gap": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
           if prog["losses"] else float("inf")}
    g_ref = _norms(ref["grad"])
    kept = _kept(g_ref)
    try:
        out["grad_gap"] = max(_gaps(_norms(prog["grad"]), g_ref, kept).values())
        out["update_gap"] = max(_gaps(_norms(prog["delta"]), _norms(ref["delta"]),
                                      kept).values())
    except KeyError:
        out["grad_gap"] = out["update_gap"] = float("inf")
    return {k: (v if v == v else float("inf")) for k, v in out.items()}


def train_details(prog: dict, ref: dict) -> dict:
    """What the look behind ``train_numbers`` needs: each step's loss gap,
    the worst leaf of the gradient and of the change, and the entries whose
    first gradient has the other sign than the reference's."""
    g_ref = _norms(ref["grad"])
    kept = _kept(g_ref)
    out = {"loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])],
           "left_out": sorted(set(g_ref) - set(kept))}
    for key in ("grad", "delta"):
        if prog.get(key):
            gaps = _gaps(_norms(prog[key]), _norms(ref[key]), kept)
            worst = max(gaps, key=gaps.get)
            out[f"{key}_worst"] = [worst, gaps[worst]]
    if prog.get("grad"):
        out["sign_flips"] = sum(int((torch.sign(prog["grad"][k]) != torch.sign(
            ref["grad"][k].to(prog["grad"][k].device))).sum()) for k in kept)
    return out


def serve_numbers(fields: list, refs: list, std: float) -> dict[str, float]:
    """The widest gap of a served value from the reference's, in units of
    the stress field's std, over every sampled mesh and node."""
    worst = 0.0
    if len(fields) != len(refs):
        return {"field_gap": float("inf")}
    for got, want in zip(fields, refs):
        got = torch.as_tensor(got, dtype=torch.float64)
        if got.shape != want.shape:
            return {"field_gap": float("inf")}
        gap = float((got.to(want.device) - want).abs().max()) / std
        worst = max(worst, gap if gap == gap else float("inf"))
    return {"field_gap": worst}


def judged(numbers: dict[str, float], cell_limits: dict[str, float]) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]): correct when every number is
    within its limit."""
    checks = [(k, numbers.get(k, float("inf")), lim) for k, lim in cell_limits.items()]
    return all(v <= lim for _, v, lim in checks), checks
