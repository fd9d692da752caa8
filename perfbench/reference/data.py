"""The reference's view of the inputs: the normalisation statistics of a
mesh pool and the concatenated batch of some of its meshes, worked out
from the meshes' own arrays (no padding, no reordering)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.model import RefBatch


def norm_stats(meshes: list[dict], means: list[np.ndarray], fields: list[np.ndarray]) -> dict:
    """Scalar mean and unbiased std of the positions (x, y), the mean
    stress broadcast to every node, the stress field and the edge weights
    over the whole pool, in fp64."""
    pos = np.concatenate([m["pos"][:, :2] for m in meshes]).astype(np.float64)
    ms = np.concatenate([np.broadcast_to(mean, (len(m["pos"]), 3))
                         for m, mean in zip(meshes, means)]).astype(np.float64)
    ls = np.concatenate(fields).astype(np.float64)
    ew = np.concatenate([m["edge_weight"] for m in meshes]).astype(np.float64)
    out = {}
    for key, x in (("pos", pos), ("mean_stress", ms), ("local_stress", ls), ("edge_weight", ew)):
        out[f"mean_{key}"] = float(x.mean())
        out[f"std_{key}"] = float(x.std(ddof=1))
    return out


def ref_batch(meshes: list[dict], means: list[np.ndarray], fields: list[np.ndarray] | None,
              device: torch.device | str) -> RefBatch:
    """The meshes concatenated in the given order, each in its own node order."""
    xs, snd, rcv, ew, gid, ntype, drow, dsrc, disy, dval, tgt = ([] for _ in range(11))
    off = 0
    for g, mesh in enumerate(meshes):
        n = len(mesh["pos"])
        feats = np.zeros((n, 6), np.float64)
        feats[:, :3] = means[g]
        feats[:, 3:5] = mesh["pos"][:, :2]
        feats[:, 5] = mesh["labels"]
        xs.append(feats)
        snd.append(mesh["edge_index"][0] + off)
        rcv.append(mesh["edge_index"][1] + off)
        ew.append(mesh["edge_weight"])
        gid.append(np.full(n, g))
        ntype.append(mesh["labels"])
        if "div_data" in mesh:
            cols = mesh["div_col"]
            keep = cols < 2 * n
            drow.append(mesh["div_row"][keep] + off)
            dsrc.append(cols[keep] % n + off)
            disy.append(cols[keep] >= n)
            dval.append(mesh["div_data"][keep])
        if fields is not None:
            tgt.append(fields[g])
        off += n

    def t(parts: list, dtype: torch.dtype) -> torch.Tensor:
        if not parts:
            return torch.zeros(0, dtype=dtype, device=device)
        return torch.as_tensor(np.concatenate(parts), device=device).to(dtype)

    return RefBatch(
        x_in=t(xs, torch.float64), senders=t(snd, torch.long), receivers=t(rcv, torch.long),
        edge_w=t(ew, torch.float64)[:, None], node_gid=t(gid, torch.long),
        n_graphs=len(meshes), node_type=t(ntype, torch.long), div_row=t(drow, torch.long),
        div_src=t(dsrc, torch.long), div_isy=t(disy, torch.bool), div_val=t(dval, torch.float64),
        target=t(tgt, torch.float64) if fields is not None else None,
    )
