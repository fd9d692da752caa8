"""Read and write the JAX package's checkpoints without flax or msgpack.

The counterpart of ``p_div_gnn_tpu/train/checkpoint.py``. A checkpoint is
one msgpack map with the keys ``epoch``, ``model_state_dict``
(``{"params": ...}``), ``optimizer_state_dict`` and ``stats`` (the 8
normalization scalars), as ``flax.serialization.msgpack_serialize`` writes
it: every map's keys sorted (the pytree order), arrays as msgpack extension
type 1 whose payload is itself msgpack of ``(shape, dtype_name,
raw_bytes)``, numpy scalars as extension type 3 with the same payload.

The optimizer state is optax's ``adam`` state, ``{"0": {"count", "mu":
{"params": ...}, "nu": {"params": ...}}, "1": {}}``, which torch's Adam
holds as each parameter's ``step``, ``exp_avg`` and ``exp_avg_sq``; with
``skip_nonfinite_updates`` it is wrapped as optax's ``ApplyIfFiniteState``
(``notfinite_count``, ``last_finite``, ``total_notfinite``,
``inner_state``). With ``flatten_optimizer`` it is ``optax.flatten(adam)``'s
state: ``mu`` and ``nu`` are each ONE fp32 vector, the parameters' moments
raveled and concatenated in the params tree's leaf order (keys sorted at
every level).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.models.params import params_from_jax, params_to_jax

BEST_CHECKPOINT = "model_weights.ckpt"
LAST_CHECKPOINT = "last_epoch_model_weights.ckpt"
# the fields optax's ApplyIfFiniteState adds around the inner state
NONFINITE_FIELDS = ("notfinite_count", "last_finite", "total_notfinite")

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_CHUNK = 2**30  # flax.serialization.MAX_CHUNK_SIZE


class _Reader:
    """Decoder for the msgpack subset flax writes: nil, bool, ints, floats,
    str, bin, array, map and ext."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # tag: (length format, kind)
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        scalars = {
            0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"unsupported msgpack tag 0x{b:02x} at byte {self.pos - 1}")

    def array(self, n: int) -> list[Any]:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype_name, buf = read_msgpack(payload)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


def read_msgpack(data: bytes) -> Any:
    """Decode one msgpack object (flax's array extensions → numpy)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after msgpack object")
    return out


def _pack_int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for tag, fmt, top in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                              (0xCE, "I", 0xFFFFFFFF), (0xCF, "Q", 2**64 - 1)):
            if x <= top:
                return bytes([tag]) + struct.pack(">" + fmt, x)
    for tag, fmt, low in ((0xD0, "b", -0x80), (0xD1, "h", -0x8000),
                          (0xD2, "i", -0x80000000), (0xD3, "q", -2**63)):
        if x >= low:
            return bytes([tag]) + struct.pack(">" + fmt, x)
    raise ValueError(f"integer {x} does not fit msgpack")


def _pack_len(n: int, fix: int | None, fix_max: int, tags: tuple[int, ...]) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for tag, fmt in zip(tags, ("B", "H", "I")):
        if tag and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([tag]) + struct.pack(">" + fmt, n)
    raise ValueError(f"msgpack length {n} too large")


def _pack_array_payload(arr: np.ndarray) -> bytes:
    if arr.nbytes > _MAX_CHUNK:
        raise ValueError(f"an array of {arr.nbytes} bytes: flax would split it in chunks")
    return _write(list(arr.shape)) + _write(arr.dtype.name) + _write(arr.tobytes())


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def _write(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if type(obj) is int:
        return _pack_int(obj)
    if type(obj) is float:
        return b"\xcb" + struct.pack(">d", obj)
    if type(obj) is str:
        raw = obj.encode()
        return _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if type(obj) is bytes:
        return _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + obj
    if type(obj) is list:
        head = _pack_len(len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        return head + b"".join(_write(v) for v in obj)
    if type(obj) is dict:  # in the pytree's order: keys sorted
        head = _pack_len(len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        return head + b"".join(_write(k) + _write(obj[k]) for k in sorted(obj))
    if isinstance(obj, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, b"\x93" + _pack_array_payload(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(_EXT_NPSCALAR, b"\x93" + _pack_array_payload(np.asarray(obj)))
    raise TypeError(f"cannot write {type(obj).__name__} to a checkpoint")


def write_msgpack(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives ``tree`` (maps
    with str keys, lists, None, bools, ints, floats, str, numpy arrays and
    scalars; an array of more than 1 GiB, which flax splits, raises)."""
    return _write(tree)


def flat_order(names: Iterable[str]) -> list[str]:
    """Parameter names in the params tree's leaf order (``jax.tree.flatten``
    of nested dicts: keys sorted at every level), the order of
    ``optax.flatten``'s vector."""
    return sorted(names, key=lambda n: n.split("."))


def _flatten_moment(tensors: dict[str, torch.Tensor]) -> np.ndarray:
    return np.concatenate([tensors[n].detach().cpu().float().numpy().ravel()
                           for n in flat_order(tensors)])


def _moments(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             flat: bool = False) -> dict[str, Any]:
    """optax's adam state (``optax.flatten(adam)``'s with ``flat``) from
    torch Adam's per-parameter state."""
    named = dict(model.named_parameters())
    mu, nu, count = {}, {}, 0
    for name, p in named.items():
        state = optimizer.state.get(p)
        if state:
            mu[name], nu[name] = state["exp_avg"], state["exp_avg_sq"]
            count = int(state["step"])
        else:
            mu[name] = nu[name] = torch.zeros_like(p)
    pack = _flatten_moment if flat else params_to_jax
    return {"0": {"count": np.asarray(count, np.int32), "mu": pack(mu), "nu": pack(nu)},
            "1": {}}


def _optimizer_state(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    nonfinite: dict[str, torch.Tensor] | None = None,
    flat: bool = False,
) -> dict[str, Any]:
    """The optimizer state in optax's layout, wrapped as ApplyIfFiniteState
    when ``nonfinite`` holds its counters."""
    inner = _moments(model, optimizer, flat)
    if nonfinite is None:
        return inner
    out = {k: np.asarray(nonfinite[k].cpu().numpy()) for k in NONFINITE_FIELDS}
    out["inner_state"] = inner
    return out


def save_checkpoint(
    path: str | Path,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    epoch: int,
    stats: NormStats,
    nonfinite: dict[str, torch.Tensor] | None = None,
    flat: bool = False,
) -> None:
    """Write the JAX package's checkpoint of ``model`` and ``optimizer``
    (``save_checkpoint`` of ``p_div_gnn_tpu/train/checkpoint.py:25-45``),
    through a ``.tmp`` file replaced atomically: a run killed while saving
    keeps its previous checkpoint. ``flat``: the optimizer state in
    ``optax.flatten(adam)``'s layout (``Trainer(flatten_optimizer=True)``)."""
    payload = {
        "model_state_dict": params_to_jax(model.state_dict()),
        "optimizer_state_dict": _optimizer_state(model, optimizer, nonfinite, flat),
        "epoch": int(epoch),
        "stats": stats.to_dict(),
    }
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(write_msgpack(payload))
    tmp.replace(path)


def _is_wrapped(sd: Any) -> bool:
    return isinstance(sd, dict) and {*NONFINITE_FIELDS, "inner_state"} <= set(sd)


def _unflatten_moment(vector: np.ndarray, named: dict[str, torch.Tensor],
                      key: str) -> dict[str, torch.Tensor]:
    sizes = {n: p.numel() for n, p in named.items()}
    if vector.shape != (sum(sizes.values()),):
        raise ValueError(f"checkpoint optimizer {key} does not match the model's parameters: "
                         f"a vector of {vector.shape}, the model has {sum(sizes.values())} "
                         "entries")
    out, at = {}, 0
    for n in flat_order(named):
        out[n] = torch.from_numpy(np.array(vector[at:at + sizes[n]], np.float32)).reshape(
            named[n].shape)
        at += sizes[n]
    return out


def _restore_adam(saved: Any, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  flat: bool = False) -> None:
    """Set torch Adam's state from optax's adam state (``optax.flatten``'s
    with ``flat``); ``ValueError`` when the saved state does not have the
    model's layout."""
    moment_type = np.ndarray if flat else dict
    layout = "optax.flatten(adam)'s" if flat else "optax adam's"
    if not (isinstance(saved, dict) and set(saved) == {"0", "1"} and saved["1"] == {}
            and isinstance(saved["0"], dict) and set(saved["0"]) == {"count", "mu", "nu"}
            and all(isinstance(saved["0"][k], moment_type) for k in ("mu", "nu"))):
        raise ValueError(f"checkpoint optimizer state is not {layout} layout "
                         f"({{'0': {{count, mu, nu}}, '1': {{}}}}): keys {sorted(saved)}")
    named = dict(model.named_parameters())
    moments = {}
    for key in ("mu", "nu"):
        if flat:
            moments[key] = _unflatten_moment(saved["0"][key], named, key)
            continue
        tree = params_from_jax(saved["0"][key])
        if set(tree) != set(named) or any(tree[n].shape != named[n].shape for n in named):
            raise ValueError(f"checkpoint optimizer {key} does not match the model's parameters")
        moments[key] = tree
    count = int(np.asarray(saved["0"]["count"]))
    for name, p in named.items():
        set_adam_state(optimizer, p, count, moments["mu"][name], moments["nu"][name])


def set_adam_state(
    optimizer: torch.optim.Optimizer,
    p: torch.Tensor,
    step: int,
    exp_avg: torch.Tensor,
    exp_avg_sq: torch.Tensor,
) -> None:
    """Give parameter ``p`` the Adam state torch would hold after ``step``
    steps: the step count as torch keeps it (an fp32 scalar, on the host
    unless the optimizer is capturable) and the two moments on ``p``'s
    device."""
    capturable = bool(optimizer.defaults.get("capturable", False))
    optimizer.state[p] = {
        "step": torch.tensor(float(step), dtype=torch.float32,
                             device=p.device if capturable else "cpu"),
        "exp_avg": exp_avg.to(p.device, torch.float32).clone(),
        "exp_avg_sq": exp_avg_sq.to(p.device, torch.float32).clone(),
    }


def load_checkpoint(
    path: str | Path,
    model: torch.nn.Module | None = None,
    optimizer: torch.optim.Optimizer | None = None,
    nonfinite: dict[str, torch.Tensor] | None = None,
    flat: bool = False,
) -> tuple[dict[str, torch.Tensor], int, NormStats]:
    """Returns (state_dict for EncodeProcessDecode, epoch, stats).

    With ``optimizer`` (and the ``model`` it steps) the optimizer state is
    restored into it too, and with ``nonfinite`` (a trainer's
    ApplyIfFiniteState counters) the counters. As in the JAX package, a
    checkpoint written with the other ``skip_nonfinite_updates`` setting
    (the wrapper present on one side only) restores nothing of the
    optimizer, with a warning: the run resumes with fresh Adam moments. Any
    other mismatch raises ``ValueError``: an optimizer state in
    ``optax.flatten(adam)``'s layout restores only with ``flat`` (a trainer
    with ``flatten_optimizer``), and the per-parameter layout only without."""
    payload = read_msgpack(Path(path).read_bytes())
    state_dict = params_from_jax(payload["model_state_dict"])
    if optimizer is not None:
        if model is None:
            raise ValueError("restoring the optimizer needs the model it steps")
        saved = payload["optimizer_state_dict"]
        if _is_wrapped(saved) != (nonfinite is not None):
            print(
                "WARNING: checkpoint optimizer state was saved with the opposite "
                "skip_nonfinite_updates setting; restoring params only with a FRESH "
                "optimizer state (Adam moments reset — expect a brief loss bump "
                "after resume)."
            )
        else:
            _restore_adam(saved["inner_state"] if nonfinite is not None else saved,
                          model, optimizer, flat)
            if nonfinite is not None:
                for k in NONFINITE_FIELDS:
                    nonfinite[k].copy_(torch.as_tensor(np.asarray(saved[k])))
    return state_dict, int(payload["epoch"]), NormStats.from_dict(payload["stats"])
