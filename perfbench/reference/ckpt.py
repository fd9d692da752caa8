"""A reader of the JAX package's msgpack checkpoints, frozen: a copy of
the decoder of the port's ``train/checkpoint.py`` (the msgpack subset flax
writes, arrays as extension type 1, numpy scalars as type 3), so the
reference reads the served weights without the program and without the
``msgpack`` package.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


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


def read_checkpoint(path: str | Path) -> tuple[dict[str, np.ndarray], dict[str, float]]:
    """({parameter name: fp32 array}, {statistic: value}) of a checkpoint;
    names are the flax paths joined by dots, as the port names them."""
    tree = read_msgpack(Path(path).read_bytes())
    params: dict[str, np.ndarray] = {}

    def walk(node: dict[str, Any], prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
            else:
                params[f"{prefix}{key}"] = np.array(value, dtype=np.float32)

    walk(tree["model_state_dict"]["params"], "")
    return params, {k: float(v) for k, v in tree["stats"].items()}
