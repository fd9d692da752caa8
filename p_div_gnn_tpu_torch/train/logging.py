"""Run metrics: a JSONL stream always, TensorBoard when it imports.

The counterpart of ``p_div_gnn_tpu/train/logging.py:20-80``, writing the same
records to ``<log_dir>/metrics.jsonl``: ``{"tag", "value", "step", "time"}``
per scalar, ``{"tag", "text", "time"}`` per text and ``{"tag",
"histogram": {"min", "max", "mean", "count"}, "step", "time"}`` per
histogram. TensorBoard event files are written beside it when
``torch.utils.tensorboard`` imports (it needs the ``tensorboard`` package,
which a machine may lack); the JSONL stays the record.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np


class MetricsWriter:
    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=str(self.log_dir))
        except ImportError:
            self._tb = None

    def _write(self, rec: dict[str, Any]) -> None:
        rec["time"] = time.time()
        self._jsonl.write(json.dumps(rec) + "\n")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step)})
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_text(self, tag: str, text: str) -> None:
        self._write({"tag": tag, "text": text})
        if self._tb is not None:
            self._tb.add_text(tag, text)

    def add_histogram(self, tag: str, values: Any, step: int = 0) -> None:
        v = np.asarray(values, dtype=float)
        self._write({
            "tag": tag,
            "histogram": {
                "min": float(v.min()) if v.size else 0.0,
                "max": float(v.max()) if v.size else 0.0,
                "mean": float(v.mean()) if v.size else 0.0,
                "count": int(v.size),
            },
            "step": int(step),
        })
        if self._tb is not None:
            self._tb.add_histogram(tag, v, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()
