"""Metric logging to an append-friendly ``metrics.jsonl``.

Counterpart of ``genima_tpu/core/logging.py::MetricLogger`` with its JSONL
backend only: the eval config keeps W&B and TensorBoard off (the eval CLI
refuses ``wandb.use``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np


def _to_scalar(v: Any) -> Any:
    if hasattr(v, "item") and np.ndim(v) == 0:
        return v.item()
    return v


class MetricLogger:
    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def log_metrics(self, metrics: dict, step: int, prefix: str | None = None,
                    echo: bool = True) -> None:
        scalars = {}
        for k, v in metrics.items():
            v = _to_scalar(v)
            if isinstance(v, (int, float, bool, str)):
                scalars[f"{prefix}/{k}" if prefix else k] = v
        record = {"step": int(step), "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if echo:
            parts = " | ".join(
                f"{k}: {v:.5g}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in scalars.items()
            )
            print(f"[step {step}] {parts}")

    def close(self) -> None:
        self._jsonl.close()
