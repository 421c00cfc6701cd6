"""Metric logging: stdout, an append-friendly ``metrics.jsonl``, and
TensorBoard or W&B where the package is there.

Counterpart of ``genima_tpu/core/logging.py``'s ``MetricLogger``.
A backend whose package does not import is dropped, as the JAX package
drops it, but with one printed line naming it; ``metrics.jsonl`` is always
written. Images go to TensorBoard / W&B only (callers keep PNGs on disk).
With ``main_process_only`` (the default) a rank other than 0 keeps a
logger that writes and prints nothing, so call sites stay unconditional.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np

from genima_torch.core.distributed import is_main_process


def _to_scalar(v: Any) -> Any:
    if hasattr(v, "item") and np.ndim(v) == 0:
        return v.item()
    return v


class MetricLogger:
    def __init__(self, log_dir: str | Path, use_tb: bool = False, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None, main_process_only: bool = True):
        self.log_dir = Path(log_dir)
        self._tb = None
        self._wandb = None
        self._active = not main_process_only or is_main_process()
        if not self._active:
            self._jsonl = None
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"MetricLogger: TensorBoard off ({e}); metrics.jsonl only")
            else:
                self._tb = SummaryWriter(log_dir=str(self.log_dir / "tb"))
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                print(f"MetricLogger: wandb off ({e}); metrics.jsonl only")
            else:
                self._wandb = wandb
                wandb.init(dir=str(self.log_dir), **(wandb_kwargs or {}))

    def log_metrics(self, metrics: dict, step: int, prefix: str | None = None,
                    echo: bool = True) -> None:
        if not self._active:
            return
        scalars = {}
        for k, v in metrics.items():
            v = _to_scalar(v)
            if isinstance(v, (int, float, bool, str)):
                scalars[f"{prefix}/{k}" if prefix else k] = v
        record = {"step": int(step), "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if echo:
            parts = " | ".join(
                f"{k}: {v:.5g}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in scalars.items()
            )
            print(f"[step {step}] {parts}")

    def log_images(self, images: dict, step: int, prefix: str | None = None) -> None:
        """HWC uint8 images to TensorBoard / W&B."""
        if self._tb is not None:
            for k, v in images.items():
                self._tb.add_image(f"{prefix}/{k}" if prefix else k, np.asarray(v), step,
                                   dataformats="HWC")
        if self._wandb is not None:
            self._wandb.log({(f"{prefix}/{k}" if prefix else k): self._wandb.Image(np.asarray(v))
                             for k, v in images.items()}, step=step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()

