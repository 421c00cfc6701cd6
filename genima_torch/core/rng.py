"""Seeding.

Counterpart of ``genima_tpu/core/rng.py::seed_everything``. The reference
seeds python, numpy and torch globally; the port does the same and hands
back a ``torch.Generator`` for the draws that follow, which are passed
explicitly (the JAX package threads keys instead, so the two packages give
different numbers from one seed).
"""

from __future__ import annotations

import random
import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed python, numpy and torch (every device); return a CPU generator
    seeded the same."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
