"""genima_torch: the PyTorch / CUDA port of genima_tpu for one NVIDIA H100.

The JAX package ``genima_tpu`` stays the reference; this package imports
nothing of it (nor JAX). It keeps the reference's public layouts (NHWC uint8
observations and targets, ``(B, num_queries, action_dim)`` actions) and uses
PyTorch's idiom inside: NCHW convolutions, ``nn.Module`` trees.

Every entry point takes ``device`` and defaults to ``"cuda"``; asking for
CUDA on a host without it raises instead of falling back to the CPU. On the
card the serving and eval paths compute in bf16, the trainers keep f32
master weights (the ACT trainer also computes in f32); on the CPU
everything is f32.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises where CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card (serving precision), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
