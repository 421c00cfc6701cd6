"""Build modules straight on their device, with seeded random weights.

Modules are constructed on the meta device (no host memory, no default
init), allocated on the target device, cast to the serving dtype and then
either filled from a ``torch.Generator`` (``init_random_``) or loaded from a
JAX tree (``weights.from_jax``). They come frozen; ``master_params`` makes
one trainable for a trainer.
"""

from __future__ import annotations

import itertools
from typing import Callable

import torch
from torch import nn


def build_module(factory: Callable[[], nn.Module], device: torch.device,
                 dtype: torch.dtype) -> nn.Module:
    """Construct ``factory()`` on ``device`` in ``dtype``, uninitialised."""
    with torch.device("meta"):
        module = factory()
    return module.to_empty(device=device).to(dtype).eval().requires_grad_(False)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Scaled-normal init: every tensor of rank >= 2 draws N(0, 1/fan_in),
    where fan_in is the product of its trailing dims (in * kh * kw for a
    conv, in for a linear); norm scales and variances are 1, biases and
    means 0. Unlike the reference's ``fast_init`` nothing is left at zero
    (ControlNet zero convs included), so every module shapes the output."""
    for name, t in itertools.chain(module.named_parameters(), module.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if t.ndim >= 2:
            t.normal_(0.0, t[0].numel() ** -0.5, generator=generator)
        elif leaf in ("weight", "running_var"):
            t.fill_(1.0)
        else:
            t.zero_()
    return module


@torch.no_grad()
def master_params(module: nn.Module) -> dict[str, torch.Tensor]:
    """Make ``module`` trainable and return f32 master copies of its
    parameters, keyed by name: the trainer updates these, and the module
    keeps its compute dtype as the working copy (the JAX package keeps f32
    params and computes in bf16, flax's ``param_dtype`` vs ``dtype``)."""
    module.requires_grad_(True)
    return {
        name: p.detach().to(torch.float32, copy=True)
        for name, p in module.named_parameters()
    }
