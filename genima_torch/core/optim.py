"""Global-norm gradient clipping and AdamW with optax's semantics.

Counterpart of ``optax.chain(optax.clip_by_global_norm(max_norm),
optax.adamw(schedule, b1, b2, eps, weight_decay))`` as the ControlNet
trainer builds it (``genima_tpu/diffusion/training.py:201-213``):

* the clip scales every gradient by ``max_norm / norm`` when the global norm
  reaches ``max_norm`` (no epsilon added to the norm), as optax does;
* AdamW keeps f32 moments, adds eps outside the square root, bias-corrects
  both moments, decays every parameter (decoupled, no mask) and takes the
  learning rate of step ``count`` before counting it (the first update uses
  ``schedule(0)``).

Parameters, gradients and moments are dicts of f32 tensors keyed by
parameter name. The update works in place on the parameters and moments
(the JAX package builds new arrays) to hold one copy of each on the card.
The reference's 8-bit Adam and bf16 first moment are a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def global_norm(tensors: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a 0-d f32 tensor."""
    norms = torch._foreach_norm([t.float() for t in tensors.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(
    grads: dict[str, torch.Tensor], max_norm: float
) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before clipping. Kept on the device: no host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    values = list(grads.values())
    # (g / norm) * max_norm where clipped, g / 1 * 1 (exactly g) where not
    torch._foreach_div_(values, torch.where(keep, one, norm))
    torch._foreach_mul_(values, torch.where(keep, one, one * max_norm))
    return norm


@dataclasses.dataclass
class AdamWState:
    count: int  # updates taken so far
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[int], float]  # schedule of the update count
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def step_(
        self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
        state: AdamWState,
    ) -> AdamWState:
        """One update of ``params`` (and the moments) in place."""
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        count = state.count + 1
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        # u = mu_hat / (sqrt(nu_hat) + eps) + wd * p;  p += -lr * u
        denom = torch._foreach_div(nu, 1.0 - self.b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, 1.0 - self.b1**count)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(update, -float(self.learning_rate(state.count)))
        torch._foreach_add_(p, update)
        return AdamWState(count=count, mu=state.mu, nu=state.nu)
