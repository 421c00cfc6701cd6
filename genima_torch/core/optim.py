"""Global-norm clipping, AdamW (f32, bf16 first moment or 8-bit moments) and
gradient accumulation, with optax's semantics.

Counterpart of the optimizer the ControlNet trainer builds
(``genima_tpu/diffusion/training.py:191-212``)::

    tx = optax.chain(optax.clip_by_global_norm(max_norm), adam)
    if k > 1: tx = optax.MultiSteps(tx, k)

where ``adam`` is ``optax.adamw(schedule, b1, b2, eps, weight_decay,
mu_dtype=bf16 if adam_mu_bf16)`` or ``genima_tpu/core/optim.py::adamw_8bit``.

* ``Clipped`` scales every gradient by ``max_norm / norm`` when the global
  norm reaches ``max_norm`` (no epsilon added to the norm), as optax does.
* ``AdamW`` keeps f32 moments (or a bf16 first moment: optax computes
  ``b1 * mu`` in bf16, with ``b1`` rounded to bf16, then adds the f32
  ``(1 - b1) g``), adds eps outside the square root, bias-corrects both
  moments, decays every parameter (decoupled, no mask) and takes the
  learning rate of step ``count`` before counting it.
* ``AdamW8bit`` stores both moments as int8 per block of ``BLOCK`` (256)
  with an f32 absmax/127 scale; the second moment on a sqrt scale (quantise
  ``sqrt(v)``, square on load); tensors under ``MIN_QUANTIZED`` (4096)
  elements keep f32 moments. Both sizes are fixed: the checkpoint layout the
  JAX package reads depends on them. Its
  learning rate is that of step ``count + 1``, as the JAX package's is. The
  blocks run over each tensor flattened in the reference's layout (conv
  kernels HWIO, dense kernels (I, O)), so the codes are the reference's:
  ``perms`` maps a parameter name to the permutation from the port's layout.
* ``MultiSteps`` averages ``k`` mini-step gradients with optax's running
  mean ``acc + (g - acc) / (n + 1)`` and runs the wrapped update on the mean
  every k-th mini-step; the parameters stay as they are in between.

``MultiTransform`` is the ACT controller's chain
(``genima_tpu/control/policy.py``): an optional clip over every gradient,
then an ``AdamW`` per labelled parameter group; the ``frozen`` group stays.

``Clipped.step_`` and ``MultiSteps.step_`` return the new state and the
global norm of the gradients they were given (the clip's own norm, so a
train step computes it once).

Parameters, gradients and moments are dicts of tensors keyed by parameter
name. Updates work in place on the parameters and moments (the JAX package
builds new arrays) to hold one copy of each on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple, Optional, Union

import numpy as np
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


# -- AdamW ----------------------------------------------------------------------


@dataclasses.dataclass
class AdamWState:
    count: int  # updates taken so far
    mu: dict[str, torch.Tensor]  # f32, or bf16 under mu_dtype
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[int], float]  # schedule of the update count
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    mu_dtype: torch.dtype = torch.float32  # bf16: optax's mu_dtype=bfloat16

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=self.mu_dtype) for k, p in params.items()},
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
        if self.mu_dtype == torch.float32:
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
            m = mu
        else:  # b1 mu rounded to the moment's dtype, the sum in f32
            b1 = float(torch.tensor(self.b1, dtype=self.mu_dtype))
            m = torch._foreach_mul(g, 1.0 - self.b1)
            torch._foreach_add_(m, [t.float() for t in torch._foreach_mul(mu, b1)])
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        # u = mu_hat / (sqrt(nu_hat) + eps) + wd * p;  p += -lr * u
        denom = torch._foreach_div(nu, 1.0 - self.b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(m, 1.0 - self.b1**count)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(update, -float(self.learning_rate(state.count)))
        torch._foreach_add_(p, update)
        if m is not mu:
            for dst, src in zip(mu, m):
                dst.copy_(src)
        return AdamWState(count=count, mu=state.mu, nu=state.nu)


# -- 8-bit AdamW ------------------------------------------------------------------

BLOCK = 256  # elements per quantisation block
MIN_QUANTIZED = 4096  # smaller tensors keep f32 moments


class Moment(NamedTuple):
    """One moment of one tensor: int8 codes ``q`` (blocks, block) and f32
    scales (blocks,), or ``full`` f32; both in the reference's layout."""

    q: Optional[torch.Tensor]
    scale: Optional[torch.Tensor]
    full: Optional[torch.Tensor]


@dataclasses.dataclass
class Adam8bitState:
    count: int
    mu: dict[str, Moment]
    nu: dict[str, Moment]


@dataclasses.dataclass(frozen=True)
class AdamW8bit:
    learning_rate: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # parameter name -> permutation of its dims into the reference's layout
    perms: Mapping[str, tuple[int, ...]] = dataclasses.field(default_factory=dict)

    def _ref(self, name: str, t: torch.Tensor) -> torch.Tensor:
        perm = self.perms.get(name)
        return t if perm is None else t.permute(perm)

    def _store(self, x: torch.Tensor) -> Moment:
        if x.numel() < MIN_QUANTIZED:
            return Moment(None, None, x.contiguous())
        flat = x.reshape(-1)
        blocks = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
        blocks = blocks.reshape(-1, BLOCK)
        scale = blocks.abs().amax(dim=1) / 127.0
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
        return Moment(q, scale, None)

    @staticmethod
    def _load(m: Moment, shape: torch.Size) -> torch.Tensor:
        if m.full is not None:
            return m.full
        n = int(np.prod(shape))
        return (m.q.float() * m.scale[:, None]).reshape(-1)[:n].reshape(shape)

    def init(self, params: dict[str, torch.Tensor]) -> Adam8bitState:
        def zeros(k, p):
            return self._store(torch.zeros(self._ref(k, p).shape, device=p.device))

        return Adam8bitState(
            count=0,
            mu={k: zeros(k, p) for k, p in params.items()},
            nu={k: zeros(k, p) for k, p in params.items()},
        )

    @torch.no_grad()
    def step_(
        self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
        state: Adam8bitState,
    ) -> Adam8bitState:
        count = state.count + 1
        lr = float(np.float32(self.learning_rate(count)))
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        mu, nu = {}, {}
        for k, p in params.items():
            g, pr = self._ref(k, grads[k].float()), self._ref(k, p)
            m = self.b1 * self._load(state.mu[k], g.shape) + (1.0 - self.b1) * g
            r = self._load(state.nu[k], g.shape)
            v = self.b2 * (r if state.nu[k].full is not None else r * r) + (1.0 - self.b2) * g * g
            step = (m / c1) / (torch.sqrt(v / c2) + self.eps) + self.weight_decay * pr
            pr.add_(-lr * step)
            mu[k], nu[k] = self._store(m), self._store(v if v.numel() < MIN_QUANTIZED
                                                     else torch.sqrt(v))
        return Adam8bitState(count=count, mu=mu, nu=nu)


# -- the chain and accumulation ----------------------------------------------------

Inner = Union[AdamW, AdamW8bit]


@dataclasses.dataclass(frozen=True)
class Clipped:
    """``optax.chain(clip_by_global_norm(max_norm), inner)``; the clip has no
    state of its own."""

    inner: Inner
    max_norm: float

    def init(self, params):
        return self.inner.init(params)

    def step_(self, params, grads, state):
        """Clips ``grads`` in place, then updates ``params`` in place;
        returns the new state and the norm before the clip."""
        norm = clip_by_global_norm_(grads, self.max_norm)
        return self.inner.step_(params, grads, state), norm


@dataclasses.dataclass
class MultiStepsState:
    mini_step: int  # mini-steps accumulated since the last update
    gradient_step: int  # updates taken
    inner_opt_state: Union[AdamWState, Adam8bitState]
    acc_grads: dict[str, torch.Tensor]  # running mean of this update's gradients


@dataclasses.dataclass(frozen=True)
class MultiSteps:
    """``optax.MultiSteps(inner, every_k)`` with its default running mean."""

    inner: Clipped
    every_k: int

    def init(self, params) -> MultiStepsState:
        return MultiStepsState(0, 0, self.inner.init(params),
                               {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def step_(self, params, grads, state: MultiStepsState) -> tuple[MultiStepsState, torch.Tensor]:
        """Returns the new state and the norm of this mini-step's ``grads``."""
        norm = global_norm(grads)
        acc = [state.acc_grads[k] for k in params]
        delta = torch._foreach_sub([grads[k] for k in params], acc)
        torch._foreach_div_(delta, state.mini_step + 1)
        torch._foreach_add_(acc, delta)
        if state.mini_step < self.every_k - 1:
            return dataclasses.replace(state, mini_step=state.mini_step + 1), norm
        inner, _ = self.inner.step_(params, state.acc_grads, state.inner_opt_state)
        torch._foreach_zero_(acc)
        return MultiStepsState(0, state.gradient_step + 1, inner, state.acc_grads), norm


# -- the ACT controller's chain ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiTransform:
    """The ACT agent's ``optax.chain([clip_by_global_norm(max_norm)],
    multi_transform({group: adamw, ...}, labels))``: an optional clip over
    *all* gradients (the ``frozen`` group's too), then each labelled group
    through its own ``AdamW`` (own count and moments); a group without a
    transform (``frozen``) is optax's ``set_to_zero``: never moved."""

    transforms: Mapping[str, AdamW]
    labels: Mapping[str, str]  # parameter name -> group
    max_norm: Optional[float] = None

    def _group(self, tree: dict, group: str) -> dict:
        return {k: v for k, v in tree.items() if self.labels[k] == group}

    def init(self, params: dict[str, torch.Tensor]) -> dict[str, AdamWState]:
        return {g: tx.init(self._group(params, g)) for g, tx in self.transforms.items()}

    @torch.no_grad()
    def step_(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
              state: dict[str, AdamWState]) -> tuple[dict[str, AdamWState], Optional[torch.Tensor]]:
        """Clips ``grads`` in place (with ``max_norm``), then updates each
        group's ``params`` in place; returns the new state and the norm
        before the clip (None without one)."""
        norm = clip_by_global_norm_(grads, self.max_norm) if self.max_norm else None
        new = {g: tx.step_(self._group(params, g), self._group(grads, g), state[g])
               for g, tx in self.transforms.items()}
        return new, norm


def optimizer_state_bytes(state) -> int:
    """Bytes of every tensor an optimizer state holds."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, (dict, list, tuple)):
        values = state.values() if isinstance(state, dict) else state
        return sum(optimizer_state_bytes(v) for v in values)
    if dataclasses.is_dataclass(state):
        return sum(optimizer_state_bytes(getattr(state, f.name))
                   for f in dataclasses.fields(state))
    return 0
