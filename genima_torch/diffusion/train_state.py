"""The trainer's state as the reference's checkpoint trees, both ways.

A ``checkpoint-<step>/`` directory holds ``<model>/params.msgpack`` (the
trained model's flax params tree, f32) and ``train_state.msgpack``:
``{"opt_state": ..., "step": int32}``, where ``opt_state`` is what
``flax.serialization.to_state_dict`` makes of the JAX trainer's optax state:

* ``chain(clip_by_global_norm, adamw(schedule))``:
  ``{"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {}, "2": {"count"}}}``
  (the clip's ``EmptyState``, ``ScaleByAdamState``, the decay's
  ``EmptyState``, ``ScaleByScheduleState``);
* with the 8-bit AdamW: ``{"0": {}, "1": {"count", "mu", "nu"}}``, each
  moment a ``{"q", "scale", "full"}`` map (the absent ones nil);
* under accumulation, ``MultiStepsState``: ``{"mini_step",
  "gradient_step", "inner_opt_state", "acc_grads", "skip_state": {}}``.

Scalars are 0-d int32 arrays. ``mu``, ``nu`` and ``acc_grads`` are keyed and
laid out like the params tree (conv kernels HWIO, dense kernels (I, O)),
by ``weights/to_jax.py``'s naming rules. Trees built here hold views of the
trainer's tensors (``AsyncCheckpointer.submit`` copies them); trees read
back must have exactly the expected leaves, or loading raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from genima_torch.core.optim import Adam8bitState, AdamWState, Moment, MultiStepsState
from genima_torch.weights.to_jax import layout_perm, nest, params_tree

Paths = Mapping[str, tuple[str, ...]]  # parameter name -> flax path


def _i32(x: int) -> np.ndarray:
    return np.asarray(x, np.int32)


def layout_perms(params: Mapping[str, torch.Tensor], paths: Paths) -> dict[str, tuple]:
    """Parameter name -> permutation into the reference's layout, for the
    tensors whose layouts differ (the 8-bit AdamW's ``perms``)."""
    out = {}
    for k, t in params.items():
        perm = layout_perm(paths[k][-1], t.ndim)
        if perm is not None:
            out[k] = perm
    return out


def _leaves(tree: Mapping, stop=lambda node: False, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        path = (*prefix, str(k))
        if isinstance(v, Mapping) and not stop(v):
            out.update(_leaves(v, stop, path))
        else:
            out[path] = v
    return out


def _is_moment(node: Mapping) -> bool:
    return set(node) == {"q", "scale", "full"}


def _match(tree: Mapping, paths: Paths, what: str, stop=lambda node: False) -> dict:
    """name -> leaf of a params-shaped tree, which must hold exactly the
    expected paths."""
    leaves = _leaves(tree, stop)
    want = {p: k for k, p in paths.items()}
    if set(leaves) != set(want):
        missing = sorted("/".join(p) for p in set(want) - set(leaves))[:4]
        extra = sorted("/".join(p) for p in set(leaves) - set(want))[:4]
        raise KeyError(f"{what}: missing {missing}, unexpected {extra}")
    return {want[p]: leaf for p, leaf in leaves.items()}


def _tensor(x: Any, like: torch.Tensor, perm=None) -> torch.Tensor:
    """A leaf read from a file -> ``like``'s device and dtype, back in the
    port's layout when ``perm`` says the file holds it permuted."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    if perm is not None:
        t = t.permute(tuple(np.argsort(perm))).contiguous()
    if t.shape != like.shape:
        raise ValueError(f"leaf of shape {tuple(t.shape)} where {tuple(like.shape)} is expected")
    return t.to(like.device, like.dtype)


def params_from_tree(tree: Mapping, paths: Paths, like: Mapping[str, torch.Tensor],
                     what: str = "params") -> dict[str, torch.Tensor]:
    """Tensors shaped, placed and typed like ``like`` from a params-shaped
    flax tree."""
    leaves = _match(tree, paths, what)
    return {k: _tensor(leaves[k], t, layout_perm(paths[k][-1], t.ndim)) for k, t in like.items()}


def _moments_tree(moments: Mapping[str, Moment], paths: Paths) -> dict:
    return nest({paths[k]: {"q": m.q, "scale": m.scale, "full": m.full}
                 for k, m in moments.items()})


def _moments_from_tree(tree: Mapping, paths: Paths, like: Mapping[str, Moment],
                       what: str) -> dict[str, Moment]:
    leaves = _match(tree, paths, what, stop=_is_moment)
    out = {}
    for k, m in like.items():
        node = leaves[k]
        if not isinstance(node, Mapping) or not _is_moment(node):
            raise KeyError(f"{what}: {'/'.join(paths[k])} is not a quantized moment")
        fields = []
        for name, ref in zip(Moment._fields, m):
            if (node[name] is None) != (ref is None):
                raise ValueError(f"{what}: {'/'.join(paths[k])}.{name} is "
                                 f"{'absent' if node[name] is None else 'present'} "
                                 "against this optimizer's quantisation")
            fields.append(None if ref is None else _tensor(node[name], ref))
        out[k] = Moment(*fields)
    return out


def opt_state_tree(state, paths: Paths) -> dict:
    """The reference's optax state tree of an optimizer state (views)."""
    if isinstance(state, MultiStepsState):
        return {
            "mini_step": _i32(state.mini_step),
            "gradient_step": _i32(state.gradient_step),
            "inner_opt_state": opt_state_tree(state.inner_opt_state, paths),
            "acc_grads": params_tree(state.acc_grads, paths),
            "skip_state": {},
        }
    if isinstance(state, Adam8bitState):
        return {"0": {}, "1": {"count": _i32(state.count),
                               "mu": _moments_tree(state.mu, paths),
                               "nu": _moments_tree(state.nu, paths)}}
    if isinstance(state, AdamWState):
        adam = {"count": _i32(state.count), "mu": params_tree(state.mu, paths),
                "nu": params_tree(state.nu, paths)}
        return {"0": {}, "1": {"0": adam, "1": {}, "2": {"count": _i32(state.count)}}}
    raise TypeError(f"unknown optimizer state {type(state).__name__}")


def opt_state_from_tree(tree: Mapping, like, paths: Paths):
    """An optimizer state of ``like``'s kind, devices and dtypes from the
    reference's tree."""
    if isinstance(like, MultiStepsState):
        return MultiStepsState(
            mini_step=int(np.asarray(tree["mini_step"])),
            gradient_step=int(np.asarray(tree["gradient_step"])),
            inner_opt_state=opt_state_from_tree(tree["inner_opt_state"],
                                                like.inner_opt_state, paths),
            acc_grads=params_from_tree(tree["acc_grads"], paths, like.acc_grads, "acc_grads"),
        )
    if isinstance(like, Adam8bitState):
        adam = tree["1"]
        return Adam8bitState(
            count=int(np.asarray(adam["count"])),
            mu=_moments_from_tree(adam["mu"], paths, like.mu, "mu"),
            nu=_moments_from_tree(adam["nu"], paths, like.nu, "nu"),
        )
    if isinstance(like, AdamWState):
        adam = tree["1"]["0"]
        return AdamWState(
            count=int(np.asarray(adam["count"])),
            mu=params_from_tree(adam["mu"], paths, like.mu, "mu"),
            nu=params_from_tree(adam["nu"], paths, like.nu, "nu"),
        )
    raise TypeError(f"unknown optimizer state {type(like).__name__}")
