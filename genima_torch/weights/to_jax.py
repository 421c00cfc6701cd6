"""The port's modules as the reference's parameter trees: the inverse of
``from_jax.state_dict_from_jax``.

Counterpart of the export half of ``genima_tpu/weights/torch_port.py``
(``port_torch_state_dict`` onto a flax template): ``tree_from_module``
builds the flax tree (nested dicts of numpy arrays) a JAX model of the same
configuration holds, so a checkpoint written from a port module loads in
either package. Each state-dict key becomes a flax path by joining every
``name.<int>`` pair into ``name_<int>`` and naming the leaf after the
owning module (a linear or conv ``weight`` is a ``kernel``, a norm's a
``scale``, an embedding's an ``embedding``; BatchNorm statistics are
``mean`` / ``var``); the result is checked key by key against the forward
rule, so a name the rules cannot invert raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from genima_torch.nn.resnet import FrozenBatchNorm
from genima_torch.weights.from_jax import torch_name

_NORMS = (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm)


def _flax_leaf(owner: nn.Module, leaf: str) -> str:
    if leaf == "weight" and isinstance(owner, (nn.Linear, nn.Conv2d)):
        return "kernel"
    if leaf == "weight" and isinstance(owner, _NORMS):
        return "scale"
    if leaf == "weight" and isinstance(owner, nn.Embedding):
        return "embedding"
    return {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)


def _flax_tokens(module_path: list[str]) -> list[str]:
    out: list[str] = []
    for part in module_path:
        if part.isdigit() and out:
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return out


def layout_perm(leaf: str, ndim: int) -> tuple[int, ...] | None:
    """The permutation of a tensor's dims into the reference's layout: conv
    kernels OIHW -> HWIO, dense kernels (O, I) -> (I, O); None: as it is."""
    if leaf == "kernel" and ndim == 4:
        return (2, 3, 1, 0)
    if leaf == "kernel" and ndim == 2:
        return (1, 0)
    return None


def flax_layout(t: torch.Tensor, leaf: str) -> torch.Tensor:
    """``t`` in the reference's layout: a view, no copy."""
    perm = layout_perm(leaf, t.ndim)
    return t.detach() if perm is None else t.detach().permute(perm)


def _flax_array(t: torch.Tensor, leaf: str) -> np.ndarray:
    x = t.detach().cpu()
    return np.ascontiguousarray(flax_layout(x.float() if x.is_floating_point() else x, leaf).numpy())


def _hf_clip_tokens(module_path: list[str]) -> list[str]:
    """The CLIP text tower's HF module path as flax tokens: JAX keeps the
    embeddings, layers and final norm at the top level and joins ``mlp.fc1``
    into ``mlp_fc1``."""
    parts = [p for p in module_path if p not in ("text_model", "embeddings", "encoder")]
    if parts[:1] == ["position_embedding"]:
        return []  # a raw flax param, the leaf itself
    if len(parts) >= 2 and parts[-2] == "mlp":
        parts = [*parts[:-2], f"mlp_{parts[-1]}"]
    return _flax_tokens(parts)


def _vae_tokens(module_path: list[str]) -> list[str]:
    """The VAE's diffusers module path as flax tokens: JAX names a down or up
    block's resnets ``down_blocks_<i>_resnets_<j>`` and its resampling conv
    ``down_blocks_<i>_downsample`` (``up_blocks_<i>_upsample``)."""
    tokens = _flax_tokens(module_path)
    out: list[str] = []
    i = 0
    while i < len(tokens):
        t = tokens[i]
        nxt = tokens[i + 1] if i + 1 < len(tokens) else ""
        if re.match(r"^(down|up)_blocks_\d+$", t) and nxt.startswith("resnets_"):
            out.append(f"{t}_{nxt}")
            i += 2
        elif (re.match(r"^(down|up)_blocks_\d+$", t) and nxt in ("downsamplers_0", "upsamplers_0")
              and tokens[i + 2:i + 3] == ["conv"]):
            out.append(f"{t}_{nxt[:-len('rs_0')]}")
            i += 3
        else:
            out.append(t)
            i += 1
    return out


def flax_paths(module: nn.Module, family: str) -> dict[str, tuple[str, ...]]:
    """State-dict key -> the flax path a JAX model of the same configuration
    keeps that tensor under."""
    paths = {}
    for key in module.state_dict():
        *mod_path, leaf = key.split(".")
        owner = module.get_submodule(".".join(mod_path)) if mod_path else module
        if family == "hf_clip" and mod_path[-1:] == ["position_embedding"]:
            path = ("position_embedding",)
        elif family == "hf_clip":
            path = (*_hf_clip_tokens(mod_path), _flax_leaf(owner, leaf))
        elif family == "diffusers_vae":
            path = (*_vae_tokens(mod_path), _flax_leaf(owner, leaf))
        else:
            path = (*_flax_tokens(mod_path), _flax_leaf(owner, leaf))
        if torch_name(path, family) != key:
            raise KeyError(f"no flax path maps to {key!r} under family {family!r}")
        paths[key] = path
    return paths


def nest(leaves: dict[tuple[str, ...], object]) -> dict:
    """A nested dict tree from (path -> leaf)."""
    tree: dict = {}
    for path, leaf in leaves.items():
        node = tree
        for token in path[:-1]:
            node = node.setdefault(token, {})
        if path[-1] in node:
            raise KeyError(f"two leaves map to flax path {'/'.join(path)}")
        node[path[-1]] = leaf
    return tree


def params_tree(tensors: dict[str, torch.Tensor], paths: dict[str, tuple[str, ...]]) -> dict:
    """A params-shaped flax tree of views of ``tensors`` (name -> tensor),
    each under its flax path (``paths``, name -> path)."""
    return nest({paths[k]: flax_layout(t, paths[k][-1]) for k, t in tensors.items()})


def tree_from_module(module: nn.Module, family: str) -> dict:
    """The flax params tree of ``module`` (float leaves in f32)."""
    sd = module.state_dict()
    return nest({path: _flax_array(sd[k], path[-1])
                 for k, path in flax_paths(module, family).items()})
