"""Carry the JAX package's parameter trees across to the port's modules.

``state_dict_from_jax(tree, family)`` takes a flax params tree (nested dicts
of numpy arrays) and returns the port's state dict. It keeps its own copy of
the reference's naming rules (``genima_tpu/weights/torch_port.py``): each
flax path maps to a diffusers / HF-CLIP / torchvision name, conv kernels go
HWIO -> OIHW and dense kernels (I, O) -> (O, I). The ACT transformer uses a
plain path join (family ``"act"``), since the port's attribute names are the
flax module names. ``load_from_jax`` then loads strictly: a missing, extra
or misshapen tensor raises.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

# tokens whose trailing _<int> becomes .<int> in diffusers names
_DIFFUSERS_INDEXED = (
    "down_blocks", "up_blocks", "resnets", "attentions", "transformer_blocks",
    "downsamplers", "upsamplers", "to_out", "net", "controlnet_down_blocks",
    "blocks", "layers",
)
_IDX_RE = re.compile(r"^(.*)_(\d+)$")
_VAE_FLAT_RE = re.compile(r"^(down|up)_blocks_(\d+)_(resnets)_(\d+)$")
_VAE_SAMPLE_RE = re.compile(r"^(down|up)_blocks_(\d+)_(down|up)sample$")


def _diffusers_token(token: str) -> str:
    m = _IDX_RE.match(token)
    if m and m.group(1) in _DIFFUSERS_INDEXED:
        return f"{m.group(1)}.{m.group(2)}"
    return token


def _vae_token(token: str) -> str:
    m = _VAE_FLAT_RE.match(token)
    if m:
        return f"{m.group(1)}_blocks.{m.group(2)}.resnets.{m.group(4)}"
    m = _VAE_SAMPLE_RE.match(token)
    if m:
        return f"{m.group(1)}_blocks.{m.group(2)}.{m.group(3)}samplers.0.conv"
    return _diffusers_token(token)


def _hf_clip_token(token: str) -> str:
    token = {
        "token_embedding": "text_model.embeddings.token_embedding",
        "position_embedding": "text_model.embeddings.position_embedding",
        "final_layer_norm": "text_model.final_layer_norm",
        "mlp_fc1": "mlp.fc1",
        "mlp_fc2": "mlp.fc2",
    }.get(token, token)
    m = _IDX_RE.match(token)
    if m and m.group(1) == "layers":
        return f"text_model.encoder.layers.{m.group(2)}"
    return token


def _torchvision_token(token: str) -> str:
    m = re.match(r"^(layer\d)_(\d)$", token)
    if m:
        return f"{m.group(1)}.{m.group(2)}"
    m = re.match(r"^downsample_(\d)$", token)
    if m:
        return f"downsample.{m.group(1)}"
    return token


_TOKEN_FNS: dict[str, Callable[[str], str]] = {
    "diffusers_unet": _diffusers_token,
    "diffusers_controlnet": _diffusers_token,
    "diffusers_vae": _vae_token,
    "hf_clip": _hf_clip_token,
    "torchvision_resnet": _torchvision_token,
    "act": lambda token: token,
    "tiny_vae": lambda token: token,  # AutoencoderTiny keeps the flax names
}

# flax leaf -> torch suffix
_LEAF_TO_TORCH = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "embedding": "weight",
    "mean": "running_mean",
    "var": "running_var",
}


def torch_name(path: tuple[str, ...], family: str, w8: bool = False) -> str:
    """Torch state-dict key for a flax parameter path. ``w8``: the path's
    module is a ``W8Dense`` (``kernel_q``, ``scale``, ``bias``), whose leaf
    names the port's ``W8Linear`` keeps."""
    token_fn = _TOKEN_FNS[family]
    *mods, leaf = path
    parts = [token_fn(t) for t in mods]
    if leaf == "position_embedding":  # raw flax param; torch has .weight
        parts.append(token_fn(leaf))
        leaf_name = "weight"
    elif w8:
        leaf_name = leaf
    else:  # other raw params (query_embed ...) keep their name
        leaf_name = _LEAF_TO_TORCH.get(leaf, leaf)
    return ".".join([*parts, leaf_name])


def torch_array(arr: Any, leaf: str) -> np.ndarray | torch.Tensor:
    """Flax layout -> torch layout: conv HWIO -> OIHW, dense (I,O) -> (O,I),
    int8 ``kernel_q`` (K, N) -> (N, K). A bf16 leaf, which a checkpoint
    hands over as a torch tensor (numpy has no bf16), stays one."""
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    if leaf in ("kernel", "kernel_q"):
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1) if isinstance(arr, np.ndarray) else arr.permute(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
    return arr.contiguous() if isinstance(arr, torch.Tensor) else np.ascontiguousarray(arr)


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    """(path, leaf, whether the leaf's module is a W8Dense)."""
    w8 = "kernel_q" in tree
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value, w8


def state_dict_from_jax(tree: Mapping, family: str) -> dict[str, np.ndarray]:
    """Flax params tree -> the port's state dict (numpy arrays; torch
    tensors for bf16 leaves)."""
    out: dict[str, np.ndarray] = {}
    for path, leaf, w8 in _flatten(tree):
        name = torch_name(path, family, w8)
        if name in out:
            raise KeyError(f"two flax params map to {name!r}")
        out[name] = torch_array(leaf, path[-1])
    return out


def load_from_jax(module: nn.Module, tree: Mapping, family: str) -> nn.Module:
    """Load a flax params tree into ``module`` strictly, keeping the module's
    device and each tensor's dtype (float in the module's dtype, int8
    ``kernel_q`` and f32 ``scale`` as they are)."""
    ref = next(module.parameters())
    target = module.state_dict()
    sd = {
        k: _tensor(v).to(ref.device, target[k].dtype if k in target else ref.dtype)
        for k, v in state_dict_from_jax(tree, family).items()
    }
    module.load_state_dict(sd, strict=True)
    return module


def _tensor(v) -> torch.Tensor:
    """A CPU tensor over ``v``'s memory where numpy lets it be written (a
    checkpoint's buffer), else a copy (JAX's read-only host arrays)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(v) if v.flags.writeable else torch.tensor(v)


def drop_subtrees(tree: Mapping, names: tuple[str, ...], keep: bool = False) -> dict:
    """Top-level subtrees of ``tree`` without (or, ``keep=True``, only) those
    whose key equals a name in ``names`` or starts with one ending in '_'."""
    def hit(key: str) -> bool:
        return any(key == n or (n.endswith("_") and key.startswith(n)) for n in names)
    return {k: v for k, v in tree.items() if hit(str(k)) == keep}
