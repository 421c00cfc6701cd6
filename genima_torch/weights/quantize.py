"""Post-training int8 weights for the diffusion transformer blocks.

Counterpart of ``genima_tpu/weights/quantize.py``: every targeted linear of
a UNet or ControlNet (``_TARGET_NAMES``: the attention projections, GEGLU's
``proj``, the feed-forward output and the transformers' ``proj_in`` /
``proj_out`` where they are linears) becomes a ``W8Linear`` holding ``kernel_q`` (int8), ``scale``
(f32 per output column) and its bias. The VAE and the text encoder pass
through, and so do the 1x1-conv ``proj_in`` / ``proj_out`` of a UNet built
without ``use_linear_projection`` (the reference quantizes 2-D kernels
only). Use with a ``<attn>+w8`` backend. Unlike the JAX version, which
returns a new tree, the modules are changed in place.
"""

from __future__ import annotations

import torch
from torch import nn

from genima_torch.kernels.w8_matmul import quantize_weight
from genima_torch.nn.layers import Attention, W8Linear, split_backend

# the linears' attribute paths end in one of these ("to_out.0" is the JAX
# tree's "to_out_0", "net.2" its "net_2")
_TARGET_NAMES = frozenset(
    {"to_q", "to_k", "to_v", "to_out.0", "proj", "net.2", "proj_in", "proj_out"}
)


def _targets(module: nn.Module, cls: type):
    """(parent, attribute, child) for every targeted ``cls`` child."""
    for name, child in list(module.named_modules()):
        if not isinstance(child, cls):
            continue
        parent_name, _, attr = name.rpartition(".")
        idx = parent_name.rpartition(".")[2]
        key = f"{idx}.{attr}" if attr.isdigit() else attr
        if key in _TARGET_NAMES:
            yield module.get_submodule(parent_name), attr, child


def _set_w8(module: nn.Module, w8: bool) -> None:
    for m in module.modules():
        if isinstance(m, Attention):
            attn, _ = split_backend(m.backend)
            m.backend = attn + ("+w8" if w8 else "")


@torch.no_grad()
def quantize_dense_tree(module: nn.Module) -> nn.Module:
    """Quantize every targeted ``nn.Linear`` of ``module`` (a UNet or a
    ControlNet) to a ``W8Linear``, in place; its attentions' backends get
    ``+w8``. Returns ``module``."""
    for parent, attr, lin in _targets(module, nn.Linear):
        with torch.device("meta"):  # every tensor is assigned below
            q = W8Linear(lin.in_features, lin.out_features, bias=lin.bias is not None)
        q.kernel_q, q.scale = quantize_weight(lin.weight)
        if lin.bias is not None:
            q.bias = nn.Parameter(lin.bias.detach().clone(), requires_grad=False)
        setattr(parent, attr, q)
    _set_w8(module, True)
    return module


@torch.no_grad()
def dequantize_dense_tree(module: nn.Module) -> nn.Module:
    """The reverse: each ``W8Linear`` becomes an ``nn.Linear`` whose weight is
    ``kernel_q * scale`` in the bias's (the module's) dtype, in place; the
    attentions' backends lose ``+w8``. Returns ``module``."""
    dtype = next((t.dtype for t in module.parameters() if t.is_floating_point()), torch.float32)
    for parent, attr, q in _targets(module, W8Linear):
        lin = nn.Linear(q.kernel_q.shape[1], q.kernel_q.shape[0], bias=q.bias is not None,
                        device=q.kernel_q.device, dtype=dtype)
        lin.weight.copy_(q.kernel_q.float() * q.scale[:, None])
        if q.bias is not None:
            lin.bias.copy_(q.bias)
        setattr(parent, attr, lin.requires_grad_(False))
    _set_w8(module, False)
    return module


def quantize_pipeline_params(params: dict) -> dict:
    """Quantize the UNet and the ControlNet of a pipeline's module dict in
    place; the VAE, the text encoder and anything else pass through."""
    for key in ("unet", "controlnet"):
        if key in params:
            quantize_dense_tree(params[key])
    return params
