"""Tensor-parallel placement of the diffusion weights over a mesh's
``fsdp`` devices.

Counterpart of ``genima_tpu/core/tp.py``. JAX annotates each leaf and lets
GSPMD place the collectives; the port applies the same rule itself:

* conv kernels (kh, kw, in, out) and dense kernels (in, out): ``out`` split;
* biases / norm scales (out,): split where divisible;
* embeddings and everything else: replicated;

and a leaf whose axis does not divide stays replicated.
``tp_param_shardings`` gives that rule leaf by leaf on a reference-layout
tree. ``shard_params_tp`` applies it to modules: each ``nn.Linear``,
``nn.Conv2d`` (ungrouped) and ``W8Linear`` (int8 columns with their scales)
whose output features divide becomes a ``ColumnSharded`` layer, one column
block on each fsdp device, its outputs gathered on the row's first device,
as GSPMD's all-gather does. Bias and norm tensors stay with their layers,
so every module downstream (the attention kernels included) sees whole
tensors.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

import torch
from torch import nn

from genima_torch.core.mesh import FSDP_AXIS, Mesh, place_module
from genima_torch.nn.layers import W8Linear


def _leaf_spec(name: str, shape: tuple, size: int, axis: str) -> tuple:
    if size <= 1 or name == "embedding" or "position_embedding" in name:
        return ()
    if name == "kernel" and len(shape) >= 2 and shape[-1] % size == 0:
        return (None,) * (len(shape) - 1) + (axis,)
    if name in ("bias", "scale") and len(shape) == 1 and shape[0] % size == 0:
        return (axis,)
    return ()


def tp_param_shardings(params: Mapping, mesh: Mesh | int, axis: str = FSDP_AXIS) -> dict:
    """A tree mirroring ``params`` (a reference-layout tree: dicts of
    arrays) whose leaves are partition specs: () replicated, else one entry
    per axis naming ``axis`` where that axis is split."""
    size = mesh if isinstance(mesh, int) else mesh.shape[axis]

    def walk(node, name):
        if isinstance(node, Mapping):
            return {k: walk(v, str(k)) for k, v in node.items()}
        return _leaf_spec(name, tuple(node.shape), size, axis)

    return walk(params, "")


class ColumnSharded(nn.Module):
    """A linear or conv layer split by output features: shard ``i`` lives on
    ``devices[i]``; the input goes to each, the outputs come back to
    ``home`` and are concatenated along the feature axis (``dim``).
    ``weight`` and ``bias`` give the whole tensors on ``home`` (for code
    that reads a layer's weights, and its dtype, directly)."""

    def __init__(self, shards: list[nn.Module], devices: list[torch.device], dim: int,
                 home: torch.device):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.devices = list(devices)
        self.dim = dim
        self.home = home

    def _gather(self, name: str):
        parts = [getattr(s, name) for s in self.shards]
        if parts[0] is None:
            return None
        return torch.cat([p.to(self.home) for p in parts])

    @property
    def weight(self) -> torch.Tensor:
        return self._gather("weight")

    @property
    def bias(self):
        return self._gather("bias")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [shard(x.to(dev, non_blocking=True)).to(self.home, non_blocking=True)
                for shard, dev in zip(self.shards, self.devices)]
        return torch.cat(outs, dim=self.dim)


def _slices(t, n: int, devices):
    if t is None:
        return [None] * n
    step = t.shape[0] // n
    return [t[i * step:(i + 1) * step].to(d) for i, d in enumerate(devices)]


def _shard_layer(layer: nn.Module, devices: list[torch.device], home: torch.device):
    """``layer`` as a ``ColumnSharded`` over ``devices``, or None where the
    rule keeps it whole."""
    n = len(devices)
    if isinstance(layer, W8Linear):
        out = layer.kernel_q.shape[0]
        if out % n:
            return None
        shards = []
        for q, s, b in zip(_slices(layer.kernel_q, n, devices), _slices(layer.scale, n, devices),
                           _slices(layer.bias.detach() if layer.bias is not None else None,
                                   n, devices)):
            shard = W8Linear(q.shape[1], q.shape[0], bias=b is not None).to(q.device)
            shard.kernel_q, shard.scale = q, s
            if b is not None:
                shard.bias = nn.Parameter(b, requires_grad=False)
            shards.append(shard)
        return ColumnSharded(shards, devices, -1, home)
    if isinstance(layer, nn.Linear):
        if layer.out_features % n:
            return None
        shards = []
        for w, b in zip(_slices(layer.weight.detach(), n, devices),
                        _slices(None if layer.bias is None else layer.bias.detach(), n, devices)):
            shard = nn.Linear(w.shape[1], w.shape[0], bias=b is not None, device="meta")
            shard.weight = nn.Parameter(w, requires_grad=False)
            if b is not None:
                shard.bias = nn.Parameter(b, requires_grad=False)
            shards.append(shard)
        return ColumnSharded(shards, devices, -1, home)
    if isinstance(layer, nn.Conv2d):
        if layer.groups != 1 or layer.out_channels % n:
            return None
        shards = []
        for w, b in zip(_slices(layer.weight.detach(), n, devices),
                        _slices(None if layer.bias is None else layer.bias.detach(), n, devices)):
            shard = nn.Conv2d(layer.in_channels, w.shape[0], layer.kernel_size, layer.stride,
                              layer.padding, layer.dilation, bias=b is not None,
                              padding_mode=layer.padding_mode, device="meta")
            shard.weight = nn.Parameter(w, requires_grad=False)
            if b is not None:
                shard.bias = nn.Parameter(b, requires_grad=False)
            shards.append(shard)
        return ColumnSharded(shards, devices, 1, home)
    return None


def _shard_module(module: nn.Module, devices, home) -> nn.Module:
    # share every tensor with the original; only the module objects are new
    memo = {id(t): t for t in list(module.parameters()) + list(module.buffers())}
    out = copy.deepcopy(module, memo)
    for parent in list(out.modules()):
        for name, child in list(parent.named_children()):
            sharded = _shard_layer(child, devices, home)
            if sharded is not None:
                setattr(parent, name, sharded)
    return out


def shard_params_tp(params: Any, mesh: Mesh, row: int = 0) -> Any:
    """``params`` (a module or a dict of modules) with every linear and conv
    whose output features divide split over the fsdp devices of the mesh's
    local data row ``row``; whole-tensor layers, embeddings and norms stay
    on the row's first device. The originals are left as they are."""
    devices = mesh.row(row)
    home = devices[0]
    if isinstance(params, nn.Module):
        return _shard_module(place_module(params, home), devices, home)
    return {k: shard_params_tp(v, mesh, row) for k, v in params.items()}
