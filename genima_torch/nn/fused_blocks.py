"""The VAE decoder's resnet blocks and output conv through the fused
GN-SiLU-conv3x3 kernel (``kernels/fused_conv.py``).

Counterpart of ``genima_tpu/nn/fused_blocks.py``. These are forwards over
the existing modules' parameters (``nn.layers.ResnetBlock2D``, the
decoder's ``conv_norm_out`` / ``conv_out``), so the state dict is the same
under both conv backends. They take and return NHWC tensors: the fused
decoder keeps its activations channels-last from the mid block's output to
conv_out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genima_torch.kernels.fused_conv import fold_group_norm, fused_conv3x3
from genima_torch.nn.layers import ResnetBlock2D


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    """The conv's OIHW weight in the kernel's HWIO layout."""
    return conv.weight.permute(2, 3, 1, 0)


def fused_gn_silu_conv(x: torch.Tensor, norm: nn.GroupNorm, conv: nn.Conv2d, residual=None):
    """norm -> SiLU -> conv3x3 (+ residual) on NHWC x, one kernel call."""
    scale, shift = fold_group_norm(x, norm.weight, norm.bias, norm.num_groups, norm.eps)
    return fused_conv3x3(x, _hwio(conv), conv.bias, scale, shift, residual=residual)


def fused_resnet_block(block: ResnetBlock2D, x: torch.Tensor) -> torch.Tensor:
    """A VAE ``ResnetBlock2D`` (no time embedding) as two kernel calls. The
    channel-change shortcut applies to the block's input, not the second
    conv's, so it is computed here and rides in as the residual."""
    if hasattr(block, "conv_shortcut"):
        sc = block.conv_shortcut
        shortcut = F.linear(x, sc.weight[:, :, 0, 0], sc.bias)
    else:
        shortcut = x
    h = fused_gn_silu_conv(x, block.norm1, block.conv1)
    return fused_gn_silu_conv(h, block.norm2, block.conv2, residual=shortcut)
