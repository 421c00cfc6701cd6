"""ResNet-18 image encoder of the ACT controller in PyTorch.

Counterpart of ``genima_tpu/nn/resnet.py``: torchvision attribute paths
(``conv1``, ``bn1``, ``layer1.0`` ...), DETR frozen BatchNorm, FiLM on the
CLIP language embedding after each stage, sine 2D position embeddings, and
the views laid side by side along the width.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine (DETR FrozenBatchNorm2d).

    The four tensors are parameters, as in the JAX package: in training they
    get gradients, which count in the global norm of an optional gradient
    clip, and the optimizer never moves them (its ``frozen`` group). Their
    state-dict names are torchvision's."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        inv = self.weight.float() / torch.sqrt(self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(features)
        if stride != 1 or in_ch != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, features, 1, stride, bias=False),
                FrozenBatchNorm(features),
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(y + residual)


class ResNet18(nn.Module):
    """torchvision resnet18 trunk (no avgpool/fc), optional FiLM.

    ``small_inputs``: 3x3 stride-1 stem without max-pool (8x downsample
    instead of 32x) for controllers trained on small views."""

    def __init__(self, width: int = 64, small_inputs: bool = False,
                 lang_dim: Optional[int] = None):
        super().__init__()
        w = width
        self.small_inputs = small_inputs
        if small_inputs:
            self.conv1 = nn.Conv2d(3, w, 3, 1, 1, bias=False)
        else:
            self.conv1 = nn.Conv2d(3, w, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(w)
        in_ch = w
        for stage, sw in enumerate([w, 2 * w, 4 * w, 8 * w]):
            stride = 1 if stage == 0 else 2
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock(in_ch, sw, stride), BasicBlock(sw, sw, 1)
            ))
            if lang_dim is not None:
                setattr(self, f"film{stage + 1}", nn.Linear(lang_dim, 2 * sw))
            in_ch = sw

    def forward(self, x, lang_emb: Optional[torch.Tensor] = None):
        x = F.relu(self.bn1(self.conv1(x)))
        if not self.small_inputs:
            x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            if lang_emb is not None:
                gamma, beta = getattr(self, f"film{stage}")(lang_emb).chunk(2, dim=-1)
                x = x * (1.0 + gamma[:, :, None, None]) + beta[:, :, None, None]
        return x


def sine_position_embedding_2d(
    h: int, w: int, num_pos_feats: int, temperature: float = 10000.0
) -> np.ndarray:
    """DETR PositionEmbeddingSine (normalize=True): (H, W, 2*num_pos_feats)."""
    scale = 2 * np.pi
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, axis=1)
    x_embed = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, axis=0)
    eps = 1e-6
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3)
    pos_x = pos_x.reshape(h, w, -1)
    pos_y = pos_y.reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)


class ImageEncoderACT(nn.Module):
    """Multi-view ResNet-18 -> (tokens, pos) for the DETR actor."""

    def __init__(self, hidden_dim: int = 256, use_lang_cond: bool = True,
                 width: int = 64, small_inputs: bool = False, lang_dim: int = 512):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.use_lang_cond = use_lang_cond
        self.backbone = ResNet18(
            width, small_inputs, lang_dim if use_lang_cond else None
        )
        self.input_proj = nn.Conv2d(8 * width, hidden_dim, 1)

    def forward(self, images: torch.Tensor, lang_emb: Optional[torch.Tensor] = None):
        """images: (B, V, 3, H, W) ImageNet-normalised; returns tokens
        (B, h*V*w, hidden) and pos (1, h*V*w, hidden)."""
        b, v = images.shape[:2]
        dtype = self.input_proj.weight.dtype
        x = images.reshape(b * v, *images.shape[2:]).to(dtype)
        lang = None
        if self.use_lang_cond and lang_emb is not None:
            lang = lang_emb.to(dtype).repeat_interleave(v, dim=0)
        feat = self.backbone(x, lang)  # (B*V, C, h, w), views run as one batch
        _, c, fh, fw = feat.shape
        # views side by side along the width: (B, C, h, V*w)
        feat = feat.reshape(b, v, c, fh, fw).permute(0, 2, 3, 1, 4).reshape(b, c, fh, v * fw)
        feat = self.input_proj(feat)
        pos = torch.from_numpy(
            sine_position_embedding_2d(fh, v * fw, self.hidden_dim // 2)
        ).to(device=feat.device, dtype=dtype)
        tokens = feat.permute(0, 2, 3, 1).reshape(b, fh * v * fw, self.hidden_dim)
        return tokens, pos.reshape(1, fh * v * fw, self.hidden_dim)
