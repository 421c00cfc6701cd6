"""ControlNet in PyTorch: the trainable model of the Genima diffusion stage.

Counterpart of ``genima_tpu/nn/controlnet.py``: a copy of the UNet's down
path and mid block, a conditioning-image embedding CNN, and 1x1 projections
whose outputs are added to the frozen UNet's skip connections.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from genima_torch.nn.unet import DownPath, UNetConfig, skip_channels


class ControlNetConditioningEmbedding(nn.Module):
    """Full-resolution conditioning image (NCHW, [0, 1]) -> latent resolution:
    conv_in, pairs of (conv, stride-2 conv), conv_out."""

    def __init__(self, out_channels: int,
                 block_out_channels: Sequence[int] = (16, 32, 96, 256)):
        super().__init__()
        chans = tuple(block_out_channels)
        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        blocks = []
        for i in range(len(chans) - 1):
            blocks.append(nn.Conv2d(chans[i], chans[i], 3, padding=1))
            blocks.append(nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(chans[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(cond))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNetModel(DownPath):
    def __init__(self, cfg: UNetConfig,
                 conditioning_scale_channels: Sequence[int] = (16, 32, 96, 256),
                 backend: str = "fused"):
        super().__init__(cfg, backend)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            cfg.block_out_channels[0], conditioning_scale_channels
        )
        self.controlnet_down_blocks = nn.ModuleList(
            nn.Conv2d(c, c, 1) for c in skip_channels(cfg)
        )
        c_last = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(c_last, c_last, 1)

    def forward(
        self,
        sample: torch.Tensor,  # (B, 4, h, w) noisy latents
        timesteps: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        controlnet_cond: torch.Tensor,  # (B, 3, H, W) in [0, 1], or embedded
        conditioning_scale: float = 1.0,
        cond_is_embedded: bool = False,
        added_cond_kwargs: Optional[dict] = None,  # SDXL: text_embeds, time_ids
    ) -> tuple[list[torch.Tensor], torch.Tensor]:
        """``cond_is_embedded=True``: ``controlnet_cond`` is the precomputed
        conditioning embedding (``embed_conditioning``), hoisted out of the
        denoise loop."""
        dtype = self.dtype
        context = encoder_hidden_states.to(dtype)
        emb = self.time_embed(timesteps, sample.shape[0], added_cond_kwargs)
        cond = controlnet_cond.to(dtype)
        if not cond_is_embedded:
            cond = self.controlnet_cond_embedding(cond)
        x = self.conv_in(sample.to(dtype)) + cond
        x, residuals = self.run_down(x, emb, context)
        x = self.mid_block(x, emb, context)
        down = [
            proj(r) * conditioning_scale
            for proj, r in zip(self.controlnet_down_blocks, residuals)
        ]
        return down, self.controlnet_mid_block(x) * conditioning_scale


def embed_conditioning(controlnet: ControlNetModel, cond: torch.Tensor) -> torch.Tensor:
    """Just the conditioning-embedding CNN (pair with ``cond_is_embedded``)."""
    return controlnet.controlnet_cond_embedding(cond.to(controlnet.dtype))


# top-level subtrees the ControlNet shares with the UNet (diffusers
# ControlNetModel.from_unet copies these, SDXL's add_embedding included; the
# cond embedding and zero convs keep their own init)
_SHARED_PREFIXES = ("conv_in.", "time_embedding.", "add_embedding.", "down_blocks.",
                    "mid_block.")


def controlnet_params_from_unet(
    unet_params: dict[str, torch.Tensor], controlnet_params: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """ControlNet state dict initialised from a UNet's (``from_unet``):
    every shared tensor comes from ``unet_params``, the rest is kept."""
    return {
        k: unet_params[k] if k.startswith(_SHARED_PREFIXES) and k in unet_params else v
        for k, v in controlnet_params.items()
    }
