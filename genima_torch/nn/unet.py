"""UNet2DCondition in PyTorch: the SD-turbo / SDXL-turbo epsilon predictor.

Counterpart of ``genima_tpu/nn/unet.py``: NCHW inside, diffusers attribute
paths, ControlNet residual injection, and SDXL's text_time
micro-conditioning (``addition_embed_type="text_time"``: the pooled text
embeds and the sinusoidal embedding of the 6 ``time_ids`` through
``add_embedding``, added to the time embedding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from genima_torch.nn.layers import (
    Downsample2D,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2DModel,
    Upsample2D,
    get_timestep_embedding,
    group_norm,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    # True at index i => CrossAttnDownBlock2D, else DownBlock2D; the up path
    # is the reverse
    down_block_has_attn: Sequence[bool] = (True, True, True, False)
    layers_per_block: int = 2
    num_heads: Sequence[int] = (5, 10, 20, 20)
    transformer_layers_per_block: Sequence[int] = (1, 1, 1, 1)
    cross_attention_dim: int = 1024
    # the transformers' proj_in / proj_out: linears (SD 2.x, SDXL) or 1x1
    # convs (SD 1.x)
    use_linear_projection: bool = True
    # SDXL "text_time" micro-conditioning; the add_embedding's input is the
    # pooled text embeds and 6 time_ids x addition_time_embed_dim
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @staticmethod
    def sd21(**kw) -> "UNetConfig":
        """stabilityai/sd-turbo == distilled SD 2.1 base (512px)."""
        return UNetConfig(**kw)

    @staticmethod
    def sd15(**kw) -> "UNetConfig":
        """SD 1.5: 768-wide CLIP context, 8 heads at every level (head dims
        40/80/160), conv projections."""
        return UNetConfig(
            cross_attention_dim=768,
            num_heads=(8, 8, 8, 8),
            use_linear_projection=False,
            **kw,
        )

    @staticmethod
    def sdxl(**kw) -> "UNetConfig":
        """stabilityai/sdxl-turbo UNet (1280 pooled + 6 x 256 = 2816)."""
        return UNetConfig(
            block_out_channels=(320, 640, 1280),
            down_block_has_attn=(False, True, True),
            num_heads=(5, 10, 20),
            transformer_layers_per_block=(1, 2, 10),
            cross_attention_dim=2048,
            addition_embed_type="text_time",
            projection_class_embeddings_input_dim=2816,
            **kw,
        )

    @staticmethod
    def pix2pix(**kw) -> "UNetConfig":
        """InstructPix2Pix: 8 input channels, the noisy latents and the
        conditioning image's latents side by side."""
        return UNetConfig(in_channels=8, **kw)

    @staticmethod
    def tiny(**kw) -> "UNetConfig":
        """Small config for tests (the reference's ``UNetConfig.tiny``)."""
        defaults = dict(
            block_out_channels=(32, 64),
            down_block_has_attn=(True, False),
            layers_per_block=1,
            num_heads=(2, 2),
            transformer_layers_per_block=(1, 1),
            cross_attention_dim=32,
        )
        defaults.update(kw)
        return UNetConfig(**defaults)


class DownBlock(nn.Module):
    """CrossAttnDownBlock2D (with attentions) or DownBlock2D."""

    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int, level: int,
                 temb_ch: int, add_downsample: bool, backend: str):
        super().__init__()
        self.has_attn = cfg.down_block_has_attn[level]
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb_ch)
            for i in range(cfg.layers_per_block)
        )
        if self.has_attn:
            self.attentions = nn.ModuleList(
                Transformer2DModel(
                    out_ch, cfg.num_heads[level], cfg.cross_attention_dim,
                    cfg.transformer_layers_per_block[level], backend,
                    cfg.use_linear_projection,
                )
                for _ in range(cfg.layers_per_block)
            )
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch)])

    def forward(self, x, temb, context):
        outputs = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.has_attn:
                x = self.attentions[i](x, context)
            outputs.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, outputs


class MidBlock(nn.Module):
    """UNetMidBlock2DCrossAttn."""

    def __init__(self, cfg: UNetConfig, channels: int, temb_ch: int, backend: str):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(channels, channels, temb_ch) for _ in range(2)
        )
        self.attentions = nn.ModuleList([
            Transformer2DModel(
                channels, cfg.num_heads[-1], cfg.cross_attention_dim,
                cfg.transformer_layers_per_block[-1], backend,
                cfg.use_linear_projection,
            )
        ])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UpBlock(nn.Module):
    """CrossAttnUpBlock2D (with attentions) or UpBlock2D."""

    def __init__(self, cfg: UNetConfig, level: int, in_chs: Sequence[int],
                 temb_ch: int, add_upsample: bool, backend: str):
        super().__init__()
        out_ch = cfg.block_out_channels[level]
        self.has_attn = cfg.down_block_has_attn[level]
        self.resnets = nn.ModuleList(
            ResnetBlock2D(c, out_ch, temb_ch) for c in in_chs
        )
        if self.has_attn:
            self.attentions = nn.ModuleList(
                Transformer2DModel(
                    out_ch, cfg.num_heads[level], cfg.cross_attention_dim,
                    cfg.transformer_layers_per_block[level], backend,
                    cfg.use_linear_projection,
                )
                for _ in in_chs
            )
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])

    def forward(self, x, skips: list, temb, context):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if self.has_attn:
                x = self.attentions[i](x, context)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


def skip_channels(cfg: UNetConfig) -> list[int]:
    """Channels of the down path's residuals: conv_in, then each block's."""
    chans = [cfg.block_out_channels[0]]
    for level, out_ch in enumerate(cfg.block_out_channels):
        chans += [out_ch] * cfg.layers_per_block
        if level < len(cfg.block_out_channels) - 1:
            chans.append(out_ch)
    return chans


class DownPath(nn.Module):
    """conv_in, time embedding (and SDXL's add embedding), down blocks and
    mid block: the part the UNet and the ControlNet share (diffusers
    ``from_unet`` copies exactly these)."""

    def __init__(self, cfg: UNetConfig, backend: str):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.block_out_channels[0]
        temb_ch = c0 * 4
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(c0, temb_ch)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_ch)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r}")
        n = len(cfg.block_out_channels)
        self.down_blocks = nn.ModuleList(
            DownBlock(
                cfg, cfg.block_out_channels[max(level - 1, 0)], out_ch, level,
                temb_ch, level < n - 1, backend,
            )
            for level, out_ch in enumerate(cfg.block_out_channels)
        )
        self.mid_block = MidBlock(cfg, cfg.block_out_channels[-1], temb_ch, backend)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def time_embed(self, timesteps: torch.Tensor, batch: int,
                   added_cond_kwargs: Optional[dict] = None) -> torch.Tensor:
        """The time embedding; under text_time plus ``add_embedding`` of
        ``added_cond_kwargs``' ``text_embeds`` (B, pooled) and the
        sinusoidal embedding of its ``time_ids`` (B, 6)."""
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(batch)
        cfg = self.cfg
        t_emb = get_timestep_embedding(
            timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
            cfg.freq_shift,
        ).to(self.dtype)
        emb = self.time_embedding(t_emb)
        if cfg.addition_embed_type != "text_time":
            return emb
        if added_cond_kwargs is None:
            raise ValueError("a text_time UNet needs added_cond_kwargs")
        text_embeds = added_cond_kwargs["text_embeds"]
        time_ids = added_cond_kwargs["time_ids"].to(text_embeds.device)
        ids_emb = get_timestep_embedding(
            time_ids.reshape(-1), cfg.addition_time_embed_dim, cfg.flip_sin_to_cos,
            cfg.freq_shift,
        ).to(self.dtype).reshape(text_embeds.shape[0], -1)
        add = torch.cat([text_embeds.to(self.dtype), ids_emb], dim=-1)
        return emb + self.add_embedding(add)

    def run_down(self, x, emb, context):
        residuals = [x]
        for block in self.down_blocks:
            x, outs = block(x, emb, context)
            residuals.extend(outs)
        return x, residuals


class UNet2DConditionModel(DownPath):
    def __init__(self, cfg: UNetConfig, backend: str = "fused"):
        super().__init__(cfg, backend)
        c0 = cfg.block_out_channels[0]
        temb_ch = c0 * 4
        skips = skip_channels(cfg)
        n = len(cfg.block_out_channels)
        self.up_blocks = nn.ModuleList()
        x_ch = cfg.block_out_channels[-1]
        for i in range(n):
            level = n - 1 - i  # mirror of the down path
            out_ch = cfg.block_out_channels[level]
            in_chs = []
            for _ in range(cfg.layers_per_block + 1):
                in_chs.append(x_ch + skips.pop())
                x_ch = out_ch
            self.up_blocks.append(
                UpBlock(cfg, level, in_chs, temb_ch, i < n - 1, backend)
            )
        self.conv_norm_out = group_norm(c0, 1e-5)
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,  # (B, C, H, W) latents
        timesteps: torch.Tensor,  # (B,) or scalar
        encoder_hidden_states: torch.Tensor,  # (B, S, cross_dim)
        down_block_additional_residuals: Optional[list] = None,
        mid_block_additional_residual: Optional[torch.Tensor] = None,
        added_cond_kwargs: Optional[dict] = None,  # SDXL: text_embeds, time_ids
    ) -> torch.Tensor:
        dtype = self.dtype
        context = encoder_hidden_states.to(dtype)
        emb = self.time_embed(timesteps, sample.shape[0], added_cond_kwargs)
        x = self.conv_in(sample.to(dtype))
        x, residuals = self.run_down(x, emb, context)
        if down_block_additional_residuals is not None:
            residuals = [
                r + c.to(r.dtype)
                for r, c in zip(residuals, down_block_additional_residuals)
            ]
        x = self.mid_block(x, emb, context)
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual.to(x.dtype)
        for up in self.up_blocks:
            x = up(x, residuals, emb, context)
        return self.conv_out(F.silu(self.conv_norm_out(x)))
