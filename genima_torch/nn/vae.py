"""AutoencoderKL in PyTorch: images -> latents (training) and generated
latents -> target images (serving).

Counterpart of ``genima_tpu/nn/vae.py`` (``AutoencoderKL.encode`` /
``decode``, ``Encoder``, ``Decoder``, ``VAEAttention``,
``LatentDistribution``). Serving builds the decode half only, and carrying
weights across then keeps just the JAX tree's ``DECODE_SUBTREES``; the
ControlNet trainer builds it with ``encoder=True`` and loads the whole tree.
``AutoencoderTiny`` belongs to a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from genima_torch.nn.layers import ResnetBlock2D, group_norm

DECODE_SUBTREES = ("decoder", "post_quant_conv")


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215

    @staticmethod
    def sd(**kw) -> "VAEConfig":
        return VAEConfig(**kw)

    @staticmethod
    def tiny_test(**kw) -> "VAEConfig":
        defaults = dict(block_out_channels=(16, 32), layers_per_block=1)
        defaults.update(kw)
        return VAEConfig(**defaults)


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block (library
    attention: the reference left it to XLA)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.group_norm = group_norm(c, 1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
        y = F.scaled_dot_product_attention(self.to_q(y), self.to_k(y), self.to_v(y))
        y = self.to_out[0](y[:, 0])
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(channels, channels, None, eps=1e-6) for _ in range(2)
        )
        self.attentions = nn.ModuleList([VAEAttention(channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_resnets: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, None, eps=1e-6)
            for i in range(n_resnets)
        )
        if add_downsample:
            down = nn.Module()
            down.conv = nn.Conv2d(out_ch, out_ch, 3, stride=2)
            self.downsamplers = nn.ModuleList([down])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "downsamplers"):
            # diffusers' VAE downsample: asymmetric (0, 1) x (0, 1) padding
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class Encoder(nn.Module):
    """SD VAE encoder (diffusers names ``down_blocks.N.resnets.M``)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _DownBlock(chans[max(level - 1, 0)], out_ch, cfg.layers_per_block,
                       level < len(chans) - 1)
            for level, out_ch in enumerate(chans)
        )
        self.mid_block = VAEMidBlock(chans[-1])
        self.conv_norm_out = group_norm(chans[-1], 1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_resnets: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, None, eps=1e-6)
            for i in range(n_resnets)
        )
        if add_upsample:
            up = nn.Module()
            up.conv = nn.Conv2d(out_ch, out_ch, 3, padding=1)
            self.upsamplers = nn.ModuleList([up])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if hasattr(self, "upsamplers"):
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = self.upsamplers[0].conv(x)
        return x


class Decoder(nn.Module):
    """SD VAE decoder (diffusers names ``up_blocks.N.resnets.M``)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0])
        self.up_blocks = nn.ModuleList(
            _UpBlock(rev[max(level - 1, 0)], out_ch, cfg.layers_per_block + 1,
                     level < len(rev) - 1)
            for level, out_ch in enumerate(rev)
        )
        self.conv_norm_out = group_norm(rev[-1], 1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class LatentDistribution(NamedTuple):
    """Diagonal gaussian over (B, 4, h, w) latents (diffusers
    ``DiagonalGaussianDistribution``); the normal draw is passed in."""

    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        return self.mean + torch.exp(0.5 * self.logvar) * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    """The SD KL-VAE: the decode half, and with ``encoder=True`` the encode
    half as well."""

    def __init__(self, cfg: VAEConfig, encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        if encoder:
            self.encoder = Encoder(cfg)
            self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.decoder = Decoder(cfg)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> LatentDistribution:
        """x: (B, 3, H, W) in [-1, 1] -> distribution over (B, 4, H/8, W/8)."""
        moments = self.quant_conv(self.encoder(x.to(self.post_quant_conv.weight.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return LatentDistribution(mean, logvar.clamp(-30.0, 20.0))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, 4, h, w) *unscaled* latents -> (B, 3, H, W) in [-1, 1]."""
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
