"""AutoencoderKL in PyTorch: images -> latents (training) and generated
latents -> target images (serving).

Counterpart of ``genima_tpu/nn/vae.py`` (``AutoencoderKL.encode`` /
``decode``, ``Encoder``, ``Decoder``, ``VAEAttention``,
``LatentDistribution``). Serving builds the decode half only, and carrying
weights across then keeps just the JAX tree's ``DECODE_SUBTREES``; the
ControlNet trainer builds it with ``encoder=True`` and loads the whole tree.
``conv_backend="fused"`` runs the decoder's up-block resnets and its output
conv through the fused GN-SiLU-conv3x3 kernel, with the same parameters.
``AutoencoderTiny`` is taesd, the distilled VAE the reference can decode
with (``autoencoder=taesd``): plain convs and ReLUs, latents already in the
scaled space.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from genima_torch.nn.fused_blocks import fused_gn_silu_conv, fused_resnet_block
from genima_torch.nn.layers import ResnetBlock2D, group_norm

DECODE_SUBTREES = ("decoder", "post_quant_conv")
CONV_BACKENDS = ("xla", "fused")  # "xla": the library convs, as in the reference


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
    def sdxl(**kw) -> "VAEConfig":
        return VAEConfig(scaling_factor=0.13025, **kw)

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
    """SD VAE decoder (diffusers names ``up_blocks.N.resnets.M``).
    ``conv_backend="fused"``: the up-block resnets and conv_norm_out/conv_out
    go through the fused kernel; the mid block stays on the plain modules
    and the upsample convs on the library conv, as in the reference."""

    def __init__(self, cfg: VAEConfig, conv_backend: str = "xla"):
        super().__init__()
        if conv_backend not in CONV_BACKENDS:
            raise ValueError(f"conv backend {conv_backend!r} not in {CONV_BACKENDS}")
        self.conv_backend = conv_backend
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
        if self.conv_backend == "fused":
            return self._fused_up(x)
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))

    def _fused_up(self, x):
        """The up path channels-last: one conversion in, here, and none out
        (the NCHW result is a view of the kernel's NHWC output). The
        upsample convs then run on ``channels_last`` tensors."""
        h = x.permute(0, 2, 3, 1).contiguous()
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = fused_resnet_block(resnet, h)
            if hasattr(block, "upsamplers"):
                up = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
                h = block.upsamplers[0].conv(up).permute(0, 2, 3, 1).contiguous()
        return fused_gn_silu_conv(h, self.conv_norm_out, self.conv_out).permute(0, 3, 1, 2)


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
    half as well. ``conv_backend`` selects the decoder's convs; the
    parameters are the same under both."""

    def __init__(self, cfg: VAEConfig, encoder: bool = False, conv_backend: str = "xla"):
        super().__init__()
        self.cfg = cfg
        if encoder:
            self.encoder = Encoder(cfg)
            self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.decoder = Decoder(cfg, conv_backend)
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


class _TaesdBlock(nn.Module):
    """taesd's residual block: three 3x3 convs with ReLUs between, a 1x1
    skip when the width changes, ReLU of the sum."""

    def __init__(self, in_ch: int, channels: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_ch, channels, 3, padding=1)
        self.conv_2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv_4 = nn.Conv2d(channels, channels, 3, padding=1)
        if in_ch != channels:
            self.skip = nn.Conv2d(in_ch, channels, 1, bias=False)

    def forward(self, x):
        h = self.conv_4(F.relu(self.conv_2(F.relu(self.conv_0(x)))))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return F.relu(h + x)


class _TaesdEncoder(nn.Module):
    """conv_in, block_in, then per level a stride-2 conv (``down_<l>``) and
    ``blocks_per_level`` blocks (``block_<l>_<b>``), conv_out."""

    def __init__(self, out_channels: int, width: int, n_levels: int, blocks_per_level: int):
        super().__init__()
        self.n_levels, self.blocks_per_level = n_levels, blocks_per_level
        self.conv_in = nn.Conv2d(3, width, 3, padding=1)
        self.block_in = _TaesdBlock(width, width)
        for lvl in range(n_levels):
            setattr(self, f"down_{lvl}", nn.Conv2d(width, width, 3, stride=2, padding=1,
                                                   bias=False))
            for b in range(blocks_per_level):
                setattr(self, f"block_{lvl}_{b}", _TaesdBlock(width, width))
        self.conv_out = nn.Conv2d(width, out_channels, 3, padding=1)

    def forward(self, x):
        x = self.block_in(self.conv_in(x))
        for lvl in range(self.n_levels):
            x = getattr(self, f"down_{lvl}")(x)
            for b in range(self.blocks_per_level):
                x = getattr(self, f"block_{lvl}_{b}")(x)
        return self.conv_out(x)


class _TaesdDecoder(nn.Module):
    """The latent clamp ``tanh(z / 3) * 3``, conv_in + ReLU, then per level
    ``blocks_per_level`` blocks, a nearest 2x upsample and a conv
    (``up_<l>``), block_out, conv_out."""

    def __init__(self, latent_channels: int, out_channels: int, width: int, n_levels: int,
                 blocks_per_level: int):
        super().__init__()
        self.n_levels, self.blocks_per_level = n_levels, blocks_per_level
        self.conv_in = nn.Conv2d(latent_channels, width, 3, padding=1)
        for lvl in range(n_levels):
            for b in range(blocks_per_level):
                setattr(self, f"block_{lvl}_{b}", _TaesdBlock(width, width))
            setattr(self, f"up_{lvl}", nn.Conv2d(width, width, 3, padding=1, bias=False))
        self.block_out = _TaesdBlock(width, width)
        self.conv_out = nn.Conv2d(width, out_channels, 3, padding=1)

    def forward(self, z):
        x = F.relu(self.conv_in(torch.tanh(z / 3.0) * 3.0))
        for lvl in range(self.n_levels):
            for b in range(self.blocks_per_level):
                x = getattr(self, f"block_{lvl}_{b}")(x)
            x = getattr(self, f"up_{lvl}")(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.block_out(x))


class AutoencoderTiny(nn.Module):
    """taesd: ``encode`` maps (B, 3, H, W) in [-1, 1] straight to scaled
    latents (no distribution, no scaling factor) and ``decode`` maps scaled
    latents back. Attribute paths are the reference's flax names (family
    ``tiny_vae``)."""

    def __init__(self, latent_channels: int = 4, width: int = 64, n_levels: int = 3,
                 blocks_per_level: int = 3):
        super().__init__()
        self.encoder = _TaesdEncoder(latent_channels, width, n_levels, blocks_per_level)
        self.decoder = _TaesdDecoder(latent_channels, 3, width, n_levels, blocks_per_level)

    def forward(self, x):
        return self.decode(self.encode(x))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x.to(self.encoder.conv_in.weight.dtype))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z.to(self.decoder.conv_in.weight.dtype))
