"""Shared building blocks of the SD UNet / ControlNet / VAE in PyTorch.

Counterpart of ``genima_tpu/nn/layers.py``. Modules are NCHW inside and
their attribute paths are the diffusers state-dict names, so weights carried
across from the JAX tree load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from genima_torch.kernels.flash_attention import flash_attention
from genima_torch.kernels.packed_attention import packed_flash_attention
from genima_torch.kernels.w8_matmul import w8_matmul

# 'fused' backend: self-attention at least this long with a multiple of 128
# tokens goes to the packed kernel (the reference's threshold, kept so both
# packages route the same attentions; the port has not re-measured it).
FUSED_MIN_SEQ = 256
# attention backends: "fused" (long self-attention through the packed
# kernel), "pallas" (every attention through the flash kernel),
# "pallas_self" (self-attention only), "xla" (the library attention). Each
# may carry "+w8": the transformer blocks' linears in int8 (W8Linear).
BACKENDS = ("fused", "xla", "pallas", "pallas_self")


def group_norm(channels: int, eps: float) -> nn.GroupNorm:
    """GroupNorm(32) as in SD; falls back to a divisor for tiny test widths."""
    groups = 32 if channels % 32 == 0 else math.gcd(channels, 32)
    return nn.GroupNorm(groups, channels, eps=eps)


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding, diffusers convention, in f32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    """MLP over the sinusoidal embedding: linear -> silu -> linear."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


def split_backend(spec: str) -> tuple[str, bool]:
    """A backend spec is ``<attn>[+w8]``: returns (attention backend, w8)."""
    attn, w8 = (spec[: -len("+w8")], True) if spec.endswith("+w8") else (spec, False)
    if attn not in BACKENDS:
        raise ValueError(f"attention backend {spec!r} not in {BACKENDS}, each optionally +w8")
    return attn, w8


def resolve_backend(backend: str, is_cross: bool) -> str:
    """The attention one call takes: 'fused' and 'pallas_self' send
    cross-attention (77 keys) to the library attention, 'pallas' sends it
    to the flash kernel too."""
    attn, _ = split_backend(backend)
    if attn == "pallas_self":
        return "xla" if is_cross else "pallas"
    if attn == "fused":
        return "xla" if is_cross else "fused"
    return attn


def library_attention(q, k, v, heads: int) -> torch.Tensor:
    """(B, S, heads*d) packed in and out, through SDPA."""
    b, sq, c = q.shape
    d = c // heads
    out = F.scaled_dot_product_attention(
        q.reshape(b, sq, heads, d).transpose(1, 2),
        k.reshape(b, -1, heads, d).transpose(1, 2),
        v.reshape(b, -1, heads, d).transpose(1, 2),
    )
    return out.transpose(1, 2).reshape(b, sq, c)


class W8Linear(nn.Module):
    """``nn.Linear`` with int8 weight-only storage (the reference's
    ``W8Dense``): ``kernel_q`` int8 (out, in), ``scale`` f32 (out,), an
    optional ``bias``; ``x @ (kernel_q * scale).T`` through
    ``kernels.w8_matmul``. Made from a float linear by
    ``weights.quantize.quantize_dense_tree``, or loaded from a quantized
    JAX tree. ``scale`` stays f32 when the module is cast to bf16."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.register_buffer("kernel_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        if self.scale.dtype != scale.dtype:  # a dtype cast: keep the f32 scale
            self.scale = scale.to(self.scale.device)
        return self

    def forward(self, x):
        y = w8_matmul(x, self.kernel_q, self.scale)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def make_dense(w8: bool, in_features: int, out_features: int, bias: bool = True) -> nn.Module:
    """``nn.Linear`` or its int8 weight-only twin, same call signature."""
    cls = W8Linear if w8 else nn.Linear
    return cls(in_features, out_features, bias=bias)


class Attention(nn.Module):
    """Multi-head (self or cross) attention, diffusers ``Attention`` layout."""

    def __init__(
        self, query_dim: int, heads: int,
        cross_attention_dim: Optional[int] = None, backend: str = "fused",
    ):
        super().__init__()
        self.heads = heads
        self.is_cross = cross_attention_dim is not None
        self.backend = backend
        w8 = split_backend(backend)[1]
        kv_dim = cross_attention_dim if self.is_cross else query_dim
        self.to_q = make_dense(w8, query_dim, query_dim, bias=False)
        self.to_k = make_dense(w8, kv_dim, query_dim, bias=False)
        self.to_v = make_dense(w8, kv_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([make_dense(w8, query_dim, query_dim)])

    def forward(self, hidden_states, context=None):
        context = hidden_states if context is None else context
        q = self.to_q(hidden_states)
        k = self.to_k(context)
        v = self.to_v(context)
        b, sq, c = q.shape
        backend = resolve_backend(self.backend, self.is_cross)
        if backend == "fused" and sq >= FUSED_MIN_SEQ and sq % 128 == 0:
            out = packed_flash_attention(q, k, v, self.heads)
        elif backend == "pallas":
            # (B, S, heads*d) is (B, S, heads, d) in place: no transposes
            heads = [t.reshape(b, t.shape[1], self.heads, c // self.heads) for t in (q, k, v)]
            out = flash_attention(*heads).reshape(b, sq, c)
        else:
            out = library_attention(q, k, v, self.heads)
        return self.to_out[0](out)


def set_attention_backend(module: nn.Module, backend: str) -> None:
    """Route every ``Attention`` under ``module`` through ``backend``. Its
    ``+w8`` part must match the weights the module holds (``W8Linear`` after
    ``weights.quantize.quantize_dense_tree``); it cannot switch them."""
    _, w8 = split_backend(backend)
    for m in module.modules():
        if isinstance(m, Attention):
            if isinstance(m.to_q, W8Linear) != w8:
                raise ValueError(
                    f"backend {backend!r} does not fit the module's "
                    f"{'int8' if not w8 else 'float'} linears")
            m.backend = backend


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner_dim: int, w8: bool = False):
        super().__init__()
        self.proj = make_dense(w8, dim, inner_dim * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) gelu, as diffusers


class FeedForward(nn.Module):
    """diffusers FeedForward: net.0 = GEGLU, net.1 = dropout, net.2 = Linear."""

    def __init__(self, dim: int, mult: int = 4, w8: bool = False):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult, w8), nn.Identity(), make_dense(w8, dim * mult, dim)]
        )

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross_attention_dim: int,
                 backend: str = "fused"):
        super().__init__()
        # diffusers norm_eps 1e-5 (torch LayerNorm default)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, None, backend)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, cross_attention_dim, backend)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, w8=split_backend(backend)[1])

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """Spatial transformer. Tokens are row-major (h, w), as the reference's
    ``reshape(b, h*w, c)`` of NHWC. ``use_linear_projection`` (SD 2.x,
    SDXL): ``proj_in`` / ``proj_out`` are linears on the tokens; without it
    (SD 1.x) they are 1x1 convs on the feature map, and stay float under
    ``+w8``, as in the reference."""

    def __init__(self, in_channels: int, heads: int, cross_attention_dim: int,
                 num_layers: int = 1, backend: str = "fused",
                 use_linear_projection: bool = True):
        super().__init__()
        c = in_channels
        w8 = split_backend(backend)[1]
        self.use_linear_projection = use_linear_projection
        self.norm = group_norm(c, 1e-6)
        self.proj_in = make_dense(w8, c, c) if use_linear_projection else nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(c, heads, cross_attention_dim, backend)
            for _ in range(num_layers)
        )
        self.proj_out = make_dense(w8, c, c) if use_linear_projection else nn.Conv2d(c, c, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear_projection:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.use_linear_projection:
            x = self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(b, h, w, c).permute(0, 3, 1, 2))
        return x + residual


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, eps: float = 1e-5):
        super().__init__()
        self.norm1 = group_norm(in_channels, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = group_norm(out_channels, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv, symmetric padding 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
