"""CLIP text transformer in PyTorch (HF ``CLIPTextModel`` attribute paths).

Counterpart of ``genima_tpu/nn/clip_text.py``: the SD-turbo prompt encoder
(``sd21``), SDXL's two prompt encoders (``sdxl_one``: the SD 1.5 tower,
quick_gelu; ``sdxl_two``: OpenCLIP bigG, gelu, with its text projection;
SDXL concatenates their penultimate hidden states and pools from the
second) and the controller's ViT-B/32 text tower (``vit_b_32``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 23
    num_heads: int = 16
    max_positions: int = 77
    hidden_act: str = "gelu"  # or "quick_gelu"
    projection_dim: Optional[int] = None

    @staticmethod
    def sd21(**kw) -> "CLIPTextConfig":
        """stabilityai/sd-turbo text_encoder (OpenCLIP ViT-H, truncated)."""
        return CLIPTextConfig(**kw)

    @staticmethod
    def sd15(**kw) -> "CLIPTextConfig":
        return CLIPTextConfig(
            hidden_size=768, intermediate_size=3072, num_layers=12, num_heads=12,
            hidden_act="quick_gelu", **kw,
        )

    @staticmethod
    def sdxl_one(**kw) -> "CLIPTextConfig":
        return CLIPTextConfig.sd15(**kw)

    @staticmethod
    def sdxl_two(**kw) -> "CLIPTextConfig":
        return CLIPTextConfig(
            hidden_size=1280, intermediate_size=5120, num_layers=32, num_heads=20,
            hidden_act="gelu", projection_dim=1280, **kw,
        )

    @staticmethod
    def vit_b_32(**kw) -> "CLIPTextConfig":
        """OpenAI CLIP ViT-B/32 text tower (controller language embedding)."""
        return CLIPTextConfig(
            hidden_size=512, intermediate_size=2048, num_layers=12, num_heads=8,
            hidden_act="quick_gelu", projection_dim=512, **kw,
        )

    @staticmethod
    def tiny(**kw) -> "CLIPTextConfig":
        defaults = dict(
            vocab_size=1000, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=2, projection_dim=32,
        )
        defaults.update(kw)
        return CLIPTextConfig(**defaults)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x, mask):
        b, s, c = x.shape
        d = c // self.heads

        def heads(t):
            return t.reshape(b, s, self.heads, d).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / d**0.5
        scores = scores + mask.to(scores.dtype)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, c)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        # HF "gelu" is the exact erf form
        self.act = quick_gelu if cfg.hidden_act == "quick_gelu" else F.gelu

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        # HF CLIP layer_norm_eps = 1e-5
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # after final_layer_norm
    penultimate_hidden_state: torch.Tensor  # hidden_states[-2], pre final LN
    pooled_output: torch.Tensor  # last_hidden_state at the EOT position
    text_embeds: Optional[torch.Tensor]  # pooled @ text_projection


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(
            cfg.max_positions, cfg.hidden_size
        )
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)
        )
        tm.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.text_model = tm
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(
                cfg.hidden_size, cfg.projection_dim, bias=False
            )

    def forward(self, input_ids: torch.Tensor) -> CLIPTextOutput:
        tm = self.text_model
        b, s = input_ids.shape
        # clamp: out-of-range ids (a hash tokenizer against a tiny test
        # vocab) must not index out of the table
        safe_ids = input_ids.clamp(0, self.cfg.vocab_size - 1)
        x = tm.embeddings.token_embedding(safe_ids)
        x = x + tm.embeddings.position_embedding.weight[None, :s]
        causal = torch.triu(
            torch.full((s, s), -1e9, dtype=torch.float32, device=x.device), diagonal=1
        )[None, None]
        penultimate = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == len(tm.encoder.layers) - 1:
                penultimate = x
            x = layer(x, causal)
        last = tm.final_layer_norm(x)
        # EOT pooling: argmax over ids (EOT has the highest id in CLIP vocab)
        pooled = last[torch.arange(b, device=x.device), input_ids.argmax(dim=-1)]
        text_embeds = (
            self.text_projection(pooled) if hasattr(self, "text_projection") else None
        )
        return CLIPTextOutput(last, penultimate, pooled, text_embeds)
