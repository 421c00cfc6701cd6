"""DETR-style CVAE transformer for action chunking (ACT).

Counterpart of ``genima_tpu/nn/act.py``. Attribute paths mirror the flax
module names (``encoder_0.self_attn.q_proj`` ...), so the JAX tree carries
across by a plain path join, style encoder included.

At inference the CVAE latent is zeros and dropout is off. In training
(``actions`` given) the style encoder reads [CLS, qpos, actions] and gives
``mu`` and ``logvar``; the latent is ``mu + exp(logvar / 2) * latent_eps``,
with ``latent_eps`` drawn by the caller. Dropout runs at every flax site
when a ``dropout`` mask source is given: it is called once per site, in
flax's call order, with the site's shape and rate, and returns a boolean
keep mask; kept values are scaled by ``1 / (1 - rate)`` as flax does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax LayerNorm default, which the reference uses here
PROPRIO_DROPOUT = 0.3  # Genima's proprio projection, hard-coded in the reference

# (shape, rate, device) -> bool keep mask of that shape
DropoutMasks = Callable[[tuple, float, torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ACTConfig:
    hidden_dim: int = 256
    enc_layers: int = 4
    dec_layers: int = 6
    dim_feedforward: int = 2048
    nheads: int = 8
    dropout: float = 0.1
    num_queries: int = 20
    state_dim: int = 8
    action_dim: int = 8
    latent_dim: int = 32
    kl_weight: float = 10.0
    use_lang_cond: bool = True
    lang_dim: int = 512  # CLIP ViT-B/32 projection dim

    @staticmethod
    def tiny(**kw) -> "ACTConfig":
        defaults = dict(
            hidden_dim=32, enc_layers=1, dec_layers=1, dim_feedforward=64,
            nheads=2, num_queries=4, latent_dim=8, lang_dim=16,
        )
        defaults.update(kw)
        return ACTConfig(**defaults)


class RandomDropout:
    """Keep masks drawn from ``generator`` (on its device); with ``record``
    every mask is kept in ``masks``, in draw order, for a replay."""

    def __init__(self, generator: torch.Generator, record: bool = False):
        self.generator = generator
        self.masks: Optional[list[torch.Tensor]] = [] if record else None

    def __call__(self, shape, rate: float, device) -> torch.Tensor:
        keep = torch.rand(shape, generator=self.generator,
                          device=self.generator.device) < 1.0 - rate
        if self.masks is not None:
            self.masks.append(keep)
        return keep.to(device)


class GlobalRowsDropout(RandomDropout):
    """``RandomDropout`` for one rank of a data-parallel step: a site of
    local shape (b, ...) draws the mask of the global batch
    (``global_batch``, ...) and keeps this rank's ``rows`` of it, so N
    ranks together draw what one process draws on the concatenated batch."""

    def __init__(self, generator: torch.Generator, global_batch: int, rows: slice,
                 record: bool = False):
        super().__init__(generator, record)
        self.global_batch = global_batch
        self.rows = rows

    def __call__(self, shape, rate: float, device) -> torch.Tensor:
        keep = torch.rand((self.global_batch, *shape[1:]), generator=self.generator,
                          device=self.generator.device)[self.rows] < 1.0 - rate
        if self.masks is not None:
            self.masks.append(keep)
        return keep.to(device)


class ReplayDropout:
    """The masks of an earlier run (``RandomDropout(record=True).masks``),
    handed out in order; a site of another shape raises."""

    def __init__(self, masks):
        self._masks = iter(masks)

    def __call__(self, shape, rate: float, device) -> torch.Tensor:
        keep = next(self._masks)
        if tuple(keep.shape) != tuple(shape):
            raise ValueError(f"dropout site of shape {tuple(shape)} got a mask {tuple(keep.shape)}")
        return keep.to(device)


def dropout(x: torch.Tensor, rate: float, masks: Optional[DropoutMasks]) -> torch.Tensor:
    """flax ``nn.Dropout``: ``x / (1 - rate)`` where kept, 0 where dropped;
    ``x`` itself without a mask source or at rate 0."""
    if masks is None or rate == 0.0:
        return x
    keep = masks(tuple(x.shape), rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def sinusoid_table(n: int, dim: int) -> np.ndarray:
    """1D sinusoidal position table (ACT's get_sinusoid_encoding_table)."""
    pos = np.arange(n)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / dim)
    table = np.zeros((n, dim), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class MHA(nn.Module):
    """Multi-head attention with DETR's pos-added-to-qk convention."""

    def __init__(self, dim: int, heads: int, rate: float = 0.0):
        super().__init__()
        self.heads = heads
        self.rate = rate
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in, k_in, v_in, masks: Optional[DropoutMasks] = None):
        b, _, dim = q_in.shape
        d = dim // self.heads

        def heads(t):
            return t.reshape(b, -1, self.heads, d).transpose(1, 2)

        q, k, v = heads(self.q_proj(q_in)), heads(self.k_proj(k_in)), heads(self.v_proj(v_in))
        scores = torch.matmul(q, k.transpose(-1, -2)) / d**0.5
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        # flax's probs are (b, h, q, k), as here
        probs = dropout(probs, self.rate, masks)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, -1, dim)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """DETR post-norm encoder layer."""

    def __init__(self, cfg: ACTConfig):
        super().__init__()
        self.rate = cfg.dropout
        self.self_attn = MHA(cfg.hidden_dim, cfg.nheads, cfg.dropout)
        self.norm1 = nn.LayerNorm(cfg.hidden_dim, eps=LN_EPS)
        self.linear1 = nn.Linear(cfg.hidden_dim, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, cfg.hidden_dim)
        self.norm2 = nn.LayerNorm(cfg.hidden_dim, eps=LN_EPS)

    def forward(self, x, pos, masks: Optional[DropoutMasks] = None):
        qk = x + pos
        x = self.norm1(x + dropout(self.self_attn(qk, qk, x, masks), self.rate, masks))
        h = dropout(F.relu(self.linear1(x)), self.rate, masks)
        return self.norm2(x + dropout(self.linear2(h), self.rate, masks))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ACTConfig):
        super().__init__()
        self.rate = cfg.dropout
        self.self_attn = MHA(cfg.hidden_dim, cfg.nheads, cfg.dropout)
        self.norm1 = nn.LayerNorm(cfg.hidden_dim, eps=LN_EPS)
        self.cross_attn = MHA(cfg.hidden_dim, cfg.nheads, cfg.dropout)
        self.norm2 = nn.LayerNorm(cfg.hidden_dim, eps=LN_EPS)
        self.linear1 = nn.Linear(cfg.hidden_dim, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, cfg.hidden_dim)
        self.norm3 = nn.LayerNorm(cfg.hidden_dim, eps=LN_EPS)

    def forward(self, tgt, memory, query_pos, mem_pos, masks: Optional[DropoutMasks] = None):
        qk = tgt + query_pos
        sa = self.self_attn(qk, qk, tgt, masks)
        tgt = self.norm1(tgt + dropout(sa, self.rate, masks))
        ca = self.cross_attn(tgt + query_pos, memory + mem_pos, memory, masks)
        tgt = self.norm2(tgt + dropout(ca, self.rate, masks))
        h = dropout(F.relu(self.linear1(tgt)), self.rate, masks)
        return self.norm3(tgt + dropout(self.linear2(h), self.rate, masks))


class ACTOutput(NamedTuple):
    actions: torch.Tensor  # (B, num_queries, action_dim) f32
    is_pad_logits: torch.Tensor  # (B, num_queries) f32
    mu: Optional[torch.Tensor] = None  # (B, latent_dim) f32, training only
    logvar: Optional[torch.Tensor] = None


class GenimaACTModel(nn.Module):
    """The CVAE actor: style encoder (training), DETR encoder-decoder, heads."""

    def __init__(self, cfg: ACTConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.proprio_proj_0 = nn.Linear(cfg.state_dim, h)
        self.proprio_proj_2 = nn.Linear(h, h)
        # CVAE style encoder over [CLS, qpos, actions]
        self.encoder_action_proj = nn.Linear(cfg.action_dim, h)
        self.encoder_joint_proj = nn.Linear(cfg.state_dim, h)
        self.cls_embed = nn.Parameter(torch.zeros(1, 1, h))
        for i in range(cfg.enc_layers):
            self.add_module(f"style_encoder_{i}", EncoderLayer(cfg))
        self.latent_proj = nn.Linear(h, 2 * cfg.latent_dim)
        self.latent_out_proj = nn.Linear(cfg.latent_dim, h)
        n_extra = 2
        if cfg.use_lang_cond:
            self.task_proj = nn.Linear(cfg.lang_dim, h)
            n_extra = 3
        self.additional_pos_embed = nn.Parameter(torch.zeros(n_extra, h))
        for i in range(cfg.enc_layers):
            self.add_module(f"encoder_{i}", EncoderLayer(cfg))
        self.query_embed = nn.Parameter(torch.zeros(cfg.num_queries, h))
        for i in range(cfg.dec_layers):
            self.add_module(f"decoder_{i}", DecoderLayer(cfg))
        self.decoder_norm = nn.LayerNorm(h, eps=LN_EPS)
        self.action_head = nn.Linear(h, cfg.action_dim)
        self.is_pad_head = nn.Linear(h, 1)

    def _style_latent(self, qpos, actions, latent_eps, masks, dtype):
        """(mu, logvar, latent sample), f32: the CVAE posterior."""
        c = self.cfg
        b = qpos.shape[0]
        a_tok = self.encoder_action_proj(actions[:, :c.num_queries].to(dtype))
        q_tok = self.encoder_joint_proj(qpos.to(dtype))[:, None]
        seq = torch.cat([self.cls_embed.expand(b, 1, -1), q_tok, a_tok], dim=1)
        pos = torch.from_numpy(sinusoid_table(seq.shape[1], c.hidden_dim)).to(
            device=seq.device, dtype=dtype)[None]
        for i in range(c.enc_layers):
            seq = getattr(self, f"style_encoder_{i}")(seq, pos, masks)
        latent_info = self.latent_proj(seq[:, 0])
        mu = latent_info[:, :c.latent_dim].float()
        logvar = latent_info[:, c.latent_dim:].float()
        return mu, logvar, mu + torch.exp(0.5 * logvar) * latent_eps.float()

    def forward(
        self,
        image_tokens: torch.Tensor,  # (B, S, hidden)
        image_pos: torch.Tensor,  # (1, S, hidden)
        qpos: torch.Tensor,  # (B, state_dim)
        task_emb: Optional[torch.Tensor] = None,  # (B, lang_dim)
        actions: Optional[torch.Tensor] = None,  # (B, T >= num_queries, action_dim)
        latent_eps: Optional[torch.Tensor] = None,  # (B, latent_dim) standard normal
        dropout_masks: Optional[DropoutMasks] = None,
    ) -> ACTOutput:
        """Inference without ``actions`` (zeros latent); with them, the
        training forward, which needs ``latent_eps``. ``dropout_masks``
        turns dropout on."""
        c = self.cfg
        dtype = self.action_head.weight.dtype
        b = qpos.shape[0]
        masks = dropout_masks
        # Genima's proprio projection: linear - dropout(0.3) - linear
        p = dropout(self.proprio_proj_0(qpos.to(dtype)), PROPRIO_DROPOUT, masks)
        proprio = self.proprio_proj_2(p)
        mu = logvar = None
        if actions is not None:
            if latent_eps is None:
                raise ValueError("the training forward needs latent_eps")
            mu, logvar, latent = self._style_latent(qpos, actions, latent_eps, masks, dtype)
        else:
            latent = torch.zeros(b, c.latent_dim, dtype=dtype, device=qpos.device)
        latent = self.latent_out_proj(latent.to(dtype))
        extra = [latent[:, None], proprio[:, None]]
        if c.use_lang_cond and task_emb is not None:
            extra.append(self.task_proj(task_emb.to(dtype))[:, None])
        n_extra = len(extra)
        memory = torch.cat(extra + [image_tokens.to(dtype)], dim=1)
        mem_pos = torch.cat(
            [self.additional_pos_embed[None, :n_extra], image_pos.to(dtype)], dim=1
        )
        for i in range(c.enc_layers):
            memory = getattr(self, f"encoder_{i}")(memory, mem_pos, masks)
        query_pos = self.query_embed[None].expand(b, -1, -1)
        tgt = torch.zeros_like(query_pos)
        for i in range(c.dec_layers):
            tgt = getattr(self, f"decoder_{i}")(tgt, memory, query_pos, mem_pos, masks)
        tgt = self.decoder_norm(tgt)
        return ACTOutput(
            self.action_head(tgt).float(), self.is_pad_head(tgt)[..., 0].float(), mu, logvar
        )


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid_binary_cross_entropy, numerically stable."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def act_loss(out: ACTOutput, actions: torch.Tensor, is_pad: torch.Tensor,
             kl_weight: float) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Masked L1 on the joints + 0.05 * BCE on the gripper logit + kl_weight
    * KL (summed over latent dims, averaged over the batch)."""
    nq = out.actions.shape[1]
    actions = actions[:, :nq]
    not_pad = (~is_pad[:, :nq].bool())[..., None].float()
    l1 = ((actions[..., :-1] - out.actions[..., :-1]).abs() * not_pad).mean()
    bce = sigmoid_bce(out.actions[..., -1], actions[..., -1]) * 0.05
    gripper_loss = (bce * not_pad[..., 0]).mean()
    klds = -0.5 * (1 + out.logvar - out.mu**2 - torch.exp(out.logvar))
    total_kld = klds.sum(dim=-1).mean()
    loss = l1 + gripper_loss + total_kld * kl_weight
    return loss, {"l1": l1, "gripper_loss": gripper_loss, "kl": total_kld, "loss": loss}
