"""The OpenAI CLIP text tower (``ViT-B-32.pt`` and the like) into the port's
HF-named ``CLIPTextModel``.

Counterpart of ``load_openai_clip_text`` / ``load_torch_file`` in
``genima_tpu/weights/torch_port.py``: the visual tower and ``logit_scale``
are dropped, each fused attention ``in_proj`` splits into q/k/v, OpenAI's
names become HF CLIPText names, and ``text_projection`` (stored (D, P),
used as ``x @ W``) becomes a linear weight (P, D). Loading is strict.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn


def _hf_name(k: str) -> str:
    k = k.replace("transformer.resblocks.", "text_model.encoder.layers.")
    k = k.replace(".attn.", ".self_attn.")
    k = k.replace(".ln_1.", ".layer_norm1.").replace(".ln_2.", ".layer_norm2.")
    k = k.replace(".mlp.c_fc.", ".mlp.fc1.").replace(".mlp.c_proj.", ".mlp.fc2.")
    k = k.replace("ln_final.", "text_model.final_layer_norm.")
    return {
        "token_embedding.weight": "text_model.embeddings.token_embedding.weight",
        "positional_embedding": "text_model.embeddings.position_embedding.weight",
        "text_projection": "text_projection.weight",
    }.get(k, k)


def openai_clip_text_state_dict(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """An OpenAI CLIP state dict -> the HF CLIPText names the port's
    ``CLIPTextModel`` loads."""
    out = {}
    for k, v in sd.items():
        if k.startswith("visual.") or k == "logit_scale":
            continue
        v = torch.as_tensor(v)
        if k == "text_projection":
            v = v.t()
        for fused in ("in_proj_weight", "in_proj_bias"):
            if k.endswith("attn." + fused):
                base = _hf_name(k[: -len(fused)])
                suffix = fused.split("_")[-1]
                for name, part in zip(("q_proj", "k_proj", "v_proj"), v.chunk(3, dim=0)):
                    out[f"{base}{name}.{suffix}"] = part
                break
        else:
            out[_hf_name(k)] = v
    return out


def load_openai_clip_text(clip: nn.Module, path: str | Path) -> nn.Module:
    """Load the text tower of an OpenAI CLIP file (``torch.load`` of a state
    dict, or of a module holding one) into ``clip`` strictly."""
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    ref = next(clip.parameters())
    hf = {k: v.to(ref.device, ref.dtype) for k, v in openai_clip_text_state_dict(sd).items()}
    clip.load_state_dict(hf, strict=True)
    return clip
