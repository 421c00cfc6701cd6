"""The SD-ControlNet diffusion agent's serving surface.

Counterpart of ``SDControlNetAgent`` in ``genima_tpu/eval/agents.py``:
``fused_generate`` (the hook ``eval.fused.FusedGenimaStep`` calls) and a
prompt cache keyed by token ids. Tokenisation and checkpoint discovery come
with the serial-eval slice; callers pass token ids and params.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig


@dataclasses.dataclass(eq=False)
class SDControlNetAgent:
    """SD-turbo + ControlNet. ``params`` default to seeded random weights
    on the pipeline's device."""

    pipe: SDControlNetPipeline
    params: Optional[dict] = None
    seed: int = 0

    def __post_init__(self):
        if self.params is None:
            gen = torch.Generator(device=self.pipe.device).manual_seed(self.seed)
            self.params = self.pipe.init_params(gen)
        self._prompt_cache: dict[tuple, torch.Tensor] = {}

    def embed_prompt_ids(self, input_ids) -> torch.Tensor:
        """(B, 77) token ids -> cached (B, 77, hidden) prompt embeddings."""
        ids = torch.as_tensor(input_ids, dtype=torch.long)
        key = (tuple(ids.shape), tuple(ids.flatten().tolist()))
        if key not in self._prompt_cache:
            self._prompt_cache[key] = self.pipe.encode_prompt(self.params, ids)
        return self._prompt_cache[key]

    def fused_generate(self, params, cond, embeds, latents, key,
                       num_inference_steps: int = 5):
        # key unused: Euler-discrete turbo sampling injects no noise
        return self.pipe.generate(
            params, cond, embeds, latents, num_inference_steps=num_inference_steps
        )


def make_tiny_sd_agent(device: Any = "cuda", seed: int = 0, **pipeline_kw) -> SDControlNetAgent:
    """Tiny-config agent for tests and smoke runs, f32; ``pipeline_kw``
    (``backend``, ``conv_backend``, ...) go to the pipeline."""
    pipe = SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(),
        vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(),
        dtype=torch.float32,
        device=device,
        **pipeline_kw,
    )
    return SDControlNetAgent(pipe=pipe, seed=seed)
