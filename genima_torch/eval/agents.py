"""The SD-ControlNet diffusion agent: the eval-time wrapper around the pipeline.

Counterpart of ``SDControlNetAgent`` and its ``DiffusionAgent`` lifecycle in
``genima_tpu/eval/agents.py``:

- weights (``_load_params``): the seeded random init on the device, then
  the ``sd_ckpt`` base trees (``params.msgpack``) over it, then the
  fine-tuned ControlNet found by ``find_model_checkpoint(diffusion_ckpt)``,
  each loaded through ``params_from_jax``'s naming rules into the
  pipeline's modules (bf16 on the card);
- the tokenizer (``load_tokenizer(merges, model_dir=sd_ckpt)``) and a
  prompt-embedding cache keyed by the token ids;
- per-episode latents from a ``torch.Generator`` on the device, seeded with
  ``seed`` at every ``new_episode`` (the reference's fixed
  ``torch.Generator(seed)``; the JAX package draws other numbers, so tests
  inject latents);
- ``infer_device`` / ``infer`` with classifier-free guidance, and
  ``fused_generate``, the hook ``eval.fused.FusedGenimaStep`` calls.

SDXL and InstructPix2Pix agents, and the tiny VAE, are not ported yet.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from genima_torch.core import checkpoint as ckpt
from genima_torch.data.tokenizer import load_tokenizer
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig


@dataclasses.dataclass(eq=False)
class SDControlNetAgent:
    """SD-turbo + ControlNet. ``pipe`` defaults to the full-width pipeline
    on ``device``; ``params`` to the weights ``_load_params`` assembles."""

    pipe: Optional[SDControlNetPipeline] = None
    params: Optional[dict] = None
    diffusion_ckpt: Optional[str] = None
    sd_ckpt: Optional[str] = None  # dir with the base models' params.msgpack
    resolution: int = 512
    backend: str = "fused"
    tokenizer_merges: Optional[str] = None
    num_inference_steps: int = 5
    guidance_scale: float = 0.0
    seed: int = 2  # per-episode latent seed (the reference's diffusion_seed)
    autoencoder: str = ""
    device: Any = "cuda"

    def __post_init__(self):
        if self.autoencoder:
            raise NotImplementedError(
                f"autoencoder={self.autoencoder!r}: the tiny VAE is not ported")
        if self.pipe is None:
            self.pipe = SDControlNetPipeline(backend=self.backend, device=self.device)
        self.device = self.pipe.device
        self.tokenizer = load_tokenizer(self.tokenizer_merges, model_dir=self.sd_ckpt)
        if self.params is None:
            self.params = self._load_params()
        self._prompt_cache: dict[tuple, torch.Tensor] = {}  # by token ids
        self._latent_gen: Optional[torch.Generator] = None

    # -- weights ---------------------------------------------------------------

    def _load_params(self) -> dict:
        # the seeded init under the checkpoints: seed 0, as the reference's key(0)
        gen = torch.Generator(device=self.device).manual_seed(0)
        params = self.pipe.init_params(gen)
        if self.sd_ckpt and Path(self.sd_ckpt).exists():
            base = ckpt.load_pytree(Path(self.sd_ckpt) / "params.msgpack")
            for name, tree in base.items():
                if name in params:
                    self.pipe.load_tree(params, name, tree)
        if self.diffusion_ckpt and Path(self.diffusion_ckpt).exists():
            model_dir = ckpt.find_model_checkpoint(self.diffusion_ckpt, "controlnet")
            self.pipe.load_tree(params, "controlnet",
                                ckpt.load_pytree(model_dir / "params.msgpack"))
            print(f"Loaded controlnet checkpoint from {model_dir}")
        return params

    # -- episode RNG -----------------------------------------------------------

    def new_episode(self) -> None:
        self._latent_gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def _next_latents(self, batch: int) -> torch.Tensor:
        if self._latent_gen is None:
            self.new_episode()
        return self.draw_latents(batch, self._latent_gen)

    def draw_latents(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        """(batch, res/f, res/f, 4) standard-normal latents, NHWC (f: the
        VAE's downscale), drawn from ``generator``."""
        lat = self.resolution // self.pipe.vae_scale_factor
        return torch.randn(batch, lat, lat, self.pipe.vae_cfg.latent_channels,
                           generator=generator, device=self.device)

    # -- prompts ---------------------------------------------------------------

    def _embed_prompts(self, prompts: list[str]) -> torch.Tensor:
        return self.embed_prompt_ids(np.asarray(self.tokenizer(list(prompts))))

    def embed_prompt_ids(self, input_ids) -> torch.Tensor:
        """(B, 77) token ids -> cached (B, 77, hidden) prompt embeddings."""
        ids = torch.as_tensor(input_ids, dtype=torch.long)
        key = (tuple(ids.shape), tuple(ids.flatten().tolist()))
        if key not in self._prompt_cache:
            self._prompt_cache[key] = self.pipe.encode_prompt(self.params, ids)
        return self._prompt_cache[key]

    # -- inference -------------------------------------------------------------

    def infer_device(self, images, prompts, negative_prompts=None,
                     num_inference_steps=None, guidance_scale=None) -> torch.Tensor:
        """(B, H, W, 3) uint8 tiled observations -> (B, H, W, 3) uint8
        targets, left on the device; negative prompts are used only when
        the guidance scale is above 1."""
        steps = num_inference_steps or self.num_inference_steps
        guidance = guidance_scale if guidance_scale is not None else self.guidance_scale
        cond = torch.as_tensor(images).to(self.device)  # uint8 is a quarter of the bytes
        if cond.dtype != torch.uint8:
            cond = cond.float() / 255.0
        embeds = self._embed_prompts(prompts)
        neg = None
        if guidance > 1.0 and negative_prompts:
            neg = self._embed_prompts(negative_prompts)
        latents = self._next_latents(cond.shape[0])
        return self.pipe.generate(
            self.params, cond, embeds, latents, num_inference_steps=steps,
            guidance_scale=float(guidance), negative_prompt_embeds=neg,
        )

    def infer(self, images, prompts, negative_prompts=None,
              num_inference_steps=None, guidance_scale=None) -> np.ndarray:
        return self.infer_device(
            images, prompts, negative_prompts, num_inference_steps, guidance_scale
        ).cpu().numpy()

    def fused_generate(self, params, cond, embeds, latents, key,
                       num_inference_steps: int = 5):
        # key unused: Euler-discrete turbo sampling injects no noise
        return self.pipe.generate(
            params, cond, embeds, latents, num_inference_steps=num_inference_steps
        )


def make_tiny_sd_agent(resolution: int = 64, device: Any = "cuda", backend: str = "fused",
                       conv_backend: str = "xla", **kw) -> SDControlNetAgent:
    """Tiny-config agent for tests and smoke runs, f32, targetable from the
    eval CLI (``diffusion_agent._target_``): ``kw`` are the agent's fields
    (``sd_ckpt`` is dropped: base trees of the full-width models do not fit)."""
    pipe = SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(),
        vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(),
        dtype=torch.float32,
        device=device,
        backend=backend,
        conv_backend=conv_backend,
    )
    kw.pop("sd_ckpt", None)
    return SDControlNetAgent(pipe=pipe, resolution=resolution, **kw)
