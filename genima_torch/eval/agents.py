"""The diffusion agents: the eval-time wrappers around the pipelines.

Counterpart of ``SDControlNetAgent``, ``SDXLControlNetAgent`` and their
``DiffusionAgent`` lifecycle in ``genima_tpu/eval/agents.py``:

- weights (``_load_params``): the seeded random init on the device, then
  the ``sd_ckpt`` base trees (``params.msgpack``) over it, then the
  fine-tuned ControlNet found by ``find_model_checkpoint(diffusion_ckpt)``,
  each loaded through ``params_from_jax``'s naming rules into the
  pipeline's modules, in the agent's ``dtype`` (the reference's field:
  ``None`` is ``default_dtype``, bf16 on the card; ``torch.float32`` keeps
  an f32 pipeline and an f32 tree, which sends f32 through the kernels);
- the tokenizer (``load_tokenizer(merges, model_dir=sd_ckpt)``) and a
  prompt-embedding cache keyed by the token ids;
- per-episode latents from a ``torch.Generator`` on the device, seeded with
  ``seed`` at every ``new_episode`` (the reference's fixed
  ``torch.Generator(seed)``; the JAX package draws other numbers, so tests
  inject latents);
- ``infer_device`` / ``infer`` with classifier-free guidance, and
  ``fused_generate``, the hook ``eval.fused.FusedGenimaStep`` calls;
- for SDXL, a second per-episode generator, seeded ``seed + 1``, for the
  ancestral noise (``draw_noise``: one block per denoise step), so that
  drawing it leaves the latent stream as it was; prompt embeddings are the
  (hidden, pooled) pair;
- ``SDPix2PixAgent``: the fine-tuned submodel is the UNet (``unet/``),
  the observation conditions the sampler in [-1, 1], and no noise is drawn;
- ``autoencoder="taesd"`` builds the pipeline with ``use_tiny_vae`` (the
  tiny VAE decodes), its weights from ``sd_ckpt``'s ``tiny_vae`` tree when
  there is one.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from genima_torch.core import checkpoint as ckpt
from genima_torch.data.tokenizer import load_tokenizer
from genima_torch.diffusion.pipeline import (
    SDControlNetPipeline, SDPix2PixPipeline, SDXLControlNetPipeline,
)
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig
from genima_torch.nn.vae import VAEConfig


@dataclasses.dataclass(eq=False)
class SDControlNetAgent:
    """SD-turbo + ControlNet. ``pipe`` defaults to the full-width pipeline
    on ``device``; ``params`` to the weights ``_load_params`` assembles."""

    PIPELINE = SDControlNetPipeline
    SUBMODEL = "controlnet"  # the fine-tuned model diffusion_ckpt holds

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
    autoencoder: str = ""  # "taesd": decode with the tiny VAE
    device: Any = "cuda"
    # the pipeline's and the weights' dtype; None: the pipeline's default
    # (bf16 on the card, f32 on the CPU), or the given pipe's own
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.pipe is None:
            given = {} if self.dtype is None else {"dtype": self.dtype}
            self.pipe = self.PIPELINE(backend=self.backend, device=self.device,
                                      use_tiny_vae=self.autoencoder == "taesd", **given)
        elif self.dtype is not None and self.dtype != self.pipe.dtype:
            raise ValueError(f"dtype {self.dtype} does not match the pipe's {self.pipe.dtype}")
        self.device = self.pipe.device
        self.dtype = self.pipe.dtype
        self.tokenizer = load_tokenizer(self.tokenizer_merges, model_dir=self.sd_ckpt)
        if self.params is None:
            self.params = self._load_params()
        self._prompt_cache: dict[tuple, torch.Tensor] = {}  # by token ids
        self._latent_gen: Optional[torch.Generator] = None
        self._noise_gen: Optional[torch.Generator] = None  # SDXL's ancestral noise

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
            model_dir = ckpt.find_model_checkpoint(self.diffusion_ckpt, self.SUBMODEL)
            self.pipe.load_tree(params, self.SUBMODEL,
                                ckpt.load_pytree(model_dir / "params.msgpack"))
            print(f"Loaded {self.SUBMODEL} checkpoint from {model_dir}")
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

    def draw_noise(self, steps: int, batch: int, generator: torch.Generator):
        """The sampler's in-loop noise for one generate: none (Euler
        discrete injects none)."""
        return None

    def _next_noise(self, batch: int, steps: int):
        return None

    # -- prompts ---------------------------------------------------------------

    def _embed_prompts(self, prompts: list[str]) -> torch.Tensor:
        return self.embed_prompt_ids(np.asarray(self.tokenizer(list(prompts))))

    def embed_prompt_ids(self, input_ids) -> torch.Tensor:
        """(B, 77) token ids -> cached prompt embeddings: (B, 77, hidden),
        or SDXL's ((B, 77, hidden), (B, pooled))."""
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

    def fused_generate(self, params, cond, embeds, latents, noise,
                       num_inference_steps: int = 5):
        # noise unused: Euler-discrete turbo sampling injects none
        return self.pipe.generate(
            params, cond, embeds, latents, num_inference_steps=num_inference_steps
        )


@dataclasses.dataclass(eq=False)
class SDXLControlNetAgent(SDControlNetAgent):
    """SDXL-turbo + ControlNet: prompt embeddings are (hidden, pooled), and
    each generate takes one ancestral-noise block a denoise step from the
    episode's noise generator (seeded ``seed + 1``). No guidance."""

    PIPELINE = SDXLControlNetPipeline

    def new_episode(self) -> None:
        super().new_episode()
        self._noise_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)

    def draw_noise(self, steps: int, batch: int, generator: torch.Generator) -> torch.Tensor:
        """(steps, batch, res/f, res/f, 4) standard-normal ancestral noise,
        NHWC, drawn from ``generator``."""
        lat = self.resolution // self.pipe.vae_scale_factor
        return torch.randn(steps, batch, lat, lat, self.pipe.vae_cfg.latent_channels,
                           generator=generator, device=self.device)

    def _next_noise(self, batch: int, steps: int) -> torch.Tensor:
        if self._noise_gen is None:
            self._noise_gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        return self.draw_noise(steps, batch, self._noise_gen)

    def infer_device(self, images, prompts, negative_prompts=None,
                     num_inference_steps=None, guidance_scale=None) -> torch.Tensor:
        """(B, H, W, 3) uint8 tiled observations -> (B, H, W, 3) uint8
        targets on the device; turbo sampling ignores the negative prompts
        and the guidance scale, as the reference's SDXL agent does."""
        steps = num_inference_steps or self.num_inference_steps
        cond = torch.as_tensor(images).to(self.device)
        if cond.dtype != torch.uint8:
            cond = cond.float() / 255.0
        embeds = self._embed_prompts(prompts)
        latents = self._next_latents(cond.shape[0])
        noise = self._next_noise(cond.shape[0], steps)
        return self.fused_generate(self.params, cond, embeds, latents, noise,
                                   num_inference_steps=steps)

    def fused_generate(self, params, cond, embeds, latents, noise,
                       num_inference_steps: int = 5):
        hidden, pooled = embeds
        return self.pipe.generate(params, cond, hidden, pooled, latents, noise,
                                  num_inference_steps=num_inference_steps)


@dataclasses.dataclass(eq=False)
class SDPix2PixAgent(SDControlNetAgent):
    """InstructPix2Pix: the fine-tuned UNet is the submodel (``unet/``);
    the observation conditions the sampler in [-1, 1]; no noise is drawn."""

    PIPELINE = SDPix2PixPipeline
    SUBMODEL = "unet"

    def infer_device(self, images, prompts, negative_prompts=None,
                     num_inference_steps=None, guidance_scale=None) -> torch.Tensor:
        """(B, H, W, 3) uint8 tiled observations (float ones in [0, 255])
        -> (B, H, W, 3) uint8 targets on the device; no guidance, as the
        reference's pix2pix agent."""
        steps = num_inference_steps or self.num_inference_steps
        cond = torch.as_tensor(images).to(self.device)
        if cond.dtype != torch.uint8:
            cond = cond.float() / 127.5 - 1.0
        embeds = self._embed_prompts(prompts)
        latents = self._next_latents(cond.shape[0])
        return self.pipe.generate(self.params, cond, embeds, latents,
                                  num_inference_steps=steps)

    def fused_generate(self, params, cond, embeds, latents, noise,
                       num_inference_steps: int = 5):
        # noise unused: pix2pix turbo sampling injects none
        return self.pipe.generate(params, cond, embeds, latents,
                                  num_inference_steps=num_inference_steps)


def make_tiny_sd_agent(resolution: int = 64, device: Any = "cuda", backend: str = "fused",
                       conv_backend: str = "xla", **kw) -> SDControlNetAgent:
    """Tiny-config agent for tests and smoke runs, f32, targetable from the
    eval CLI (``diffusion_agent._target_``): ``kw`` are the agent's fields
    (``sd_ckpt`` is dropped: base trees of the full-width models do not fit;
    ``autoencoder="taesd"`` gives the pipeline its tiny VAE)."""
    pipe = SDControlNetPipeline(
        unet_cfg=UNetConfig.tiny(),
        vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(),
        dtype=torch.float32,
        device=device,
        backend=backend,
        conv_backend=conv_backend,
        use_tiny_vae=kw.get("autoencoder") == "taesd",
    )
    kw.pop("sd_ckpt", None)
    return SDControlNetAgent(pipe=pipe, resolution=resolution, **kw)


def make_tiny_sdxl_agent(resolution: int = 64, device: Any = "cuda", backend: str = "fused",
                         conv_backend: str = "xla", **kw) -> SDXLControlNetAgent:
    """Tiny-config SDXL agent (the reference's ``make_tiny_sdxl_agent``
    widths), f32, targetable from the eval CLI like ``make_tiny_sd_agent``."""
    pipe = SDXLControlNetPipeline(
        unet_cfg=UNetConfig.tiny(
            addition_embed_type="text_time", addition_time_embed_dim=8,
            cross_attention_dim=48,
            projection_class_embeddings_input_dim=16 + 6 * 8,  # pooled 16, 6 ids x 8
        ),
        vae_cfg=VAEConfig.tiny_test(scaling_factor=0.13025),
        text_cfg=CLIPTextConfig.tiny(hidden_size=16, num_heads=2),
        text_cfg_2=CLIPTextConfig.tiny(hidden_size=32, projection_dim=16),
        dtype=torch.float32,
        device=device,
        backend=backend,
        conv_backend=conv_backend,
        use_tiny_vae=kw.get("autoencoder") == "taesd",
    )
    kw.pop("sd_ckpt", None)
    return SDXLControlNetAgent(pipe=pipe, resolution=resolution, **kw)


def make_tiny_pix2pix_agent(resolution: int = 64, device: Any = "cuda", backend: str = "fused",
                            **kw) -> SDPix2PixAgent:
    """Tiny-config InstructPix2Pix agent (the reference's
    ``make_tiny_pix2pix_agent`` widths), f32, targetable from the eval CLI
    like ``make_tiny_sd_agent``."""
    pipe = SDPix2PixPipeline(
        unet_cfg=UNetConfig.tiny(in_channels=8),
        vae_cfg=VAEConfig.tiny_test(),
        text_cfg=CLIPTextConfig.tiny(),
        dtype=torch.float32,
        device=device,
        backend=backend,
        use_tiny_vae=kw.get("autoencoder") == "taesd",
    )
    kw.pop("sd_ckpt", None)
    return SDPix2PixAgent(pipe=pipe, resolution=resolution, **kw)
