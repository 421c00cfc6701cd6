"""SD-turbo + ControlNet sampling: the diffusion half of the control step.

Counterpart of ``SDControlNetPipeline`` in
``genima_tpu/diffusion/pipeline.py``. The pipeline holds configuration; its
``params`` are a dict of modules (``unet``, ``controlnet``, ``vae``,
``text_encoder``) built by ``init_params`` or ``params_from_jax``, playing
the part of the reference's param trees. Classifier-free guidance runs as
the reference's does: with ``guidance_scale > 1`` and negative prompt
embeddings the batch doubles to [negative, positive] (Genima evaluates at
``guidance_scale: 0.0``, which skips it). Latents are always passed in; the
batch decodes in one pass (the reference's ``decode_mode="auto"`` window
works around a TPU conv lowering).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from genima_torch import default_dtype, resolve_device
from genima_torch.data.tiling import denormalize_to_uint8
from genima_torch.diffusion.schedulers import EulerDiscreteScheduler
from genima_torch.nn.clip_text import CLIPTextConfig, CLIPTextModel
from genima_torch.nn.controlnet import ControlNetModel, embed_conditioning
from genima_torch.nn.layers import split_backend
from genima_torch.nn.unet import UNet2DConditionModel, UNetConfig
from genima_torch.nn.vae import DECODE_SUBTREES, AutoencoderKL, VAEConfig
from genima_torch.weights.from_jax import drop_subtrees, load_from_jax
from genima_torch.weights.init import build_module, init_random_
from genima_torch.weights.quantize import quantize_pipeline_params

_FAMILIES = {
    "unet": "diffusers_unet",
    "controlnet": "diffusers_controlnet",
    "vae": "diffusers_vae",
    "text_encoder": "hf_clip",
}


@dataclasses.dataclass(eq=False)
class SDControlNetPipeline:
    unet_cfg: UNetConfig = dataclasses.field(default_factory=UNetConfig.sd21)
    vae_cfg: VAEConfig = dataclasses.field(default_factory=VAEConfig.sd)
    text_cfg: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig.sd21)
    scheduler: Any = dataclasses.field(default_factory=EulerDiscreteScheduler)
    dtype: Optional[torch.dtype] = None  # bf16 on the card, f32 on the CPU
    # "fused": long self-attention through the packed CUDA kernel;
    # "pallas": every attention through the flash kernel, "pallas_self":
    # self-attention only; "xla": everything through the library attention.
    # "+w8" on any of them: int8 transformer linears (params from
    # init_params, or a JAX tree from weights/quantize.py)
    backend: str = "fused"
    # VAE decoder convs: "xla" the library convs, "fused" the GN-SiLU-conv3x3
    # kernel (same params)
    conv_backend: str = "xla"
    device: Any = "cuda"
    # build the VAE's encode half too (the trainer encodes target images;
    # serving only decodes)
    vae_encoder: bool = False

    def __post_init__(self):
        split_backend(self.backend)  # raises on an unknown spec
        self.device = resolve_device(self.device)
        if self.dtype is None:
            self.dtype = default_dtype(self.device)
        # one stride-2 conditioning stage per VAE downsample (3 for SD's 8x)
        self.cond_channels = (16, 32, 96, 256)[: len(self.vae_cfg.block_out_channels)]

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.vae_cfg.block_out_channels) - 1)

    def _build(self, backend: Optional[str] = None) -> dict[str, nn.Module]:
        backend = backend or self.backend
        factories = {
            "unet": lambda: UNet2DConditionModel(self.unet_cfg, backend),
            "controlnet": lambda: ControlNetModel(self.unet_cfg, self.cond_channels, backend),
            "vae": lambda: AutoencoderKL(
                self.vae_cfg, encoder=self.vae_encoder, conv_backend=self.conv_backend
            ),
            "text_encoder": lambda: CLIPTextModel(self.text_cfg),
        }
        return {k: build_module(f, self.device, self.dtype) for k, f in factories.items()}

    def init_params(self, generator: torch.Generator) -> dict[str, nn.Module]:
        """All four models with seeded scaled-normal weights, on the device.
        Under ``+w8`` the float weights are drawn, then quantized, so the
        int8 linears hold real values (the reference's ``W8Dense`` init is
        all zeros)."""
        attn, w8 = split_backend(self.backend)
        params = {k: init_random_(m, generator) for k, m in self._build(attn).items()}
        return quantize_pipeline_params(params) if w8 else params

    def params_from_jax(self, tree: dict) -> dict[str, nn.Module]:
        """The four models loaded from the reference's param trees (numpy
        leaves; quantized UNet and ControlNet trees under ``+w8``)."""
        params = self._build()
        for name in params:
            self.load_tree(params, name, tree[name])
        return params

    def load_tree(self, params: dict[str, nn.Module], name: str, tree: dict) -> None:
        """Load one model of ``params`` in place from the reference's tree;
        without ``vae_encoder`` the VAE keeps only its decode subtrees."""
        if name == "vae" and not self.vae_encoder:
            tree = drop_subtrees(tree, DECODE_SUBTREES, keep=True)
        load_from_jax(params[name], tree, _FAMILIES[name])

    @torch.inference_mode()
    def encode_prompt(self, params: dict, input_ids) -> torch.Tensor:
        """(B, 77) token ids -> (B, 77, hidden) prompt embeddings."""
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
        return params["text_encoder"](ids).last_hidden_state

    @torch.inference_mode()
    def generate(
        self,
        params: dict,
        cond_image: torch.Tensor,  # (B, H, W, 3) uint8, or float in [0, 1]
        prompt_embeds: torch.Tensor,  # (B, 77, hidden)
        latents: torch.Tensor,  # (B, H/8, W/8, 4) standard normal, NHWC
        num_inference_steps: int = 5,
        guidance_scale: float = 0.0,
        negative_prompt_embeds: Optional[torch.Tensor] = None,  # (B, 77, hidden)
    ) -> torch.Tensor:
        """Denoise loop + VAE decode: (B, H, W, 3) uint8 targets."""
        unet, controlnet = params["unet"], params["controlnet"]
        state = self.scheduler.set_timesteps(num_inference_steps)
        do_cfg = guidance_scale > 1.0 and negative_prompt_embeds is not None
        cond = cond_image.to(self.device)
        if cond.dtype == torch.uint8:
            cond = cond.to(self.dtype) / 255.0
        cond = cond.to(self.dtype).permute(0, 3, 1, 2).contiguous()
        embeds = prompt_embeds.to(self.device, self.dtype)
        if do_cfg:
            embeds = torch.cat([negative_prompt_embeds.to(self.device, self.dtype), embeds])
        # loop-invariant: the conditioning CNN runs once, outside the loop
        cond_emb = embed_conditioning(controlnet, cond)
        if do_cfg:
            cond_emb = torch.cat([cond_emb, cond_emb])

        sample = latents.to(self.device, torch.float32).permute(0, 3, 1, 2).contiguous()
        sample = sample * float(state.init_noise_sigma)
        for i in range(num_inference_steps):
            model_in = self.scheduler.scale_model_input(state, sample, i)
            if do_cfg:
                model_in = torch.cat([model_in, model_in])
            model_in = model_in.to(self.dtype)
            t = torch.full(
                (model_in.shape[0],), float(state.timesteps[i]), device=self.device
            )
            down_res, mid_res = controlnet(model_in, t, embeds, cond_emb, cond_is_embedded=True)
            eps = unet(
                model_in, t, embeds,
                down_block_additional_residuals=down_res,
                mid_block_additional_residual=mid_res,
            )
            if do_cfg:
                eps_uncond, eps_text = eps.chunk(2)
                eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
            sample = self.scheduler.step(state, eps.float(), i, sample)

        z = (sample / self.vae_cfg.scaling_factor).to(self.dtype)
        image = params["vae"].decode(z).float().permute(0, 2, 3, 1).contiguous()
        return denormalize_to_uint8(image)
