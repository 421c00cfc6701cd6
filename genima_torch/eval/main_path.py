"""The main path at full width: sd-turbo (or sdxl-turbo, or SD-1.5's
geometry) ControlNet + VAE + ACT, or the InstructPix2Pix UNet + VAE + ACT,
random weights.

``build_main_path`` assembles what a user of the fused control step would:
an ``SDControlNetAgent`` at SD-2.1 / sd-turbo width (``UNetConfig.sd21``,
``VAEConfig.sd``, ``CLIPTextConfig.sd21``), with ``variant="sdxl"`` an
``SDXLControlNetAgent`` at sdxl-turbo width (``UNetConfig.sdxl``,
``VAEConfig.sdxl``, ``CLIPTextConfig.sdxl_one`` + ``sdxl_two``), or with
``variant="pix2pix"`` an ``SDPix2PixAgent`` (``UNetConfig.pix2pix``: sd-turbo
width, 8 input channels; the VAE with its encoder), with ``variant="sd15"``
an ``SDControlNetAgent`` on ``sd15_pipeline`` (``UNetConfig.sd15``: 8 heads
at 320/640/1280 channels, head dims 40/80/160; ``CLIPTextConfig.sd15``: the
768-wide CLIP-L; the SD VAE), with ``variant="pix2pix15"`` an
``SDPix2PixAgent`` on ``pix2pix15_pipeline`` (InstructPix2Pix at SD-1.5
geometry, the layout of the public instruct-pix2pix model:
``UNetConfig.sd15(in_channels=8)``, ``CLIPTextConfig.sd15``), with ``variant="sd_wide"`` an
``SDControlNetAgent`` on ``wide_head_pipeline`` (sd-turbo's widths in
fewer, wider heads: ``UNetConfig.sd21(num_heads=(1, 1, 2, 2))``, head dims
320 and 640, past the 256 columns a block of the narrow attention kernels
holds), a
``GenimaACTAgent`` (``ACTConfig()``, ViT-B/32 text tower, ResNet-18 width
64) and a ``FusedGenimaStep`` over four 256x256 views, with seeded
scaled-normal weights made on the device and seeded inputs: a 512x512 uint8
tiled observation, standard-normal latents (and SDXL's ancestral noise),
qpos and token ids. ``chip_smoke.py`` and ``genima_torch.profile_step``
drive it.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from genima_torch.control.policy import GenimaACTAgent
from genima_torch.diffusion.pipeline import SDControlNetPipeline, SDPix2PixPipeline
from genima_torch.eval.agents import SDControlNetAgent, SDPix2PixAgent, SDXLControlNetAgent
from genima_torch.eval.fused import FusedGenimaStep
from genima_torch.nn.clip_text import CLIPTextConfig
from genima_torch.nn.unet import UNetConfig

RESOLUTION = 512
OBS_SIZE = 256
EOT_ID = 49407  # CLIP end-of-text, the highest id: where the text towers pool


def sd15_pipeline(**kw) -> SDControlNetPipeline:
    """SD-1.5 geometry, as a JAX user builds it: ``SDControlNetPipeline``
    with ``UNetConfig.sd15()`` and ``CLIPTextConfig.sd15()`` in its config
    fields (the SD VAE); ``kw`` as the pipeline's own."""
    return SDControlNetPipeline(unet_cfg=UNetConfig.sd15(), text_cfg=CLIPTextConfig.sd15(), **kw)


class SD15ControlNetAgent(SDControlNetAgent):
    """``SDControlNetAgent`` on ``sd15_pipeline``."""

    PIPELINE = staticmethod(sd15_pipeline)


def wide_head_pipeline(**kw) -> SDControlNetPipeline:
    """sd-turbo's widths in wider heads, as a JAX user builds them from the
    config alone: ``SDControlNetPipeline`` with ``UNetConfig.sd21(num_heads=
    (1, 1, 2, 2))`` (head dims 320 at the 4096-token level, 640 at the
    1024-, 256- and 64-token ones: five and ten 64-column atoms; the
    ControlNet copies the UNet's config); ``kw`` as the pipeline's own."""
    return SDControlNetPipeline(unet_cfg=UNetConfig.sd21(num_heads=(1, 1, 2, 2)), **kw)


class WideHeadControlNetAgent(SDControlNetAgent):
    """``SDControlNetAgent`` on ``wide_head_pipeline``."""

    PIPELINE = staticmethod(wide_head_pipeline)


def pix2pix15_pipeline(**kw) -> SDPix2PixPipeline:
    """InstructPix2Pix at SD-1.5 geometry, as a JAX user builds it:
    ``SDPix2PixPipeline`` with ``UNetConfig.sd15(in_channels=8)`` and
    ``CLIPTextConfig.sd15()`` in its config fields; ``kw`` as the
    pipeline's own."""
    return SDPix2PixPipeline(unet_cfg=UNetConfig.sd15(in_channels=8),
                             text_cfg=CLIPTextConfig.sd15(), **kw)


class SD15Pix2PixAgent(SDPix2PixAgent):
    """``SDPix2PixAgent`` on ``pix2pix15_pipeline``."""

    PIPELINE = staticmethod(pix2pix15_pipeline)


VARIANTS = {"sd": SDControlNetAgent, "sdxl": SDXLControlNetAgent, "pix2pix": SDPix2PixAgent,
            "sd15": SD15ControlNetAgent, "pix2pix15": SD15Pix2PixAgent,
            "sd_wide": WideHeadControlNetAgent}


def build_main_path(device: Any = "cuda", seed: int = 0, backend: str = "fused",
                    conv_backend: str = "xla", n_envs: int = 1, variant: str = "sd",
                    resolution: int = RESOLUTION, dtype: Optional[torch.dtype] = None):
    """Returns ``(step, args)``; ``step(**args)`` runs one control step.
    ``backend`` and ``conv_backend`` are the pipeline's (the default path, or
    the opt-in serving configuration ``"pallas+w8"`` / ``"fused"``, whose
    int8 weights ``init_params`` quantizes from the seeded floats). With
    ``n_envs > 1`` the step is ``eval.parallel.BatchedGenimaStep`` and each
    input holds one row per env (frame stack 1), each row drawn apart.
    ``variant="sdxl"``: ``prompt_embeds`` is the (hidden, pooled) pair and
    ``noise`` the (5, n, 64, 64, 4) ancestral noise. ``resolution`` is the
    tiled observation's side (the eval CLI's ``image_resolution``: 768 gives
    96x96 latents and 384x384 views, resized to ``OBS_SIZE`` for ACT).
    ``dtype`` is the diffusion pipeline's (the agents' field: ``None`` is
    bf16 on the card; ``torch.float32`` sends f32 through every kernel)."""
    agent_cls = VARIANTS[variant]
    given = {} if dtype is None else {"dtype": dtype}
    pipe = agent_cls.PIPELINE(device=device, backend=backend, conv_backend=conv_backend, **given)
    dag = agent_cls(
        pipe, params=pipe.init_params(torch.Generator(device=pipe.device).manual_seed(seed)),
        resolution=resolution)
    device = dag.pipe.device
    act_agent = GenimaACTAgent(device=device)
    act_params, clip = act_agent.init_params(
        torch.Generator(device=device).manual_seed(seed + 1)
    )
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    lat = resolution // dag.pipe.vae_scale_factor
    n = n_envs
    ids = torch.randint(0, EOT_ID - 1, (2 * n, 77), generator=gen, device=device)
    ids[:, 12] = EOT_ID
    args = dict(
        diffusion_params=dag.params,
        controller_params=act_params,
        clip_params=clip,
        tiled_u8=torch.randint(0, 256, (n, resolution, resolution, 3), generator=gen,
                               device=device, dtype=torch.uint8),
        prompt_embeds=dag.embed_prompt_ids(ids[:n].cpu()),
        latents=torch.randn(n, lat, lat, 4, generator=gen, device=device),
        qpos=torch.randn(n, 8, generator=gen, device=device),
        lang_tokens=ids[n:],
        noise=dag.draw_noise(5, n, gen),
        num_inference_steps=5,
    )
    if n == 1:
        return FusedGenimaStep(dag, act_agent, obs_size=OBS_SIZE), args
    from genima_torch.eval.parallel import BatchedGenimaStep

    return BatchedGenimaStep(dag, act_agent, obs_size=OBS_SIZE), args
