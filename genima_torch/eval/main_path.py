"""The main path at full width: sd-turbo ControlNet + VAE + ACT, random weights.

``build_main_path`` assembles what a user of the fused control step would:
an ``SDControlNetAgent`` at SD-2.1 / sd-turbo width (``UNetConfig.sd21``,
``VAEConfig.sd``, ``CLIPTextConfig.sd21``), a ``GenimaACTAgent`` (``ACTConfig()``,
ViT-B/32 text tower, ResNet-18 width 64) and a ``FusedGenimaStep`` over four
256x256 views, with seeded scaled-normal weights made on the device and
seeded inputs: a 512x512 uint8 tiled observation, standard-normal latents,
qpos and token ids. ``chip_smoke.py`` and ``genima_torch.profile_step`` drive
it.
"""

from __future__ import annotations

from typing import Any

import torch

from genima_torch.control.policy import GenimaACTAgent
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.eval.agents import SDControlNetAgent
from genima_torch.eval.fused import FusedGenimaStep

RESOLUTION = 512
OBS_SIZE = 256
EOT_ID = 49407  # CLIP end-of-text, the highest id: where the text towers pool


def build_main_path(device: Any = "cuda", seed: int = 0, backend: str = "fused",
                    conv_backend: str = "xla"):
    """Returns ``(step, args)``; ``step(**args)`` runs one control step.
    ``backend`` and ``conv_backend`` are the pipeline's (the default path, or
    the opt-in serving configuration ``"pallas+w8"`` / ``"fused"``, whose
    int8 weights ``init_params`` quantizes from the seeded floats)."""
    pipe = SDControlNetPipeline(device=device, backend=backend, conv_backend=conv_backend)
    dag = SDControlNetAgent(pipe, seed=seed)
    device = dag.pipe.device
    act_agent = GenimaACTAgent(device=device)
    act_params, clip = act_agent.init_params(
        torch.Generator(device=device).manual_seed(seed + 1)
    )
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    lat = RESOLUTION // dag.pipe.vae_scale_factor
    ids = torch.randint(0, EOT_ID - 1, (2, 77), generator=gen, device=device)
    ids[:, 12] = EOT_ID
    args = dict(
        diffusion_params=dag.params,
        controller_params=act_params,
        clip_params=clip,
        tiled_u8=torch.randint(0, 256, (1, RESOLUTION, RESOLUTION, 3), generator=gen,
                               device=device, dtype=torch.uint8),
        prompt_embeds=dag.embed_prompt_ids(ids[:1].cpu()),
        latents=torch.randn(1, lat, lat, 4, generator=gen, device=device),
        qpos=torch.randn(1, 8, generator=gen, device=device),
        lang_tokens=ids[1:],
        num_inference_steps=5,
    )
    return FusedGenimaStep(dag, act_agent, obs_size=OBS_SIZE), args
