"""The Genima control step: tiled observation -> target image -> actions.

Counterpart of ``genima_tpu/eval/fused.py::FusedGenimaStep``, with the same
call signature: the 5-step ControlNet denoise loop and VAE decode, the
untile into camera views, and the ACT forward, in one call under
``torch.inference_mode``. The serial harness calls it for one environment
(n = 1); ``eval.parallel.BatchedGenimaStep`` is the same call for n
environments' rows stacked env-major.
"""

from __future__ import annotations

import torch

from genima_torch.data.tiling import untile_to_cameras


class FusedGenimaStep:
    """generate + untile + act. Built from a diffusion agent exposing
    ``fused_generate`` (``eval.agents``) and a controller agent
    (``control.policy.GenimaACTAgent``)."""

    def __init__(self, diffusion_agent, controller_agent, obs_size: int = 256):
        self.diffusion_agent = diffusion_agent
        self.pipe = diffusion_agent.pipe
        self._gen = diffusion_agent.fused_generate
        self.controller = controller_agent
        self.obs_size = obs_size

    @torch.inference_mode()
    def __call__(
        self,
        diffusion_params,
        controller_params,
        clip_params,
        tiled_u8,  # (n*fs, 2S, 2S, 3) uint8
        prompt_embeds,  # (n*fs, 77, hidden), or SDXL's (that, (n*fs, pooled))
        latents,  # (n*fs, h, w, 4)
        qpos,  # (n, state_dim*fs)
        lang_tokens,  # (n, 77)
        noise=None,  # SDXL's ancestral noise (steps, n*fs, h, w, 4); else None
        num_inference_steps: int = 5,
    ):
        target = self._gen(
            diffusion_params, tiled_u8, prompt_embeds, latents, noise,
            num_inference_steps=num_inference_steps,
        )  # (n*fs, 2S, 2S, 3) uint8
        cams = untile_to_cameras(target.float(), target_size=self.obs_size)  # (n*fs, V, S, S, 3)
        n, s = qpos.shape[0], self.obs_size
        fs, v = cams.shape[0] // n, cams.shape[1]
        # per env: camera-major, then frame order
        act_images = cams.reshape(n, fs, v, s, s, 3).transpose(1, 2).reshape(n, v * fs, s, s, 3)
        actions = self.controller._act_impl(
            controller_params, clip_params, act_images, qpos, lang_tokens
        )
        return actions, target
