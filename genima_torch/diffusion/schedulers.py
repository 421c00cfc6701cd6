"""Euler-discrete sampling (sd-turbo's scheduler) for the port.

Counterpart of ``EulerDiscreteScheduler`` in
``genima_tpu/diffusion/schedulers.py``. The timestep and sigma tables are
built in float64 numpy and stored as float32, exactly as the reference builds
them; the per-step coefficients are float32 numpy scalars, so the tensor
arithmetic matches the reference's f32 step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Stable-Diffusion defaults (v1/v2/turbo share these)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear"
    prediction_type: str = "epsilon"  # or "v_prediction": the trainer's target
    timestep_spacing: str = "leading"  # "leading" | "trailing" | "linspace"
    steps_offset: int = 1


def make_alphas_cumprod(config: SchedulerConfig) -> np.ndarray:
    """SD's "scaled_linear" betas (linear in sqrt(beta)), or "linear"."""
    n = config.num_train_timesteps
    if config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start**0.5, config.beta_end**0.5, n, dtype=np.float64) ** 2
    elif config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, n, dtype=np.float64)
    else:
        raise ValueError(f"Unknown beta_schedule {config.beta_schedule}")
    return np.cumprod(1.0 - betas).astype(np.float32)


def _acp(alphas_cumprod: torch.Tensor, sample: torch.Tensor, timesteps: torch.Tensor):
    acp = alphas_cumprod.to(sample.device)[timesteps].to(sample.dtype)
    return acp.reshape(acp.shape + (1,) * (sample.ndim - acp.ndim))


def add_noise(alphas_cumprod: torch.Tensor, sample: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0); ``timesteps`` is (B,) int and indexes
    ``alphas_cumprod`` (which must hold every value: torch indexing raises
    where the reference's gather would clamp)."""
    acp = _acp(alphas_cumprod, sample, timesteps)
    return torch.sqrt(acp) * sample + torch.sqrt(1.0 - acp) * noise


def get_velocity(alphas_cumprod: torch.Tensor, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps: torch.Tensor) -> torch.Tensor:
    """The v-prediction target (Salimans & Ho): sqrt(acp) noise - sqrt(1 - acp) x_0."""
    acp = _acp(alphas_cumprod, sample, timesteps)
    return torch.sqrt(acp) * noise - torch.sqrt(1.0 - acp) * sample


def _spaced_timesteps(config: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Inference timesteps, descending, per diffusers spacing conventions."""
    n_train, n = config.num_train_timesteps, num_inference_steps
    if config.timestep_spacing == "linspace":
        ts = np.linspace(0, n_train - 1, n, dtype=np.float64)[::-1]
    elif config.timestep_spacing == "leading":
        step_ratio = n_train // n
        ts = (np.arange(0, n) * step_ratio).round()[::-1].astype(np.float64)
        ts += config.steps_offset
    elif config.timestep_spacing == "trailing":
        step_ratio = n_train / n
        ts = np.arange(n_train, 0, -step_ratio).round().astype(np.float64) - 1
    else:
        raise ValueError(f"Unknown timestep_spacing {config.timestep_spacing}")
    return ts.copy()


class EulerState(NamedTuple):
    timesteps: np.ndarray  # (n,) float32, the value passed to the UNet
    sigmas: np.ndarray  # (n+1,) float32 with a trailing 0.0
    init_noise_sigma: np.float32


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler:
    config: SchedulerConfig = SchedulerConfig(timestep_spacing="trailing")

    def set_timesteps(self, num_inference_steps: int) -> EulerState:
        acp = make_alphas_cumprod(self.config).astype(np.float64)
        sigmas_full = np.sqrt((1 - acp) / acp)
        ts = _spaced_timesteps(self.config, num_inference_steps)
        sigmas = np.interp(ts, np.arange(len(sigmas_full)), sigmas_full)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        max_sigma = sigmas.max()
        if self.config.timestep_spacing in ("linspace", "trailing"):
            init_noise_sigma = max_sigma
        else:
            init_noise_sigma = np.sqrt(max_sigma**2 + 1)
        return EulerState(
            timesteps=ts.astype(np.float32),
            sigmas=sigmas,
            init_noise_sigma=np.float32(init_noise_sigma),
        )

    def scale_model_input(self, state: EulerState, sample: torch.Tensor, i: int):
        sigma = state.sigmas[i]
        return sample / float(np.sqrt(sigma * sigma + np.float32(1)))

    def step(self, state: EulerState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor) -> torch.Tensor:
        """One Euler step on an epsilon prediction, in f32 whatever the
        model's dtype."""
        sigma = float(state.sigmas[i])
        dsigma = float(state.sigmas[i + 1] - state.sigmas[i])
        sample32 = sample.float()
        pred_x0 = sample32 - sigma * model_output.float()
        derivative = (sample32 - pred_x0) / sigma
        return (sample32 + derivative * dsigma).to(sample.dtype)
