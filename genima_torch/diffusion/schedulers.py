"""Diffusion noise schedulers for the port: Euler discrete (sd-turbo's
sampler), Euler ancestral (sdxl-turbo's), DDIM and DDPM.

Counterpart of ``genima_tpu/diffusion/schedulers.py``. The timestep, sigma
and alpha tables are built in float64 numpy and stored as float32, exactly
as the reference builds them; the per-step coefficients are float32 numpy
scalars, so the tensor arithmetic matches the reference's f32 step. The
stochastic steps (Euler ancestral, DDPM) take their standard-normal draw as
an input, ``noise``, in the sample's layout: the reference draws one block
per step from a key, the port from a ``torch.Generator`` its caller owns.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

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
    set_alpha_to_one: bool = False  # DDIM: SD uses final_alpha = acp[0]


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


def _pred_original(sample: torch.Tensor, model_output: torch.Tensor, sigma: np.float32,
                   prediction_type: str) -> torch.Tensor:
    """x0 estimate in sigma space (the Euler samplers' convention)."""
    if prediction_type == "epsilon":
        return sample - float(sigma) * model_output
    if prediction_type == "v_prediction":
        s2 = sigma * sigma + np.float32(1)
        return model_output * float(-sigma / np.sqrt(s2)) + sample / float(s2)
    raise ValueError(f"Unknown prediction_type {prediction_type}")


def _alpha_pred(sample: torch.Tensor, model_output: torch.Tensor, a_t: np.float32,
                prediction_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(x0 estimate, epsilon estimate) in alpha space (DDIM and DDPM)."""
    sa, s1a = float(np.sqrt(a_t)), float(np.sqrt(np.float32(1) - a_t))
    if prediction_type == "epsilon":
        return (sample - s1a * model_output) / sa, model_output
    if prediction_type == "v_prediction":
        return sa * sample - s1a * model_output, sa * model_output + s1a * sample
    raise ValueError(f"Unknown prediction_type {prediction_type}")


# ---------------------------------------------------------------------------
# Euler discrete (sd-turbo's sampler; timestep_spacing="trailing")
# ---------------------------------------------------------------------------


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
        """One Euler step, in f32 whatever the model's dtype."""
        sigma = state.sigmas[i]
        dsigma = float(state.sigmas[i + 1] - state.sigmas[i])
        sample32 = sample.float()
        pred_x0 = _pred_original(sample32, model_output.float(), sigma,
                                 self.config.prediction_type)
        derivative = (sample32 - pred_x0) / float(sigma)
        return (sample32 + derivative * dsigma).to(sample.dtype)


# ---------------------------------------------------------------------------
# Euler ancestral (sdxl-turbo's sampler)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EulerAncestralScheduler(EulerDiscreteScheduler):
    """Euler discrete's tables and input scaling; a stochastic step."""

    def step(self, state: EulerState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One ancestral step: the Euler step to sigma_down, then ``noise``
        (standard normal, the sample's shape) times sigma_up. The reference
        draws a block on every step, the last one (sigma_up = 0) included,
        so a caller hands one per step."""
        sigma_from, sigma_to = state.sigmas[i], state.sigmas[i + 1]
        sample32 = sample.float()
        pred_x0 = _pred_original(sample32, model_output.float(), sigma_from,
                                 self.config.prediction_type)
        up2 = sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2
        sigma_up = np.sqrt(np.maximum(up2, np.float32(0)))
        sigma_down = np.sqrt(np.maximum(sigma_to**2 - sigma_up**2, np.float32(0)))
        derivative = (sample32 - pred_x0) / float(sigma_from)
        prev = sample32 + derivative * float(sigma_down - sigma_from)
        prev = prev + noise.to(sample.device, torch.float32) * float(sigma_up)
        return prev.to(sample.dtype)


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------


class DDIMState(NamedTuple):
    timesteps: np.ndarray  # (n,) int64
    alphas_cumprod: np.ndarray  # (num_train,) float32
    final_alpha_cumprod: np.float32
    step_ratio: int


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    config: SchedulerConfig = SchedulerConfig()

    def set_timesteps(self, num_inference_steps: int) -> DDIMState:
        acp = make_alphas_cumprod(self.config)
        return DDIMState(
            timesteps=_spaced_timesteps(self.config, num_inference_steps).astype(np.int64),
            alphas_cumprod=acp,
            final_alpha_cumprod=np.float32(1.0 if self.config.set_alpha_to_one else acp[0]),
            step_ratio=self.config.num_train_timesteps // num_inference_steps,
        )

    def scale_model_input(self, state: DDIMState, sample: torch.Tensor, i: int):
        return sample

    def step(self, state: DDIMState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor) -> torch.Tensor:
        """Deterministic DDIM step (eta = 0)."""
        t = int(state.timesteps[i])
        prev_t = t - state.step_ratio
        a_t = state.alphas_cumprod[t]
        a_prev = state.alphas_cumprod[prev_t] if prev_t >= 0 else state.final_alpha_cumprod
        pred_x0, eps = _alpha_pred(sample.float(), model_output.float(), a_t,
                                   self.config.prediction_type)
        prev = float(np.sqrt(a_prev)) * pred_x0 + float(np.sqrt(np.float32(1) - a_prev)) * eps
        return prev.to(sample.dtype)


# ---------------------------------------------------------------------------
# DDPM (the training-noise scheduler; also a sampler)
# ---------------------------------------------------------------------------


class DDPMState(NamedTuple):
    timesteps: np.ndarray  # (n,) int64
    alphas_cumprod: np.ndarray  # (num_train,) float32
    betas: np.ndarray  # (num_train,) float32
    step_ratio: int


@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    config: SchedulerConfig = SchedulerConfig()

    @property
    def alphas_cumprod(self) -> torch.Tensor:
        return torch.from_numpy(make_alphas_cumprod(self.config))

    def set_timesteps(self, num_inference_steps: int) -> DDPMState:
        acp = make_alphas_cumprod(self.config)
        alphas = np.empty_like(acp)
        alphas[0] = acp[0]
        alphas[1:] = acp[1:] / acp[:-1]
        ts = _spaced_timesteps(
            dataclasses.replace(self.config, steps_offset=0), num_inference_steps
        ).astype(np.int64)
        return DDPMState(
            timesteps=ts,
            alphas_cumprod=acp,
            betas=(1.0 - alphas).astype(np.float32),
            step_ratio=self.config.num_train_timesteps // num_inference_steps,
        )

    def scale_model_input(self, state: DDPMState, sample: torch.Tensor, i: int):
        return sample

    def step(self, state: DDPMState, model_output: torch.Tensor, i: int,
             sample: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Ancestral DDPM step with the fixed-small variance; ``noise`` is
        the step's standard-normal draw (unused at t = 0)."""
        t = int(state.timesteps[i])
        prev_t = t - state.step_ratio
        one = np.float32(1)
        a_t = state.alphas_cumprod[t]
        a_prev = state.alphas_cumprod[prev_t] if prev_t >= 0 else one
        alpha_t = a_t / a_prev
        beta_t = one - alpha_t
        sample32 = sample.float()
        pred_x0, _ = _alpha_pred(sample32, model_output.float(), a_t,
                                 self.config.prediction_type)
        coef_x0 = np.sqrt(a_prev) * beta_t / (one - a_t)
        coef_xt = np.sqrt(alpha_t) * (one - a_prev) / (one - a_t)
        mean = float(coef_x0) * pred_x0 + float(coef_xt) * sample32
        var = np.maximum(beta_t * (one - a_prev) / (one - a_t), np.float32(1e-20))
        std = float(np.sqrt(var)) if t > 0 else 0.0
        return (mean + std * noise.to(sample.device, torch.float32)).to(sample.dtype)


SCHEDULERS = {
    "ddpm": DDPMScheduler,
    "ddim": DDIMScheduler,
    "euler_discrete": EulerDiscreteScheduler,
    "euler_ancestral": EulerAncestralScheduler,
}


def make_scheduler(name: str, config: Optional[SchedulerConfig] = None):
    """A scheduler by the reference's ``train_scheduler`` names; the default
    config spaces the Euler samplers "trailing", the others "leading"."""
    if name not in SCHEDULERS:
        raise ValueError(f"Scheduler {name} not supported")
    config = config or SchedulerConfig(
        timestep_spacing="trailing" if "euler" in name else "leading")
    return SCHEDULERS[name](config)
