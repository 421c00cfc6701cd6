"""ControlNet fine-tune: the reference's second learned stage, on one GPU.

Counterpart of ``genima_tpu/diffusion/training.py`` (``ControlNetTrainer``,
``TrainConfig``, ``make_lr_schedule``, ``sample_train_timesteps``). One
train step: VAE-encode the target image, add scheduler noise at random
timesteps, CLIP-encode the prompt, ControlNet forward -> residuals, frozen
UNet noise prediction, MSE loss, gradients w.r.t. the ControlNet only,
global-norm clip, AdamW on f32 master weights.

Precision: the JAX package keeps f32 params and computes in the pipeline's
dtype. Here the frozen UNet, VAE and CLIP are stored in that dtype (bf16 on
the card); the ControlNet module is a working copy in that dtype, refreshed
from the f32 master weights (``TrainState.params``) before every step, and
its gradients are taken to f32 for the clip and the update.

The step's three random draws (the VAE sample's normal, the latent noise and
the timesteps) are a ``Draws``: ``train_step`` takes them from an explicit
``torch.Generator``, and tests hand both packages the same numbers.
Gradient accumulation, augmentations, 8-bit Adam and the bf16 first moment
raise; the SDXL and pix2pix trainers are later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from genima_torch.core.optim import AdamW, AdamWState, clip_by_global_norm_
from genima_torch.diffusion.schedulers import SchedulerConfig, add_noise, make_alphas_cumprod
from genima_torch.weights.init import master_params

TURBO_TIMESTEPS = (999, 749, 499, 249, 0)  # sd-turbo's ADD grid


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    use_8bit_adam: bool = False  # raises: a later slice
    max_grad_norm: float = 1.0
    # recompute the ControlNet + UNet forward in the backward instead of
    # keeping its activations (torch.utils.checkpoint)
    gradient_checkpointing: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    max_train_steps: int = 15000
    gradient_accumulation_steps: int = 1  # > 1 raises: a later slice
    timestep_spacing: str = "uniform"  # or "turbo_timesteps"
    # explicit training-timestep grid; overrides timestep_spacing
    train_timestep_grid: Optional[tuple[int, ...]] = None
    lr_num_cycles: int = 1  # cosine_with_restarts hard restarts
    lr_power: float = 1.0  # polynomial decay exponent
    lr_end: float = 1e-7  # polynomial floor
    adam_mu_bf16: bool = False  # raises: a later slice
    augmentations: Optional[str] = None  # raises: a later slice
    scheduler_config: SchedulerConfig = SchedulerConfig()


class Draws(NamedTuple):
    """A train step's random draws, in the reference's layouts."""

    sample_noise: torch.Tensor  # (B, h, w, 4) standard normal: the VAE sample
    noise: torch.Tensor  # (B, h, w, 4) standard normal: the diffusion noise
    timesteps: torch.Tensor  # (B,) int


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # f32 master weights of the ControlNet
    opt_state: AdamWState
    step: int = 0


def sample_train_timesteps(
    cfg: TrainConfig, generator: torch.Generator, bsz: int
) -> torch.Tensor:
    """Training timesteps per the config: the explicit
    ``train_timestep_grid``, else sd-turbo's grid (``turbo_timesteps``),
    else uniform over [0, num_train_timesteps). A grid value outside that
    range raises (the JAX package's gather clamps it silently)."""
    n_train = cfg.scheduler_config.num_train_timesteps
    grid = cfg.train_timestep_grid
    if not grid and cfg.timestep_spacing == "turbo_timesteps":
        grid = TURBO_TIMESTEPS
    if not grid:
        return torch.randint(0, n_train, (bsz,), generator=generator, device=generator.device)
    bad = [t for t in grid if not 0 <= t < n_train]
    if bad:
        raise ValueError(f"train_timestep_grid values {bad} outside [0, {n_train})")
    idx = torch.randint(0, len(grid), (bsz,), generator=generator, device=generator.device)
    return torch.tensor(grid, dtype=torch.long, device=generator.device)[idx]


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then held."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules for two pieces: ``second`` sees the step offset."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate of each update count: diffusers' ``get_scheduler``
    choices as the JAX package builds them from optax pieces."""
    base = cfg.learning_rate
    warmup = cfg.lr_warmup_steps
    if cfg.lr_scheduler == "constant":
        return lambda count: base
    if cfg.lr_scheduler == "constant_with_warmup":
        return _join(_linear(0.0, base, warmup), lambda count: base, warmup)
    if cfg.lr_scheduler == "linear":
        return _join(
            _linear(0.0, base, warmup),
            _linear(base, 0.0, max(cfg.max_train_steps - warmup, 1)),
            warmup,
        )
    if cfg.lr_scheduler == "cosine":
        # optax.warmup_cosine_decay_schedule, its warmup clamped below
        # max_train_steps (optax rejects a decay of <= 0 steps)
        warmup = min(warmup, max(cfg.max_train_steps - 1, 0))
        decay = max(cfg.max_train_steps, warmup + 1) - warmup

        def cosine(count):
            return base * 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))

        return _join(_linear(0.0, base, warmup), cosine, warmup)
    decay = max(cfg.max_train_steps - warmup, 1)
    if cfg.lr_scheduler == "cosine_with_restarts":
        cycles = max(int(cfg.lr_num_cycles), 1)

        def restarts(count):
            progress = max(count / decay, 0.0)
            if progress >= 1.0:
                return 0.0
            return base * 0.5 * (1.0 + math.cos(math.pi * ((cycles * progress) % 1.0)))

        return _join(_linear(0.0, base, warmup), restarts, warmup)
    if cfg.lr_scheduler == "polynomial":
        def poly(count):
            progress = min(max(count / decay, 0.0), 1.0)
            return (base - cfg.lr_end) * (1.0 - progress) ** cfg.lr_power + cfg.lr_end

        return _join(_linear(0.0, base, warmup), poly, warmup)
    raise ValueError(f"Unknown lr_scheduler {cfg.lr_scheduler}")


def normalize_image_batch(
    pixel_values: torch.Tensor, cond_values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 batches (the loader's ``emit_uint8``) to [-1, 1] targets and
    [0, 1] conditions, on the device; float batches pass through."""
    if pixel_values.dtype == torch.uint8:
        pixel_values = pixel_values.float() / 127.5 - 1.0
    if cond_values.dtype == torch.uint8:
        cond_values = cond_values.float() / 255.0
    return pixel_values, cond_values


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


class ControlNetTrainer:
    """Trains ``params["controlnet"]``; the UNet, VAE and text encoder stay
    frozen (the reference freezes them too)."""

    def __init__(self, pipe, cfg: TrainConfig):
        for flag, unsupported in (
            ("gradient_accumulation_steps > 1", cfg.gradient_accumulation_steps > 1),
            ("augmentations", bool(cfg.augmentations)),
            ("use_8bit_adam", cfg.use_8bit_adam),
            ("adam_mu_bf16", cfg.adam_mu_bf16),
        ):
            if unsupported:
                raise NotImplementedError(f"{flag} is not ported yet")
        if not pipe.vae_encoder:
            raise ValueError("the trainer needs a pipeline built with vae_encoder=True")
        self.pipe = pipe
        self.cfg = cfg
        self.alphas_cumprod = torch.from_numpy(
            make_alphas_cumprod(cfg.scheduler_config)
        ).to(pipe.device)
        self.lr_schedule = make_lr_schedule(cfg)
        self.optimizer = AdamW(
            self.lr_schedule, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon,
            cfg.adam_weight_decay,
        )
        self.frozen: dict[str, nn.Module] = {}
        self.controlnet: Optional[nn.Module] = None  # the working copy

    def create_state(self, params: dict[str, nn.Module]) -> TrainState:
        self.frozen = {k: m.requires_grad_(False) for k, m in params.items() if k != "controlnet"}
        self.controlnet = params["controlnet"]
        master = master_params(self.controlnet)
        return TrainState(params=master, opt_state=self.optimizer.init(master))

    def sample_draws(self, bsz: int, resolution: int, generator: torch.Generator) -> Draws:
        h = resolution // self.pipe.vae_scale_factor
        shape = (bsz, h, h, self.pipe.vae_cfg.latent_channels)
        dev = generator.device
        return Draws(
            sample_noise=torch.randn(shape, generator=generator, device=dev),
            noise=torch.randn(shape, generator=generator, device=dev),
            timesteps=sample_train_timesteps(self.cfg, generator, bsz),
        )

    def loss(self, batch: dict[str, Any], draws: Draws) -> torch.Tensor:
        """MSE of the noise prediction; differentiable in the working
        ControlNet's parameters."""
        pipe, dev, dtype = self.pipe, self.pipe.device, self.pipe.dtype
        pixel_values, cond_values = normalize_image_batch(
            torch.as_tensor(batch["pixel_values"], device=dev),
            torch.as_tensor(batch["conditioning_pixel_values"], device=dev),
        )  # (B, H, W, 3) in [-1, 1] / [0, 1]
        noise = _nchw(draws.noise.to(dev, torch.float32))
        timesteps = draws.timesteps.to(dev)
        with torch.no_grad():
            dist = self.frozen["vae"].encode(_nchw(pixel_values).to(dtype))
            latents = dist.sample(_nchw(draws.sample_noise.to(dev))).float()
            latents = latents * pipe.vae_cfg.scaling_factor
            noisy = add_noise(self.alphas_cumprod, latents, noise, timesteps).to(dtype)
            ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev)
            context = self.frozen["text_encoder"](ids).last_hidden_state
        cond = _nchw(cond_values).to(dtype)
        t = timesteps.float()

        def model_eps(noisy, cond):
            down, mid = self.controlnet(noisy, t, context, cond)
            return self.frozen["unet"](
                noisy, t, context,
                down_block_additional_residuals=down,
                mid_block_additional_residual=mid,
            )

        if self.cfg.gradient_checkpointing:
            eps = torch.utils.checkpoint.checkpoint(model_eps, noisy, cond, use_reentrant=False)
        else:
            eps = model_eps(noisy, cond)
        return torch.mean((eps.float() - noise) ** 2)

    def gradients(
        self, state: TrainState, batch: dict[str, Any], draws: Draws
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Loss and f32 gradients w.r.t. the ControlNet at ``state.params``."""
        cn = self.controlnet
        with torch.no_grad():
            for name, p in cn.named_parameters():
                p.copy_(state.params[name])
                p.grad = None
        loss = self.loss(batch, draws)
        loss.backward()
        grads = {name: p.grad.float() for name, p in cn.named_parameters()}
        for p in cn.parameters():
            p.grad = None
        return loss.detach(), grads

    def step_with_draws(
        self, state: TrainState, batch: dict[str, Any], draws: Draws
    ) -> tuple[TrainState, dict[str, Any]]:
        loss, grads = self.gradients(state, batch, draws)
        grad_norm = clip_by_global_norm_(grads, self.cfg.max_grad_norm)
        opt_state = self.optimizer.step_(state.params, grads, state.opt_state)
        metrics = {"loss": loss, "lr": self.lr_schedule(state.step), "grad_norm": grad_norm}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    def train_step(
        self, state: TrainState, batch: dict[str, Any], generator: torch.Generator
    ) -> tuple[TrainState, dict[str, Any]]:
        """One step on ``batch`` (NHWC images, uint8 or normalised, and
        (B, 77) token ids), its draws taken from ``generator``."""
        bsz, resolution = batch["pixel_values"].shape[:2]
        return self.step_with_draws(state, batch, self.sample_draws(bsz, resolution, generator))
