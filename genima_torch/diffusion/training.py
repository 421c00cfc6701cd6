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

The optimizer is the JAX trainer's: the f32 AdamW (optionally with a bf16
first moment) or the 8-bit AdamW behind the global-norm clip, wrapped in
gradient accumulation when ``gradient_accumulation_steps > 1``
(``core/optim.py``); ``TrainState.step`` counts mini-steps, as in JAX. With
``augmentations`` the normalised batch goes through
``controlnet_train_augment`` before the VAE encode. The target is the noise,
or the velocity under ``prediction_type="v_prediction"``.

The step's random draws (the VAE sample's normal, the latent noise, the
timesteps and the augmentations' parameters) are a ``Draws``:
``train_step`` takes them from an explicit ``torch.Generator``, and tests
hand both packages the same numbers. ``SDXLControlNetTrainer`` conditions
on both frozen text encoders and SDXL's ``add_time_ids``.
``Pix2PixTrainer`` trains the whole 8-channel InstructPix2Pix UNet with
conditioning dropout (its ``random_p`` draw an input too) and an optional
EMA of the f32 master weights, ``TrainState.ema``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from genima_torch.core.optim import AdamW, AdamW8bit, Clipped, MultiSteps
from genima_torch.data.augment import (
    ControlNetAugmentDraws, controlnet_train_augment, parse_augmentations,
    sample_controlnet_augment_draws,
)
from genima_torch.diffusion.schedulers import (
    SchedulerConfig, add_noise, get_velocity, make_alphas_cumprod,
)
from genima_torch.diffusion.train_state import layout_perms
from genima_torch.weights.init import master_params
from genima_torch.weights.to_jax import flax_paths

TURBO_TIMESTEPS = (999, 749, 499, 249, 0)  # sd-turbo's ADD grid


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    use_8bit_adam: bool = False  # blockwise int8 moments (core/optim.py)
    max_grad_norm: float = 1.0
    # recompute the ControlNet + UNet forward in the backward instead of
    # keeping its activations (torch.utils.checkpoint)
    gradient_checkpointing: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    max_train_steps: int = 15000
    gradient_accumulation_steps: int = 1
    timestep_spacing: str = "uniform"  # or "turbo_timesteps"
    # explicit training-timestep grid; overrides timestep_spacing
    train_timestep_grid: Optional[tuple[int, ...]] = None
    lr_num_cycles: int = 1  # cosine_with_restarts hard restarts
    lr_power: float = 1.0  # polynomial decay exponent
    lr_end: float = 1e-7  # polynomial floor
    adam_mu_bf16: bool = False  # bf16 first moment (optax mu_dtype)
    # comma list: colorjitter,elastic,blur,affine,crop (data/augment.py)
    augmentations: Optional[str] = None
    scheduler_config: SchedulerConfig = SchedulerConfig()


class Draws(NamedTuple):
    """A train step's random draws, in the reference's layouts."""

    sample_noise: torch.Tensor  # (B, h, w, 4) standard normal: the VAE sample
    noise: torch.Tensor  # (B, h, w, 4) standard normal: the diffusion noise
    timesteps: torch.Tensor  # (B,) int
    augment: Optional[ControlNetAugmentDraws] = None  # with cfg.augmentations
    random_p: Optional[torch.Tensor] = None  # (B,) uniform: pix2pix's conditioning dropout


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # f32 master weights of the trained model
    opt_state: Any  # of the trainer's ``tx``: AdamWState, Adam8bitState, MultiStepsState
    step: int = 0  # mini-steps taken
    ema: Optional[dict[str, torch.Tensor]] = None  # pix2pix ``--use_ema``: f32, like params


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
    frozen (the reference freezes them too). ``TRAINED`` names the model a
    subclass trains instead, and its weight family (``diffusion/pretrain.py``)."""

    TRAINED = ("controlnet", "diffusers_controlnet")

    def __init__(self, pipe, cfg: TrainConfig):
        if not pipe.vae_encoder:
            raise ValueError("the trainer needs a pipeline built with vae_encoder=True")
        if cfg.scheduler_config.prediction_type not in ("epsilon", "v_prediction"):
            raise ValueError(f"Unknown prediction_type {cfg.scheduler_config.prediction_type}")
        parse_augmentations(cfg.augmentations)  # raises on an unknown name
        self.pipe = pipe
        self.cfg = cfg
        self.alphas_cumprod = torch.from_numpy(
            make_alphas_cumprod(cfg.scheduler_config)
        ).to(pipe.device)
        self.lr_schedule = make_lr_schedule(cfg)
        self.tx = None  # built by create_state: the 8-bit AdamW needs the layouts
        self.paths: dict[str, tuple[str, ...]] = {}  # parameter name -> flax path
        self.frozen: dict[str, nn.Module] = {}
        self.model: Optional[nn.Module] = None  # the working copy of the trained model

    def _make_tx(self, perms: dict[str, tuple[int, ...]]):
        """clip -> AdamW (f32, bf16 first moment, or 8-bit), in gradient
        accumulation when k > 1: the JAX trainer's optax chain."""
        cfg = self.cfg
        if cfg.use_8bit_adam:
            adam = AdamW8bit(self.lr_schedule, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon,
                             cfg.adam_weight_decay, perms=perms)
        else:
            adam = AdamW(self.lr_schedule, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon,
                         cfg.adam_weight_decay,
                         mu_dtype=torch.bfloat16 if cfg.adam_mu_bf16 else torch.float32)
        tx = Clipped(adam, cfg.max_grad_norm)
        if cfg.gradient_accumulation_steps > 1:
            tx = MultiSteps(tx, cfg.gradient_accumulation_steps)
        return tx

    def create_state(self, params: dict[str, nn.Module]) -> TrainState:
        name, family = self.TRAINED
        self.frozen = {k: m.requires_grad_(False) for k, m in params.items() if k != name}
        self.model = params[name]
        master = master_params(self.model)
        self.paths = flax_paths(self.model, family)
        self.tx = self._make_tx(layout_perms(master, self.paths))
        return TrainState(params=master, opt_state=self.tx.init(master))

    def sample_draws(self, bsz: int, resolution: int, generator: torch.Generator) -> Draws:
        h = resolution // self.pipe.vae_scale_factor
        shape = (bsz, h, h, self.pipe.vae_cfg.latent_channels)
        dev = generator.device
        return Draws(
            sample_noise=torch.randn(shape, generator=generator, device=dev),
            noise=torch.randn(shape, generator=generator, device=dev),
            timesteps=sample_train_timesteps(self.cfg, generator, bsz),
            augment=(sample_controlnet_augment_draws(
                self.cfg.augmentations, resolution, resolution, generator)
                if self.cfg.augmentations else None),
        )

    def text_condition(self, ids: torch.Tensor) -> tuple[torch.Tensor, Optional[dict]]:
        """(B, 77) token ids -> (the frozen encoder's context, no added
        conditioning)."""
        return self.frozen["text_encoder"](ids).last_hidden_state, None

    def loss(self, batch: dict[str, Any], draws: Draws) -> torch.Tensor:
        """MSE of the noise (or velocity) prediction; differentiable in the
        working ControlNet's parameters."""
        pipe, dev, dtype = self.pipe, self.pipe.device, self.pipe.dtype
        pixel_values, cond_values = normalize_image_batch(
            torch.as_tensor(batch["pixel_values"], device=dev),
            torch.as_tensor(batch["conditioning_pixel_values"], device=dev),
        )  # (B, H, W, 3) in [-1, 1] / [0, 1]
        if self.cfg.augmentations:
            augment = ControlNetAugmentDraws(*(
                None if t is None else t.to(dev) for t in draws.augment))
            pixel_values, cond_values = controlnet_train_augment(
                pixel_values, cond_values, self.cfg.augmentations, augment)
        noise = _nchw(draws.noise.to(dev, torch.float32))
        timesteps = draws.timesteps.to(dev)
        with torch.no_grad():
            dist = self.frozen["vae"].encode(_nchw(pixel_values).to(dtype))
            latents = dist.sample(_nchw(draws.sample_noise.to(dev))).float()
            latents = latents * pipe.vae_cfg.scaling_factor
            noisy = add_noise(self.alphas_cumprod, latents, noise, timesteps).to(dtype)
            ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev)
            context, added = self.text_condition(ids)
        cond = _nchw(cond_values).to(dtype)
        t = timesteps.float()

        def model_eps(noisy, cond):
            down, mid = self.model(noisy, t, context, cond, added_cond_kwargs=added)
            return self.frozen["unet"](
                noisy, t, context,
                down_block_additional_residuals=down,
                mid_block_additional_residual=mid,
                added_cond_kwargs=added,
            )

        if self.cfg.gradient_checkpointing:
            eps = torch.utils.checkpoint.checkpoint(model_eps, noisy, cond, use_reentrant=False)
        else:
            eps = model_eps(noisy, cond)
        if self.cfg.scheduler_config.prediction_type == "v_prediction":
            target = get_velocity(self.alphas_cumprod, latents, noise, timesteps)
        else:
            target = noise
        return torch.mean((eps.float() - target) ** 2)

    @torch.no_grad()
    def sync_working_copy(self, state: TrainState) -> nn.Module:
        """Refresh the working copy of the trained model from the master
        weights; returns it."""
        for name, p in self.model.named_parameters():
            p.copy_(state.params[name])
        return self.model

    def gradients(
        self, state: TrainState, batch: dict[str, Any], draws: Draws
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Loss and f32 gradients w.r.t. the trained model at ``state.params``."""
        model = self.sync_working_copy(state)
        for p in model.parameters():
            p.grad = None
        loss = self.loss(batch, draws)
        loss.backward()
        # a parameter the loss does not reach (the tiny VAE's encoder under
        # the distiller) gets a zero gradient, as jax.grad gives it
        grads = {name: p.grad.float() if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for name, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.detach(), grads

    def step_with_draws(
        self, state: TrainState, batch: dict[str, Any], draws: Draws
    ) -> tuple[TrainState, dict[str, Any]]:
        loss, grads = self.gradients(state, batch, draws)
        # grad_norm: of this mini-step's gradients, before the clip
        opt_state, grad_norm = self.tx.step_(state.params, grads, state.opt_state)
        metrics = {"loss": loss, "lr": self.lr_schedule(state.step), "grad_norm": grad_norm}
        return TrainState(state.params, opt_state, state.step + 1, state.ema), metrics

    def train_step(
        self, state: TrainState, batch: dict[str, Any], generator: torch.Generator
    ) -> tuple[TrainState, dict[str, Any]]:
        """One step on ``batch`` (NHWC images, uint8 or normalised, and
        (B, 77) token ids), its draws taken from ``generator``."""
        bsz, resolution = batch["pixel_values"].shape[:2]
        return self.step_with_draws(state, batch, self.sample_draws(bsz, resolution, generator))


class SDXLControlNetTrainer(ControlNetTrainer):
    """The SDXL ControlNet fine-tune: the context is both frozen encoders'
    penultimate hidden states side by side, the added conditioning encoder
    2's pooled embeds and ``make_time_ids(batch, resolution)``. Both
    encoders run inside the step, as in the JAX package (the reference
    precomputes the embeddings and frees the encoders, the same numbers)."""

    def __init__(self, pipe, cfg: TrainConfig, resolution: int = 512):
        super().__init__(pipe, cfg)
        self.resolution = resolution

    def text_condition(self, ids: torch.Tensor) -> tuple[torch.Tensor, dict]:
        hidden, pooled = self.pipe.encode_ids(self.frozen, ids)
        return hidden, {"text_embeds": pooled,
                        "time_ids": self.pipe.make_time_ids(ids.shape[0], self.resolution)}


class Pix2PixTrainer(ControlNetTrainer):
    """The InstructPix2Pix fine-tune: trains the whole 8-channel UNet. The
    target latents are the VAE posterior's sample x scaling factor; the
    conditioning image (``cond * 2 - 1``) is encoded to its posterior's
    mode, unscaled, and channel-concatenated with the noisy latents. With
    ``conditioning_dropout_prob`` p, a sample's prompt becomes the null
    prompt's context (``null_token_ids``, else all-zero ids) where
    ``random_p < 2p``, and its image latents zero where ``p <= random_p <
    3p``. With ``use_ema``, ``ema' = d * ema + (1 - d) * params`` over the
    f32 masters after every step (one foreach pass), starting from a copy
    of the params; no warmup schedule. No augmentations, as in the JAX
    trainer."""

    TRAINED = ("unet", "diffusers_unet")

    def __init__(self, pipe, cfg: TrainConfig, conditioning_dropout_prob: Optional[float] = 0.05,
                 use_ema: bool = False, ema_decay: float = 0.9999, null_token_ids=None):
        super().__init__(pipe, cfg)
        self.conditioning_dropout_prob = conditioning_dropout_prob
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.null_token_ids = null_token_ids
        self._null_context: Optional[torch.Tensor] = None

    def create_state(self, params: dict[str, nn.Module]) -> TrainState:
        state = super().create_state(params)
        if self.use_ema:
            state.ema = {k: v.clone() for k, v in state.params.items()}
        self._null_context = None
        return state

    def sample_draws(self, bsz: int, resolution: int, generator: torch.Generator) -> Draws:
        h = resolution // self.pipe.vae_scale_factor
        shape = (bsz, h, h, self.pipe.vae_cfg.latent_channels)
        dev = generator.device
        return Draws(
            sample_noise=torch.randn(shape, generator=generator, device=dev),
            noise=torch.randn(shape, generator=generator, device=dev),
            timesteps=sample_train_timesteps(self.cfg, generator, bsz),
            random_p=(torch.rand(bsz, generator=generator, device=dev)
                      if self.conditioning_dropout_prob else None),
        )

    def null_context(self, length: int) -> torch.Tensor:
        """(1, 77, hidden) context of the null prompt (the frozen encoder's:
        made once)."""
        if self._null_context is None:
            ids = (torch.zeros((1, length), dtype=torch.long) if self.null_token_ids is None
                   else torch.as_tensor(np.asarray(self.null_token_ids), dtype=torch.long))
            with torch.no_grad():
                self._null_context = self.frozen["text_encoder"](
                    ids.to(self.pipe.device)).last_hidden_state
        return self._null_context

    def loss(self, batch: dict[str, Any], draws: Draws) -> torch.Tensor:
        pipe, dev, dtype = self.pipe, self.pipe.device, self.pipe.dtype
        pixel_values, cond_values = normalize_image_batch(
            torch.as_tensor(batch["pixel_values"], device=dev),
            torch.as_tensor(batch["conditioning_pixel_values"], device=dev),
        )  # edited target in [-1, 1], original in [0, 1]
        noise = _nchw(draws.noise.to(dev, torch.float32))
        timesteps = draws.timesteps.to(dev)
        with torch.no_grad():
            vae = self.frozen["vae"]
            dist = vae.encode(_nchw(pixel_values).to(dtype))
            latents = dist.sample(_nchw(draws.sample_noise.to(dev))).float()
            latents = latents * pipe.vae_cfg.scaling_factor
            image_latents = vae.encode(_nchw(cond_values * 2.0 - 1.0).to(dtype)).mode().float()
            noisy = add_noise(self.alphas_cumprod, latents, noise, timesteps)
            ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev)
            context = self.frozen["text_encoder"](ids).last_hidden_state
            p = self.conditioning_dropout_prob
            if p:
                random_p = draws.random_p.to(dev)
                drop_prompt = (random_p < 2 * p)[:, None, None]
                context = torch.where(drop_prompt, self.null_context(ids.shape[1]), context)
                keep_image = 1.0 - ((random_p >= p) & (random_p < 3 * p)).float()
                image_latents = image_latents * keep_image[:, None, None, None]
            model_in = torch.cat([noisy.to(dtype), image_latents.to(dtype)], dim=1)
        t = timesteps.float()

        def model_eps(model_in):
            return self.model(model_in, t, context)

        if self.cfg.gradient_checkpointing:
            eps = torch.utils.checkpoint.checkpoint(model_eps, model_in, use_reentrant=False)
        else:
            eps = model_eps(model_in)
        if self.cfg.scheduler_config.prediction_type == "v_prediction":
            target = get_velocity(self.alphas_cumprod, latents, noise, timesteps)
        else:
            target = noise
        return torch.mean((eps.float() - target) ** 2)

    def step_with_draws(
        self, state: TrainState, batch: dict[str, Any], draws: Draws
    ) -> tuple[TrainState, dict[str, Any]]:
        state, metrics = super().step_with_draws(state, batch, draws)
        if state.ema is not None:
            with torch.no_grad():
                names = list(state.ema)
                torch._foreach_lerp_([state.ema[k] for k in names],
                                     [state.params[k] for k in names], 1.0 - self.ema_decay)
        return state, metrics
