"""Base-model pretraining: VAE reconstruction and UNet denoising.

Counterpart of ``genima_tpu/diffusion/pretrain.py`` (``VAETrainer``,
``UNetPretrainer``, ``pretrain_base_model``, ``save_base_model``). The
reference downloads ``stabilityai/sd-turbo`` and fine-tunes a ControlNet
against the frozen base; a from-scratch user (a new visual domain, or no
downloaded weights, as in the learning gate) trains the two towers here:

* ``VAETrainer``: reconstruction (MSE + ``kl_weight`` x KL) of the
  AutoencoderKL, so latents round-trip the target domain;
* ``UNetPretrainer``: epsilon- (or velocity-) prediction denoising of the
  bare UNet on the target images: the fine-tune's loss without the
  ControlNet.

Both are ``ControlNetTrainer``s with another trained model: f32 master
weights, the model itself as the working copy in the pipeline's dtype (bf16
on the card), the clip and AdamW of the fine-tune, and every random draw
passed in (``Draws``: the VAE trainer draws only the posterior sample's
normal; the UNet pretrainer the sample's normal, the noise and the
timesteps, which JAX takes from ``split(key, 3)``). ``save_base_model``
writes ``<dir>/{vae,unet,text_encoder}/params.msgpack`` and the one-file
``params.msgpack`` in the JAX package's trees, which both packages'
``load_pretrained_pipeline`` (``--pretrained_model_name_or_path``) and the
eval agents' ``sd_ckpt`` read. The tiny-VAE distiller and mesh training are
later work.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Optional

import torch

from genima_torch.core import checkpoint as ckpt
from genima_torch.data.dataset import to_device
from genima_torch.diffusion import train_state as ts
from genima_torch.diffusion.schedulers import add_noise, get_velocity
from genima_torch.diffusion.training import (
    ControlNetTrainer, Draws, TrainConfig, TrainState, _nchw, normalize_image_batch,
)
from genima_torch.weights.to_jax import flax_paths, tree_from_module

BASE_MODELS = {"vae": "diffusers_vae", "unet": "diffusers_unet", "text_encoder": "hf_clip"}


class VAETrainer(ControlNetTrainer):
    """Trains ``params["vae"]``: reconstruction + beta-weighted KL."""

    TRAINED = ("vae", "diffusers_vae")

    def __init__(self, pipe, cfg: TrainConfig, kl_weight: float = 1e-6):
        super().__init__(pipe, cfg)
        self.kl_weight = kl_weight

    def sample_draws(self, bsz: int, resolution: int, generator: torch.Generator) -> Draws:
        h = resolution // self.pipe.vae_scale_factor
        shape = (bsz, h, h, self.pipe.vae_cfg.latent_channels)
        return Draws(sample_noise=torch.randn(shape, generator=generator, device=generator.device),
                     noise=None, timesteps=None)

    def loss(self, batch: dict[str, Any], draws: Draws) -> torch.Tensor:
        dev, dtype = self.pipe.device, self.pipe.dtype
        pixel_values, _ = normalize_image_batch(
            torch.as_tensor(batch["pixel_values"], device=dev),
            torch.as_tensor(batch["conditioning_pixel_values"], device=dev),
        )
        x = _nchw(pixel_values).float()
        dist = self.model.encode(x.to(dtype))
        recon = self.model.decode(dist.sample(_nchw(draws.sample_noise.to(dev))))
        rec = torch.mean((recon.float() - x) ** 2)
        mean, logvar = dist.mean.float(), dist.logvar.float()
        kl = 0.5 * torch.mean(mean**2 + torch.exp(logvar) - 1.0 - logvar)
        return rec + self.kl_weight * kl


class UNetPretrainer(ControlNetTrainer):
    """Trains ``params["unet"]``: plain denoising (the ControlNet
    fine-tune's loss without the ControlNet: the base model)."""

    TRAINED = ("unet", "diffusers_unet")

    def loss(self, batch: dict[str, Any], draws: Draws) -> torch.Tensor:
        pipe, dev, dtype = self.pipe, self.pipe.device, self.pipe.dtype
        pixel_values, _ = normalize_image_batch(
            torch.as_tensor(batch["pixel_values"], device=dev),
            torch.as_tensor(batch["conditioning_pixel_values"], device=dev),
        )
        noise = _nchw(draws.noise.to(dev, torch.float32))
        timesteps = draws.timesteps.to(dev)
        with torch.no_grad():
            dist = self.frozen["vae"].encode(_nchw(pixel_values).to(dtype))
            latents = dist.sample(_nchw(draws.sample_noise.to(dev))).float()
            latents = latents * pipe.vae_cfg.scaling_factor
            noisy = add_noise(self.alphas_cumprod, latents, noise, timesteps).to(dtype)
            ids = torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev)
            context = self.frozen["text_encoder"](ids).last_hidden_state
        eps = self.model(noisy, timesteps.float(), context)
        if self.cfg.scheduler_config.prediction_type == "v_prediction":
            target = get_velocity(self.alphas_cumprod, latents, noise, timesteps)
        else:
            target = noise
        return torch.mean((eps.float() - target) ** 2)


def pretrain_base_model(
    pipe,
    params: dict,
    loader,
    vae_steps: int = 300,
    unet_steps: int = 300,
    vae_lr: float = 2e-3,
    unet_lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 50,
    train_timestep_grid: Optional[tuple[int, ...]] = None,
    masters: Optional[dict] = None,
    step_hook: Optional[Callable[[str, int, TrainState, dict], None]] = None,
) -> dict:
    """Train the VAE, then the UNet, on ``loader``'s batches (cycled);
    returns ``params`` with both modules holding the trained weights. The
    stages are sequential by construction: the UNet denoises in the latent
    space the trained VAE defines. Each stage draws from a generator seeded
    with ``seed``. ``masters``, when given, receives each stage's f32
    master weights (name -> tensors) for ``save_base_model``;
    ``step_hook(stage, step, state, metrics)`` runs after every step."""

    def run(trainer, steps: int, tag: str) -> None:
        state = trainer.create_state(params)
        generator = torch.Generator(device=pipe.device).manual_seed(seed)
        it = iter(loader)
        for step in range(steps):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(loader)
                batch = next(it)
            state, metrics = trainer.train_step(state, to_device(batch, pipe.device), generator)
            if step_hook is not None:
                step_hook(tag, step + 1, state, metrics)
            if step % log_every == 0 or step == steps - 1:
                print(f"pretrain[{tag}] step {step}: loss={float(metrics['loss']):.5f}")
        trainer.sync_working_copy(state)
        trainer.model.requires_grad_(False)
        if masters is not None:
            masters[tag] = state.params

    run(VAETrainer(pipe, TrainConfig(
        learning_rate=vae_lr, max_train_steps=vae_steps, lr_scheduler="cosine",
        lr_warmup_steps=min(50, vae_steps // 4), adam_weight_decay=0.0,
    )), vae_steps, "vae")
    run(UNetPretrainer(pipe, TrainConfig(
        learning_rate=unet_lr, max_train_steps=unet_steps, lr_scheduler="cosine",
        lr_warmup_steps=min(50, unet_steps // 4), train_timestep_grid=train_timestep_grid,
    )), unet_steps, "unet")
    return params


def save_base_model(out_dir: str | Path, params: dict, masters: Optional[dict] = None) -> Path:
    """HF-hub-style snapshot: ``<dir>/<model>/params.msgpack`` for every base
    model present, and the one-file ``<dir>/params.msgpack`` (all but the
    ControlNet) for the eval agents' ``sd_ckpt``. A model in ``masters``
    (``pretrain_base_model``'s) is written from its f32 master weights, the
    others from their modules (float leaves in f32)."""
    out_dir = Path(out_dir)
    trees = {}
    for name, family in BASE_MODELS.items():
        if name not in params:
            continue
        if masters and name in masters:
            trees[name] = ts.params_tree(masters[name], flax_paths(params[name], family))
        else:
            trees[name] = tree_from_module(params[name], family)
        ckpt.save_pytree(trees[name], out_dir / name / "params.msgpack")
    ckpt.save_pytree(trees, out_dir / "params.msgpack")
    return out_dir
