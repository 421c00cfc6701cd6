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
eval agents' ``sd_ckpt`` read. ``TinyVAEDistiller`` / ``distill_tiny_vae``
train the taesd decoder (``params["tiny_vae"]``, a pipeline built with
``use_tiny_vae``) to match the KL decoder on the same scaled latents, and
``tiny_vae_decode_psnr`` measures how far apart the two decodes are;
``save_base_model`` writes ``tiny_vae/`` too. Mesh training is later work.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Optional

import math

import torch

from genima_torch.core import checkpoint as ckpt
from genima_torch.core.mesh import shard_batch
from genima_torch.data.dataset import to_device
from genima_torch.diffusion import train_state as ts
from genima_torch.diffusion.schedulers import add_noise, get_velocity
from genima_torch.diffusion.training import (
    ControlNetTrainer, Draws, TrainConfig, TrainState, _nchw, normalize_image_batch,
)
from genima_torch.weights.to_jax import flax_paths, tree_from_module

BASE_MODELS = {"vae": "diffusers_vae", "unet": "diffusers_unet", "text_encoder": "hf_clip",
               "text_encoder_2": "hf_clip", "tiny_vae": "tiny_vae"}


class VAETrainer(ControlNetTrainer):
    """Trains ``params["vae"]``: reconstruction + beta-weighted KL."""

    TRAINED = ("vae", "diffusers_vae")

    def __init__(self, pipe, cfg: TrainConfig, mesh=None, kl_weight: float = 1e-6):
        super().__init__(pipe, cfg, mesh)
        self.kl_weight = kl_weight

    def sample_draws(self, bsz: int, resolution: int, generator: torch.Generator) -> Draws:
        gb, rows = self.global_rows(bsz)
        return Draws(sample_noise=torch.randn(self.latent_shape(gb, resolution),
                                              generator=generator, device=generator.device)[rows],
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


def _run_stage(trainer: ControlNetTrainer, params: dict, loader, steps: int, tag: str,
               seed: int, log_every: int, masters: Optional[dict],
               step_hook: Optional[Callable], what: str = "pretrain") -> None:
    """``steps`` steps of ``trainer`` on ``loader``'s batches (cycled), its
    draws from a generator seeded with ``seed``; the trained module then
    holds the final master weights (frozen), and ``masters[tag]`` them.
    With the trainer's mesh, each batch goes through ``shard_batch``."""
    pipe = trainer.pipe
    state = trainer.create_state(params)
    generator = torch.Generator(device=pipe.device).manual_seed(seed)
    it = iter(loader)
    for step in range(steps):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(loader)
            batch = next(it)
        batch = (shard_batch(batch, trainer.mesh)[0] if trainer.mesh is not None
                 else to_device(batch, pipe.device))
        state, metrics = trainer.train_step(state, batch, generator)
        if step_hook is not None:
            step_hook(tag, step + 1, state, metrics)
        if step % log_every == 0 or step == steps - 1:
            print(f"{what}[{tag}] step {step}: loss={float(metrics['loss']):.5f}")
    trainer.sync_working_copy(state)
    trainer.model.requires_grad_(False)
    if masters is not None:
        masters[tag] = state.params


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
    mesh=None,
) -> dict:
    """Train the VAE, then the UNet, on ``loader``'s batches (cycled);
    returns ``params`` with both modules holding the trained weights. The
    stages are sequential by construction: the UNet denoises in the latent
    space the trained VAE defines. Each stage draws from a generator seeded
    with ``seed``. ``masters``, when given, receives each stage's f32
    master weights (name -> tensors) for ``save_base_model``;
    ``step_hook(stage, step, state, metrics)`` runs after every step.
    ``mesh`` (``core/mesh.py::process_mesh``) trains data-parallel over the
    process group, each rank on its loader's batches."""

    def run(trainer, steps: int, tag: str) -> None:
        _run_stage(trainer, params, loader, steps, tag, seed, log_every, masters, step_hook)

    run(VAETrainer(pipe, TrainConfig(
        learning_rate=vae_lr, max_train_steps=vae_steps, lr_scheduler="cosine",
        lr_warmup_steps=min(50, vae_steps // 4), adam_weight_decay=0.0,
    ), mesh), vae_steps, "vae")
    run(UNetPretrainer(pipe, TrainConfig(
        learning_rate=unet_lr, max_train_steps=unet_steps, lr_scheduler="cosine",
        lr_warmup_steps=min(50, unet_steps // 4), train_timestep_grid=train_timestep_grid,
    ), mesh), unet_steps, "unet")
    return params


class TinyVAEDistiller(ControlNetTrainer):
    """Trains ``params["tiny_vae"]`` (its decoder's output; the encoder
    gets no gradient) to match the full KL decoder: MSE between the tiny
    decode of the posterior mode's scaled latents and the KL decode of the
    same latents, the taesd recipe, for domains no released taesd covers.
    No random draw."""

    TRAINED = ("tiny_vae", "tiny_vae")

    def create_state(self, params: dict) -> TrainState:
        if "tiny_vae" not in params:
            raise ValueError("params has no 'tiny_vae' model: build the pipeline with "
                             "use_tiny_vae=True (init_params then makes it)")
        return super().create_state(params)

    def sample_draws(self, bsz: int, resolution: int, generator: torch.Generator) -> Draws:
        return Draws(sample_noise=None, noise=None, timesteps=None)

    def loss(self, batch: dict[str, Any], draws: Draws) -> torch.Tensor:
        dev, dtype, sf = self.pipe.device, self.pipe.dtype, self.pipe.vae_cfg.scaling_factor
        pixel_values, _ = normalize_image_batch(
            torch.as_tensor(batch["pixel_values"], device=dev),
            torch.as_tensor(batch["conditioning_pixel_values"], device=dev),
        )
        with torch.no_grad():
            vae = self.frozen["vae"]
            # deterministic teacher latents, scaled as serving hands them over
            z = vae.encode(_nchw(pixel_values).to(dtype)).mode().float() * sf
            teacher = vae.decode((z / sf).to(dtype))
        student = self.model.decode(z.to(dtype))
        return torch.mean((student.float() - teacher.float()) ** 2)


def distill_tiny_vae(
    pipe,
    params: dict,
    loader,
    steps: int = 300,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 50,
    masters: Optional[dict] = None,
    step_hook: Optional[Callable[[str, int, TrainState, dict], None]] = None,
    mesh=None,
) -> dict:
    """Train ``params["tiny_vae"]`` to mimic the full decoder on ``loader``'s
    images (cosine schedule, no weight decay); returns ``params`` with the
    module holding the trained weights (``masters["tiny_vae"]`` the f32
    masters, when given). ``tiny_vae_decode_psnr`` then says whether
    serving can decode with it for this domain. ``mesh``: as in
    ``pretrain_base_model``."""
    cfg = TrainConfig(learning_rate=lr, max_train_steps=steps, lr_scheduler="cosine",
                      lr_warmup_steps=min(50, steps // 4), adam_weight_decay=0.0)
    _run_stage(TinyVAEDistiller(pipe, cfg, mesh), params, loader, steps, "tiny_vae", seed, log_every,
               masters, step_hook, what="distill")
    return params


@torch.no_grad()
def tiny_vae_decode_psnr(pipe, params: dict, images) -> float:
    """PSNR in dB (a [-1, 1] signal: peak 2) of the tiny decode against the
    KL decode of the same posterior-mode latents; ``images`` (B, H, W, 3)
    uint8, or float in [-1, 1]."""
    x = torch.as_tensor(images).to(pipe.device)
    if x.dtype == torch.uint8:
        x = x.float() / 127.5 - 1.0
    z = params["vae"].encode(_nchw(x).to(pipe.dtype)).mode().float()
    teacher = params["vae"].decode(z.to(pipe.dtype)).float()
    student = params["tiny_vae"].decode((z * pipe.vae_cfg.scaling_factor).to(pipe.dtype)).float()
    mse = float(torch.mean((student - teacher) ** 2))
    return 10.0 * math.log10(4.0 / max(mse, 1e-12))


def save_base_model(out_dir: str | Path, params: dict, masters: Optional[dict] = None) -> Path:
    """HF-hub-style snapshot: ``<dir>/<model>/params.msgpack`` for every base
    model present, and the one-file ``<dir>/params.msgpack`` (all but the
    ControlNet) for the eval agents' ``sd_ckpt``. A model in ``masters``
    (``pretrain_base_model``'s, ``distill_tiny_vae``'s) is written from its
    f32 master weights, the
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
