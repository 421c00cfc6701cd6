"""Training driver behind ``python -m genima_torch.cli.train_controlnet_genima``.

Counterpart of ``genima_tpu/diffusion/driver.py`` for the SD ControlNet
fine-tune on one device: seed, dataset and loader, models (seeded random
weights, or the caller's), ``from_unet`` initialisation of the ControlNet,
AdamW with its schedule, and the step loop, which logs loss and learning
rate at step 1 and every 50 steps and stops at ``max_train_steps``.

Not ported yet, and raising when asked for (``unsupported``): step
checkpoints and resume, the final model save, validation images,
TensorBoard / wandb, preemption handling, loading pretrained or ControlNet
weights from disk, 8-bit Adam, gradient accumulation, augmentations, the
tiny VAE, and the SDXL / pix2pix variants.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from genima_torch import resolve_device
from genima_torch.core.rng import seed_everything
from genima_torch.data.dataset import DevicePrefetcher, DiffusionDataLoader, index_rendered_dataset
from genima_torch.data.tokenizer import load_tokenizer
from genima_torch.diffusion.pipeline import SDControlNetPipeline
from genima_torch.diffusion.schedulers import SchedulerConfig
from genima_torch.diffusion.training import ControlNetTrainer, TrainConfig, TrainState
from genima_torch.nn.controlnet import controlnet_params_from_unet

LOG_EVERY = 50


def unsupported(args) -> list[str]:
    """The flags in ``args`` that ask for what the port does not have yet."""
    asked = {
        "--pretrained_model_name_or_path": args.pretrained_model_name_or_path,
        "--controlnet_model_name_or_path": args.controlnet_model_name_or_path,
        "--checkpointing_steps": args.checkpointing_steps,
        "--resume_from_checkpoint": args.resume_from_checkpoint,
        "--validation_steps": args.validation_steps,
        "--validation_images_path": args.validation_images_path,
        "--report_to": args.report_to not in (None, "none"),
        "--use_8bit_adam": args.use_8bit_adam,
        "--gradient_accumulation_steps": args.gradient_accumulation_steps > 1,
        "--augmentations": args.augmentations,
        "--tiny_vae": args.tiny_vae,
    }
    return [flag for flag, value in asked.items() if value]


def build_pipeline(args, device: Any = None) -> SDControlNetPipeline:
    """sd-turbo + ControlNet with the VAE's encoder; the packed attention
    kernels with ``--enable_xformers_memory_efficient_attention``; bf16
    unless ``--mixed_precision no``."""
    return SDControlNetPipeline(
        dtype=torch.float32 if args.mixed_precision == "no" else torch.bfloat16,
        backend="fused" if args.enable_xformers_memory_efficient_attention else "xla",
        device=device if device is not None else args.device,
        vae_encoder=True,
    )


def make_train_dataset(args, tokenizer) -> DiffusionDataLoader:
    samples = index_rendered_dataset(
        args.data_path,
        tasks=args.tasks,
        variation=args.variation,
        num_demos=args.num_demos,
        image_type=args.image_type,
        conditioning_image_type=args.conditioning_image_type,
        cameras=args.cameras,
        tiled=args.tiled,
    )
    if args.max_train_samples is not None:
        rng = np.random.RandomState(args.seed or 0)
        pick = rng.permutation(len(samples))[: args.max_train_samples]
        samples = [samples[i] for i in pick]
    return DiffusionDataLoader(
        samples,
        tokenizer,
        batch_size=args.train_batch_size,
        resolution=args.resolution,
        num_workers=args.dataloader_num_workers,
        seed=args.seed or 0,
        proportion_empty_prompts=args.proportion_empty_prompts,
        emit_uint8=True,  # 4x less host->device traffic; normalised on the device
    )


def init_model_params(pipe: SDControlNetPipeline, args, tree: Optional[dict] = None) -> dict:
    """The four models: from the reference's param ``tree`` when given, else
    seeded random weights made on the device; then the ControlNet's shared
    subtrees from the UNet (the reference's ``ControlNetModel.from_unet``)."""
    if tree is not None:
        params = pipe.params_from_jax(tree)
    else:
        params = pipe.init_params(torch.Generator(device=pipe.device).manual_seed(args.seed or 0))
    cn = params["controlnet"]
    cn.load_state_dict(controlnet_params_from_unet(params["unet"].state_dict(), cn.state_dict()))
    return params


def train_config(args, max_steps: int) -> TrainConfig:
    lr = args.learning_rate
    if args.scale_lr:
        lr *= args.gradient_accumulation_steps * args.train_batch_size
    return TrainConfig(
        learning_rate=lr,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        adam_weight_decay=args.adam_weight_decay,
        adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        gradient_checkpointing=args.gradient_checkpointing,
        lr_scheduler=args.lr_scheduler,
        lr_num_cycles=args.lr_num_cycles,
        lr_power=args.lr_power,
        lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=max_steps,
        timestep_spacing=args.timestep_spacing,
        train_timestep_grid=(
            tuple(int(t) for t in args.train_timestep_grid.split(","))
            if args.train_timestep_grid else None
        ),
        scheduler_config=SchedulerConfig(
            timestep_spacing="trailing" if args.train_scheduler == "euler_discrete" else "leading"
        ),
    )


def run_training(
    args,
    pipe: Optional[SDControlNetPipeline] = None,
    params: Optional[dict] = None,
    step_hook: Optional[Callable[[int, TrainState, dict], None]] = None,
) -> dict:
    """Train the ControlNet for ``max_train_steps`` (or the epochs' worth).
    ``pipe`` and ``params`` default to ``build_pipeline`` and
    ``init_model_params``; ``step_hook(step, state, metrics)`` runs after
    every step."""
    asked = unsupported(args)
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)}")
    device = resolve_device(args.device)
    if args.seed is not None:
        seed_everything(args.seed)
    tokenizer = load_tokenizer(args.tokenizer_name)
    pipe = pipe if pipe is not None else build_pipeline(args, device)
    loader = make_train_dataset(args, tokenizer)
    if len(loader) == 0:
        raise ValueError(
            f"{len(loader.samples)} samples cannot fill one batch of {args.train_batch_size}"
        )
    max_steps = args.max_train_steps or args.num_train_epochs * len(loader)
    trainer = ControlNetTrainer(pipe, train_config(args, max_steps))
    params = params if params is not None else init_model_params(pipe, args)
    state = trainer.create_state(params)

    generator = torch.Generator(device=pipe.device).manual_seed((args.seed or 0) + 1234)
    prefetch = DevicePrefetcher(loader, pipe.device, depth=2)
    t_start = time.time()
    metrics: dict = {}
    while state.step < max_steps:
        for batch in prefetch:
            state, metrics = trainer.train_step(state, batch, generator)
            if step_hook is not None:
                step_hook(state.step, state, metrics)
            if state.step % LOG_EVERY == 0 or state.step == 1:
                print(json.dumps({
                    "step": state.step,
                    "loss": float(metrics["loss"]),
                    "lr": metrics["lr"],
                    "steps_per_sec": state.step / (time.time() - t_start),
                }), flush=True)
            if state.step >= max_steps:
                break
    return {"global_step": state.step, "final_loss": float(metrics["loss"])}
