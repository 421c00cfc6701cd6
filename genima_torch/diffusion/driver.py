"""Training driver behind ``python -m genima_torch.cli.train_controlnet_genima``,
``train_controlnet_sdxl_genima`` and ``train_instruct_pix2pix_genima``.

Counterpart of ``genima_tpu/diffusion/driver.py`` for the SD and SDXL
ControlNet fine-tunes (``variant="sd"`` / ``"sdxl"``) and the
InstructPix2Pix UNet fine-tune (``variant="pix2pix"``) on one device: seed,
dataset and loader, models (seeded random
weights, then base weights from ``--pretrained_model_name_or_path`` when it
is a directory), the ControlNet from ``--controlnet_model_name_or_path`` or
``from_unet`` (pix2pix has none), the optimizer and its schedule, resume
from ``latest`` or a path, and the step loop:

* train metrics (loss, lr, steps/s) at step 1 and every 50 steps;
* a ``checkpoint-<step>/`` every ``--checkpointing_steps``, copied on the
  device and written on a background thread, pruned to
  ``--checkpoints_total_limit``;
* validation every ``--validation_steps``: 4-step, guidance-0 sampling of
  random samples with the updated master weights (SDXL: its ancestral
  noise from a generator seeded 1, as the reference's ``key(1)``; pix2pix:
  the condition as ``cond * 2 - 1``), a cond | target |
  generated | error-map grid per sample as a PNG under
  ``<output>/<logging_dir>/validation/``, and ``validation/val_mse``;
* on SIGTERM (or ``PreemptionGuard.request``): wait for the writer, write a
  checkpoint synchronously, stop;

then the final save of the f32 master weights (pix2pix under
``--use_ema``: the EMA) to ``<output>/<model>/params.msgpack``, where the
model is ``controlnet``, or pix2pix's ``unet``. Metrics go to
``<output>/<logging_dir>/metrics.jsonl`` and, with ``--report_to``, to
TensorBoard / W&B where installed. Checkpoints are the JAX package's trees
(``diffusion/train_state.py``; pix2pix's EMA as ``ema.msgpack`` beside
them), so either package resumes the other's.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from genima_torch import resolve_device
from genima_torch.core import checkpoint as ckpt
from genima_torch.core.logging import MetricLogger
from genima_torch.core.preemption import PreemptionGuard
from genima_torch.core.rng import seed_everything
from genima_torch.data.dataset import DevicePrefetcher, DiffusionDataLoader, index_rendered_dataset
from genima_torch.data.tokenizer import load_tokenizer
from genima_torch.diffusion import train_state as ts
from genima_torch.diffusion.pipeline import (
    SDControlNetPipeline, SDPix2PixPipeline, SDXLControlNetPipeline,
)
from genima_torch.diffusion.schedulers import SchedulerConfig
from genima_torch.diffusion.training import (
    ControlNetTrainer, Pix2PixTrainer, SDXLControlNetTrainer, TrainConfig, TrainState,
)
from genima_torch.nn.controlnet import controlnet_params_from_unet
from genima_torch.weights.load_pretrained import load_pretrained_pipeline

LOG_EVERY = 50
MODEL_SUBDIR = "controlnet"
VALIDATION_STEPS, VALIDATION_GUIDANCE = 4, 0.0


PIPELINES = {"sd": SDControlNetPipeline, "sdxl": SDXLControlNetPipeline,
             "pix2pix": SDPix2PixPipeline}


def build_pipeline(args, variant: str = "sd", device: Any = None) -> SDControlNetPipeline:
    """sd-turbo (or sdxl-turbo) + ControlNet, or the 8-channel pix2pix
    UNet, with the VAE's encoder; the packed attention kernels with
    ``--enable_xformers_memory_efficient_attention``; bf16 unless
    ``--mixed_precision no``."""
    return PIPELINES[variant](
        dtype=torch.float32 if args.mixed_precision == "no" else torch.bfloat16,
        backend="fused" if args.enable_xformers_memory_efficient_attention else "xla",
        device=device if device is not None else args.device,
        vae_encoder=True,
    )


def _index(args, data_path) -> list:
    return index_rendered_dataset(
        data_path,
        tasks=args.tasks,
        variation=args.variation,
        num_demos=args.num_demos,
        image_type=args.image_type,
        conditioning_image_type=args.conditioning_image_type,
        cameras=args.cameras,
        tiled=args.tiled,
    )


def make_train_dataset(args, tokenizer) -> DiffusionDataLoader:
    samples = _index(args, args.data_path)
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
    """The pipeline's models: from the reference's param ``tree`` when given, else
    seeded random weights made on the device; then base weights from
    ``--pretrained_model_name_or_path`` when it is a directory; then the
    ControlNet from ``--controlnet_model_name_or_path`` when it exists,
    else from the UNet (the reference's ``ControlNetModel.from_unet``), where
    the pipeline has one."""
    if tree is not None:
        params = pipe.params_from_jax(tree)
    else:
        params = pipe.init_params(torch.Generator(device=pipe.device).manual_seed(args.seed or 0))
    base = args.pretrained_model_name_or_path
    if base and Path(base).is_dir():
        print(f"base weights: {load_pretrained_pipeline(base, params)}")
    elif base:
        print(f"base weights: {base} is not a directory; keeping the seeded weights")
    if "controlnet" not in params:  # pix2pix trains its UNet
        return params
    cn_path = args.controlnet_model_name_or_path
    if cn_path and Path(cn_path).exists():
        model_dir = ckpt.find_model_checkpoint(cn_path, MODEL_SUBDIR)
        pipe.load_tree(params, "controlnet", ckpt.load_pytree(model_dir / "params.msgpack"))
        print(f"controlnet init from {model_dir}")
    else:
        cn = params["controlnet"]
        cn.load_state_dict(controlnet_params_from_unet(params["unet"].state_dict(),
                                                       cn.state_dict()))
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
        use_8bit_adam=args.use_8bit_adam,
        max_grad_norm=args.max_grad_norm,
        gradient_checkpointing=args.gradient_checkpointing,
        lr_scheduler=args.lr_scheduler,
        lr_num_cycles=args.lr_num_cycles,
        lr_power=args.lr_power,
        lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=max_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        timestep_spacing=args.timestep_spacing,
        train_timestep_grid=(
            tuple(int(t) for t in args.train_timestep_grid.split(","))
            if args.train_timestep_grid else None
        ),
        augmentations=args.augmentations,
        scheduler_config=SchedulerConfig(
            timestep_spacing="trailing" if args.train_scheduler == "euler_discrete" else "leading"
        ),
    )


def make_trainer(args, variant: str, pipe: SDControlNetPipeline, cfg: TrainConfig,
                 tokenizer) -> ControlNetTrainer:
    """The variant's trainer; pix2pix's null prompt is the tokenizer's ``""``."""
    if variant == "sdxl":
        return SDXLControlNetTrainer(pipe, cfg, args.resolution)
    if variant == "pix2pix":
        return Pix2PixTrainer(pipe, cfg,
                              conditioning_dropout_prob=args.conditioning_dropout_prob,
                              use_ema=args.use_ema, null_token_ids=tokenizer([""]))
    return ControlNetTrainer(pipe, cfg)


# -- checkpoints --------------------------------------------------------------------


def checkpoint_trees(trainer: ControlNetTrainer, state: TrainState) -> tuple[dict, dict]:
    """(params tree, train-state tree) of ``state``: views of its tensors."""
    return (ts.params_tree(state.params, trainer.paths),
            {"opt_state": ts.opt_state_tree(state.opt_state, trainer.paths),
             "step": np.asarray(state.step, np.int32)})


def extra_trees(trainer: ControlNetTrainer, state: TrainState) -> dict:
    """The checkpoint's ``<name>.msgpack`` trees: the EMA's, where the
    state keeps one (views of its tensors)."""
    return {} if state.ema is None else {"ema": ts.params_tree(state.ema, trainer.paths)}


def restore_checkpoint(trainer: ControlNetTrainer, state: TrainState, resume_dir: Path) -> TrainState:
    """``state`` with the params, optimizer state and step of ``resume_dir``
    (params only when it holds no ``train_state.msgpack``), and the EMA of
    its ``ema.msgpack`` where the state keeps one and the file exists."""
    tree = ckpt.load_pytree(resume_dir / trainer.TRAINED[0] / "params.msgpack")
    params = ts.params_from_tree(tree, trainer.paths, state.params)
    ema = state.ema
    if ema is not None and (resume_dir / "ema.msgpack").exists():
        ema = ts.params_from_tree(ckpt.load_pytree(resume_dir / "ema.msgpack"), trainer.paths,
                                  ema, what="ema")
    train_state_path = resume_dir / "train_state.msgpack"
    if not train_state_path.exists():
        return TrainState(params, state.opt_state, state.step, ema)
    restored = ckpt.load_pytree(train_state_path)
    return TrainState(
        params,
        ts.opt_state_from_tree(restored["opt_state"], state.opt_state, trainer.paths),
        int(np.asarray(restored["step"])),
        ema,
    )


def find_resume_dir(args) -> Optional[Path]:
    if args.resume_from_checkpoint == "latest":
        return ckpt.latest_step_checkpoint(args.output_dir)
    if Path(args.resume_from_checkpoint).exists():
        return Path(args.resume_from_checkpoint)
    return None


# -- validation ---------------------------------------------------------------------


def _validation_samples(loader: DiffusionDataLoader, args) -> list:
    """Random samples (global ``np.random``, as the reference draws them)
    from ``--validation_images_path`` when it indexes, else the training set."""
    samples = loader.samples
    if args.validation_images_path:
        try:
            samples = _index(args, args.validation_images_path) or samples
        except OSError as e:  # a broken validation dir must not end a long fine-tune
            print(f"validation_images_path unusable ({e}); validating on training samples instead")
    n = max(1, int(args.num_validation_images or 1))
    idx = np.random.choice(len(samples), size=n, replace=len(samples) < n)
    return [samples[int(i)] for i in idx]


def log_validation(pipe: SDControlNetPipeline, params: dict, loader: DiffusionDataLoader, args,
                   logger: MetricLogger, step: int) -> float:
    """Sample each validation image (4 steps, guidance 0, latents seeded
    ``seed + j``; SDXL's ancestral noise from a generator seeded 1 for each
    image, as the reference's ``key(1)``), write its cond | target | generated | error-map grid
    (``(gen - gt) / sqrt(mse) * 255``, shifted to uint8) and log
    ``validation/val_mse``."""
    from PIL import Image

    out_dir = Path(args.output_dir) / args.logging_dir / "validation"
    out_dir.mkdir(parents=True, exist_ok=True)
    mses, images = [], {}
    lat = args.resolution // pipe.vae_scale_factor
    for j, sample in enumerate(_validation_samples(loader, args)):
        gt, cond_u8 = loader._load_one(sample)  # uint8: the loader emits uint8
        embeds = pipe.encode_prompt(params, np.asarray(loader.tokenizer([sample.text]), np.int32))
        gen = torch.Generator(device=pipe.device).manual_seed((args.seed or 0) + j)
        latents = torch.randn(1, lat, lat, pipe.vae_cfg.latent_channels, generator=gen,
                              device=pipe.device)
        cond = torch.tensor(cond_u8[None])
        if isinstance(pipe, SDPix2PixPipeline):
            image = pipe.generate(params, cond.float() / 255.0 * 2 - 1, embeds, latents,
                                  num_inference_steps=VALIDATION_STEPS)
        elif isinstance(pipe, SDXLControlNetPipeline):
            noise = torch.randn(VALIDATION_STEPS, *latents.shape, device=pipe.device,
                                generator=torch.Generator(device=pipe.device).manual_seed(1))
            image = pipe.generate(params, cond, *embeds, latents, noise,
                                  num_inference_steps=VALIDATION_STEPS)
        else:
            image = pipe.generate(params, cond, embeds, latents,
                                  num_inference_steps=VALIDATION_STEPS,
                                  guidance_scale=VALIDATION_GUIDANCE)
        image = image[0].cpu().numpy().astype(np.float32)
        # the reference's round trip through [-1, 1] and [0, 1] (its grid
        # truncates what the trip leaves below an integer)
        gt_img = ((gt.astype(np.float32) / 127.5 - 1.0 + 1) * 127.5).astype(np.float32)
        cond_img = cond_u8.astype(np.float32) / 255.0 * 255.0
        diff = image - gt_img
        mse = float(np.mean(np.square(diff)))
        mses.append(mse)
        norm_mse = (diff / np.sqrt(mse) if mse > 0 else diff) * 255.0
        err_vis = np.clip(norm_mse / 2.0 + 127.5, 0, 255)
        grid = np.concatenate([cond_img, gt_img, image, err_vis],
                              axis=1).astype(np.uint8)
        images[f"sample_{j}"] = grid
        Image.fromarray(grid).save(out_dir / f"step{step}_val{j}.png")
    val_mse = float(np.mean(mses))
    logger.log_metrics({"val_mse": val_mse}, step, prefix="validation")
    logger.log_images(images, step, prefix="validation")
    return val_mse


# -- the loop -----------------------------------------------------------------------


def run_training(
    args,
    variant: str = "sd",
    pipe: Optional[SDControlNetPipeline] = None,
    params: Optional[dict] = None,
    step_hook: Optional[Callable[[int, TrainState, dict], None]] = None,
    preemption: Optional[PreemptionGuard] = None,
) -> dict:
    """Train the ``variant``'s ControlNet ("sd" or "sdxl") or pix2pix UNet
    ("pix2pix") for ``max_train_steps`` (or the epochs' worth) and save it. ``pipe`` and
    ``params`` default to ``build_pipeline`` and
    ``init_model_params``; ``step_hook(step, state, metrics)`` runs after
    every step; ``preemption`` defaults to a guard installed on SIGTERM for
    the run (a caller's guard is polled, not installed)."""
    device = resolve_device(args.device)
    if args.seed is not None:
        seed_everything(args.seed)
    tokenizer = load_tokenizer(args.tokenizer_name, model_dir=args.pretrained_model_name_or_path)
    pipe = pipe if pipe is not None else build_pipeline(args, variant, device)
    loader = make_train_dataset(args, tokenizer)
    if len(loader) == 0:
        raise ValueError(
            f"{len(loader.samples)} samples cannot fill one batch of {args.train_batch_size}"
        )
    max_steps = args.max_train_steps or args.num_train_epochs * len(loader)
    cfg = train_config(args, max_steps)
    trainer = make_trainer(args, variant, pipe, cfg, tokenizer)
    subdir = trainer.TRAINED[0]
    params = params if params is not None else init_model_params(pipe, args)
    state = trainer.create_state(params)

    if args.resume_from_checkpoint:
        resume_dir = find_resume_dir(args)
        if resume_dir is None:
            print(f"Checkpoint '{args.resume_from_checkpoint}' does not exist. "
                  "Starting a new training run.")
        else:
            state = restore_checkpoint(trainer, state, resume_dir)
            print(f"Resumed from {resume_dir} at step {state.step}")

    logger = MetricLogger(
        Path(args.output_dir) / args.logging_dir,
        use_tb=args.report_to in ("tensorboard", "all"),
        use_wandb=args.report_to in ("wandb", "all"),
        wandb_kwargs={"project": args.tracker_project_name, "name": args.report_name},
    )
    generator = torch.Generator(device=pipe.device).manual_seed((args.seed or 0) + 1234)
    writer = ckpt.AsyncCheckpointer()
    guard = preemption if preemption is not None else PreemptionGuard.install()
    prefetch = DevicePrefetcher(loader, pipe.device, depth=2)
    t_start = time.time()
    metrics: dict = {}
    val_mse = None
    try:
        while state.step < max_steps:
            for batch in prefetch:
                state, metrics = trainer.train_step(state, batch, generator)
                step = state.step
                if step_hook is not None:
                    step_hook(step, state, metrics)
                if step % LOG_EVERY == 0 or step == 1:
                    logger.log_metrics({
                        "loss": float(metrics["loss"]),
                        "lr": float(metrics["lr"]),
                        "steps_per_sec": step / (time.time() - t_start),
                    }, step, prefix="train")
                if args.checkpointing_steps and step % args.checkpointing_steps == 0:
                    model_tree, state_tree = checkpoint_trees(trainer, state)
                    writer.submit(  # copies the trees before it returns
                        ckpt.save_step_checkpoint, args.output_dir, step,
                        model_params=model_tree, model_subdir=subdir,
                        train_state=state_tree, total_limit=args.checkpoints_total_limit,
                        extra=extra_trees(trainer, state),
                    )
                    print(f"Saving state to checkpoint-{step} (async)")
                if args.validation_steps and step % args.validation_steps == 0:
                    trainer.sync_working_copy(state)  # the updated master weights
                    val_mse = log_validation(pipe, {**trainer.frozen, subdir: trainer.model},
                                             loader, args, logger, step)
                if guard.requested:
                    writer.wait()
                    model_tree, state_tree = checkpoint_trees(trainer, state)
                    ckpt.save_step_checkpoint(
                        args.output_dir, step, model_params=model_tree,
                        model_subdir=subdir, train_state=state_tree,
                        total_limit=args.checkpoints_total_limit,
                        extra=extra_trees(trainer, state),
                    )
                    print(f"Preemption requested: saved checkpoint-{step}, exiting "
                          "(resume with --resume_from_checkpoint latest)")
                    break
                if step >= max_steps:
                    break
            if guard.requested:
                break
    finally:
        # flush the writer while the guard still absorbs a second SIGTERM,
        # then drop the handler even if the write raised
        try:
            writer.close()
        finally:
            if preemption is None:
                guard.uninstall()
            logger.close()

    final = state.ema if state.ema is not None else state.params
    ckpt.save_final_model(args.output_dir, ts.params_tree(final, trainer.paths), subdir)
    return {
        "global_step": state.step,
        "final_loss": float(metrics["loss"]) if metrics else None,
        "val_mse": val_mse,
    }
