"""Argument parser of the port's ControlNet trainer.

The flag names are the reference's (``diffusion/train_controlnet_genima.py``)
and the JAX package's (``genima_tpu/cli/_diffusion_args.py``), so launch
scripts carry over. Features the port does not have yet default to off, and
the driver raises when one is asked for (``diffusion.driver.unsupported``):
step checkpoints, resume, validation, TensorBoard/wandb, pretrained weight
loading, 8-bit Adam, gradient accumulation, augmentations and the tiny VAE.
``--device`` picks the card (the default) or the CPU.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Genima ControlNet trainer (PyTorch)")
    add = p.add_argument

    add("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    add("--pretrained_model_name_or_path", type=str, default=None)
    add("--controlnet_model_name_or_path", type=str, default=None)
    add("--tokenizer_name", type=str, default=None,
        help="path to a CLIP BPE merges file")
    add("--output_dir", type=str, default="./controlnet-model")
    add("--seed", type=int, default=None)
    add("--resolution", type=int, default=512)

    # dataset (rlbench_dataset args)
    add("--data_path", type=str, default=None)
    add("--tasks", type=str, nargs="+", default=None)
    add("--variation", type=int, default=0)
    add("--num_demos", type=int, default=100)
    add("--cameras", type=str, nargs="+",
        default=["wrist", "front", "right_shoulder", "left_shoulder"])
    add("--image_type", type=str, default="tiled_rgb_rendered")
    add("--conditioning_image_type", type=str, default="tiled_rgb")
    add("--tiled", action="store_true", default=True)
    add("--no_tiled", dest="tiled", action="store_false")
    add("--max_train_samples", type=int, default=None)
    add("--proportion_empty_prompts", type=float, default=0.0)
    add("--dataloader_num_workers", type=int, default=8)

    # training
    add("--num_train_epochs", type=int, default=100)
    add("--max_train_steps", type=int, default=None)
    add("--train_batch_size", type=int, default=4)
    add("--gradient_accumulation_steps", type=int, default=1)
    add("--gradient_checkpointing", action="store_true")
    add("--learning_rate", type=float, default=5e-6)
    add("--scale_lr", action="store_true")
    add("--lr_scheduler", type=str, default="constant")
    add("--lr_warmup_steps", type=int, default=500)
    add("--lr_num_cycles", type=int, default=1)
    add("--lr_power", type=float, default=1.0)
    add("--use_8bit_adam", action="store_true")
    add("--adam_beta1", type=float, default=0.9)
    add("--adam_beta2", type=float, default=0.999)
    add("--adam_weight_decay", type=float, default=1e-2)
    add("--adam_epsilon", type=float, default=1e-8)
    add("--max_grad_norm", type=float, default=1.0)
    add("--train_scheduler", type=str, default="ddpm",
        choices=["ddpm", "euler_discrete", "ddim"])
    add("--timestep_spacing", type=str, default="uniform",
        choices=["uniform", "turbo_timesteps"])
    add("--train_timestep_grid", type=str, default=None,
        help="comma list of explicit training timesteps; overrides --timestep_spacing")
    add("--augmentations", type=str, default=None)
    add("--tiny_vae", action="store_true")

    # checkpointing / logging: not ported yet, off by default
    add("--checkpointing_steps", type=int, default=None)
    add("--checkpoints_total_limit", type=int, default=2)
    add("--resume_from_checkpoint", type=str, default=None)
    add("--validation_steps", type=int, default=None)
    add("--validation_images_path", type=str, default=None)
    add("--report_to", type=str, default="none")

    # precision / attention
    add("--mixed_precision", type=str, default="bf16", choices=["no", "fp16", "bf16"],
        help="bf16 compute with f32 master weights; fp16 maps to bf16; no = f32")
    add("--enable_xformers_memory_efficient_attention", action="store_true",
        help="route long self-attention through the packed flash-attention kernels")
    return p
