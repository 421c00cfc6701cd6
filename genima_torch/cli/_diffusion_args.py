"""Argument parser of the port's diffusion trainers (SD and SDXL ControlNet,
InstructPix2Pix).

Every flag and default of the JAX package's trainers
(``genima_tpu/cli/_diffusion_args.py::build_parser("sd")``, ``("sdxl")``
and ``("pix2pix")``), whose names are the reference's
(``diffusion/train_controlnet_genima.py``,
``train_controlnet_sdxl_genima.py``, ``train_instruct_pix2pix_genima.py``),
so launch scripts carry over; plus
``--device``, the card (the default) or the CPU. Flags that do nothing in
the JAX trainer do nothing here either, and their help says so.
"""

from __future__ import annotations

import argparse

NO_OP = "accepted for launch-script compatibility; does nothing"


def build_parser(variant: str = "sd") -> argparse.ArgumentParser:
    if variant not in ("sd", "sdxl", "pix2pix"):
        raise ValueError(f"variant {variant!r}: the port has the sd, sdxl and pix2pix trainers")
    p = argparse.ArgumentParser(description=f"Genima {variant} trainer (PyTorch)")
    add = p.add_argument

    add("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    add("--pretrained_model_name_or_path", type=str, default=None,
        help="dir with base-model weights (unet/vae/text_encoder subdirs; "
             "native msgpack or diffusers safetensors / .bin)")
    add("--controlnet_model_name_or_path", type=str, default=None,
        help="a ControlNet checkpoint (output dir, checkpoint-<step> or final "
             "model dir) to start from instead of the UNet's weights")
    add("--revision", type=str, default=None, help=NO_OP)
    add("--variant", type=str, default=None, help=NO_OP)
    add("--tokenizer_name", type=str, default=None,
        help="path to a CLIP BPE merges file")
    add("--output_dir", type=str, default="./controlnet-model")
    add("--cache_dir", type=str, default=None, help=NO_OP)
    add("--seed", type=int, default=None)
    add("--resolution", type=int, default=512)

    # dataset (rlbench_dataset args)
    add("--data_path", type=str, required=False, default=None)
    add("--tasks", type=str, nargs="+", default=None)
    add("--variation", type=int, default=0)
    add("--num_demos", type=int, default=100)
    add("--cameras", type=str, nargs="+",
        default=["wrist", "front", "right_shoulder", "left_shoulder"])
    add("--image_type", type=str, default="tiled_rgb_rendered")
    add("--conditioning_image_type", type=str, default="tiled_rgb")
    add("--tiled", action="store_true", default=True)
    add("--no_tiled", dest="tiled", action="store_false")
    add("--caption_column", type=str, default=None, help=NO_OP)
    add("--max_train_samples", type=int, default=None)
    add("--proportion_empty_prompts", type=float, default=0.0)
    add("--dataloader_num_workers", type=int, default=8)

    # training
    add("--num_train_epochs", type=int, default=100)
    add("--max_train_steps", type=int, default=None)
    add("--train_batch_size", type=int, default=4)
    add("--gradient_accumulation_steps", type=int, default=1,
        help="average this many mini-steps' gradients per update "
             "(optax.MultiSteps); the step count counts mini-steps")
    add("--gradient_checkpointing", action="store_true")
    add("--learning_rate", type=float, default=5e-6)
    add("--scale_lr", action="store_true")
    add("--lr_scheduler", type=str, default="constant")
    add("--lr_warmup_steps", type=int, default=500)
    add("--lr_num_cycles", type=int, default=1)
    add("--lr_power", type=float, default=1.0)
    add("--use_8bit_adam", action="store_true",
        help="blockwise int8 Adam moments (core/optim.py): ~2.03 bytes per "
             "parameter of optimizer state instead of 8")
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
    add("--augmentations", type=str, default=None,
        help="comma list: colorjitter,elastic,blur,affine,crop")
    add("--tiny_vae", action="store_true",
        help=NO_OP + " (the SD trainer encodes with the full VAE)")
    add("--set_grads_to_none", action="store_true", help=NO_OP)

    # checkpointing / logging
    add("--checkpointing_steps", type=int, default=500)
    add("--checkpoints_total_limit", type=int, default=2)
    add("--resume_from_checkpoint", type=str, default=None,
        help='"latest", or a checkpoint-<step> dir')
    add("--validation_steps", type=int, default=100)
    add("--validation_prompt", type=str, default=None,
        help=NO_OP + " (validation prompts are the samples' own)")
    add("--validation_images_path", type=str, default=None)
    add("--num_validation_images", type=int, default=1)
    add("--logging_dir", type=str, default="logs")
    add("--report_to", type=str, default="tensorboard",
        help="tensorboard | wandb | all | none; metrics.jsonl is always written")
    add("--report_name", type=str, default=None)
    add("--tracker_project_name", type=str, default="genima_tpu")
    add("--push_to_hub", action="store_true", help=NO_OP)
    add("--hub_token", type=str, default=None, help=NO_OP)
    add("--hub_model_id", type=str, default=None, help=NO_OP)

    # precision / attention
    add("--mixed_precision", type=str, default="bf16", choices=["no", "fp16", "bf16"],
        help="bf16 compute with f32 master weights; fp16 maps to bf16; no = f32")
    add("--enable_xformers_memory_efficient_attention", action="store_true",
        help="route long self-attention through the packed flash-attention kernels")
    add("--allow_tf32", action="store_true", help=NO_OP)
    if variant == "pix2pix":
        add("--conditioning_dropout_prob", type=float, default=None,
            help="drop the prompt where a uniform draw is < 2p, the image where p <= it < 3p")
        add("--use_ema", action="store_true",
            help="keep an EMA (decay 0.9999) of the UNet; it is the final save")
        add("--original_image_column", type=str, default="conditioning_image", help=NO_OP)
        add("--edited_image_column", type=str, default="image", help=NO_OP)
    if variant == "sdxl":
        add("--pretrained_vae_model_name_or_path", type=str, default=None,
            help=NO_OP + " (the VAE comes from --pretrained_model_name_or_path, "
                 "as in the JAX trainer)")
    return p
