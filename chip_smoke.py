#!/usr/bin/env python3
"""Drive genima_torch's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --wide    # phase 18 alone, after the build

1. Builds every CUDA kernel of the paths from ``genima_torch/csrc`` into
   ``build/`` (one ``nvcc`` per source, started together).
2. Kernel phase: each kernel at the shapes its path gives it, on seeded bf16
   inputs, against its plain PyTorch version (stated tolerance), timed with
   CUDA events beside its plain version and the one library call that
   computes the same function (``scaled_dot_product_attention`` forward, or
   its autograd backward: yardsticks the port never calls). B1, the packed
   forward, at the serving batch 1 and the trainer's batch 4; B2a (forward
   + log-sum-exp) and B2b (backward) at batch 4. B2a's output must be B1's
   bit for bit. B1/B2a rows carry their launch plan (``forward_plan``),
   ptxas registers and spills and shared memory (held to the kernel's own
   count); B2b's rows its two kernels' registers, spills and shared memory,
   and two B2b calls on the same inputs must give the same bits.
3. Serving path: the fused control step (SD-turbo ControlNet 5-step
   denoise, VAE decode, untile, ACT) at full sd-turbo + ACT width with
   seeded random weights, for a few steps on 512x512 uint8 observations.
   Launch counts are zeroed just before and read just after; each step must
   launch B1 exactly 105 times. The result is checked for shape, dtype and
   finiteness, and one denoise step's noise prediction is held to the same
   models run with the library attention instead of the kernel.
4. Opt-in kernel phase: B3 (flash attention on (B, S, H, 64)), B4 (fused
   GN-SiLU-conv3x3, NHWC) and B5 (int8 weight-only matmul) at every distinct
   shape the opt-in serving configuration gives them, against their plain
   versions, timed beside their bound and a labelled library yardstick.
   B3/B4/B5 rows carry their launch plan, ptxas registers and spills and
   shared memory (held to the kernel's own count); two B5 calls on the
   same inputs must give the same bits.
5. Opt-in serving path: the same control step built with
   ``backend="pallas+w8", conv_backend="fused"`` (int8 weights quantized by
   ``quantize_pipeline_params`` from the seeded floats). Each step must
   launch B3 230 times, B5 1380 times, B4 25 times and B1 never. One
   denoise step's noise prediction is held to the library attention on the
   same int8 weights (B3 in place), that to the float models on the
   dequantised weights (B5 in place), and the fused VAE decode to the
   default decoder on the same latents (B4 in place).
6. Train path: ``genima_torch.diffusion.driver.run_training`` (the CLI's
   entry point) takes 3 ControlNet fine-tune steps at full sd-turbo width,
   512x512, batch 4, bf16 compute with f32 master weights, the packed
   attention kernels, on a small rendered dataset written from the seed.
   Each step must launch B1 6 times, B2a and B2b 15 times each, with no
   plain-recompute fallback; the loss must be finite, the ControlNet must
   move and the UNet, VAE and CLIP must stay bit-unchanged. Then one step's
   ControlNet gradients through the kernels are held to those through the
   library attention.
7. Eval path: ``genima_torch.cli.eval_genima.main``, the serial closed-loop
   eval on the fake env at 256x256 views (512x512 tiles), from checkpoints
   the phase writes with the port's own flax-msgpack writer under a
   temporary directory: a full-width controller (``ACTConfig()``, ResNet-18
   width 64, its train config as ``config_json``, the stats JSON files) and
   a seeded f32 ControlNet (``checkpoint-1/controlnet/params.msgpack``); the
   base models stay seeded. Two episodes at guidance 0 (the fused control
   step), then one at guidance 2.0 (classifier-free guidance: B1 at batch
   2, the split infer -> untile -> ACT path). Every control step must
   launch B1 exactly 105 times, at batch 1 and at batch 2 under CFG; no
   episode may end on an env exception; the loaded ControlNet must equal
   the written tree after the bf16 cast; targets must be (1,512,512,3)
   uint8 and actions finite; one harness control step must equal
   ``FusedGenimaStep`` called directly on the same inputs and params. The
   kernel phase also times B1 at batch 2 at the three levels.

8. Fine-tune features: ``run_training`` at the train path's width and
   batch on a seeded dataset of 12 samples (3 batches an epoch, so the
   steps timed around a submit start no epoch). Run A: every augmentation,
   a step checkpoint every 2 steps (limit 1), validation every 3 (so the
   step after a submit carries the writer alone), TensorBoard, 6 steps
   asked for, and a preemption request after step 3: it must stop at 3
   with only ``checkpoint-3`` (params, train state, metadata), the step-3
   validation PNG and a finite val_mse; each train step launches
   B1/B2a/B2b as in phase 6, each validation 84 B1 (4 denoise steps at batch 1) and no
   B2. Run B: resume from ``latest`` to step 6; the restored params and
   moments must equal run A's at step 3 bit for bit, and the final
   ``controlnet/params.msgpack`` loaded by the eval agent must equal the
   final master weights cast to bf16. Run C: 8-bit AdamW, 2-step gradient
   accumulation, 4 mini-steps; the params stay after mini-steps 1 and 3 and
   move after 2 and 4, and the 8-bit moments hold ~2.03 bytes a parameter.
   Times: the checkpoint's bytes, each write's seconds, each submit's wait
   on the previous write and its copy apart, the step right after a submit
   against the one before it, the resume's load, validation, run C's steps,
   peak memory.
9. ACT controller training: ``genima_torch.cli.train_act.main`` at the
   published controller width (``ACTConfig()``, ResNet-18 width 64 over 4
   views at 256x256, CLIP ViT-B/32 text, batch 8, augmentations, AdamW at
   5e-5 / 1e-5 for the backbone), f32, seeded weights made on the card, on
   4 fake demos of 40 steps (156 samples, 20 steps an epoch): 2 epochs with
   a checkpoint each, a resume of the same directory to epoch 3, then
   ``eval_act`` for one episode from it. Fails on a non-finite loss, a
   swallowed update exception, a frozen BatchNorm tensor or the CLIP tower
   not bit-unchanged, a parameter group that did not move, a work dir
   without ``latest.ckpt`` and ``1.ckpt`` as the JAX package rotates them,
   a payload not equal to the live master weights bit for bit, a
   ``config.yaml`` the port's own reader does not read back, a resume not
   at epoch 2 with 40 updates, non-finite eval actions, any B1-B5 launch,
   and a first-step loss more than 1e-2 (relative) from the same step run
   by the port on the CPU in f32 with the same batch and draws. Times: the
   step (median after step 2, host clock), the update's augmentation,
   forward + backward and optimizer by CUDA events, samples/s, epoch
   seconds, the checkpoint's bytes and write seconds, the resume's load,
   peak memory, and the update with cuDNN's TF32 off and on in turns (on
   is PyTorch's default for convolutions, which the CLI leaves alone).

10. Lockstep-batched eval (run right after phase 7, on its checkpoints):
   ``eval_genima.main`` with ``num_parallel_envs=4``, 5 episodes (the
   second round: 1 counted and 3 uncounted slots), guidance 0, beside run
   S, the serial harness on the same 5 episodes (each run's loop time, less
   the checkpoint load and the gen-time probe, gives its control steps a
   second). Run A overlaps two cohorts of 2 envs
   (``eval_overlap=true``): every generate launches B1 105 times at batch
   2, targets (2,512,512,3) uint8, actions (2,20,8) finite. Run B is one
   batch of 4 (B1 at batch 4) with run A's episode count and per-episode
   steps. Then, on the device worker's stream: one ``BatchedGenimaStep`` at
   4 envs, row by row against ``FusedGenimaStep`` at batch 1 (the
   ``ROW_*`` limits), its time by events and host clock beside the serial
   step's and N=2's; the opt-in batched step (pinned 230 B3 / 25 B4 / 1380
   B5 / 0 B1 a step, rows held likewise); B3/B4/B5 at every batch-4 shape
   against their plain versions; B5 split-K calls on two streams at once
   bit-equal to the same calls one after the other.
11. Rendering, pretraining, the controller on rendered data and the gate:
   (a) 8 goal-observable fake demos of 60 steps at 256x256 over the 4
   non-overhead cameras, exported, then ``RenderData`` on the card with
   ``RENDER``'s values (both draw sets, joints 1/3/5, the cameras' scales)
   except the learning gate's sphere radius 0.11 and 4 episode threads:
   frames/s by the host clock, one camera-episode's render call by events,
   and episode 0 rendered again on the CPU (at most 0.1% of pixels more
   than 1 level apart). (b) 3 ``VAETrainer`` and 3 ``UNetPretrainer``
   steps at sd-turbo geometry (512x512 tiles, 64x64 latents, batch 4,
   bf16 compute with f32 masters) on the rendered tiles: each UNet step
   launches B2a and B2b 15 times and B1 never, VAE steps none, no
   fallback, finite losses, the frozen models bit-unchanged in each stage;
   ``save_base_model`` (bytes, write s), then 2 steps of
   ``run_training --pretrained_model_name_or_path <base>`` (its UNet must
   be the written one; the fine-tune's pinned launches); the PNG decoder
   the loader used. (c) 1 epoch of ``train_act env.factory=rendered`` at
   ``ACTConfig()`` width on the rendered tree, then ``run_learning_gate``
   at a cut ``GateConfig`` (10 steps a stage, 8 demos, 1 ACT epoch, 2
   eval episodes), whose ``learning_gate.json`` must hold the JAX keys;
   neither launches a kernel.
12. The SDXL-turbo ControlNet variant at its published width and depth
   (``UNetConfig.sdxl``, the SDXL ControlNet, ``CLIPTextConfig.sdxl_one`` +
   ``sdxl_two``, ``VAEConfig.sdxl``; seeded weights made on the card, bf16).
   (a) 3 control steps of ``build_main_path(variant="sdxl")`` (512x512, 5
   Euler-ancestral steps, batch 1): each launches B1 520 times (70 UNet +
   34 ControlNet self-attentions at >= 256 tokens a denoise step); one
   denoise step's noise prediction held to the library attention. (b) 3
   steps of ``run_training(args, "sdxl")`` at the SDXL trainer CLI's
   defaults (batch 4, 512x512) on seeded PNGs: each launches B1 34, B2a 70,
   B2b 70 times with no fallback; finite losses, the ControlNet moves, the
   UNet, VAE and both text encoders stay bit-unchanged; one step's ControlNet
   gradients held to the library attention. (c) ``eval_genima.main`` with
   ``SDXLControlNetAgent`` loading (b)'s final save, on phase 7's controller:
   one serial episode (every generate 520 B1 at batch 1; the loaded
   ControlNet = the final master weights in bf16; one harness step =
   ``FusedGenimaStep`` called directly), then 2 episodes at
   ``num_parallel_envs=2`` in one batch of 2 (520 B1 at batch 2 a generate;
   the first batched step's rows against ``FusedGenimaStep`` at batch 1
   within phase 10's limits). Times: control step by events, train step by
   the host clock, the final save's write, each eval run's load and loop,
   peak memory.
13. InstructPix2Pix and the tiny VAE at sd-turbo width (seeded weights made
   on the card, bf16), under a temporary directory removed when the phase
   ends. (a) ``run_training(args, "pix2pix")`` with the pix2pix trainer
   CLI's defaults (batch 4, 512x512) and ``--use_ema
   --conditioning_dropout_prob 0.05``: run A takes 2 steps and writes one
   step checkpoint (limit 1; f32 UNet, both moments, ``ema.msgpack``) and a
   validation; run B resumes it to step 4, its EMA the written one bit for
   bit. Each step launches B2a and B2b 15 times and B1 never, no fallback;
   finite losses, the UNet moves, the EMA trails it, the VAE and CLIP stay
   bit-unchanged, the final save is the EMA bit for bit; one step's UNet
   gradients held to the library attention as in phase 12. (b)
   ``eval_genima.main`` with ``SDPix2PixAgent`` loading the final save
   (``<out>/unet``) on phase 7's controller, serially and in one batch of 2
   (75 B1 a generate; the loaded UNet = the EMA in bf16; one harness step =
   ``FusedGenimaStep``; rows within phase 10's limits), then one control
   step of ``build_main_path(variant="pix2pix", backend="pallas+w8",
   conv_backend="fused")`` pinned at 160 B3 / 960 B5 / 25 B4 / 0 B1. (c) 20
   ``distill_tiny_vae`` steps at 512x512, batch 4, from the full-width
   KL-VAE (the tiny VAE's PSNR against it must rise), ``save_base_model``
   with ``tiny_vae/``, then ``eval_genima.main`` with ``autoencoder=taesd``
   and ``sd_ckpt`` on that snapshot (105 B1 a generate; the loaded tiny VAE
   = the distilled masters in bf16), one generate with the KL decoder on
   ``conv_backend="fused"`` (0 B4: the tiny VAE decodes), and both decodes
   at batch 1 by CUDA events.

14. Multi-GPU training and mesh serving, on the one card (under the phase
   7 temporary directory). (a) 2 ranks spawned on ``cuda:0`` in a gloo
   group (NCCL refuses two ranks on one device; ``file://`` rendezvous)
   each run ``run_training`` for the SD ControlNet at full width with
   ``--train_batch_size 2 --max_train_steps 2 --lr_scheduler constant`` on
   phase 6's seeded PNGs: each step launches B1 6 / B2a 15 / B2b 15 times a
   rank with no fallback, the ranks' f32 ControlNets are bit-equal after
   each step (a checksum of every tensor's words), rank 0's draws are the
   first rows of the global ones, rank 0 alone writes (the final save, one
   metrics line), and step 1 is held to one process's
   step on the concatenated batch of 4 from the same weights and draws: the
   averaged gradients within 1e-2 (relative norm), and the update within
   1e-6 of one process's optimizer on those gradients. The update against
   the batch-4 step's own is printed, not held: Adam's first step, ~lr x
   sign(g), follows bf16 rounding wherever the gradient is near zero. (b) One NCCL rank takes one step, so
   the trainers' real backend runs on the card. (c) 2 gloo ranks of
   ``train_act`` at phase 9's cut for one epoch: the same updates, bit-equal
   masters, rank 0 alone writes. (b) and (c) run at once. (d) ``eval_genima``
   with ``eval_data_parallel=true num_parallel_envs=2`` (a 1x1 mesh on one
   card: 105 B1 at batch 1 a generate), then, through the API,
   ``make_mesh(1, 2, [cuda:0, cuda:0])`` with sd-turbo's weights split by
   ``shard_params_tp``: one denoise step's noise prediction against the
   whole UNet + ControlNet (max error within the 5e-2 of the
   kernel-vs-library check) and against the same models in f32 (no further
   than 1.5x the whole bf16 models are), and 3 TP control steps of
   ``BatchedGenimaStep(mesh=)`` at 105 B1 each beside 3 whole ones. One card
   cannot show multi-GPU scaling: the times say what the machinery costs.
15. The attention kernels at SD-1.5's head dims (8 heads at 320/640/1280
   channels: 40/80/160) and at the SD levels of 768x768 (9216 and 2304
   tokens). Kernel checks against the plain versions: B1 at batch 1 and 4,
   B2a (its output B1's bit for bit) and B2b (two calls bit-equal) at batch
   4, at SD-1.5's three levels and the two 768x768 ones; B3 self and cross
   (77 keys) at SD-1.5's four levels. Paths: (a) ``build_main_path(variant=
   "sd15")`` (``UNetConfig.sd15``, ``CLIPTextConfig.sd15``, the SD VAE), 2
   control steps at 105 B1 each, the noise prediction under the kernels and
   under ``pallas`` held to the library attention, and one ``pallas`` step
   at 230 B3 / 0 B1; (b) ``run_training(args, "sd", pipe=sd15_pipeline)``, 3
   steps at batch 4, 512x512, 6 B1 / 15 B2a / 15 B2b a step, no fallback,
   frozen models bit-unchanged, one step's ControlNet gradients held to the
   library attention; (c) the SD fine-tune at ``--resolution 768``, 3 steps
   at 4 B1 / 10 B2a / 10 B2b (level 2's 576 tokens take the library
   attention, as in JAX); (d) 2 SD control steps at ``resolution=768``, 70
   B1 (the untile resizes 384x384 views to 256). Peak memory of each.
   Under ``pallas`` each backend's noise prediction is made twice in turns
   and its digest printed, beside the inputs' and weights' digests.
16. The opt-in backends on every geometry the JAX package builds, and the
   attention kernels at any head dim. A sweep of B1 (batch 1 x 4096), B2a
   and B2b (batch 4 x 1024) and B3 (1000 queries, self and over 77 keys)
   at 8 heads of d = 36 (zero-padded to 40), 40, 100, 168, 200 and 256
   (four atoms) against their plain versions, printed as
   ``head_dim_sweep`` (no path runs those dims); B3, B4 and B5 at SD's
   768x768 shapes and B5 at the cross-attention K/V of K = 768 (SD-1.5's
   CLIP-L) and 2048 (SDXL's towers). Paths, each 2 control steps with
   every kernel's launches pinned, its build's and steps' peaks, and one
   denoise step's noise prediction held to the library path with each
   kernel in place (as phase 5): (a) ``build_main_path(variant=
   "pix2pix15")`` (InstructPix2Pix at SD-1.5 geometry) on the default
   backend (75 B1) and under ``pallas+w8`` / fused (160 B3 / 25 B4 / 800
   B5), and ``run_training(args, "pix2pix", pipe=pix2pix15_pipeline(...))``
   with EMA, 2 steps at 0 B1 / 15 B2a / 15 B2b, frozen models bit-unchanged;
   (b) SD-1.5 under ``pallas+w8`` / fused (230 / 25 / 1150); (c) SD at
   768x768 likewise (230 / 25 / 1380); (d) SDXL-turbo under ``pallas``
   (1040 B3) and (e) under ``pallas+w8`` / fused (1040 / 25 / 5360).
17. Float32 through every kernel, TF32 off on every side. Kernel checks of
   the f32 kernels (attention and B4: 3xTF32 on the tensor cores; B5: the
   bf16 kernel on f32 x, rounded to bf16 in shared memory, the TPU body's
   cast) against their f32 plain versions: B1 at SD's
   levels, B1/B2a/B2b at the trainer's batch 4, B3/B4/B5 at the opt-in
   path's shapes, then B1/B2a/B2b/B3 at SD-1.5's levels, at 768x768's and
   a head-dim sweep (d = 1, 36, 64, 100, 160, 200, 256), printed as
   ``f32_shape_checks``. Limits: attention and L max abs err 1e-4 at
   unit-scale inputs, B2b and B4 1e-4 of max |grad| or |y|, B5 1e-2 of
   max |y| and bit-equal over two calls; B2a's output B1's bit for bit.
   Paths: (a) ``build_main_path(dtype=torch.float32)`` on the default
   backend, 2 control steps at 105 B1 each; (b) the same under
   ``pallas+w8`` / fused at 230 B3 / 25 B4 / 1380 B5 / 0 B1, each noise
   prediction within 1e-3 (relative) of the library path's (under ``+w8``
   the attention kernel is held on the float models: the int8 layers round
   their inputs to bf16, so those comparisons keep phase 5's 5e-2), the
   fused decode within 1e-3 of the default one; (c) ``run_training`` with
   ``--mixed_precision no --enable_xformers_memory_efficient_attention`` at
   batch 4, 512x512, 2 steps at 6 B1 / 15 B2a / 15 B2b / 0 fallbacks, frozen
   models bit-unchanged, step 1's ControlNet gradients within 1e-3
   (relative norm) of the library attention's. Step ms by events and peaks.
18. Heads wider than 256 columns, and B1 at every length the TPU kernel
   takes. The wide kernels (O, dQ, dK, dV in chunks of three or four
   64-column atoms, one a block; S and dP summed over every atom streamed
   through a ring) against their plain versions: B1 at the wide-head path's
   levels (1 head of 320 at 4096 tokens, 1 of 640 at 1024, 2 at 256), B1,
   B2a and B2b at its batch 4, B3 self and over 77 keys at its opt-in
   shapes, B1 in f32 at its levels; a sweep of B1 (1 x 4096, one head),
   B2a and B2b (4 x 1024) and B3 (1000 queries, self and over 77 keys) in
   2-8 heads of d = 264, 320, 384, 512, 640 and 1024, in bf16 and in f32
   (``wide_head_checks``); B1 and B2a at Sq x Sk = 128x77, 96x4096, 77x77
   and 256x77, d = 64 and 320, bf16 and f32; one autograd call at
   1x128x320 in 5 heads over 77 keys, which runs B1's kernel and counts one
   fallback. Limits as phases 2, 4 and 17. Paths: (a)
   ``build_main_path(variant="sd_wide")`` (``UNetConfig.sd21(num_heads=(1,
   1, 2, 2))``: head dims 320 and 640), 2 control steps at 105 B1; (b) the
   same under ``pallas+w8`` / fused, 230 B3 / 25 B4 / 1380 B5 / 0 B1; (c)
   ``run_training(args, "sd", pipe=wide_head_pipeline(...))``, 2 steps at
   batch 4, 512x512, 6 B1 / 15 B2a / 15 B2b / 0 fallbacks, frozen models
   bit-unchanged, one step's ControlNet gradients within 0.1 of the library
   attention's; (d) (a) in f32 (TF32 off), 105 B1, noise prediction within
   1e-3. Step ms by events and peaks.

Prints the card's name and power limit, the per-step times and peak memory,
a ``per_step`` line (per path, per kernel: launches a step x ms, and the
same sums of its bound and library time, and of the FFMA bound where a
row keeps one), one ``{"kernels": [...]}`` line,
and last
``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a GPU or without the package.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
ATTN_TOL = 1e-2  # bf16 output and bf16-rounded P on unit-scale inputs
EPS_REL_TOL = 5e-2  # kernel vs library attention through one full-width step
PATH_STEPS = 4
LAUNCHES_PER_STEP = 105  # 7 per level per denoise step x 3 levels x 5 steps
# (B, S, C, heads) of the SD-turbo self-attention levels at 64x64 latents
SD_LEVELS = [(1, 4096, 320, 5), (1, 1024, 640, 10), (1, 256, 1280, 20)]
# the same levels at batch 2: classifier-free guidance doubles the batch
CFG_LEVELS = [(2, s, c, h) for _, s, c, h in SD_LEVELS]
TRAIN_BATCH = 4  # the trainer CLI's default train_batch_size
TRAIN_LEVELS = [(TRAIN_BATCH, s, c, h) for _, s, c, h in SD_LEVELS]
LSE_TOL = 2e-3  # f32 log-sum-exp of unit-scale scores over <= 4096 keys
GRAD_TOL = 2e-2  # bf16 dq/dk/dv and bf16-rounded P, dS: error / max |grad|
TRAIN_STEPS = 3
# per train step at batch 4: the UNet down blocks' 2 self-attentions per
# level need no gradient (B1); the UNet up blocks' 3 and the ControlNet down
# blocks' 2 per level do (B2a forward, B2b backward); x 3 levels
TRAIN_LAUNCHES = {"B1": 6, "B2a": 15, "B2b": 15, "fallbacks": 0}
# ControlNet gradients, kernels vs library attention, one full-width bf16
# step: relative global-norm difference, and the worst attention projection's
TRAIN_GRAD_REL_TOL = 0.1

# the opt-in serving configuration: "pallas+w8" attention, fused VAE convs
OPT_BACKEND, OPT_CONV_BACKEND = "pallas+w8", "fused"
OPT_STEPS = 3
OPT16_STEPS = 2  # phase 16: control steps a path, the first carrying its new shapes' warm-up
# per control step (5 denoise steps): B3 = 46 attentions per denoise step
# (16 UNet + 7 ControlNet transformer blocks, self and cross) x 5; B5 = 12
# int8 linears per transformer block x 23 x 5; B4 = 12 decoder resnets x 2
# convs + conv_out; B1 none (the "pallas" backend replaces it)
OPT_LAUNCHES = {"B1": 0, "B3": 230, "B4": 25, "B5": 1380}
# (tokens, channels, heads) of the UNet / ControlNet levels at 64x64 latents
OPT_LEVELS = [(4096, 320, 5), (1024, 640, 10), (256, 1280, 20), (64, 1280, 20)]
CONTEXT = (77, 1024)  # prompt tokens, CLIP width
# B3 (B, Sq, Sk, C, heads): self-attention, then cross-attention over 77 keys
FLASH_SHAPES = [(1, s, s, c, h) for s, c, h in OPT_LEVELS] + [
    (1, s, CONTEXT[0], c, h) for s, c, h in OPT_LEVELS]
# B4 (B, H, W, C, O) of the SD VAE decoder's up blocks and conv_out at 512^2
CONV_SHAPES = [
    (1, 64, 64, 512, 512), (1, 128, 128, 512, 512), (1, 256, 256, 512, 256),
    (1, 256, 256, 256, 256), (1, 512, 512, 256, 128), (1, 512, 512, 128, 128),
    (1, 512, 512, 128, 3),
]
# B5 (M, K, N): proj_in/out and attention projections, GEGLU in and out,
# and the cross-attention K/V on the 77 prompt tokens
W8_SHAPES = sorted(
    {(m, k, n) for m, c, _ in OPT_LEVELS for k, n in ((c, c), (c, 8 * c), (4 * c, c))}
    | {(CONTEXT[0], CONTEXT[1], c) for _, c, _ in OPT_LEVELS})
# phase 10: N lockstep envs batch every opt-in kernel's input by N
PARALLEL_ENVS = 4
BATCHED_FLASH_SHAPES = [(PARALLEL_ENVS, *shape[1:]) for shape in FLASH_SHAPES]
BATCHED_CONV_SHAPES = [(PARALLEL_ENVS, *shape[1:]) for shape in CONV_SHAPES]
BATCHED_W8_SHAPES = sorted({(PARALLEL_ENVS * m, k, n) for m, k, n in W8_SHAPES})
KERNEL_SOURCES = ["packed_attention", "packed_attention_bwd", "flash_attention", "fused_conv",
                  "w8_matmul"]
# each kernel row's name -> the label its path counts its launches under
COUNTERS = {"packed_flash_attention": "B1", "flash_attention": "B3", "fused_conv3x3": "B4",
            "w8_matmul": "B5", "packed_attention_forward_lse": "B2a",
            "packed_attention_backward": "B2b"}
# phase 15: SD-1.5's geometry (8 heads at every level: head dims 40/80/160)
SD15_LEVELS = [(1, 4096, 320, 8), (1, 1024, 640, 8), (1, 256, 1280, 8)]
SD15_TRAIN_LEVELS = [(TRAIN_BATCH, s, c, h) for _, s, c, h in SD15_LEVELS]
# B3 under "pallas": self-attention at the four levels, cross-attention over
# the 77 prompt tokens (SD-1.5's 768-wide CLIP-L context)
SD15_FLASH_SHAPES = [(1, s, s, c, 8) for s, c, _ in OPT_LEVELS] + [
    (1, s, CONTEXT[0], c, 8) for s, c, _ in OPT_LEVELS]
# and the SD levels at 768x768 (96x96 latents): 9216 and 2304 tokens take
# the packed kernels, 576 (not a multiple of 128) the library attention
RES_768 = 768
SD768_LEVELS = [(1, 9216, 320, 5), (1, 2304, 640, 10)]
SD768_TRAIN_LEVELS = [(TRAIN_BATCH, s, c, h) for _, s, c, h in SD768_LEVELS]
SD15_STEPS = 2  # SD-1.5 control steps on the default backend
SD15_TRAIN_STEPS = 3
# the opt-in step ("pallas"): every attention through B3, as phase 5's B3
SD15_OPT_LAUNCHES = {"B1": 0, "B3": OPT_LAUNCHES["B3"]}
# at 768x768 two of the three levels take B1: 7 a level a denoise step x 5
SD768_LAUNCHES_PER_STEP = 70
SD768_STEPS = 2  # control steps (the first carries the new shapes' warm-up)
# per train step at batch 4: phase 6's pins at two levels of three
SD768_TRAIN_LAUNCHES = {"B1": 4, "B2a": 10, "B2b": 10, "fallbacks": 0}
CONV_REL_TOL = 2e-2  # bf16 activation and output roundings: error / max |y|
W8_REL_TOL = 1e-2  # bf16 output rounding: error / max |y|
OPT_REL_TOL = 5e-2  # each kernel vs the library path through a full model


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device ms per call. A ~50 ms sleep kernel goes first, so the host has
    queued every launch before the device reaches them: the events then
    time device work, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _forward_report(pa, b: int, s: int, h: int, d: int, with_lse: bool) -> dict:
    """B1's or B2a's launch plan at a shape, the shared memory its kernel
    asks for (held to ``forward_plan``'s count) and its ptxas registers and
    spills."""
    from genima_torch.kernels import _build
    from genima_torch.kernels import flash_attention as fa

    plan = pa.forward_plan(b, s, s, h, d)
    smem = pa._library().packed_attention_smem_bytes(plan.nwg, plan.bn, plan.stages,
                                                     fa.padded_head_dim(d))
    if smem != plan.smem_bytes:
        raise AssertionError(f"packed forward plan's shared memory {plan.smem_bytes} != {smem}")
    regs = ptxas_report(_build.build_log("packed_attention"))
    return {
        "plan": _forward_plan_dict(plan),
        "smem_bytes": smem,
        **regs.get(_kernel_key(plan, with_lse), {}),
    }


def _kernel_key(plan, with_lse: bool) -> str:
    """``ptxas_report``'s key of the bf16 forward a plan launches: the
    narrow kernel's atoms x warpgroups x key tile and L flag; the paired
    wide kernel's L and key-split flags, or the streaming one's atoms a
    chunk and the same flags."""
    from genima_torch.kernels import flash_attention as fa

    lse, split = int(with_lse), int(plan.splits > 1)
    if plan.atoms <= fa.NARROW_ATOMS:
        return f"{plan.atoms}x{plan.nwg}x{plan.bn}x{lse}"
    if plan.nwg == 2:
        return f"pair_{lse}x{split}"
    return f"wide_{fa.wide_chunking(plan.atoms)[1]}x{lse}x{split}"


def _forward_plan_dict(plan) -> dict:
    return {"warpgroups": plan.nwg, "query_rows": plan.rows, "key_tile": plan.bn,
            "stages": plan.stages, "blocks": plan.blocks, "head_atoms": plan.atoms,
            "column_chunks": plan.chunks, "cluster": plan.cluster, "key_splits": plan.splits}


def _b1_row(pa, q, k, v, h, err: float) -> dict:
    import torch.nn.functional as F

    b, s, c = q.shape
    iters = 100 if b == 1 else 50

    def library():  # SDPA on (B, heads, S, d) views, back to the packed layout
        return F.scaled_dot_product_attention(
            *(x.view(b, s, h, c // h).transpose(1, 2) for x in (q, k, v))
        ).transpose(1, 2).reshape(b, s, c)

    bound_ms, bound_by = _bound(4 * b * s * s * c, 2 * 4 * b * s * c)  # q, k, v read, o written
    kernel_ms = cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), iters)
    return {
        "name": "packed_flash_attention",
        "route": "cuda",
        "source": "genima_torch/csrc/packed_attention.cu",
        "replaces": "genima_tpu/kernels/packed_attention.py:194",
        "shape": f"{b}x{s}x{c}/{h}", "key": f"{b}x{s}x{s}x{c}",
        "launches": None,  # filled from the path phase
        "max_abs_err": err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": cuda_ms(lambda: pa.packed_attention_reference(q, k, v, h), 5 if b == 1 else 3),
        "library_ms": cuda_ms(library, iters),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        **_forward_report(pa, b, s, h, c // h, with_lse=False),
    }


def kernel_phase(pa, levels=SD_LEVELS, seed: int = 0) -> list[dict]:
    """B1 at the three SD levels (the serving batch 1, or CFG's batch 2)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for b, s, c, h in levels:
        q, k, v = (
            torch.randn(b, s, c, generator=gen, device="cuda").bfloat16() for _ in range(3)
        )
        got = pa.packed_flash_attention(q, k, v, h)
        want = pa.packed_attention_reference(q, k, v, h)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"packed attention {b}x{s}x{c}/{h}: max abs err {err}")
        rows.append(_b1_row(pa, q, k, v, h, err))
    return rows


def _sd_serve(pa, variant: str, resolution: int, steps: int, launches: int,
              opt_in: bool) -> dict:
    """The serving path (phase 3; SDXL's in phase 12, SD-1.5's and SD's at
    768x768 in phase 15): control steps of ``build_main_path(variant=,
    resolution=)``, B1 pinned at ``launches`` a step; one denoise step's
    noise prediction against the library attention. With ``opt_in``, the
    same models under ``backend="pallas"`` too: that noise prediction held
    likewise, and one control step with B3 pinned (``SD15_OPT_LAUNCHES``);
    and each backend's noise prediction made twice in turns, to say which
    side of a kernel-vs-library comparison is not bit-repeatable (each
    prediction's digest is printed, so two runs can be compared too)."""
    from genima_torch.eval.main_path import build_main_path
    from genima_torch.kernels import flash_attention as fa
    from genima_torch.nn.layers import set_attention_backend

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    step, args = build_main_path(device="cuda", seed=0, variant=variant, resolution=resolution)
    torch.cuda.synchronize()
    out = {"setup_s": time.time() - t0, "params": {
        k: sum(p.numel() for p in m.parameters()) for k, m in args["diffusion_params"].items()}}

    def timed_step():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        result = step(**args)
        end.record()
        torch.cuda.synchronize()
        return result, start.elapsed_time(end), (time.perf_counter() - h0) * 1e3

    pa.packed_flash_attention.launches = 0
    pa.packed_flash_attention.launches_by_shape.clear()
    step_ms, host_ms = [], []
    for _ in range(steps):
        before = pa.packed_flash_attention.launches
        (actions, target), ms, host = timed_step()
        step_ms.append(ms)
        host_ms.append(host)
        n = pa.packed_flash_attention.launches - before
        if n != launches:
            raise AssertionError(f"{variant} at {resolution}: {n} B1 launches in a control "
                                 f"step, want {launches}")
    out["launches_by_shape"] = {"x".join(map(str, k)): v
                                for k, v in pa.packed_flash_attention.launches_by_shape.items()}
    if actions.shape != (1, EVAL_HORIZON, 8) or not torch.isfinite(actions).all():
        raise AssertionError(f"{variant} actions {tuple(actions.shape)}")
    if target.shape != (1, resolution, resolution, 3) or target.dtype != torch.uint8:
        raise AssertionError(f"{variant} target {tuple(target.shape)} {target.dtype}")

    unet, cn = args["diffusion_params"]["unet"], args["diffusion_params"]["controlnet"]
    backends = ("fused", "pallas", "xla") if opt_in else ("fused", "xla")
    eps = {b: [] for b in backends}
    for _ in range(2 if opt_in else 1):
        for backend in backends:
            set_attention_backend(unet, backend)
            set_attention_backend(cn, backend)
            eps[backend].append(_denoise_eps(step.pipe, unet, cn, args))
    rel = {b: _rel_err(eps[b][0], eps["xla"][0]) for b in backends if b != "xla"}
    for b, r in rel.items():
        if not (torch.isfinite(eps[b][0]).all() and r <= EPS_REL_TOL):
            raise AssertionError(f"{variant} eps {b} vs library attention: rel err {r}")
    if opt_in:
        out["eps_repeat"] = {b: {
            "bit_equal": torch.equal(*eps[b]), "digests": [_digest(e) for e in eps[b]],
            "rel_err_vs_library_second": _rel_err(eps[b][1], eps["xla"][1]) if b != "xla" else 0.0,
        } for b in backends}
        # what both sides start from: the seeded weights and inputs
        out["eps_repeat"]["inputs"] = {
            "digests": [_digest(args[k]) for k in ("latents", "prompt_embeds", "tiled_u8")]
            + [_digest(torch.cat([p.detach().flatten() for p in list(m.parameters())[:8]]))
               for m in (unet, cn)]}
    del eps
    if opt_in:
        set_attention_backend(unet, "pallas")
        set_attention_backend(cn, "pallas")
        fa.flash_attention.launches = 0
        fa.flash_attention.launches_by_shape.clear()
        before = pa.packed_flash_attention.launches
        (actions, target), ms, host = timed_step()
        counts = {"B1": pa.packed_flash_attention.launches - before,
                  "B3": fa.flash_attention.launches}
        if counts != SD15_OPT_LAUNCHES:
            raise AssertionError(f"{variant} opt-in step launches {counts}, "
                                 f"want {SD15_OPT_LAUNCHES}")
        if not torch.isfinite(actions).all() or target.dtype != torch.uint8:
            raise AssertionError(f"{variant} opt-in step: actions finite "
                                 f"{torch.isfinite(actions).all().item()}, target {target.dtype}")
        out["opt_in"] = {"step_ms": ms, "host_step_ms": host, "launches": counts,
                         "eps_rel_err_vs_library_attention": rel["pallas"],
                         "launches_by_shape": {"x".join(map(str, k)): v for k, v in
                                               fa.flash_attention.launches_by_shape.items()}}
    set_attention_backend(unet, "fused")
    set_attention_backend(cn, "fused")
    out.update(step_ms=step_ms, host_step_ms=host_ms,
               eps_rel_err_vs_library_attention=rel["fused"],
               actions_abs_max=actions.abs().max().item(),
               target_mean=target.float().mean().item(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def _digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import hashlib

    raw = t.detach().contiguous().flatten().view(torch.uint8).cpu()  # any dtype, bf16 too
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    ops_s, bytes_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s > bytes_s else "bytes"


def _wide_bwd_keys(atoms: int, f32: bool) -> dict[str, str]:
    """``ptxas_report``'s keys of B2b's three wide kernels (dq, dV, dK) at a
    head of ``atoms`` atoms: ``bwd_wide_kernel<mode, oa, resident>`` (bf16),
    ``attention_f32_bwd_wide_kernel<mode, oa>`` (f32); mode 0 dq, 1 dK, 2 dV."""
    from genima_torch.kernels import packed_attention as pa

    oa = pa.wide_backward_out_atoms(atoms, f32)
    tail = "" if f32 else f"x{int(pa.wide_backward_resident(atoms))}"
    prefix = "f32_wide_" if f32 else "wide_"
    return {name: f"{prefix}{mode}x{oa}{tail}" for name, mode in (("dq", 0), ("dv", 2), ("dk", 1))}


def _bwd_kernel_report(d: int = 64) -> dict:
    """ptxas registers and spills of B2b's kernels at head dim d and the
    shared memory each asks for (held to ``backward_plan``'s count), keyed
    "dq" and "dkdv" (past four atoms "dq", "dv" and "dk": three launches)."""
    from genima_torch.kernels import _build
    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import packed_attention as pa

    lib = pa._bwd_library()
    report = ptxas_report(_build.build_log("packed_attention_bwd"))
    plan = pa.backward_plan(1, 64, 64, 1, d)
    smem = [lib.packed_attention_bwd_smem_bytes(x, fa.padded_head_dim(d)) for x in (0, 1, 2)]
    if smem != [plan.dq_smem_bytes, plan.dkdv_smem_bytes, plan.dv_smem_bytes]:
        raise AssertionError(f"B2b kernels' shared memory {smem} != backward_plan's")
    if plan.atoms <= fa.NARROW_ATOMS:
        return {name: {**report.get(f"{name}{plan.atoms}", {}), "smem_bytes": b}
                for name, b in (("dq", smem[0]), ("dkdv", smem[1]))}
    keys = _wide_bwd_keys(plan.atoms, f32=False)
    return {name: {**report.get(keys[name], {}), "smem_bytes": b}
            for name, b in (("dq", smem[0]), ("dk", smem[1]), ("dv", smem[2]))}


def training_kernel_phase(pa, levels=TRAIN_LEVELS, seed: int = 1) -> list[dict]:
    """B2a, B1 and B2b at the three SD levels at batch 4 (or ``levels``')."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for b, s, c, h in levels:
        bwd_report = _bwd_kernel_report(c // h)
        q, k, v, do = (
            torch.randn(b, s, c, generator=gen, device="cuda").bfloat16() for _ in range(4)
        )
        shape = f"{b}x{s}x{c}/{h}"
        bp = pa.backward_plan(b, s, s, h, c // h)

        # B2a: o and L against the plain version
        o, lse = pa.packed_attention_forward_lse(q, k, v, h)
        o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
        torch.cuda.synchronize()
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        if not (o_err <= ATTN_TOL and lse_err <= LSE_TOL):
            raise AssertionError(f"B2a {shape}: o err {o_err}, L err {lse_err}")
        o1 = pa.packed_flash_attention(q, k, v, h)
        torch.cuda.synchronize()
        if not torch.equal(o, o1):  # one kernel, one plan: B2a adds the L store
            raise AssertionError(f"B2a {shape}: output differs from B1's")
        heads = [x.view(b, s, h, c // h).transpose(1, 2) for x in (q, k, v)]
        bound_ms, bound_by = _bound(4 * b * s * s * c, 2 * 4 * b * s * c + 4 * b * s * h)
        rows.append({
            "name": "packed_attention_forward_lse",
            "route": "cuda",
            "source": "genima_torch/csrc/packed_attention.cu",
            "replaces": "genima_tpu/kernels/packed_attention.py:274",
            "shape": shape, "key": f"{b}x{s}x{s}x{c}",
            "launches": None,  # filled from the train path
            "max_abs_err": max(o_err, lse_err),
            "o_abs_err": o_err,
            "lse_abs_err": lse_err,
            "ms": cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), 50),
            "plain_ms": cuda_ms(lambda: pa.packed_attention_lse_reference(q, k, v, h), 3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), 50),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            **_forward_report(pa, b, s, h, c // h, with_lse=True),
        })
        # B1 at batch 4 (the UNet down blocks' attention, which needs no gradient)
        rows.append(_b1_row(pa, q, k, v, h, (o1.float() - o_ref.float()).abs().max().item()))

        # B2b: dq, dk, dv against the plain version, from the kernel's o and L
        got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
        want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
        again = pa.packed_attention_backward(q, k, v, o, lse, do, h)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):  # no atomics
            raise AssertionError(f"B2b {shape}: two calls differ")
        abs_err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want))
        rel_err = max(
            ((x.float() - y.float()).abs().max() / y.float().abs().max()).item()
            for x, y in zip(got, want)
        )
        if not rel_err <= GRAD_TOL:
            raise AssertionError(f"B2b {shape}: max err {rel_err} of max |grad|")
        leaves = [x.detach().requires_grad_() for x in heads]
        out = F.scaled_dot_product_attention(*leaves)
        go = do.view(b, s, h, c // h).transpose(1, 2)
        bound_ms, bound_by = _bound(10 * b * s * s * c, 2 * 8 * b * s * c + 4 * b * s * h)
        rows.append({
            "name": "packed_attention_backward",
            "route": "cuda",
            "source": "genima_torch/csrc/packed_attention_bwd.cu",
            "replaces": "genima_tpu/kernels/packed_attention.py:380",
            "shape": shape, "key": f"{b}x{s}x{s}x{c}",
            "launches": None,
            "max_abs_err": abs_err,
            "max_rel_err": rel_err,
            "ms": cuda_ms(lambda: pa.packed_attention_backward(q, k, v, o, lse, do, h), 50),
            "plain_ms": cuda_ms(
                lambda: pa.packed_attention_backward_reference(q, k, v, o, lse, do, h), 3),
            "library_ms": cuda_ms(
                lambda: torch.autograd.grad(out, leaves, go, retain_graph=True), 50),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "plan": {"kernels": "dq, then dV and dK" if bp.out_atoms else "dq, then dk/dv",
                     "rows_per_block": bp.rows, "stages": bp.stages, "head_atoms": bp.atoms,
                     "dkdv_passes": bp.passes, "column_chunks": bp.chunks,
                     "out_atoms_per_warpgroup": bp.out_atoms,
                     "tile_splits": [bp.splits, bp.dkdv_splits],
                     "blocks": [math.prod(bp.dq_grid), math.prod(bp.dkdv_grid)]},
            **bwd_report,
        })
        del out, leaves
    return rows


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers and spills of each kernel instantiation in an ``nvcc
    -Xptxas -v`` log, keyed by its template arguments ("128x0" for
    ``w8_matmul_kernel<128, false>``, "128x1" for its f32-x form, "128x2"
    for ``fused_conv3x3_kernel<128, 2>``, "1x2x128x1" for
    ``attention_fwd_kernel<1, 2, 128, true>``; B2b's two kernels "dq1" /
    "dkdv1" for ``packed_attention_bwd_dq_kernel<1>``); the f32 kernels
    named so with an "f32_" in front ("f32_1x2x64x1" for
    ``attention_f32_fwd_kernel<1, 2, 64, true>``, "f32_dq4", "f32_128x2" for
    ``fused_conv3x3_f32_kernel<128, 2>``); the wide kernels (heads past 256
    columns) with "wide_" after that ("wide_4x1x0" for
    ``attention_fwd_wide_kernel<4, true, false>``, "wide_dkdv3x0" for
    ``bwd_wide_dkdv_kernel<3, false>``, "f32_wide_dq4"), the paired wide
    forward "pair_1x0" (``attention_fwd_pair_kernel<true, false>``) and the
    clustered f32 one "f32_cluster_0"
    (``attention_f32_fwd_cluster_kernel<false>``)."""
    import re

    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            f32 = "attn_f32" in m.group(1) or "_f32_kernel" in m.group(1)
            key = "x".join(re.findall(r"L[ib](\d+)E", m.group(1))) or ("" if f32 else m.group(1))
            kind = re.search(r"_(dq|dkdv)_(?:wide_)?kernel", m.group(1))
            if kind:
                key = kind.group(1) + key
            if "_wide_" in m.group(1):
                key = "wide_" + key
            if "_cluster_" in m.group(1):
                key = "cluster_" + key
            if "_pair_" in m.group(1):
                key = "pair_" + key
            if f32:
                key = "f32_" + key
            out[key] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and key is not None:
            out[key]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and key is not None:
            out[key]["registers"] = int(m.group(1))
    return out


def opt_kernel_phase(flash_shapes=FLASH_SHAPES, conv_shapes=CONV_SHAPES,
                     w8_shapes=W8_SHAPES, seed: int = 2) -> list[dict]:
    """B3, B4 and B5 at every shape of the opt-in serving path (or of its
    lockstep batch of N envs)."""
    import torch.nn.functional as F

    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import _build
    from genima_torch.kernels import fused_conv as fc
    from genima_torch.kernels import w8_matmul as w8

    regs = {name: ptxas_report(_build.build_log(name))
            for name in ("flash_attention", "fused_conv", "w8_matmul")}
    fa_lib, conv_lib, w8_lib = fa._library(), fc._library(), w8._library()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for b, sq, sk, c, h in flash_shapes:
        q, k, v = (torch.randn(b, s, h, c // h, generator=gen, device="cuda").bfloat16()
                   for s in (sq, sk, sk))
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"B3 {b}x{sq}x{sk}x{c}/{h}: max abs err {err}")
        heads = [t.transpose(1, 2) for t in (q, k, v)]
        plan = fa.plan(b, sq, sk, h, c // h)
        smem = fa_lib.flash_attention_smem_bytes(plan.nwg, plan.bn, plan.stages,
                                                 fa.padded_head_dim(c // h))
        if smem != plan.smem_bytes:
            raise AssertionError(f"B3 plan's shared memory {plan.smem_bytes} != the kernel's")
        bound_ms, bound_by = _bound(4 * b * sq * sk * c, 2 * b * (2 * sq + 2 * sk) * c)
        rows.append({
            "name": "flash_attention", "route": "cuda",
            "source": "genima_torch/csrc/flash_attention.cu",
            "replaces": "genima_tpu/kernels/flash_attention.py:129",
            "shape": f"{b}x{sq}x{sk}x{c}/{h}", "key": f"{b}x{sq}x{sk}x{c}",
            "launches": None, "max_abs_err": err,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 50),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(q, k, v), 3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), 50),
            "library": "scaled_dot_product_attention forward on the same (B, H, S, D) views",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": _forward_plan_dict(plan),
            "smem_bytes": plan.smem_bytes,
            **regs["flash_attention"].get(_kernel_key(plan, False), {}),
        })

    for b, h, w, c, o in conv_shapes:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda").bfloat16()
        gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
        scale, shift = fc.fold_group_norm(x, gamma, beta, 32, 1e-6)
        wt = (torch.randn(3, 3, c, o, generator=gen, device="cuda") / (3 * c ** 0.5)).bfloat16()
        bias = torch.randn(o, generator=gen, device="cuda").bfloat16()
        # the path's calls at a C == O shape include each block's second conv,
        # which adds the residual
        res = torch.randn(b, h, w, o, generator=gen, device="cuda").bfloat16() if c == o else None
        args = (x, wt, bias, scale, shift, None, res)
        got = fc.fused_conv3x3(*args)
        want = fc.fused_conv3x3_reference(*args)
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        if not rel <= CONV_REL_TOL:
            raise AssertionError(f"B4 {b}x{h}x{w}x{c}->{o}: max err {rel} of max |y|")
        plan = fc.plan(b, h, w, c, o)
        if conv_lib.fused_conv3x3_smem_bytes(plan.bn, plan.rows) != plan.smem_bytes:
            raise AssertionError(f"B4 plan's shared memory {plan.smem_bytes} != the kernel's")
        act = (x.float() * scale[:, None, None] + shift[:, None, None])
        act = (act * torch.sigmoid(act)).bfloat16().permute(0, 3, 1, 2)  # channels_last NCHW
        w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        nbytes = 2 * b * h * w * (c + o + (o if res is not None else 0)) + 2 * 9 * c * o \
            + 2 * o + 8 * b * c
        bound_ms, bound_by = _bound(2 * b * h * w * o * 9 * c, nbytes)
        rows.append({
            "name": "fused_conv3x3", "route": "cuda",
            "source": "genima_torch/csrc/fused_conv.cu",
            "replaces": "genima_tpu/kernels/fused_conv.py:380",
            "shape": f"{b}x{h}x{w}x{c}->{o}" + ("+res" if res is not None else ""),
            "key": f"{b}x{h}x{w}x{c}x{o}",
            "launches": None, "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "max_rel_err": rel,
            "ms": cuda_ms(lambda: fc.fused_conv3x3(*args), 20),
            "plain_ms": cuda_ms(lambda: fc.fused_conv3x3_reference(*args), 3),
            "library_ms": cuda_ms(lambda: F.conv2d(act, w_cl, bias, padding=1), 20),
            "library": "cuDNN conv2d alone, channels_last bf16, on the pre-activated input "
                       "(a lower yardstick: it skips the GN/SiLU prologue and the residual)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": {"tile": f"{plan.rows * 64} pixels x {plan.bn} channels",
                     "tiles": plan.n_tiles, "blocks": plan.blocks},
            "smem_bytes": plan.smem_bytes,
            **regs["fused_conv"].get(f"{plan.bn}x{plan.rows}", {}),
        })

    for m, k, n in w8_shapes:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w_q, scale = w8.quantize_weight(torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5)
        got = w8.w8_matmul(x, w_q, scale)
        want = w8.w8_matmul_reference(x, w_q, scale)
        again = w8.w8_matmul(x, w_q, scale)
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        if not rel <= W8_REL_TOL:
            raise AssertionError(f"B5 {m}x{k}x{n}: max err {rel} of max |y|")
        if not torch.equal(got, again):  # split-K sums in a fixed order
            raise AssertionError(f"B5 {m}x{k}x{n}: two calls differ")
        plan = w8.plan(m, k, n)
        if w8_lib.w8_matmul_smem_bytes(plan.bt, plan.stages) != plan.smem_bytes:
            raise AssertionError(f"B5 plan's shared memory {plan.smem_bytes} != the kernel's")
        w_deq = (w_q.float() * scale[:, None]).bfloat16().t()
        bound_ms, bound_by = _bound(2 * m * k * n, 2 * m * k + k * n + 4 * n + 2 * m * n)
        rows.append({
            "name": "w8_matmul", "route": "cuda",
            "source": "genima_torch/csrc/w8_matmul.cu",
            "replaces": "genima_tpu/kernels/w8_matmul.py:94",
            "shape": f"{m}x{k}x{n}", "key": f"{m}x{k}x{n}",
            "launches": None, "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "max_rel_err": rel,
            "ms": cuda_ms(lambda: w8.w8_matmul(x, w_q, scale), 100),
            "plain_ms": cuda_ms(lambda: w8.w8_matmul_reference(x, w_q, scale), 5),
            "library_ms": cuda_ms(lambda: torch.matmul(x, w_deq), 100),
            "library": "torch.matmul on the pre-dequantised bf16 weight (reads twice the "
                       "weight bytes)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "plan": {"tile": f"{plan.bt} tokens x {w8.BN} rows", "split": plan.split,
                     "stages": plan.stages, "blocks": plan.blocks},
            "smem_bytes": plan.smem_bytes, **regs["w8_matmul"].get(f"{plan.bt}x0", {}),
        })
    return rows


def _denoise_eps(pipe, unet, cn, args) -> torch.Tensor:
    """One denoise step's noise prediction at the first timestep (SDXL's
    prompt embeddings are the (hidden, pooled) pair)."""
    state = pipe.scheduler.set_timesteps(5)
    with torch.inference_mode():
        x = args["latents"].permute(0, 3, 1, 2) * float(state.init_noise_sigma)
        x = pipe.scheduler.scale_model_input(state, x.contiguous(), 0).to(pipe.dtype)
        t = torch.full((1,), float(state.timesteps[0]), device="cuda")
        cond = args["tiled_u8"].permute(0, 3, 1, 2).to(pipe.dtype).contiguous() / 255.0
        embeds, added = args["prompt_embeds"], None
        if isinstance(embeds, tuple):
            embeds, pooled = embeds
            added = {"text_embeds": pooled,
                     "time_ids": pipe.make_time_ids(1, args["tiled_u8"].shape[1])}
        down, mid = cn(x, t, embeds, cond, cond_is_embedded=False, added_cond_kwargs=added)
        return unet(x, t, embeds, down, mid, added_cond_kwargs=added).float()


def _denoise_eps_any(pipe, params, args) -> torch.Tensor:
    """``_denoise_eps`` for the ControlNet variants; for InstructPix2Pix the
    UNet on the scaled latents beside the conditioning image's (the VAE
    posterior's mode), as ``SDPix2PixPipeline.generate`` feeds it."""
    if "controlnet" in params:
        return _denoise_eps(pipe, params["unet"], params["controlnet"], args)
    state = pipe.scheduler.set_timesteps(5)
    with torch.inference_mode():
        x = args["latents"].permute(0, 3, 1, 2) * float(state.init_noise_sigma)
        x = pipe.scheduler.scale_model_input(state, x.contiguous(), 0).to(pipe.dtype)
        t = torch.full((1,), float(state.timesteps[0]), device="cuda")
        cond = (args["tiled_u8"].to(pipe.dtype) / 127.5 - 1.0).permute(0, 3, 1, 2).contiguous()
        image_latents = params["vae"].encode(cond).mode().float().to(pipe.dtype)
        return params["unet"](torch.cat([x, image_latents], dim=1), t,
                              args["prompt_embeds"]).float()


def _serve(variant: str, resolution: int, backend: str, conv_backend: str, pins: dict,
           steps: int = OPT16_STEPS, dtype=None, eps_tol: float = OPT_REL_TOL) -> dict:
    """A serving path (phase 5's opt-in step, phase 13's, phase 16's):
    control steps of ``build_main_path(variant=, resolution=, backend=,
    conv_backend=)``, every kernel's launches pinned at ``pins`` a step, the
    result's shape, dtype and finiteness held; the build's peak (under
    ``+w8`` the float weights are drawn, then quantized in place). Then, on
    the same models, one denoise step's noise prediction against the
    library path with each kernel in place: the attention kernel against
    the library attention on the same weights; under ``+w8`` the int8
    models (B5) against the float models on the dequantised weights; with
    the fused decoder (B4) its decode against the default decoder's.
    ``dtype`` is ``build_main_path``'s (phase 17: f32). With ``eps_tol``
    below ``OPT_REL_TOL`` the attention kernel's and the fused decoder's
    comparisons are held to it; under ``+w8`` the attention kernel is then
    also held to it on the float models (the dequantised weights), since the
    int8 layers round their inputs to bf16, which f32-level differences
    upstream flip, and those comparisons stay at ``OPT_REL_TOL``."""
    from genima_torch.eval.main_path import build_main_path
    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import fused_conv as fc
    from genima_torch.kernels import packed_attention as pa
    from genima_torch.kernels import w8_matmul as w8
    from genima_torch.nn.layers import set_attention_backend, split_backend
    from genima_torch.weights.quantize import dequantize_dense_tree

    tag = f"{variant} at {resolution} under {backend} / {conv_backend}"
    counters = {"B1": pa.packed_flash_attention, "B3": fa.flash_attention,
                "B4": fc.fused_conv3x3, "B5": w8.w8_matmul}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    step, args = build_main_path(device="cuda", seed=0, variant=variant, resolution=resolution,
                                 backend=backend, conv_backend=conv_backend, dtype=dtype)
    torch.cuda.synchronize()
    params = args["diffusion_params"]
    out = {"setup_s": time.time() - t0,
           "build_peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "params": {k: sum(p.numel() for p in m.parameters()) for k, m in params.items()}}
    for fn in counters.values():
        fn.launches = 0
        fn.launches_by_shape.clear()
    torch.cuda.reset_peak_memory_stats()
    step_ms, host_ms, per_step = [], [], []
    for _ in range(steps):
        before = {k: fn.launches for k, fn in counters.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        actions, target = step(**args)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        per_step.append({k: fn.launches - before[k] for k, fn in counters.items()})
        if per_step[-1] != pins:
            raise AssertionError(f"{tag}: control step launches {per_step[-1]}, want {pins}")
    out.update(step_ms=step_ms, host_step_ms=host_ms, launches_per_step=per_step,
               step_peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches_by_shape={k: {"x".join(map(str, sh)): n for sh, n in
                                      fn.launches_by_shape.items()}
                                  for k, fn in counters.items()})
    if actions.shape != (1, EVAL_HORIZON, 8) or not torch.isfinite(actions).all():
        raise AssertionError(f"{tag}: actions {tuple(actions.shape)}")
    if target.shape != (1, resolution, resolution, 3) or target.dtype != torch.uint8:
        raise AssertionError(f"{tag}: target {tuple(target.shape)} {target.dtype}")

    pipe = step.pipe
    models = [m for k, m in params.items() if k in ("unet", "controlnet")]
    attn, int8 = split_backend(backend)
    library = "xla+w8" if int8 else "xla"
    eps = {backend: _denoise_eps_any(pipe, params, args)}
    for m in models:
        set_attention_backend(m, library)
    eps[library] = _denoise_eps_any(pipe, params, args)
    for m in models:
        set_attention_backend(m, backend)
    errs = {"eps_rel_err_vs_library_attention": _rel_err(eps[backend], eps[library])}
    limits = {"eps_rel_err_vs_library_attention": OPT_REL_TOL if int8 else eps_tol}
    if int8:
        floats = dict(params)
        for k in ("unet", "controlnet"):
            if k in params:
                floats[k] = dequantize_dense_tree(copy.deepcopy(params[k]))
                set_attention_backend(floats[k], "xla")
        eps["xla"] = _denoise_eps_any(pipe, floats, args)
        errs["eps_int8_vs_dequantised_float"] = _rel_err(eps[library], eps["xla"])
        limits["eps_int8_vs_dequantised_float"] = OPT_REL_TOL
        if eps_tol < OPT_REL_TOL:  # the attention kernel alone, on the float models
            for k in ("unet", "controlnet"):
                if k in floats:
                    set_attention_backend(floats[k], attn)
            eps["float_" + attn] = _denoise_eps_any(pipe, floats, args)
            errs["eps_float_models_rel_err_vs_library_attention"] = _rel_err(
                eps["float_" + attn], eps["xla"])
            limits["eps_float_models_rel_err_vs_library_attention"] = eps_tol
        del floats
    if conv_backend == "fused":
        vae = params["vae"]
        z = args["latents"].permute(0, 3, 1, 2).contiguous().to(pipe.dtype)
        with torch.inference_mode():
            fused_img = vae.decode(z).float()
            vae.decoder.conv_backend = "xla"
            xla_img = vae.decode(z).float()
            vae.decoder.conv_backend = conv_backend
        errs["vae_fused_vs_default_decode"] = _rel_err(fused_img, xla_img)
        limits["vae_fused_vs_default_decode"] = eps_tol
        eps["decode"] = fused_img
    finite = all(torch.isfinite(t).all() for t in eps.values())
    if not (finite and all(errs[k] <= limits[k] for k in errs)):
        raise AssertionError(f"{tag} vs the library path: {errs}, limits {limits} "
                             f"(finite={finite})")
    del eps, step, args, params, models
    torch.cuda.empty_cache()
    out.update(errs, actions_abs_max=actions.abs().max().item(),
               target_mean=target.float().mean().item())
    return out


def write_rendered_dataset(root: Path, episodes: int = 2, frames: int = 5, size: int = 512):
    """A seeded rendered dataset in the layout ``index_rendered_dataset``
    reads: <task>/variation0/episodes/episode<i>/{tiled_rgb,tiled_rgb_rendered}."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)
    for ep in range(episodes):
        for sub in ("tiled_rgb", "tiled_rgb_rendered"):
            d = root / "toy_task" / "variation0" / "episodes" / f"episode{ep}" / sub
            d.mkdir(parents=True)
            for i in range(frames):
                img = rng.randint(0, 256, (size, size, 3), dtype=np.uint8)
                Image.fromarray(img).save(d / f"{i}.png")


def train_phase(pa) -> dict:
    from genima_torch.cli.train_controlnet_genima import parse_args
    from genima_torch.data.dataset import to_device
    from genima_torch.data.tokenizer import HashTokenizer
    from genima_torch.diffusion import driver
    from genima_torch.diffusion.training import ControlNetTrainer
    from genima_torch.nn.layers import set_attention_backend

    with tempfile.TemporaryDirectory() as tmp:
        write_rendered_dataset(Path(tmp))
        args = parse_args([
            "--data_path", tmp, "--tasks", "toy_task", "--resolution", "512",
            "--train_batch_size", str(TRAIN_BATCH), "--max_train_steps", str(TRAIN_STEPS),
            "--seed", "0", "--device", "cuda", "--mixed_precision", "bf16",
            "--enable_xformers_memory_efficient_attention", "--max_grad_norm", "1.0",
            "--dataloader_num_workers", "4", "--output_dir", str(Path(tmp) / "out"),
            "--report_to", "none",
        ])
        t0 = time.time()
        pipe = driver.build_pipeline(args)
        params = driver.init_model_params(pipe, args)
        frozen = {
            name: {k: t.clone() for k, t in params[name].state_dict().items()}
            for name in ("unet", "vae", "text_encoder")
        }
        cn_init = {k: p.detach().float().clone() for k, p in params["controlnet"].named_parameters()}
        torch.cuda.synchronize()
        setup_s = time.time() - t0

        counters = {"B1": pa.packed_flash_attention, "B2a": pa.packed_attention_forward_lse,
                    "B2b": pa.packed_attention_backward}
        for fn in counters.values():
            fn.launches = 0
            fn.launches_by_shape.clear()
        pa.PackedFlashAttention.fallbacks = 0
        per_step, step_ms, losses, last = [], [], [], {}
        marks = [time.perf_counter()]

        def hook(step, state, metrics):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            step_ms.append((marks[-1] - marks[-2]) * 1e3)
            counts = {k: fn.launches for k, fn in counters.items()}
            counts["fallbacks"] = pa.PackedFlashAttention.fallbacks
            per_step.append(counts)
            losses.append(float(metrics["loss"]))
            last["state"] = state

        torch.cuda.reset_peak_memory_stats()
        result = driver.run_training(args, pipe=pipe, params=params, step_hook=hook)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        launches_by_shape = {
            k: {"x".join(map(str, s)): n for s, n in fn.launches_by_shape.items()}
            for k, fn in counters.items()
        }
        deltas = [
            {k: c[k] - (per_step[i - 1][k] if i else 0) for k in c}
            for i, c in enumerate(per_step)
        ]
        if result["global_step"] != TRAIN_STEPS or len(deltas) != TRAIN_STEPS:
            raise AssertionError(f"train path took {result['global_step']} steps")
        for i, d in enumerate(deltas):
            if d != TRAIN_LAUNCHES:
                raise AssertionError(f"train step {i + 1} launches {d}, want {TRAIN_LAUNCHES}")
        if not all(map(torch.isfinite, map(torch.tensor, losses))):
            raise AssertionError(f"train losses {losses}")
        for name, before in frozen.items():
            after = params[name].state_dict()
            changed = [k for k, t in before.items() if not torch.equal(t, after[k])]
            if changed:
                raise AssertionError(f"frozen {name} changed: {changed[:3]}")
        moved = max(
            (last["state"].params[k] - v).abs().max().item() for k, v in cn_init.items()
        )
        if not moved > 0:
            raise AssertionError("the ControlNet did not move")

        # one step's ControlNet gradients: kernels vs the library attention
        trainer = ControlNetTrainer(pipe, driver.train_config(args, TRAIN_STEPS))
        state = trainer.create_state(params)
        loader = driver.make_train_dataset(args, HashTokenizer())
        batch = to_device(next(iter(loader)), pipe.device)
        draws = trainer.sample_draws(
            TRAIN_BATCH, 512, torch.Generator(device="cuda").manual_seed(7))
        grads = {}
        for backend in ("fused", "xla"):
            for name in ("unet", "controlnet"):
                set_attention_backend(params[name], backend)
            grads[backend] = trainer.gradients(state, batch, draws)[1]
        for name in ("unet", "controlnet"):
            set_attention_backend(params[name], "fused")

    def norm(ts):
        return torch.stack([t.norm() for t in ts]).norm().item()

    f, x = grads["fused"], grads["xla"]
    diff = {k: f[k] - x[k] for k in x}
    global_rel = norm(diff.values()) / norm(x.values())
    max_rel = max(d.abs().max().item() for d in diff.values()) / max(
        t.abs().max().item() for t in x.values())
    attn = [k for k in x if ".attn1.to_" in k and k.endswith("weight")]
    attn_rel = max(diff[k].norm().item() / x[k].norm().item() for k in attn)
    if not (global_rel <= TRAIN_GRAD_REL_TOL and attn_rel <= TRAIN_GRAD_REL_TOL
            and norm(x.values()) > 0):
        raise AssertionError(
            f"ControlNet grads kernels vs library: global {global_rel}, "
            f"attention projections {attn_rel}")
    return {
        "setup_s": setup_s,
        "step_ms": step_ms,
        "losses": losses,
        "launches_per_step": deltas,
        "launches_by_shape": launches_by_shape,
        "controlnet_max_move": moved,
        "grad_rel_norm_diff_vs_library_attention": global_rel,
        "grad_max_err_vs_library_attention": max_rel,
        "grad_attn_proj_rel_norm_diff_vs_library_attention": attn_rel,
        "peak_mem_gb": peak_gb,
    }


# phase 7: the eval CLI on the fake env
EVAL_EPISODES, EVAL_EPISODE_LENGTH, EVAL_HORIZON = 2, 40, 20
EVAL_GUIDANCE = 2.0
DIRECT_STEP_TOL = 0.0  # the harness's step vs FusedGenimaStep on the same inputs

# the controller trainer's config for ACTConfig() at ResNet-18 width 64, as
# the JAX trainer writes it into the checkpoint (genima_tpu/cfgs/controller.yaml)
CONTROLLER_CONFIG = {
    "frame_stack": 1, "action_sequence": EVAL_HORIZON, "use_onehot_time": False,
    "clip_weights": None, "seed": 0,
    "env": {"factory": "fake", "task": "fake_reach", "episode_length": EVAL_EPISODE_LENGTH,
            "image_size": 256},
    "method": {
        "_target_": "genima_tpu.control.policy.GenimaACTAgent", "lr": 5e-05,
        "lr_backbone": 1e-05, "weight_decay": 0.0001, "actor_grad_clip": None,
        "num_views": 4, "frame_stack": 1, "image_size": 256, "data_augmentation": True,
        "resnet_width": 64,
        "act_cfg": {"hidden_dim": 256, "enc_layers": 4, "dec_layers": 6,
                    "dim_feedforward": 2048, "dropout": 0.1, "nheads": 8,
                    "num_queries": EVAL_HORIZON, "state_dim": 8, "action_dim": 8,
                    "latent_dim": 32, "kl_weight": 10.0, "use_lang_cond": True,
                    "lang_dim": 512},
    },
}


def write_eval_checkpoints(root: Path) -> dict:
    """A full-width controller checkpoint (``latest.ckpt`` + stats JSON) and
    a seeded f32 ControlNet checkpoint, from modules made on the card."""
    import numpy as np

    from genima_torch.control.policy import build_agent
    from genima_torch.core import checkpoint as ckpt
    from genima_torch.diffusion.pipeline import SDControlNetPipeline
    from genima_torch.nn.controlnet import ControlNetModel
    from genima_torch.weights.init import build_module, init_random_
    from genima_torch.weights.to_jax import tree_from_module

    ctrl_dir, diff_dir = root / "controller", root / "diffusion"
    t0 = time.time()
    agent = build_agent(CONTROLLER_CONFIG, device="cuda")
    params, _ = agent.init_params(torch.Generator(device="cuda").manual_seed(11))
    tree = {"encoder": tree_from_module(params["encoder"], "torchvision_resnet"),
            "actor": tree_from_module(params["actor"], "act")}
    ckpt.save_pytree(ckpt.epoch_payload(1, 100, tree, CONTROLLER_CONFIG),
                     ctrl_dir / ckpt.LATEST_NAME)
    rng = np.random.RandomState(0)
    for name in ("action_stats.json", "proprio_stats.json"):
        (ctrl_dir / name).write_text(json.dumps({
            "mean": rng.uniform(-0.3, 0.3, 8).tolist(), "std": rng.uniform(0.5, 1.5, 8).tolist()}))
    torch.cuda.synchronize()
    controller_write_s = time.time() - t0
    del agent, params, tree

    pipe = SDControlNetPipeline(device="cuda")  # dims only: no weights are made
    controlnet = build_module(
        lambda: ControlNetModel(pipe.unet_cfg, pipe.cond_channels, pipe.backend), pipe.device,
        pipe.dtype)
    init_random_(controlnet, torch.Generator(device="cuda").manual_seed(12))
    t0 = time.time()
    cn_tree = tree_from_module(controlnet, "diffusers_controlnet")  # f32 leaves
    ckpt.save_pytree(cn_tree, diff_dir / "checkpoint-1" / "controlnet" / "params.msgpack")
    controlnet_write_s = time.time() - t0
    n_params = sum(x.size for x in _leaves(cn_tree))
    return {"controller_dir": ctrl_dir, "diffusion_dir": diff_dir,
            "controlnet_state": {k: v.clone() for k, v in controlnet.state_dict().items()},
            "controlnet_params": n_params,
            "controlnet_file_bytes": (diff_dir / "checkpoint-1" / "controlnet"
                                      / "params.msgpack").stat().st_size,
            "controller_write_s": controller_write_s, "controlnet_write_s": controlnet_write_s}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


class _EvalProbe:
    """Wraps, for one eval run, the methods that show what the CLI ran: each
    ``generate`` call's B1 launches by shape, each ``FusedGenimaStep`` call
    (the first one's inputs and outputs kept), the split path's actions, and
    the agent's and controller's checkpoint load times."""

    def __init__(self, pa):
        from genima_torch.diffusion.pipeline import (
            SDControlNetPipeline, SDPix2PixPipeline, SDXLControlNetPipeline,
        )
        from genima_torch.eval.agents import SDControlNetAgent
        from genima_torch.eval.fused import FusedGenimaStep
        from genima_torch.eval.harness import GenimaEvalWorkspace

        self.pa = pa
        self.generate_calls, self.fused_calls, self.split_actions = [], [], []
        self.first_fused, self.targets, self.step_actions = None, [], []
        self.load = {}
        self._saved = []
        probe = self
        wrap = self.wrap

        def generate(orig):
            def fn(pipe_self, *args, **kwargs):
                before = collections.Counter(pa.packed_flash_attention.launches_by_shape)
                out = orig(pipe_self, *args, **kwargs)
                delta = pa.packed_flash_attention.launches_by_shape - before
                probe.generate_calls.append(dict(delta))
                probe.targets.append(out)
                return out
            return fn

        def fused_call(orig):
            def fn(step_self, *args, **kwargs):
                before = pa.packed_flash_attention.launches
                out = orig(step_self, *args, **kwargs)
                probe.fused_calls.append(pa.packed_flash_attention.launches - before)
                probe.step_actions.append((tuple(out[0].shape),
                                           bool(torch.isfinite(out[0]).all())))
                if probe.first_fused is None:
                    probe.first_fused = (step_self, args, kwargs,
                                         tuple(t.clone() for t in out))
                return out
            return fn

        def act_device(orig):
            def fn(ws_self, *args, **kwargs):
                out = orig(ws_self, *args, **kwargs)
                probe.split_actions.append(out)
                return out
            return fn

        def timed(key):
            def make(orig):
                def fn(obj, *args, **kwargs):
                    t0 = time.time()
                    out = orig(obj, *args, **kwargs)
                    torch.cuda.synchronize()
                    probe.load[key] = time.time() - t0
                    probe.load[key + "_owner"] = obj
                    return out
                return fn
            return make

        wrap(SDControlNetPipeline, "generate", generate)
        wrap(SDXLControlNetPipeline, "generate", generate)  # its own generate
        wrap(SDPix2PixPipeline, "generate", generate)  # its own generate
        wrap(FusedGenimaStep, "__call__", fused_call)
        wrap(GenimaEvalWorkspace, "_controller_act_device", act_device)
        wrap(SDControlNetAgent, "_load_params", timed("diffusion_params_s"))
        wrap(GenimaEvalWorkspace, "load_controller_ckpt", timed("controller_ckpt_s"))

    def wrap(self, cls, name, make) -> None:
        orig = getattr(cls, name)
        self._saved.append((cls, name, orig))
        setattr(cls, name, make(orig))

    def close(self) -> None:
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)


def _run_eval_cli(pa, argv: list[str], probe_cls=None) -> tuple[dict, "_EvalProbe"]:
    from genima_torch.cli import eval_genima

    pa.packed_flash_attention.launches = 0
    pa.packed_flash_attention.launches_by_shape.clear()
    probe = (probe_cls or _EvalProbe)(pa)
    try:
        logs = eval_genima.main(argv)
    finally:
        probe.close()
    torch.cuda.synchronize()
    return logs, probe


def _last_metrics(ctrl_dir: Path) -> dict:
    lines = (ctrl_dir / "eval_logs" / "metrics.jsonl").read_text().splitlines()
    return json.loads(lines[-1])


def eval_phase(pa, card: str, written: dict) -> dict:
    """Phase 7: the eval CLI at full width on the checkpoints
    ``write_eval_checkpoints`` wrote."""
    import numpy as np

    ctrl_dir = written["controller_dir"]
    argv = [
        f"controller_ckpt={ctrl_dir}", f"diffusion_ckpt={written['diffusion_dir']}",
        "task=fake_reach", "env.factory=fake", "env.image_size=256",
        "image_resolution=512", "num_diffusion_steps=5",
        f"episode_length={EVAL_EPISODE_LENGTH}", f"execution_horizon={EVAL_HORIZON}",
        "device=cuda",
    ]
    out = {"card": card}
    for name, extra, episodes in (
        ("fused", ["guidance_scale=0.0"], EVAL_EPISODES),
        ("cfg", [f"guidance_scale={EVAL_GUIDANCE}"], 1),
    ):
        logs, probe = _run_eval_cli(pa, argv + extra + [f"num_eval_episodes={episodes}"])
        results = logs["results"]
        if results["total_episodes"] != episodes or results["env_exception_episodes"]:
            raise AssertionError(f"eval {name}: results {results}")
        control_steps = sum(-(-e["steps"] // EVAL_HORIZON) for e in logs["eval_episodes"])
        batch = 1 if name == "fused" else 2
        # fused: a generate per control step inside FusedGenimaStep, plus the
        # two of the one-off gen-time measurement; CFG: one per control step
        want_generates = control_steps + (2 if name == "fused" else 0)
        if len(probe.generate_calls) != want_generates:
            raise AssertionError(f"eval {name}: {len(probe.generate_calls)} generate calls, "
                                 f"want {want_generates}")
        for delta in probe.generate_calls:
            if sum(delta.values()) != LAUNCHES_PER_STEP or {k[0] for k in delta} != {batch}:
                raise AssertionError(f"eval {name}: a generate launched B1 {dict(delta)}")
        for t in probe.targets:
            if t.shape != (1, 512, 512, 3) or t.dtype != torch.uint8:
                raise AssertionError(f"eval {name}: target {tuple(t.shape)} {t.dtype}")
        if name == "fused":
            if probe.fused_calls != [LAUNCHES_PER_STEP] * control_steps:
                raise AssertionError(f"eval fused: B1 launches per step {probe.fused_calls}")
            step_self, args, kwargs, (actions, target) = probe.first_fused
            if actions.shape != (1, 20, 8) or not torch.isfinite(actions).all():
                raise AssertionError(f"eval fused: actions {tuple(actions.shape)}")
            # the harness's step against FusedGenimaStep called directly
            from genima_torch.eval.fused import FusedGenimaStep

            dag = probe.load["diffusion_params_s_owner"]
            direct = FusedGenimaStep(dag, step_self.controller, step_self.obs_size)
            d_actions, d_target = direct(*args, **kwargs)
            torch.cuda.synchronize()
            step_err = (d_actions.float() - actions.float()).abs().max().item()
            if not (torch.equal(d_target, target) and step_err <= DIRECT_STEP_TOL):
                raise AssertionError(f"eval fused: harness step vs direct FusedGenimaStep: "
                                     f"actions err {step_err}, target equal "
                                     f"{torch.equal(d_target, target)}")
            # the ControlNet the agent loaded: the written tree, cast to bf16
            loaded = dag.params["controlnet"].state_dict()
            diff = [k for k, v in written["controlnet_state"].items()
                    if not torch.equal(loaded[k], v)]
            if diff or loaded[next(iter(loaded))].dtype != torch.bfloat16:
                raise AssertionError(f"eval: loaded ControlNet differs at {diff[:3]}")
            out["harness_vs_direct_step_actions_err"] = step_err
        else:
            if len(probe.split_actions) != control_steps or not all(
                    a.shape == (20, 8) and bool(np.isfinite(a).all())
                    for a in probe.split_actions):
                raise AssertionError("eval cfg: split-path actions missing or not finite")
            out["cfg_launches_by_shape"] = {
                "x".join(map(str, k)): v
                for k, v in pa.packed_flash_attention.launches_by_shape.items()}
        metrics = _last_metrics(ctrl_dir)
        out[name] = {
            "episodes": results["total_episodes"],
            "control_steps": control_steps,
            "steps": [e["steps"] for e in logs["eval_episodes"]],
            "b1_launches_per_generate": [sum(d.values()) for d in probe.generate_calls],
            "gen_time_s": metrics["eval_genima/gen_time"],
            "control_time_s": metrics["eval_genima/control_time"],
            "fused_step_time_s": metrics.get("eval_genima/fused_step_time"),
            "diffusion_params_load_s": probe.load["diffusion_params_s"],
            "controller_ckpt_load_s": probe.load["controller_ckpt_s"],
        }
    out.update({k: written[k] for k in ("controller_write_s", "controlnet_write_s",
                                         "controlnet_params", "controlnet_file_bytes")})
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out


# phase 8: the fine-tune's features at full width
FT_STEPS, FT_PREEMPT_AT, FT_ACCUM_STEPS = 6, 3, 4
FT_AUGMENTATIONS = "colorjitter,elastic,blur,affine,crop"
VAL_B1_LAUNCHES = 84  # 21 per denoise step x 4 validation steps, batch 1


def _ft_counts(pa) -> dict:
    c = {"B1": pa.packed_flash_attention.launches, "B2a": pa.packed_attention_forward_lse.launches,
         "B2b": pa.packed_attention_backward.launches}
    c["fallbacks"] = pa.PackedFlashAttention.fallbacks
    return c


def _ft_zero(pa) -> None:
    for fn in (pa.packed_flash_attention, pa.packed_attention_forward_lse,
               pa.packed_attention_backward):
        fn.launches = 0
        fn.launches_by_shape.clear()
    pa.PackedFlashAttention.fallbacks = 0


class _FinetuneProbe:
    """Wraps the driver's validation, checkpoint submit, step-checkpoint
    writer and resume for one phase: their times, the B1/B2a/B2b launches between
    steps (validation's counted apart), the written checkpoints' bytes, and
    the state a resume restored. ``close`` puts the originals back."""

    def __init__(self, pa, driver, ckpt):
        self.pa, self.driver, self.ckpt = pa, driver, ckpt
        self.orig = (driver.log_validation, ckpt.save_step_checkpoint,
                     driver.restore_checkpoint, ckpt.AsyncCheckpointer.submit)
        self.reset()
        driver.log_validation = self._validation
        ckpt.save_step_checkpoint = self._save
        driver.restore_checkpoint = self._restore
        probe = self

        def submit(writer, fn, *args, **kwargs):
            # the wait on the previous write, then the copy (whose own wait
            # is then a no-op)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            writer.wait()
            t1 = time.perf_counter()
            self.orig[3](writer, fn, *args, **kwargs)
            torch.cuda.synchronize()
            probe.mark = time.perf_counter()
            probe.submits.append({"step": args[1], "wait_ms": (t1 - t0) * 1e3,
                                  "copy_ms": (probe.mark - t1) * 1e3})

        ckpt.AsyncCheckpointer.submit = submit

    def reset(self) -> None:
        _ft_zero(self.pa)
        torch.cuda.synchronize()
        self.last, self.mark = _ft_counts(self.pa), time.perf_counter()
        self.steps, self.validations, self.writes, self.restores, self.submits = [], [], [], [], []

    def hook(self, step, state, metrics):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), _ft_counts(self.pa)
        self.steps.append({"step": step, "ms": (now - self.mark) * 1e3,
                           "loss": float(metrics["loss"]),
                           "launches": {k: counts[k] - self.last[k] for k in counts}})
        self.last, self.mark = counts, now

    def _validation(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), _ft_counts(self.pa)
        out = self.orig[0](*args, **kwargs)
        torch.cuda.synchronize()
        self.last, self.mark = _ft_counts(self.pa), time.perf_counter()
        self.validations.append({"step": args[5], "s": self.mark - t0, "val_mse": out,
                                 "launches": {k: self.last[k] - c0[k] for k in c0}})
        return out

    def _save(self, output_dir, step, **kwargs):
        import threading

        t0 = time.perf_counter()
        d = self.orig[1](output_dir, step, **kwargs)
        self.writes.append({
            "step": step, "s": time.perf_counter() - t0,
            "bytes": sum(f.stat().st_size for f in d.rglob("*") if f.is_file()),
            "async": threading.current_thread() is not threading.main_thread()})
        return d

    def _restore(self, trainer, state, resume_dir):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.orig[2](trainer, state, resume_dir)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        # copies: the run goes on to update these tensors in place
        self.restores.append({"s": dt, "step": out.step, "count": out.opt_state.count, **{
            name: {k: t.clone() for k, t in tensors.items()} for name, tensors in (
                ("params", out.params), ("mu", out.opt_state.mu), ("nu", out.opt_state.nu))}})
        return out

    def close(self) -> None:
        (self.driver.log_validation, self.ckpt.save_step_checkpoint,
         self.driver.restore_checkpoint, self.ckpt.AsyncCheckpointer.submit) = self.orig


def _check_train_launches(run: str, steps: list) -> None:
    for s in steps:
        if s["launches"] != TRAIN_LAUNCHES:
            raise AssertionError(f"finetune {run}: step {s['step']} launches {s['launches']}, "
                                 f"want {TRAIN_LAUNCHES}")
        if not math.isfinite(s["loss"]):
            raise AssertionError(f"finetune {run}: step {s['step']} loss {s['loss']}")


def finetune_phase(pa, card: str) -> dict:
    """Phase 8: ``run_training`` at full width with step checkpoints,
    validation, augmentations and a preemption (run A), a resume from
    ``latest`` to the final save, which the eval agent loads (run B), and
    the 8-bit AdamW under gradient accumulation (run C)."""
    from genima_torch.cli.train_controlnet_genima import parse_args
    from genima_torch.core import checkpoint as ckpt
    from genima_torch.core.optim import BLOCK, MIN_QUANTIZED, optimizer_state_bytes
    from genima_torch.core.preemption import PreemptionGuard
    from genima_torch.diffusion import driver
    from genima_torch.eval.agents import SDControlNetAgent
    from genima_torch.weights.from_jax import state_dict_from_jax

    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        data, run_dir = Path(tmp) / "data", Path(tmp) / "out"
        # 12 samples, 3 batches an epoch: steps 2 and 3 of run A (before and
        # after the first submit) and 5 and 6 of run B start no epoch
        write_rendered_dataset(data, frames=7)
        base = ["--data_path", str(data), "--tasks", "toy_task", "--resolution", "512",
                "--train_batch_size", str(TRAIN_BATCH), "--seed", "0", "--device", "cuda",
                "--mixed_precision", "bf16", "--enable_xformers_memory_efficient_attention",
                "--dataloader_num_workers", "4"]
        argv = base + ["--output_dir", str(run_dir), "--augmentations", FT_AUGMENTATIONS,
                       "--checkpointing_steps", "2", "--checkpoints_total_limit", "1",
                       "--validation_steps", "3", "--report_to", "tensorboard",
                       "--max_train_steps", str(FT_STEPS)]
        probe = _FinetuneProbe(pa, driver, ckpt)
        try:
            # run A: preempted after step 3
            guard, held = PreemptionGuard(), {}

            def hook_a(step, state, metrics):
                probe.hook(step, state, metrics)
                if step == FT_PREEMPT_AT:
                    held["params"] = {k: t.clone() for k, t in state.params.items()}
                    held["mu"] = {k: t.clone() for k, t in state.opt_state.mu.items()}
                    held["nu"] = {k: t.clone() for k, t in state.opt_state.nu.items()}
                    held["opt_bytes"] = optimizer_state_bytes(state.opt_state)
                    held["params_bytes"] = sum(t.numel() * 4 for t in state.params.values())
                    guard.request()

            probe.reset()
            torch.cuda.reset_peak_memory_stats()
            res_a = driver.run_training(parse_args(argv), step_hook=hook_a, preemption=guard)
            peak_a = torch.cuda.max_memory_allocated() / 2**30
            a = {"steps": probe.steps, "validations": probe.validations,
                 "submit_ms": probe.submits, "writes": probe.writes}
            if res_a["global_step"] != FT_PREEMPT_AT:
                raise AssertionError(f"finetune A stopped at {res_a['global_step']}")
            kept = [p.name for _, p in ckpt.list_step_checkpoints(run_dir)]
            if kept != [f"checkpoint-{FT_PREEMPT_AT}"]:
                raise AssertionError(f"finetune A: checkpoints {kept}")
            for f in ("controlnet/params.msgpack", "train_state.msgpack", "metadata.json"):
                if not (run_dir / kept[0] / f).is_file():
                    raise AssertionError(f"finetune A: {kept[0]}/{f} missing")
            if not (run_dir / "logs" / "validation" / "step3_val0.png").is_file():
                raise AssertionError("finetune A: validation PNG of step 3 missing")
            if not (res_a["val_mse"] is not None and math.isfinite(res_a["val_mse"])):
                raise AssertionError(f"finetune A: val_mse {res_a['val_mse']}")
            _check_train_launches("A", probe.steps)
            for v in probe.validations:
                want = {"B1": VAL_B1_LAUNCHES, "B2a": 0, "B2b": 0, "fallbacks": 0}
                if v["launches"] != want:
                    raise AssertionError(f"finetune A: validation launches {v['launches']}")
            if [w["async"] for w in probe.writes] != [True, False]:
                raise AssertionError(f"finetune A: writes {probe.writes}")

            # run B: resume from latest to the end, the final save
            final = {}

            def hook_b(step, state, metrics):
                probe.hook(step, state, metrics)
                final["params"] = state.params

            probe.reset()
            res_b = driver.run_training(parse_args(argv + ["--resume_from_checkpoint", "latest"]),
                                        step_hook=hook_b)
            b = {"steps": probe.steps, "validations": probe.validations,
                 "submit_ms": probe.submits, "writes": probe.writes,
                 "resume_load_s": probe.restores[0]["s"]}
            restored = probe.restores[0]
            if restored["step"] != FT_PREEMPT_AT or restored["count"] != FT_PREEMPT_AT:
                raise AssertionError(f"finetune B: restored step {restored['step']}")
            for name in ("params", "mu", "nu"):
                diff = [k for k, t in held[name].items() if not torch.equal(restored[name][k], t)]
                if diff:
                    raise AssertionError(f"finetune B: restored {name} differ at {diff[:3]}")
            if res_b["global_step"] != FT_STEPS:
                raise AssertionError(f"finetune B ended at {res_b['global_step']}")
            _check_train_launches("B", probe.steps)
            # checkpoint-6, written on the writer thread, holds the final weights
            written = state_dict_from_jax(ckpt.load_pytree(
                run_dir / f"checkpoint-{FT_STEPS}" / "controlnet" / "params.msgpack"),
                "diffusers_controlnet")
            diff = [k for k, t in final["params"].items()
                    if not torch.equal(torch.from_numpy(written[k]), t.cpu())]
            if diff:
                raise AssertionError(f"finetune B: checkpoint-{FT_STEPS} differs at {diff[:3]}")
            agent = SDControlNetAgent(diffusion_ckpt=str(run_dir / "controlnet"), device="cuda")
            loaded = agent.params["controlnet"].state_dict()
            diff = [k for k, t in final["params"].items()
                    if not torch.equal(loaded[k], t.to(agent.pipe.dtype))]  # bf16 on the card
            if diff or loaded["conv_in.weight"].dtype != agent.pipe.dtype:
                raise AssertionError(f"finetune B: the agent's ControlNet differs at {diff[:3]}")
            del agent, loaded, final, restored, written, held["params"], held["mu"], held["nu"]
            probe.restores.clear()
            torch.cuda.empty_cache()

            # run C: 8-bit AdamW, gradient accumulation over 2 mini-steps
            prev, moved, c_state = {}, [], {}

            def hook_c(step, state, metrics):
                probe.hook(step, state, metrics)
                moved.append(any(not torch.equal(prev["p"][k], t)
                                 for k, t in state.params.items()))
                prev["p"] = {k: t.clone() for k, t in state.params.items()}
                c_state["opt"] = state.opt_state
                torch.cuda.synchronize()
                probe.mark = time.perf_counter()  # the checks are not the next step's time

            args_c = parse_args(base + ["--output_dir", str(Path(tmp) / "out_c"), "--use_8bit_adam",
                                        "--gradient_accumulation_steps", "2", "--report_to", "none",
                                        "--max_train_steps", str(FT_ACCUM_STEPS)])
            pipe = driver.build_pipeline(args_c)
            params = driver.init_model_params(pipe, args_c)
            prev["p"] = {k: p.detach().float().clone()
                         for k, p in params["controlnet"].named_parameters()}
            probe.reset()
            torch.cuda.reset_peak_memory_stats()
            res_c = driver.run_training(args_c, pipe=pipe, params=params, step_hook=hook_c)
            peak_c = torch.cuda.max_memory_allocated() / 2**30
            c = {"steps": probe.steps}
            if res_c["global_step"] != FT_ACCUM_STEPS or moved != [False, True, False, True]:
                raise AssertionError(f"finetune C: steps {res_c['global_step']}, params moved "
                                     f"after mini-steps {moved}")
            _check_train_launches("C", probe.steps)
            opt = c_state["opt"]
            q8_bytes = optimizer_state_bytes(opt.inner_opt_state)
            # int8 codes padded to whole blocks and an f32 scale per block for
            # both moments; f32 moments for the small tensors
            want = sum(2 * (-(-t.numel() // BLOCK)) * (BLOCK + 4) if t.numel() >= MIN_QUANTIZED
                       else 8 * t.numel() for t in prev["p"].values())
            if q8_bytes != want:
                raise AssertionError(f"finetune C: 8-bit state {q8_bytes} bytes, want {want}")
        finally:
            probe.close()

    # run A: step 2 runs with no write in flight, step 3 right after the
    # submit of checkpoint-2 (the writer copies and writes during it)
    step2, step3 = a["steps"][1]["ms"], a["steps"][2]["ms"]
    out.update({
        "run_a": a, "run_b": b, "run_c": c,
        "checkpoint_bytes": a["writes"][0]["bytes"],
        "params_bytes": held["params_bytes"],
        "f32_moment_bytes": held["opt_bytes"],
        "q8_moment_bytes": q8_bytes,
        "q8_state_with_accumulator_bytes": optimizer_state_bytes(opt),
        "submits": a["submit_ms"] + b["submit_ms"],
        "async_write_s": [w["s"] for w in a["writes"] + b["writes"] if w["async"]],
        "sync_write_s": [w["s"] for w in a["writes"] + b["writes"] if not w["async"]],
        "step_before_submit_ms": step2,
        "step_after_submit_ms": step3,
        "blocked_ms": step3 - step2,
        "run_b_step_ms": [s["ms"] for s in b["steps"]],
        "resume_load_s": b["resume_load_s"],
        "validation_s": [v["s"] for v in a["validations"] + b["validations"]],
        "val_mse": [v["val_mse"] for v in a["validations"] + b["validations"]],
        "run_c_update_step_ms": [s["ms"] for s in c["steps"] if s["step"] % 2 == 0],
        "run_c_accumulate_step_ms": [s["ms"] for s in c["steps"][1:] if s["step"] % 2],
        "peak_mem_gb_a": peak_a, "peak_mem_gb_c": peak_c,
    })
    return out


# phase 9: ACT controller training at full width
ACT_DEMOS, ACT_BATCH, ACT_EPOCHS, ACT_RESUME_EPOCHS = 4, 8, 2, 3
ACT_EVAL_LENGTH, ACT_HORIZON = 40, 20
# the card's first-step loss vs the port's CPU run in f32 on the same batch
# and draws: TF32 is off, so only summation order differs (cuDNN vs oneDNN)
ACT_LOSS_REL_TOL = 1e-2


def _kernel_counters() -> dict:
    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import fused_conv as fc
    from genima_torch.kernels import packed_attention as pa
    from genima_torch.kernels import w8_matmul as w8

    return {"B1": pa.packed_flash_attention, "B2a": pa.packed_attention_forward_lse,
            "B2b": pa.packed_attention_backward, "B3": fa.flash_attention,
            "B4": fc.fused_conv3x3, "B5": w8.w8_matmul}


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_cpu(v) for v in x)
    if hasattr(x, "_fields"):  # NamedTuple
        return type(x)(*(_to_cpu(v) for v in x))
    return x


class _ActTrainProbe:
    """Wraps, for phase 9, what shows what ``train_act`` ran: each update
    (host ms after a synchronise, CUDA-event ms of the whole update, the
    augmentation and the optimizer chain, the loss), the first update's
    inputs (params, clip tower, batch, draws with its dropout masks kept),
    the workspace's state when training starts and its resume, each epoch's
    seconds, each checkpoint write, and the eval agent's actions."""

    def __init__(self):
        from genima_torch.control import policy, replay, trainer
        from genima_torch.core import checkpoint as ckpt
        from genima_torch.core import optim

        self.updates, self.epochs, self.writes, self.resumes, self.actions = [], [], [], [], []
        self.first, self.starts = None, []
        self._saved = []
        probe = self

        def wrap(owner, name, make):
            orig = getattr(owner, name)
            self._saved.append((owner, name, orig))
            setattr(owner, name, make(orig))

        def events(key):
            def make(orig):
                def fn(*args, **kwargs):
                    start, end = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                    start.record()
                    out = orig(*args, **kwargs)
                    end.record()
                    probe._events.setdefault(key, []).append((start, end))
                    return out
                return fn
            return make

        def sample_draws(orig):
            def fn(agent, batch, generator, record_dropout=False, mesh=None):
                return orig(agent, batch, generator, record_dropout=probe.first is None,
                            mesh=mesh)
            return fn

        def update(orig):
            def fn(agent, state, batch, draws):
                if probe.first is None:
                    probe.first = {"tree": _to_cpu(state.tree()), "batch": _to_cpu(batch),
                                   "draws": _to_cpu(draws._replace(dropout=None)),
                                   "clip": _to_cpu(agent.clip_params.state_dict()),
                                   "dropout": draws.dropout}
                probe._events = {}
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                out = orig(agent, state, batch, draws)
                end.record()
                loss = float(out[1]["loss"])
                torch.cuda.synchronize()
                now = time.perf_counter()
                ev = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in probe._events.items()}
                probe.updates.append({"host_ms": (now - h0) * 1e3, "end": now, "loss": loss,
                                      "update_ms": start.elapsed_time(end),
                                      "augment_ms": ev.get("augment", 0.0),
                                      "optimizer_ms": ev.get("optimizer", 0.0)})
                if "dropout_masks" not in probe.first:
                    probe.first["dropout_masks"] = [m.cpu() for m in draws.dropout.masks]
                    probe.first["loss"] = loss
                return out
            return fn

        def train(orig):
            def fn(ws, *args, **kwargs):
                torch.cuda.synchronize()
                probe.starts.append({
                    "epoch": ws._epoch, "num_iters": ws._num_iters,
                    "labels": dict(ws.agent.tx.labels),
                    "master": {k: t.clone() for k, t in ws.state.master.items()},
                    "clip": {k: t.clone() for k, t in ws.agent.clip_params.state_dict().items()}})
                return orig(ws, *args, **kwargs)
            return fn

        def resume(orig):
            def fn(ws):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                orig(ws)
                torch.cuda.synchronize()
                if ws.resumed:
                    probe.resumes.append({"s": time.perf_counter() - t0, "epoch": ws._epoch,
                                          "num_iters": ws._num_iters})
            return fn

        def epoch_iter(orig):
            def fn(buf):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = 0
                for batch in orig(buf):
                    n += len(batch["images"])
                    yield batch
                torch.cuda.synchronize()
                probe.epochs.append({"s": time.perf_counter() - t0, "samples": n})
            return fn

        def save(orig):
            def fn(ckpt_dir, **kwargs):
                t0 = time.perf_counter()
                out = orig(ckpt_dir, **kwargs)
                probe.writes.append({"epoch": kwargs["epoch"], "s": time.perf_counter() - t0,
                                     "bytes": out.stat().st_size})
                return out
            return fn

        def act(orig):
            def fn(agent, *args, **kwargs):
                out = orig(agent, *args, **kwargs)
                probe.actions.append(out.float().cpu())
                return out
            return fn

        wrap(policy.GenimaACTAgent, "sample_draws", sample_draws)
        wrap(policy.GenimaACTAgent, "update", update)
        wrap(policy.GenimaACTAgent, "act", act)
        wrap(policy, "act_train_augment", events("augment"))
        wrap(optim.MultiTransform, "step_", events("optimizer"))
        wrap(trainer.ControllerWorkspace, "train", train)
        wrap(trainer.ControllerWorkspace, "_maybe_resume", resume)
        wrap(replay.EpochReplayBuffer, "__iter__", epoch_iter)
        wrap(ckpt, "save_epoch_checkpoint", save)

    def close(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)


def _act_cpu_loss(cfg: dict, first: dict) -> float:
    """The first update's loss, recomputed by the port on the CPU in f32
    from the same params, clip tower, batch and draws (dropout replayed)."""
    from genima_torch.control.policy import build_agent
    from genima_torch.nn.act import ReplayDropout

    agent = build_agent(cfg, device="cpu", dtype=torch.float32)
    params = agent.load_params(_numpy_tree(first["tree"]))
    clip = agent._build_clip()
    clip.load_state_dict(first["clip"])
    agent.clip_params = clip
    draws = first["draws"]._replace(dropout=ReplayDropout(first["dropout_masks"]))
    with torch.no_grad():
        loss, _ = agent.loss(params, first["batch"], draws)
    return float(loss)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def act_train_phase(card: str) -> dict:
    """Phase 9: ``train_act`` at the published controller width (ACTConfig(),
    ResNet-18 width 64 over 4 views at 256x256, CLIP ViT-B/32 text, batch 8,
    augmentations, split-LR AdamW) for 2 epochs on 4 fake demos, a resume to
    epoch 3, then ``eval_act`` for one episode from the same directory."""
    import numpy as np

    from genima_torch.cli import eval_act, train_act
    from genima_torch.core import checkpoint as ckpt
    from genima_torch.core.config import parse_yaml

    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
        fn.launches_by_shape.clear()
    torch.cuda.reset_peak_memory_stats()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp) / "controller"
        argv = [f"work_dir={work}", "device=cuda", "env.factory=fake", "env.task=fake_reach",
                "env.image_size=256", f"num_demos={ACT_DEMOS}", f"batch_size={ACT_BATCH}",
                "checkpoint_every=1", "num_checkpoints=3"]
        probe = _ActTrainProbe()
        try:
            t0 = time.perf_counter()
            ws = train_act.main(argv + [f"num_train_epochs={ACT_EPOCHS}"])
            torch.cuda.synchronize()
            run1_s = time.perf_counter() - t0
            run1_updates = list(probe.updates)
            start = probe.starts[0]
            names = sorted(p.name for p in work.iterdir())
            if ws.update_failures:
                raise AssertionError(f"act train: {len(ws.update_failures)} swallowed update "
                                     f"exceptions, first:\n{ws.update_failures[0]}")
            bad = [u["loss"] for u in run1_updates if not math.isfinite(u["loss"])]
            if bad or not run1_updates:
                raise AssertionError(f"act train: non-finite losses {bad[:4]}")
            # the frozen BN tensors and the CLIP tower bit-unchanged; every
            # trained group moved
            moved = {g: 0 for g in ("main", "backbone")}
            for k, t in ws.state.master.items():
                group = start["labels"][k]
                same = torch.equal(t, start["master"][k])
                if group == "frozen" and not same:
                    raise AssertionError(f"act train: frozen tensor {k} moved")
                if group != "frozen" and not same:
                    moved[group] += 1
            if not all(moved.values()):
                raise AssertionError(f"act train: a parameter group did not move: {moved}")
            clip_now = ws.agent.clip_params.state_dict()
            if any(not torch.equal(clip_now[k], v) for k, v in start["clip"].items()):
                raise AssertionError("act train: the CLIP tower moved")
            # latest.ckpt and 1.ckpt as the JAX package rotates them, the
            # payload = the live master weights, config.yaml read back
            want = {"latest.ckpt", "1.ckpt", "config.yaml", "action_stats.json",
                    "proprio_stats.json", "metrics.jsonl"}
            if not want <= set(names) or any(n.endswith(".ckpt") and n not in want
                                             for n in names):
                raise AssertionError(f"act train: work dir holds {names}")
            t0 = time.perf_counter()
            payload = ckpt.load_epoch_checkpoint(work / ckpt.LATEST_NAME)
            load_s = time.perf_counter() - t0
            if int(payload["epoch"]) != ACT_EPOCHS or int(
                    ckpt.load_epoch_checkpoint(work / "1.ckpt")["epoch"]) != 1:
                raise AssertionError("act train: checkpoint epochs")
            live = {k: v.detach().cpu().numpy() for k, v in
                    _flat_tree(ws.state.tree()).items()}
            stored = _flat_tree(payload["agent"])
            if set(live) != set(stored) or any(not np.array_equal(np.asarray(stored[k]), v)
                                               for k, v in live.items()):
                raise AssertionError("act train: the payload's params are not the live "
                                     "master weights")
            if parse_yaml((work / "config.yaml").read_text()) != ws._config_dict():
                raise AssertionError("act train: config.yaml does not read back")
            steps_per_epoch = -(-len(ws.replay) // ACT_BATCH)
            # the first step's loss against the port's CPU run in f32
            cpu_loss = _act_cpu_loss(ws._config_dict(), probe.first)
            card_loss = probe.first["loss"]
            loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
            if not loss_rel <= ACT_LOSS_REL_TOL:
                raise AssertionError(f"act train: first loss {card_loss} on the card, {cpu_loss} "
                                     f"on the CPU (rel {loss_rel})")
            n_params = {g: sum(t.numel() for k, t in ws.state.master.items()
                               if start["labels"][k] == g) for g in ("main", "backbone", "frozen")}
            tf32 = _act_tf32_turns(ws, probe)
            del ws

            # resume to epoch 3 from the same dir
            t0 = time.perf_counter()
            ws2 = train_act.main(argv + [f"num_train_epochs={ACT_RESUME_EPOCHS}"])
            torch.cuda.synchronize()
            run2_s = time.perf_counter() - t0
            r = probe.resumes[-1] if probe.resumes else None
            if r is None or (r["epoch"], r["num_iters"]) != (ACT_EPOCHS,
                                                            ACT_EPOCHS * steps_per_epoch):
                raise AssertionError(f"act train: resume {r}, want epoch {ACT_EPOCHS}, num_iters "
                                     f"{ACT_EPOCHS * steps_per_epoch}")
            if ws2.update_failures or ws2._epoch != ACT_RESUME_EPOCHS:
                raise AssertionError(f"act train: resumed run ended at {ws2._epoch}, "
                                     f"{len(ws2.update_failures)} swallowed exceptions")
            del ws2

            # the port's eval on the controller it trained
            n_actions = len(probe.actions)
            logs = eval_act.main([f"controller_ckpt={work}", "device=cuda", "task=fake_reach",
                                  "env.factory=fake", "env.image_size=256",
                                  f"episode_length={ACT_EVAL_LENGTH}", "num_eval_episodes=1",
                                  f"execution_horizon={ACT_HORIZON}"])
            torch.cuda.synchronize()
            acts = probe.actions[n_actions:]
            if (logs["results"]["total_episodes"] != 1 or logs["results"]["env_exception_episodes"]
                    or not acts or not all(bool(torch.isfinite(a).all()) for a in acts)):
                raise AssertionError(f"act eval: results {logs['results']}, "
                                     f"{len(acts)} action chunks")
        finally:
            probe.close()
        launches = {k: fn.launches for k, fn in counters.items()}
        if any(launches.values()):
            raise AssertionError(f"act train: kernels launched on the ACT path: {launches}")
        ends = [u["end"] for u in run1_updates]
        steady = run1_updates[2:]
        out.update({
            "steps_per_epoch": steps_per_epoch, "samples_per_epoch": probe.epochs[0]["samples"],
            "params": n_params, "first_loss_card": card_loss, "first_loss_cpu": cpu_loss,
            "first_loss_rel": loss_rel, "losses": [u["loss"] for u in run1_updates],
            "step_ms_median": 1e3 * float(np.median(np.diff(ends)[1:])),
            "update_host_ms_median": float(np.median([u["host_ms"] for u in steady])),
            "update_ms_median": float(np.median([u["update_ms"] for u in steady])),
            "augment_ms_median": float(np.median([u["augment_ms"] for u in steady])),
            "optimizer_ms_median": float(np.median([u["optimizer_ms"] for u in steady])),
            "fwd_bwd_ms_median": float(np.median([u["update_ms"] - u["augment_ms"]
                                                  - u["optimizer_ms"] for u in steady])),
            "epoch_s": [e["s"] for e in probe.epochs],
            "samples_per_s": probe.epochs[1]["samples"] / probe.epochs[1]["s"],
            "checkpoint_bytes": probe.writes[-1]["bytes"],
            "checkpoint_write_s": [w["s"] for w in probe.writes],
            "payload_load_s": load_s, "resume_load_s": probe.resumes[-1]["s"],
            "run1_s": run1_s, "run2_s": run2_s, "eval_episode_steps":
                [e["steps"] for e in logs["eval_episodes"]],
            "launches": launches,
            "update_ms_median_cudnn_tf32_off": float(np.median(tf32[False])),
            "update_ms_median_cudnn_tf32_on": float(np.median(tf32[True])),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        })
    return out


def _act_tf32_turns(ws, probe) -> dict:
    """Update ms (CUDA events) on the first batch with cuDNN's TF32 off (as
    the rest of this script runs) and on (PyTorch's default for
    convolutions, which the CLI leaves as it is), in turns off, on, on, off,
    twice. These updates go on from the trained state; the run's checks and
    checkpoints are behind them."""
    batch = {k: v.to(ws.agent.device) for k, v in probe.first["batch"].items()}
    times = {False: [], True: []}
    prev = torch.backends.cudnn.allow_tf32
    try:
        for flag in (False, True, True, False) * 2:
            torch.backends.cudnn.allow_tf32 = flag
            ws.state, _ = ws.agent.update(ws.state, batch, ws.agent.sample_draws(batch, ws.generator))
            times[flag].append(probe.updates[-1]["update_ms"])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return times


def _flat_tree(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = v
    return out


# phase 10: lockstep-batched eval at full width
BATCHED_EPISODES = 5  # round 1: 4 counted slots; round 2: 1 counted, 3 uncounted
BATCHED_STEPS = 3  # opt-in batched steps with their launches pinned
TIMED_STEPS = 3
# a BatchedGenimaStep row against FusedGenimaStep at batch 1 on the row's
# inputs, bf16: cuDNN and cuBLAS may pick other algorithms at batch 4 than at
# batch 1, and the 5 denoise steps carry the rounding into the targets. The
# first chip call measured at most 5 levels (mean 0.47) and 0.047 on the
# actions over the 8 rows of both configurations (PERF.md, PR 10); the
# limits leave about twice that.
ROW_TARGET_MAX_LEVELS = 12
ROW_TARGET_MEAN_LEVELS = 1.0
ROW_ACTION_ATOL = 0.1


class _BatchedEvalProbe(_EvalProbe):
    """``_EvalProbe`` plus the eval loop's host time, the gen-time probe's
    time and estimate, and each env chunk's time (the env threads')."""

    def __init__(self, pa):
        super().__init__(pa)
        from genima_torch.eval.harness import GenimaEvalWorkspace
        from genima_torch.eval.parallel import ParallelGenimaEvalWorkspace

        self.eval_s, self.gen_probe, self.env_chunk_s = [], [], []
        probe = self

        def timed(into, keep_result=False):
            def make(orig):
                def fn(ws, *args, **kwargs):
                    t0 = time.perf_counter()
                    out = orig(ws, *args, **kwargs)
                    wall = time.perf_counter() - t0
                    into.append({"wall_s": wall, "gen_time_s": out} if keep_result else wall)
                    return out
                return fn
            return make

        for cls in (GenimaEvalWorkspace, ParallelGenimaEvalWorkspace):
            self.wrap(cls, "eval_checkpoints", timed(self.eval_s))
        self.wrap(GenimaEvalWorkspace, "_measure_gen_time", timed(self.gen_probe, True))
        self.wrap(ParallelGenimaEvalWorkspace, "_measure_batched_gen",
                  timed(self.gen_probe, True))
        self.wrap(ParallelGenimaEvalWorkspace, "_step_slot", timed(self.env_chunk_s))

    def loop_s(self) -> float:
        """The eval's host time less the checkpoint load and the probe."""
        return (sum(self.eval_s) - self.load["controller_ckpt_s"]
                - sum(p["wall_s"] for p in self.gen_probe))


def _row_slice(args: dict, i: int) -> dict:
    rows = ("tiled_u8", "prompt_embeds", "latents", "qpos", "lang_tokens")
    return {k: v[i:i + 1] if k in rows else v for k, v in args.items()}


def _row_errors(step, args: dict) -> dict:
    """Each row of one batched step against ``FusedGenimaStep`` at batch 1
    on that row's inputs (run on the device worker)."""
    from genima_torch.eval.fused import FusedGenimaStep

    serial = FusedGenimaStep(step.diffusion_agent, step.controller, step.obs_size)
    actions, target = step(**args)
    t_max, t_mean, a_max = [], [], []
    for i in range(args["qpos"].shape[0]):
        a, t = serial(**_row_slice(args, i))
        diff = (t.int() - target[i:i + 1].int()).abs().float()
        t_max.append(diff.max().item())
        t_mean.append(diff.mean().item())
        a_max.append((a.float() - actions[i:i + 1].float()).abs().max().item())
    finite = bool(torch.isfinite(actions).all())
    out = {"target_max_levels": t_max, "target_mean_levels": t_mean, "actions_max_abs": a_max,
           "actions_finite": finite}
    if not (finite and max(t_max) <= ROW_TARGET_MAX_LEVELS
            and max(t_mean) <= ROW_TARGET_MEAN_LEVELS and max(a_max) <= ROW_ACTION_ATOL):
        raise AssertionError(f"batched step rows vs FusedGenimaStep at batch 1: {out}")
    return out


def _worker_ms(worker, fn, iters: int = TIMED_STEPS) -> dict:
    """One warm-up, then ``iters`` calls of ``fn`` on the device worker's
    stream: CUDA events on that stream, and the host clock after it
    synchronises."""
    def run():
        fn()
        ev, host = [], []
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            worker.synchronize()
            h0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            worker.synchronize()
            host.append((time.perf_counter() - h0) * 1e3)
            ev.append(start.elapsed_time(end))
        return {"events_ms": ev, "host_ms": host}
    return worker.submit(run).result()


def two_stream_b5() -> dict:
    """B5 split-K calls at the batched shapes, issued on two streams at once,
    against the same calls one after the other: bit for bit."""
    from genima_torch.kernels import w8_matmul as w8

    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = [shape for shape in BATCHED_W8_SHAPES if w8.plan(*shape).split > 1]
    calls = []
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        calls.append((x, *w8.quantize_weight(
            torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5)))
    want = [w8.w8_matmul(*c) for c in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(5):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                order = range(len(calls)) if i == 0 else reversed(range(len(calls)))
                got += [(j, w8.w8_matmul(*calls[j])) for j in order]
    torch.cuda.synchronize()
    bad = sorted({shapes[j] for j, out in got if not torch.equal(out, want[j])})
    if bad:
        raise AssertionError(f"B5 split-K on two streams differs at {bad}")
    return {"shapes": ["x".join(map(str, x)) for x in shapes], "calls": len(got)}


def batched_eval_phase(pa, card: str, written: dict) -> dict:
    """Phase 10: ``eval_genima`` with 4 lockstep envs (runs A and B), one
    batched step's rows against the serial step, the opt-in batched step's
    launches, B5 on two streams, and the batched step's times, on phase
    7's checkpoints."""
    from genima_torch.eval.fused import FusedGenimaStep
    from genima_torch.eval.main_path import build_main_path
    from genima_torch.eval.parallel import DeviceWorker
    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import fused_conv as fc
    from genima_torch.kernels import w8_matmul as w8

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    out = {"card": card}
    ctrl_dir = written["controller_dir"]
    argv = [
        f"controller_ckpt={ctrl_dir}", f"diffusion_ckpt={written['diffusion_dir']}",
        "task=fake_reach", "env.factory=fake", "env.image_size=256",
        "image_resolution=512", "num_diffusion_steps=5", "guidance_scale=0.0",
        f"episode_length={EVAL_EPISODE_LENGTH}", f"execution_horizon={EVAL_HORIZON}",
        f"num_eval_episodes={BATCHED_EPISODES}", f"num_parallel_envs={PARALLEL_ENVS}",
        "device=cuda",
    ]
    # run S: the serial harness on the same episodes, for its loop's time
    logs, probe = _run_eval_cli(pa, [a for a in argv if "num_parallel_envs" not in a],
                                _BatchedEvalProbe)
    control_steps = sum(-(-e["steps"] // EVAL_HORIZON) for e in logs["eval_episodes"])
    if (logs["results"]["total_episodes"] != BATCHED_EPISODES
            or logs["results"]["env_exception_episodes"]
            or probe.fused_calls != [LAUNCHES_PER_STEP] * control_steps):
        raise AssertionError(f"serial eval: {logs['results']}, B1 per step {probe.fused_calls}")
    out["S"] = {"episode_steps": [e["steps"] for e in logs["eval_episodes"]],
                "control_steps": control_steps, "loop_s": probe.loop_s(),
                "control_steps_per_s": control_steps / probe.loop_s(),
                "fused_step_time_s": _last_metrics(ctrl_dir)["eval_genima/fused_step_time"]}
    for run, overlap, batch in (("A", True, PARALLEL_ENVS // 2), ("B", False, PARALLEL_ENVS)):
        logs, probe = _run_eval_cli(pa, argv + [f"eval_overlap={str(overlap).lower()}"],
                                    _BatchedEvalProbe)
        results = logs["results"]
        if (results["total_episodes"] != BATCHED_EPISODES or results["env_exception_episodes"]
                or results["num_parallel_envs"] != PARALLEL_ENVS):
            raise AssertionError(f"batched eval {run}: results {results}")
        steps = len(probe.fused_calls)
        # a generate per batched step, and the gen-time probe's warm-up and timed one
        if len(probe.generate_calls) != steps + 2 or len(probe.gen_probe) != 1:
            raise AssertionError(f"batched eval {run}: {len(probe.generate_calls)} generates "
                                 f"for {steps} batched steps")
        for delta in probe.generate_calls:
            if sum(delta.values()) != LAUNCHES_PER_STEP or {k[0] for k in delta} != {batch}:
                raise AssertionError(f"batched eval {run}: a generate launched B1 {dict(delta)}")
        for t in probe.targets:
            if t.shape != (batch, 512, 512, 3) or t.dtype != torch.uint8:
                raise AssertionError(f"batched eval {run}: target {tuple(t.shape)} {t.dtype}")
        if any(a != ((batch, EVAL_HORIZON, 8), True) for a in probe.step_actions):
            raise AssertionError(f"batched eval {run}: actions {probe.step_actions}")
        episode_steps = [e["steps"] for e in logs["eval_episodes"]]
        control_steps = sum(-(-x // EVAL_HORIZON) for x in episode_steps)
        loop_s = probe.loop_s()
        metrics = _last_metrics(ctrl_dir)
        out[run] = {
            "eval_overlap": overlap, "batch": batch, "episodes": results["total_episodes"],
            "episode_steps": episode_steps, "control_steps": control_steps,
            "batched_steps": steps, "generates": len(probe.generate_calls),
            "launches_by_shape": {"x".join(map(str, k)): v for k, v in
                                  pa.packed_flash_attention.launches_by_shape.items()},
            "loop_s": loop_s, "rounds_per_s": steps / loop_s,
            "control_steps_per_s": control_steps / loop_s,
            "control_steps_per_s_per_env": control_steps / loop_s / PARALLEL_ENVS,
            "gen_probe": probe.gen_probe[0],
            "env_chunk_ms_median": 1e3 * sorted(probe.env_chunk_s)[len(probe.env_chunk_s) // 2],
            "gen_time_s": metrics["eval_genima/gen_time"],
            "control_time_s": metrics["eval_genima/control_time"],
            "fused_step_time_s": metrics["eval_genima/fused_step_time"],
        }
    for run in ("S", "B"):
        if out[run]["episode_steps"] != out["A"]["episode_steps"]:
            raise AssertionError(f"eval run {run}'s episode steps "
                                 f"{out[run]['episode_steps']} != run A's "
                                 f"{out['A']['episode_steps']}")

    worker = DeviceWorker(torch.device("cuda"))
    try:
        step, args = build_main_path(device="cuda", seed=0, n_envs=PARALLEL_ENVS)
        out["rows_default"] = worker.submit(_row_errors, step, args).result()
        serial = FusedGenimaStep(step.diffusion_agent, step.controller, step.obs_size)
        two = {k: v[:2] if k in ("tiled_u8", "prompt_embeds", "latents", "qpos", "lang_tokens")
               else v for k, v in args.items()}
        out["step_ms"] = {
            "serial": _worker_ms(worker, lambda: serial(**_row_slice(args, 0))),
            "n2": _worker_ms(worker, lambda: step(**two)),
            f"n{PARALLEL_ENVS}": _worker_ms(worker, lambda: step(**args)),
        }
        del step, args, serial, two

        step, args = build_main_path(device="cuda", seed=0, backend=OPT_BACKEND,
                                     conv_backend=OPT_CONV_BACKEND, n_envs=PARALLEL_ENVS)
        counters = {"B1": pa.packed_flash_attention, "B3": fa.flash_attention,
                    "B4": fc.fused_conv3x3, "B5": w8.w8_matmul}
        for fn in counters.values():
            fn.launches = 0
            fn.launches_by_shape.clear()
        per_step = []
        for _ in range(BATCHED_STEPS):
            before = {k: fn.launches for k, fn in counters.items()}
            actions, target = worker.submit(lambda: step(**args)).result()
            per_step.append({k: fn.launches - before[k] for k, fn in counters.items()})
            if per_step[-1] != OPT_LAUNCHES:
                raise AssertionError(f"opt-in batched step launches {per_step[-1]}, "
                                     f"want {OPT_LAUNCHES}")
        out["opt_launches_per_step"] = per_step
        out["opt_launches_by_shape"] = {
            k: {"x".join(map(str, shape)): n for shape, n in fn.launches_by_shape.items()}
            for k, fn in counters.items()}
        if (actions.shape != (PARALLEL_ENVS, EVAL_HORIZON, 8)
                or target.shape != (PARALLEL_ENVS, 512, 512, 3)):
            raise AssertionError(f"opt-in batched step: {tuple(actions.shape)}, "
                                 f"{tuple(target.shape)}")
        out["rows_opt_in"] = worker.submit(_row_errors, step, args).result()
        out["step_ms"][f"opt_in_n{PARALLEL_ENVS}"] = _worker_ms(worker, lambda: step(**args))
        del step, args, actions, target
    finally:
        worker.close()
    out["two_stream_b5"] = two_stream_b5()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.time() - t0
    return out


# phase 11: the dataset-rendering path, base-model pretraining, the
# controller on the rendered tree and the learning gate
RENDER_TASK = "fake_reach_visual"
RENDER_EPISODES, RENDER_STEPS, RENDER_SIZE = 8, 60, 256
RENDER_CAMERAS = ["wrist", "front", "right_shoulder", "left_shoulder"]
# the learning gate's sphere radius: in the fake world's units RENDER's 0.01
# (times the cameras' scales) is below a pixel
RENDER_RADIUS = 0.11
RENDER_THREADS = 8  # RenderData's episode pool, one episode each (RENDER's num_processes is 1)
# card vs CPU, as the CPU test holds the port to JAX: pixels more than 1
# level apart (hit-mask flips and stripe edges) per pixel rendered
RENDER_MAX_SHARE = 1e-3
PRETRAIN_STEPS, PRETRAIN_BATCH = 3, 4
# per UNet pretrain step at batch 4: all 15 UNet self-attentions with S >= 256
# (2 down + 3 up blocks per level x 3 levels) need their gradient: B2a
# forward, B2b backward, none B1; the VAE steps launch none
PRETRAIN_LAUNCHES = {"B1": 0, "B2a": 15, "B2b": 15, "fallbacks": 0}
VAE_LAUNCHES = {"B1": 0, "B2a": 0, "B2b": 0, "fallbacks": 0}
BASE_FINETUNE_STEPS = 2
GATE_KEYS = ["config", "val_mse_init", "cn_final_loss", "val_mse_final", "trained_success",
             "untrained_success", "elapsed_s", "passed"]


def _tree_bytes(root: Path) -> int:
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def render_pretrain_phase(pa, card: str) -> dict:
    """Phase 11: (a) render 8 exported fake demos with ``RenderData`` on the
    card, held to the CPU on one episode; (b) 3 ``VAETrainer`` and 3
    ``UNetPretrainer`` steps at sd-turbo geometry on the rendered tiles,
    ``save_base_model``, then 2 fine-tune steps from that base model;
    (c) 1 epoch of ``train_act env.factory=rendered`` at ACTConfig() width
    and a cut learning gate."""
    import dataclasses

    import numpy as np

    from genima_torch import native
    from genima_torch.cli import train_act
    from genima_torch.cli.train_controlnet_genima import parse_args
    from genima_torch.core.config import RENDER
    from genima_torch.data.dataset import DiffusionDataLoader, index_rendered_dataset
    from genima_torch.data.tokenizer import HashTokenizer
    from genima_torch.diffusion import driver
    from genima_torch.diffusion.pipeline import SDControlNetPipeline
    from genima_torch.diffusion.pretrain import pretrain_base_model, save_base_model
    from genima_torch.envs.export import export_demos_rlbench_format
    from genima_torch.envs.fake import FakeRLBenchFactory
    from genima_torch.eval.learning_gate import GateConfig, run_learning_gate
    from genima_torch.rendering import render_data

    counters = {"B1": pa.packed_flash_attention, "B2a": pa.packed_attention_forward_lse,
                "B2b": pa.packed_attention_backward}

    def zero():
        for fn in counters.values():
            fn.launches = 0
            fn.launches_by_shape.clear()
        pa.PackedFlashAttention.fallbacks = 0

    def counts():
        return {**{k: fn.launches for k, fn in counters.items()},
                "fallbacks": pa.PackedFlashAttention.fallbacks}

    out: dict = {"card": card}
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- (a) render -----------------------------------------------------------
        t0 = time.time()
        demos = FakeRLBenchFactory(
            task_name=RENDER_TASK, image_size=RENDER_SIZE, demo_length=RENDER_STEPS,
            episode_length=RENDER_STEPS, goal_observable=True, seed=0,
        ).collect_or_fetch_demos(RENDER_EPISODES)
        export_demos_rlbench_format(demos, tmp / "raw", RENDER_TASK)
        del demos
        out["demos_export_s"] = time.time() - t0
        scales = dict(zip(RENDER["cameras"], RENDER["camera_scales"]))
        cfg = {**RENDER, "dataset_root": str(tmp / "raw"), "save_path": str(tmp),
               "textures_path": None, "task": RENDER_TASK, "episodes": RENDER_EPISODES,
               "num_processes": RENDER_THREADS, "cameras": RENDER_CAMERAS,
               "image_width": RENDER_SIZE, "image_height": RENDER_SIZE,
               "camera_scales": [scales[c] for c in RENDER_CAMERAS],
               "render": {**RENDER["render"], "sphere": {"radius": RENDER_RADIUS}}}
        # each render call, tagged with its episode; episode 0's inputs and
        # outputs are kept to hold the card to the CPU
        frames_fn, demo_fn = render_data.render_frames, render_data.RenderData.render_demo
        calls, episode0, local = [], [], threading.local()

        def recording(*args, **kw):
            result = frames_fn(*args, **kw)
            calls.append(local.episode)
            if local.episode == 0:
                episode0.append((args, kw, [x.cpu() for x in result]))
            return result

        def tagged(self, episode):
            local.episode = episode
            return demo_fn(self, episode)

        render_data.render_frames, render_data.RenderData.render_demo = recording, tagged
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_data.RenderData(cfg, device="cuda").generate()
            out["render_s"] = time.perf_counter() - t0
        finally:
            render_data.render_frames, render_data.RenderData.render_demo = frames_fn, demo_fn
        frames = RENDER_EPISODES * len(RENDER_CAMERAS) * (RENDER_STEPS - 1)
        if sorted(calls) != sorted(list(range(RENDER_EPISODES)) * len(RENDER_CAMERAS)):
            raise AssertionError(f"render calls by episode {sorted(calls)}: want one a camera")
        out["render_frames"] = frames
        out["render_frames_per_s"] = frames / out["render_s"]
        args, kw, _ = episode0[0]
        out["render_call_ms"] = cuda_ms(lambda: frames_fn(*args, **kw), 10)
        out["render_call_frames"] = int(args[1].shape[0])
        # the same function on the CPU, on episode 0's inputs
        far = total = 0
        t0 = time.perf_counter()
        for args, kw, card_out in episode0:
            cpu = frames_fn(*_to_cpu(list(args)), **kw)
            for x, y in zip(card_out, cpu):
                d = (x.short() - y.short()).abs().amax(-1)
                far, total = far + int((d > 1).sum()), total + d.numel()
        out["render_cpu_episode_s"] = time.perf_counter() - t0
        del episode0, args, kw
        out["render_vs_cpu_far_pixels"], out["render_vs_cpu_pixels"] = far, total
        if not (total > 0 and far <= RENDER_MAX_SHARE * total):
            raise AssertionError(f"render card vs CPU: {far} of {total} pixels > 1 level apart")
        rendered = tmp / "raw_rgb_rendered"

        # -- (b) pretrain at sd-turbo geometry ---------------------------------------
        samples = index_rendered_dataset(rendered, tasks=[RENDER_TASK],
                                         num_demos=RENDER_EPISODES)
        loader = DiffusionDataLoader(samples, HashTokenizer(), batch_size=PRETRAIN_BATCH,
                                     resolution=512, seed=0, num_workers=4, emit_uint8=True)
        t0 = time.time()
        pipe = SDControlNetPipeline(device="cuda", vae_encoder=True)
        params = pipe.init_params(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        out["pretrain_setup_s"] = time.time() - t0

        def snapshot(names):
            return {n: {k: t.clone() for k, t in params[n].state_dict().items()} for n in names}

        def changed(snap):
            return [f"{n}.{k}" for n, sd in snap.items() for k, t in sd.items()
                    if not torch.equal(t, params[n].state_dict()[k])]

        frozen_vae_stage = snapshot(("unet", "text_encoder", "controlnet"))
        unet_init = frozen_vae_stage["unet"]
        steps = {"vae": [], "unet": []}
        marks = [time.perf_counter()]
        stage_checks = {}

        def hook(stage, step, state, metrics):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            steps[stage].append({"ms": (marks[-1] - marks[-2]) * 1e3, "counts": counts(),
                                 "loss": float(metrics["loss"])})
            if stage == "vae" and step == PRETRAIN_STEPS:
                stage_checks["vae_stage_changed"] = changed(frozen_vae_stage)
            if stage == "unet" and step == 1:
                stage_checks["unet_stage"] = snapshot(("vae", "text_encoder", "controlnet"))

        masters: dict = {}
        torch.cuda.reset_peak_memory_stats()
        zero()
        pretrain_base_model(pipe, params, loader, vae_steps=PRETRAIN_STEPS,
                            unet_steps=PRETRAIN_STEPS, seed=0, log_every=1, masters=masters,
                            step_hook=hook)
        out["pretrain_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out["pretrain_launches_by_shape"] = {
            k: {"x".join(map(str, s)): n for s, n in fn.launches_by_shape.items()}
            for k, fn in counters.items()}
        if stage_checks["vae_stage_changed"]:
            raise AssertionError(f"frozen towers changed in the VAE stage: "
                                 f"{stage_checks['vae_stage_changed'][:3]}")
        unet_stage_changed = changed(stage_checks.pop("unet_stage"))
        if unet_stage_changed:
            raise AssertionError(f"frozen towers changed in the UNet stage: "
                                 f"{unet_stage_changed[:3]}")
        prev = dict(VAE_LAUNCHES)
        for stage, want in (("vae", VAE_LAUNCHES), ("unet", PRETRAIN_LAUNCHES)):
            if len(steps[stage]) != PRETRAIN_STEPS:
                raise AssertionError(f"pretrain {stage}: {len(steps[stage])} steps")
            for i, s in enumerate(steps[stage]):
                delta = {k: s["counts"][k] - prev[k] for k in want}
                prev = s["counts"]
                if delta != want:
                    raise AssertionError(f"pretrain {stage} step {i + 1} launches {delta}, "
                                         f"want {want}")
            losses = [s["loss"] for s in steps[stage]]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"pretrain {stage} losses {losses}")
            out[f"{stage}_losses"] = losses
            out[f"{stage}_step_ms"] = [s["ms"] for s in steps[stage]]
        out["unet_launches_per_step"] = PRETRAIN_LAUNCHES
        moved = max((masters["unet"][k] - t.float()).abs().max().item()
                    for k, t in unet_init.items())
        if not moved > 0:
            raise AssertionError("the UNet did not move")
        del frozen_vae_stage, unet_init
        out["decoder"] = dict(loader.decoded)
        out["native_build_error"] = native.build_error
        t0 = time.perf_counter()
        base = save_base_model(tmp / "base", params, masters)
        out["base_write_s"] = time.perf_counter() - t0
        out["base_bytes"] = _tree_bytes(base)
        unet_master = {k: v.to(torch.bfloat16) for k, v in masters["unet"].items()}
        del params, pipe, masters
        torch.cuda.empty_cache()

        # the fine-tune from the written base model
        args = parse_args([
            "--data_path", str(rendered), "--tasks", RENDER_TASK, "--resolution", "512",
            "--train_batch_size", str(TRAIN_BATCH), "--max_train_steps",
            str(BASE_FINETUNE_STEPS), "--seed", "0", "--device", "cuda",
            "--mixed_precision", "bf16", "--enable_xformers_memory_efficient_attention",
            "--pretrained_model_name_or_path", str(base), "--dataloader_num_workers", "4",
            "--output_dir", str(tmp / "ft"), "--report_to", "none",
        ])
        pipe = driver.build_pipeline(args)
        t0 = time.perf_counter()
        params = driver.init_model_params(pipe, args)
        torch.cuda.synchronize()
        out["base_load_s"] = time.perf_counter() - t0
        loaded = params["unet"].state_dict()
        if not all(torch.equal(loaded[k], v) for k, v in unet_master.items()):
            raise AssertionError("the fine-tune's UNet is not the written base model's")
        del unet_master
        ft_steps = []
        ft_marks = [time.perf_counter()]

        def ft_hook(step, state, metrics):
            torch.cuda.synchronize()
            ft_marks.append(time.perf_counter())
            ft_steps.append({"ms": (ft_marks[-1] - ft_marks[-2]) * 1e3, "counts": counts(),
                             "loss": float(metrics["loss"])})

        zero()
        result = driver.run_training(args, pipe=pipe, params=params, step_hook=ft_hook)
        if result["global_step"] != BASE_FINETUNE_STEPS or len(ft_steps) != BASE_FINETUNE_STEPS:
            raise AssertionError(f"fine-tune from the base took {result['global_step']} steps")
        prev = {k: 0 for k in TRAIN_LAUNCHES}
        for i, s in enumerate(ft_steps):
            delta = {k: s["counts"][k] - prev[k] for k in TRAIN_LAUNCHES}
            prev = s["counts"]
            if delta != TRAIN_LAUNCHES:
                raise AssertionError(f"fine-tune from the base, step {i + 1}: launches {delta}")
        if not all(math.isfinite(s["loss"]) for s in ft_steps):
            raise AssertionError(f"fine-tune from the base: losses {ft_steps}")
        out["base_finetune_losses"] = [s["loss"] for s in ft_steps]
        out["base_finetune_step_ms"] = [s["ms"] for s in ft_steps]
        del params, pipe
        torch.cuda.empty_cache()

        # -- (c) the controller on the rendered tree, and the gate --------------------
        zero()
        t0 = time.perf_counter()
        ws = train_act.main([
            f"work_dir={tmp / 'ctrl'}", "device=cuda", "num_train_epochs=1", "checkpoint_every=1",
            "env.factory=rendered", f"env.dataset_root={rendered}",
            f"env.train_tasks=[{RENDER_TASK}]", "+env.eval_env_factory=fake",
            f"env.image_size={RENDER_SIZE}", "+env.goal_observable=true",
            f"num_demos={RENDER_EPISODES}",
        ])
        torch.cuda.synchronize()
        out["act_epoch_s"] = time.perf_counter() - t0
        records = [json.loads(x) for x in (tmp / "ctrl" / "metrics.jsonl").read_text().split("\n")
                   if x]
        loss = records[-1]["train_act/loss"]
        if ws.update_failures or not ws._num_iters or not math.isfinite(loss):
            raise AssertionError(f"train_act on the rendered tree: {ws._num_iters} updates, "
                                 f"loss {loss}, failures {ws.update_failures[:1]}")
        out["act_updates"], out["act_loss"] = ws._num_iters, loss
        del ws
        gate_cfg = GateConfig(vae_steps=10, unet_steps=10, cn_steps=10, num_demos=8,
                              act_epochs=1, eval_episodes=2)
        t0 = time.perf_counter()
        run_learning_gate(tmp / "gate", gate_cfg, device="cuda")
        out["gate_cut_s"] = time.perf_counter() - t0
        saved = json.loads((tmp / "gate" / "learning_gate.json").read_text())
        if list(saved) != GATE_KEYS or saved["config"] != dataclasses.asdict(gate_cfg):
            raise AssertionError(f"learning_gate.json keys {list(saved)}")
        out["gate_cut"] = {k: v for k, v in saved.items() if k != "config"}
        if any(counts().values()):
            raise AssertionError(f"controller and gate launched kernels: {counts()}")
        if not all(np.isfinite([saved["val_mse_init"], saved["val_mse_final"]])):
            raise AssertionError(f"gate val_mse {saved}")
    out["phase_s"] = time.time() - t_phase
    return out


# phase 12: the SDXL-turbo ControlNet variant at full width
SDXL_STEPS = 3  # control steps, then train steps
# per denoise step, the UNet's self-attentions at >= 256 tokens (down level 1:
# 2 blocks x 2 layers; level 2: 2 x 10; mid 10; up level 2: 3 x 10; up level
# 1: 3 x 2; level 0 has none) and the ControlNet's (4 + 20 + 10); x 5 steps
SDXL_LAUNCHES_PER_STEP = 5 * (70 + 34)
# per train step at batch 4: the ControlNet's 34 and the UNet up path's 36
# take gradients (B2a forward, B2b backward); the UNet's down path and mid
# block (34) need none (B1)
SDXL_TRAIN_LAUNCHES = {"B1": 34, "B2a": 70, "B2b": 70, "fallbacks": 0}
# the B1/B2a/B2b shapes of the SDXL path: SD's levels 1 and 2 (S, C, heads)
SDXL_KEYS = {f"{b}x{s}x{s}x{c}" for b in (1, TRAIN_BATCH) for _, s, c, _ in SD_LEVELS[1:]}
SDXL_AGENT = "genima_torch.eval.agents.SDXLControlNetAgent"


def _to_host(module_or_tensors) -> dict:
    items = (module_or_tensors.state_dict().items() if hasattr(module_or_tensors, "state_dict")
             else module_or_tensors.items())
    return {k: t.detach().to("cpu", copy=True) for k, t in items}


def _sdxl_train(pa, root: Path) -> dict:
    """(b): the SDXL fine-tune through the driver, launches pinned, frozen
    models held, one step's gradients against the library attention."""
    from genima_torch.cli.train_controlnet_sdxl_genima import parse_args
    from genima_torch.data.dataset import to_device
    from genima_torch.data.tokenizer import HashTokenizer
    from genima_torch.diffusion import driver
    from genima_torch.diffusion.training import SDXLControlNetTrainer, TrainState
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from genima_torch.nn.layers import set_attention_backend

    write_rendered_dataset(root / "data")
    args = parse_args([
        "--data_path", str(root / "data"), "--tasks", "toy_task", "--resolution", "512",
        "--train_batch_size", str(TRAIN_BATCH), "--max_train_steps", str(SDXL_STEPS),
        "--seed", "0", "--device", "cuda", "--mixed_precision", "bf16",
        "--enable_xformers_memory_efficient_attention", "--dataloader_num_workers", "4",
        "--output_dir", str(root / "out"), "--report_to", "none",
    ])
    t0 = time.time()
    pipe = driver.build_pipeline(args, "sdxl")
    params = driver.init_model_params(pipe, args)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    frozen = {name: _to_host(params[name])
              for name in ("unet", "vae", "text_encoder", "text_encoder_2")}
    cn_init = _to_host(dict(params["controlnet"].named_parameters()))
    steps, last = [], {}

    def hook(step, state, metrics):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), _ft_counts(pa)
        steps.append({"ms": (now - last["mark"]) * 1e3, "loss": float(metrics["loss"]),
                      "launches": {k: counts[k] - last["counts"][k] for k in counts}})
        last["mark"], last["counts"] = now, counts
        if step == SDXL_STEPS:  # the final master weights, which the driver saves
            last["master"] = _to_host(state.params)

    _ft_zero(pa)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    last["mark"], last["counts"] = time.perf_counter(), _ft_counts(pa)
    t0 = time.time()
    result = driver.run_training(args, "sdxl", pipe=pipe, params=params, step_hook=hook)
    run_s = time.time() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches_by_shape = {
        k: {"x".join(map(str, sh)): n for sh, n in fn.launches_by_shape.items()}
        for k, fn in (("B1", pa.packed_flash_attention),
                      ("B2a", pa.packed_attention_forward_lse),
                      ("B2b", pa.packed_attention_backward))}
    if result["global_step"] != SDXL_STEPS or len(steps) != SDXL_STEPS:
        raise AssertionError(f"sdxl train took {result['global_step']} steps")
    for i, st in enumerate(steps):
        if st["launches"] != SDXL_TRAIN_LAUNCHES:
            raise AssertionError(f"sdxl train step {i + 1} launches {st['launches']}, "
                                 f"want {SDXL_TRAIN_LAUNCHES}")
        if not math.isfinite(st["loss"]):
            raise AssertionError(f"sdxl train step {i + 1} loss {st['loss']}")
    for name, before in frozen.items():
        after = params[name].state_dict()
        changed = [k for k, t in before.items() if not torch.equal(t.to("cuda"), after[k])]
        if changed:
            raise AssertionError(f"sdxl frozen {name} changed: {changed[:3]}")
    moved = max((last["master"][k] - v).abs().max().item() for k, v in cn_init.items())
    if not moved > 0:
        raise AssertionError("sdxl: the ControlNet did not move")
    final = root / "out" / "controlnet" / "params.msgpack"
    del frozen, cn_init

    # one step's ControlNet gradients: kernels vs the library attention (no
    # optimizer state: only the master weights are read)
    trainer = SDXLControlNetTrainer(pipe, driver.train_config(args, SDXL_STEPS), 512)
    state = trainer.create_state(params)
    state = TrainState(state.params, None, 0)
    batch = to_device(next(iter(driver.make_train_dataset(args, HashTokenizer()))), pipe.device)
    draws = trainer.sample_draws(TRAIN_BATCH, 512, torch.Generator(device="cuda").manual_seed(7))
    grads = {}
    for run, backend, sdpa in (("fused", "fused", None), ("xla", "xla", None),
                               ("xla_efficient", "xla", SDPBackend.EFFICIENT_ATTENTION)):
        for name in ("unet", "controlnet"):
            set_attention_backend(params[name], backend)
        with sdpa_kernel(sdpa) if sdpa is not None else contextlib.nullcontext():
            grads[run] = _to_host(trainer.gradients(state, batch, draws)[1])
    for name in ("unet", "controlnet"):
        set_attention_backend(params[name], "fused")

    report = _grad_report(grads["fused"], grads["xla"], grads["xla_efficient"])
    global_rel, attn_rel = report["global_rel"], report["attn_rel_floored"]
    if not (global_rel <= TRAIN_GRAD_REL_TOL and attn_rel <= TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"sdxl ControlNet grads kernels vs library: {json.dumps(report)}")
    return {
        "setup_s": setup_s, "run_s": run_s, "step_ms": [st["ms"] for st in steps],
        "losses": [st["loss"] for st in steps],
        "launches_per_step": [st["launches"] for st in steps],
        "launches_by_shape": launches_by_shape, "controlnet_max_move": moved,
        "grad_rel_norm_diff_vs_library_attention": global_rel,
        "grad_attn_proj_rel_norm_diff_vs_library_attention": report["attn_rel"],
        "grad_attn_proj_rel_floored": attn_rel,
        "grad_library_backends_rel_norm_diff": report["lib_global_rel"],
        "grad_worst_attn": report["worst_attn"],
        "final_save_bytes": final.stat().st_size, "peak_mem_gb": peak_gb,
        "master": last["master"],
    }


# a self-attention projection's gradient is held to the library's relative to
# its own norm, or to this share of the largest projection gradient's where
# it is smaller: in SDXL's 10-layer stacks some q/k gradients sit at ~1e-4
# of the largest, where the library's own two SDPA backends disagree by as
# much (the report's lib_rel), so their own relative difference is rounding
GRAD_PROJ_FLOOR = 1e-2


def _grad_report(got: dict, want: dict, other: dict) -> dict:
    """Kernel (``got``) against library (``want``) gradients: the global
    relative norm difference, and per self-attention projection its own
    relative difference (``rel``), that against the floor
    (``GRAD_PROJ_FLOOR``), its norm over the largest projection's, and the
    library's other SDPA backend (``other``) against ``want`` (``lib_rel``),
    worst first."""
    def norm(ts):
        return torch.stack([t.float().norm() for t in ts]).norm().item()

    if not norm(want.values()) > 0:
        raise AssertionError("library gradients are all zero")
    diff = {k: got[k] - want[k] for k in want}
    attn = [k for k in want if ".attn1.to_" in k and k.endswith("weight")]
    top = max(want[k].norm().item() for k in attn)
    rows = []
    for k in attn:
        n, d = want[k].norm().item(), diff[k].norm().item()
        rows.append({"key": k, "rel": d / n, "rel_floored": d / max(n, GRAD_PROJ_FLOOR * top),
                     "norm_over_max": n / top,
                     "lib_rel": (other[k] - want[k]).norm().item() / n})
    rows.sort(key=lambda r: -r["rel"])
    return {"global_rel": norm(diff.values()) / norm(want.values()),
            "lib_global_rel": norm([other[k] - want[k] for k in want]) / norm(want.values()),
            "attn_rel": rows[0]["rel"], "attn_rel_floored": max(r["rel_floored"] for r in rows),
            "worst_attn": rows[:8]}


def _variant_eval(pa, ctrl_dir: Path, diffusion_dir: Path, master: dict, agent: str,
                  submodel: str, launches: int, tag: str) -> dict:
    """The eval CLI with ``agent`` on a fine-tune's final save: one serial
    episode, then 2 episodes in one batch of 2. Every generate launches B1
    ``launches`` times; the loaded ``submodel`` must be ``master`` in bf16
    (phase 12: SDXL's ControlNet; phase 13: the pix2pix UNet)."""
    from genima_torch.eval.fused import FusedGenimaStep

    argv = [
        f"controller_ckpt={ctrl_dir}", f"diffusion_ckpt={diffusion_dir}",
        f"diffusion_agent._target_={agent}", "task=fake_reach", "env.factory=fake",
        "env.image_size=256", "image_resolution=512", "num_diffusion_steps=5",
        "guidance_scale=0.0", f"episode_length={EVAL_EPISODE_LENGTH}",
        f"execution_horizon={EVAL_HORIZON}", "device=cuda",
    ]
    out = {}
    for run, extra, episodes, batch in (
        ("S", [], 1, 1),
        ("B", ["num_parallel_envs=2", "eval_overlap=false"], 2, 2),
    ):
        logs, probe = _run_eval_cli(pa, argv + extra + [f"num_eval_episodes={episodes}"],
                                    _BatchedEvalProbe)
        results = logs["results"]
        if results["total_episodes"] != episodes or results["env_exception_episodes"]:
            raise AssertionError(f"{tag} eval {run}: results {results}")
        steps = len(probe.fused_calls)
        # a generate per (batched) control step, and the gen-time probe's two
        if len(probe.generate_calls) != steps + 2:
            raise AssertionError(f"{tag} eval {run}: {len(probe.generate_calls)} generates for "
                                 f"{steps} steps")
        for delta in probe.generate_calls:
            if sum(delta.values()) != launches or {k[0] for k in delta} != {batch}:
                raise AssertionError(f"{tag} eval {run}: a generate launched B1 {dict(delta)}")
        for t in probe.targets:
            if t.shape != (batch, 512, 512, 3) or t.dtype != torch.uint8:
                raise AssertionError(f"{tag} eval {run}: target {tuple(t.shape)} {t.dtype}")
        if any(a != ((batch, EVAL_HORIZON, 8), True) for a in probe.step_actions):
            raise AssertionError(f"{tag} eval {run}: actions {probe.step_actions}")
        launches_by_shape = {"x".join(map(str, k)): v for k, v in
                             pa.packed_flash_attention.launches_by_shape.items()}
        step_self, args, kwargs, (actions, target) = probe.first_fused
        torch.cuda.synchronize()
        dag = probe.load["diffusion_params_s_owner"]
        serial = FusedGenimaStep(dag, step_self.controller, step_self.obs_size)
        r = {}
        if run == "S":
            # the model the agent loaded: the final master weights in bf16
            loaded = dag.params[submodel].state_dict()
            bad = [k for k, v in master.items()
                   if not torch.equal(loaded[k], v.to("cuda", loaded[k].dtype))]
            if bad or loaded[next(iter(loaded))].dtype != torch.bfloat16:
                raise AssertionError(f"{tag} eval: loaded {submodel} differs at {bad[:3]}")
            d_actions, d_target = serial(*args, **kwargs)
            torch.cuda.synchronize()
            err = (d_actions.float() - actions.float()).abs().max().item()
            if not (torch.equal(d_target, target) and err <= DIRECT_STEP_TOL):
                raise AssertionError(f"{tag} eval: harness step vs FusedGenimaStep: actions err "
                                     f"{err}, target equal {torch.equal(d_target, target)}")
            r["harness_vs_direct_step_actions_err"] = err
        else:
            # the first batched step's rows against FusedGenimaStep at batch 1
            params, ctrl, clip, tiled, embeds, latents, qpos, lang = args
            noise = kwargs["noise"]
            t_max, t_mean, a_max = [], [], []
            for i in range(batch):
                row = slice(i, i + 1)
                row_embeds = (tuple(e[row] for e in embeds) if isinstance(embeds, tuple)
                              else embeds[row])  # SDXL's (hidden, pooled)
                a, t = serial(params, ctrl, clip, tiled[row], row_embeds,
                              latents[row], qpos[row], lang[row],
                              noise=None if noise is None else noise[:, row],
                              num_inference_steps=kwargs["num_inference_steps"])
                diff = (t.int() - target[row].int()).abs().float()
                t_max.append(diff.max().item())
                t_mean.append(diff.mean().item())
                a_max.append((a.float() - actions[row].float()).abs().max().item())
            r["rows"] = {"target_max_levels": t_max, "target_mean_levels": t_mean,
                         "actions_max_abs": a_max}
            if not (max(t_max) <= ROW_TARGET_MAX_LEVELS and max(t_mean) <= ROW_TARGET_MEAN_LEVELS
                    and max(a_max) <= ROW_ACTION_ATOL):
                raise AssertionError(f"{tag} batched rows vs FusedGenimaStep: {r['rows']}")
        metrics = _last_metrics(ctrl_dir)
        out[run] = {
            **r, "episodes": results["total_episodes"], "control_steps": steps,
            "generates": len(probe.generate_calls),
            "b1_launches_per_generate": [sum(d.values()) for d in probe.generate_calls],
            "launches_by_shape": launches_by_shape,
            "diffusion_params_load_s": probe.load["diffusion_params_s"],
            "loop_s": probe.loop_s(),
            "gen_time_s": metrics["eval_genima/gen_time"],
            "control_time_s": metrics["eval_genima/control_time"],
            "fused_step_time_s": metrics.get("eval_genima/fused_step_time"),
        }
        del probe, dag, serial, step_self, args, kwargs, actions, target
        torch.cuda.empty_cache()
    return out


def sdxl_phase(pa, card: str, ctrl_dir: Path, root: Path) -> dict:
    """Phase 12: serving, the fine-tune and the eval CLI at sdxl-turbo width."""
    import gc

    t_phase = time.time()
    out = {"card": card, "serve": _sd_serve(pa, "sdxl", 512, SDXL_STEPS, SDXL_LAUNCHES_PER_STEP,
                                             opt_in=False)}
    gc.collect()
    torch.cuda.empty_cache()
    train = _sdxl_train(pa, root)
    master = train.pop("master")
    out["train"] = train
    gc.collect()
    torch.cuda.empty_cache()
    out["eval"] = _variant_eval(pa, ctrl_dir, root / "out", master, SDXL_AGENT, "controlnet",
                                SDXL_LAUNCHES_PER_STEP, "sdxl")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.time() - t_phase
    return out


# phase 13: InstructPix2Pix (EMA, conditioning dropout) and the tiny VAE
PIX2PIX_AGENT = "genima_torch.eval.agents.SDPix2PixAgent"
PIX2PIX_CKPT_AT, PIX2PIX_STEPS = 2, 4  # run A: 2 steps, a checkpoint at 2; run B: a resume to 4
# per denoise step the UNet's 15 self-attentions at >= 256 tokens (2 down + 3
# up blocks at each of its three attention levels; the 64-token mid block
# takes the library attention) x 5 steps; no ControlNet
PIX2PIX_LAUNCHES_PER_STEP = 5 * 15
# the whole UNet trains: its 15 take gradients (B2a forward, B2b backward)
PIX2PIX_TRAIN_LAUNCHES = {"B1": 0, "B2a": 15, "B2b": 15, "fallbacks": 0}
# opt-in: 16 transformers x (self + cross) x 5 steps = 160 B3; 12 int8 linears
# x 16 x 5 = 960 B5; the KL decoder's 25 B4; no B1
PIX2PIX_OPT_LAUNCHES = {"B1": 0, "B3": 160, "B4": 25, "B5": 960}
DISTILL_STEPS = 20  # tiny-VAE distillation steps at 512^2, batch 4
DECODE_ITERS = 10


class _Pix2PixProbe:
    """Wraps, for phase 13 (a), the step-checkpoint writer (seconds, bytes)
    and the resume (seconds; its EMA held to ``want_ema`` bit for bit, on
    the host). ``close`` puts the originals back."""

    def __init__(self, driver, ckpt):
        self.driver, self.ckpt = driver, ckpt
        self.orig = (ckpt.save_step_checkpoint, driver.restore_checkpoint)
        self.writes, self.restores, self.want_ema = [], [], None
        ckpt.save_step_checkpoint = self._save
        driver.restore_checkpoint = self._restore

    def _save(self, output_dir, step, **kwargs):
        t0 = time.perf_counter()
        d = self.orig[0](output_dir, step, **kwargs)
        self.writes.append({"step": step, "s": time.perf_counter() - t0,
                            "bytes": _tree_bytes(d), "files": sorted(
                                str(f.relative_to(d)) for f in d.rglob("*") if f.is_file())})
        return d

    def _restore(self, trainer, state, resume_dir):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.orig[1](trainer, state, resume_dir)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        bad = (["<no EMA>"] if out.ema is None else
               [k for k, v in self.want_ema.items() if not torch.equal(out.ema[k].cpu(), v)])
        if bad:
            raise AssertionError(f"pix2pix resume: EMA not the written one at {bad[:3]}")
        self.restores.append({"s": dt, "step": out.step})
        return out

    def close(self) -> None:
        self.ckpt.save_step_checkpoint, self.driver.restore_checkpoint = self.orig


def _pix2pix_train(pa, root: Path) -> dict:
    """(a): the pix2pix fine-tune through the trainer CLI's parser and the
    driver with EMA and conditioning dropout: run A checkpoints at step 2,
    run B resumes it to step 4; launches pinned, frozen models held, the
    final save = the EMA, one step's UNet gradients against the library
    attention."""
    from genima_torch.cli.train_instruct_pix2pix_genima import parse_args
    from genima_torch.core import checkpoint as ckpt
    from genima_torch.data.dataset import to_device
    from genima_torch.data.tokenizer import HashTokenizer
    from genima_torch.diffusion import driver
    from genima_torch.diffusion import train_state as ts
    from genima_torch.diffusion.training import Pix2PixTrainer, TrainState
    from genima_torch.nn.layers import set_attention_backend
    from genima_torch.weights.to_jax import flax_paths
    from torch.nn.attention import SDPBackend, sdpa_kernel

    write_rendered_dataset(root / "data")
    out_dir = root / "out"
    argv = ["--data_path", str(root / "data"), "--tasks", "toy_task", "--seed", "0",
            "--device", "cuda", "--enable_xformers_memory_efficient_attention",
            "--dataloader_num_workers", "4", "--output_dir", str(out_dir),
            "--report_to", "none", "--use_ema", "--conditioning_dropout_prob", "0.05",
            "--checkpoints_total_limit", "1"]
    # run A checkpoints and validates at its last step; run B does neither
    run_a = ["--max_train_steps", str(PIX2PIX_CKPT_AT), "--checkpointing_steps",
             str(PIX2PIX_CKPT_AT), "--validation_steps", str(PIX2PIX_CKPT_AT)]
    args = parse_args(argv + run_a)
    if (args.train_batch_size, args.resolution) != (TRAIN_BATCH, 512):
        raise AssertionError("the pix2pix parser's defaults moved")
    t0 = time.time()
    pipe = driver.build_pipeline(args, "pix2pix")
    params = driver.init_model_params(pipe, args)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    frozen = {name: _to_host(params[name]) for name in ("vae", "text_encoder")}
    unet_init = _to_host(params["unet"])
    steps, last = [], {}

    def hook(step, state, metrics):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), _ft_counts(pa)
        steps.append({"step": step, "ms": (now - last["mark"]) * 1e3,
                      "loss": float(metrics["loss"]),
                      "launches": {k: counts[k] - last["counts"][k] for k in counts}})
        last["mark"], last["counts"] = now, counts
        if step == PIX2PIX_CKPT_AT:  # what run A's checkpoint holds
            probe.want_ema = _to_host(state.ema)
        if step == PIX2PIX_STEPS:
            last["ema"], last["master"] = _to_host(state.ema), _to_host(state.params)

    probe = _Pix2PixProbe(driver, ckpt)
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    try:
        for run, extra in (("A", run_a),
                           ("B", ["--max_train_steps", str(PIX2PIX_STEPS),
                                  "--checkpointing_steps", "0", "--validation_steps", "0",
                                  "--resume_from_checkpoint", "latest"])):
            _ft_zero(pa)
            torch.cuda.synchronize()
            last["mark"], last["counts"] = time.perf_counter(), _ft_counts(pa)
            t0 = time.time()
            runs[run] = driver.run_training(parse_args(argv + extra), "pix2pix", pipe=pipe,
                                            params=params, step_hook=hook)
            runs[run]["s"] = time.time() - t0
            if run == "A":
                launches_by_shape = {
                    k: {"x".join(map(str, sh)): n for sh, n in fn.launches_by_shape.items()}
                    for k, fn in (("B1", pa.packed_flash_attention),
                                  ("B2a", pa.packed_attention_forward_lse),
                                  ("B2b", pa.packed_attention_backward))}
    finally:
        probe.close()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if [st["step"] for st in steps] != list(range(1, PIX2PIX_STEPS + 1)):
        raise AssertionError(f"pix2pix train steps {[st['step'] for st in steps]}")
    if runs["B"]["global_step"] != PIX2PIX_STEPS or len(probe.restores) != 1:
        raise AssertionError(f"pix2pix resume: {runs['B']}, restores {probe.restores}")
    for st in steps:
        if st["launches"] != PIX2PIX_TRAIN_LAUNCHES or not math.isfinite(st["loss"]):
            raise AssertionError(f"pix2pix train step {st['step']}: launches {st['launches']}, "
                                 f"want {PIX2PIX_TRAIN_LAUNCHES}; loss {st['loss']}")
    files = probe.writes[0]["files"] if probe.writes else []
    if len(probe.writes) != 1 or "ema.msgpack" not in files or not math.isfinite(
            runs["A"]["val_mse"]):
        raise AssertionError(f"pix2pix checkpoint: {probe.writes}, val_mse {runs['A']['val_mse']}")
    for name, before in frozen.items():
        after = params[name].state_dict()
        changed = [k for k, t in before.items() if not torch.equal(t.to("cuda"), after[k])]
        if changed:
            raise AssertionError(f"pix2pix frozen {name} changed: {changed[:3]}")
    moved = max((last["master"][k] - v.float()).abs().max().item() for k, v in unet_init.items())
    lag = max((last["ema"][k] - last["master"][k]).abs().max().item() for k in last["ema"])
    if not (moved > 0 and lag > 0):
        raise AssertionError(f"pix2pix: the UNet moved {moved}, the EMA trails by {lag}")
    # the final save is the EMA, bit for bit
    t0 = time.time()
    final = out_dir / "unet" / "params.msgpack"
    saved = ts.params_from_tree(ckpt.load_pytree(final),
                                flax_paths(params["unet"], "diffusers_unet"), last["ema"])
    final_load_s = time.time() - t0
    bad = [k for k, v in last["ema"].items() if not torch.equal(saved[k], v)]
    if bad:
        raise AssertionError(f"pix2pix final save is not the EMA at {bad[:3]}")
    del saved, frozen, unet_init
    shutil.rmtree(out_dir / f"checkpoint-{PIX2PIX_CKPT_AT}", ignore_errors=True)

    # one step's UNet gradients: kernels vs the library attention
    trainer = Pix2PixTrainer(pipe, driver.train_config(args, PIX2PIX_STEPS),
                             conditioning_dropout_prob=args.conditioning_dropout_prob,
                             null_token_ids=HashTokenizer()([""]))
    state = trainer.create_state(params)
    state = TrainState(state.params, None, 0)
    torch.cuda.empty_cache()
    batch = to_device(next(iter(driver.make_train_dataset(args, HashTokenizer()))), pipe.device)
    draws = trainer.sample_draws(TRAIN_BATCH, 512, torch.Generator(device="cuda").manual_seed(7))
    grads = {}
    for run, backend, sdpa in (("fused", "fused", None), ("xla", "xla", None),
                               ("xla_efficient", "xla", SDPBackend.EFFICIENT_ATTENTION)):
        set_attention_backend(params["unet"], backend)
        with sdpa_kernel(sdpa) if sdpa is not None else contextlib.nullcontext():
            grads[run] = _to_host(trainer.gradients(state, batch, draws)[1])
    set_attention_backend(params["unet"], "fused")
    del state, trainer
    report = _grad_report(grads["fused"], grads["xla"], grads["xla_efficient"])
    del grads
    if not (report["global_rel"] <= TRAIN_GRAD_REL_TOL
            and report["attn_rel_floored"] <= TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"pix2pix UNet grads kernels vs library: {json.dumps(report)}")
    write = probe.writes[0]
    return {
        "setup_s": setup_s, "run_s": {k: v["s"] for k, v in runs.items()},
        "step_ms": [st["ms"] for st in steps], "losses": [st["loss"] for st in steps],
        # host clock, less each run's first step (run B's holds the resume)
        "steady_step_ms": [st["ms"] for st in steps if st["step"] not in (1, PIX2PIX_CKPT_AT + 1)],
        "launches_per_step": [st["launches"] for st in steps],
        "launches_by_shape": launches_by_shape, "unet_max_move": moved, "ema_lag": lag,
        "val_mse": runs["A"]["val_mse"],
        "checkpoint_bytes": write["bytes"], "checkpoint_files": write["files"],
        "checkpoint_write_s": write["s"], "resume_s": probe.restores[0]["s"],
        "final_save_bytes": final.stat().st_size, "final_load_s": final_load_s,
        "grad_rel_norm_diff_vs_library_attention": report["global_rel"],
        "grad_attn_proj_rel_norm_diff_vs_library_attention": report["attn_rel"],
        "grad_attn_proj_rel_floored": report["attn_rel_floored"],
        "grad_library_backends_rel_norm_diff": report["lib_global_rel"],
        "grad_worst_attn": report["worst_attn"][:3], "peak_mem_gb": peak_gb,
        "ema": last["ema"],
    }


def _tiny_vae(pa, root: Path, ctrl_dir: Path) -> dict:
    """(c): distil the tiny VAE from the full-width KL-VAE at 512^2, save a
    base-model snapshot with it, and run the eval CLI with
    ``autoencoder=taesd`` on that snapshot; its decode timed against the KL
    decoder's."""
    from genima_torch.cli.train_instruct_pix2pix_genima import parse_args
    from genima_torch.data.tokenizer import HashTokenizer
    from genima_torch.diffusion import driver
    from genima_torch.diffusion.pipeline import SDControlNetPipeline
    from genima_torch.diffusion.pretrain import (
        distill_tiny_vae, save_base_model, tiny_vae_decode_psnr,
    )
    from genima_torch.kernels import fused_conv as fc
    from genima_torch.nn.vae import AutoencoderKL, AutoencoderTiny
    from genima_torch.weights.init import build_module, init_random_

    pipe = SDControlNetPipeline(device="cuda", vae_encoder=True, use_tiny_vae=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    params = {"vae": init_random_(build_module(
                  lambda: AutoencoderKL(pipe.vae_cfg, encoder=True), pipe.device, pipe.dtype), gen),
              "tiny_vae": init_random_(build_module(
                  lambda: AutoencoderTiny(n_levels=len(pipe.vae_cfg.block_out_channels) - 1),
                  pipe.device, pipe.dtype), gen)}
    args = parse_args(["--data_path", str(root / "data"), "--tasks", "toy_task", "--seed", "0",
                       "--dataloader_num_workers", "4"])
    loader = driver.make_train_dataset(args, HashTokenizer())
    images = torch.from_numpy(next(iter(loader))["pixel_values"]).to("cuda")
    psnr = [tiny_vae_decode_psnr(pipe, params, images)]
    masters, step_ms, mark = {}, [], {}
    _ft_zero(pa)

    def hook(tag, step, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - mark["t"]) * 1e3)
        mark["t"] = now

    torch.cuda.synchronize()
    mark["t"] = time.perf_counter()
    t0 = time.time()
    distill_tiny_vae(pipe, params, loader, steps=DISTILL_STEPS, lr=1e-3, masters=masters,
                     step_hook=hook, log_every=DISTILL_STEPS)
    distill_s = time.time() - t0
    psnr.append(tiny_vae_decode_psnr(pipe, params, images))
    if not (math.isfinite(psnr[1]) and psnr[1] > psnr[0]):
        raise AssertionError(f"tiny VAE distillation: PSNR {psnr[0]} -> {psnr[1]}")
    if any(_ft_counts(pa).values()):
        raise AssertionError(f"the distiller launched {_ft_counts(pa)}")
    t0 = time.time()
    save_base_model(root / "base", params, masters)
    save_s = time.time() - t0
    if not (root / "base" / "tiny_vae" / "params.msgpack").exists():
        raise AssertionError("save_base_model wrote no tiny_vae/params.msgpack")
    tiny_master = {k: v.cpu() for k, v in masters["tiny_vae"].items()}
    del params, masters
    torch.cuda.empty_cache()

    # the eval CLI, the default agent decoding with the distilled tiny VAE
    argv = [f"controller_ckpt={ctrl_dir}", f"sd_ckpt={root / 'base'}", "autoencoder=taesd",
            "task=fake_reach", "env.factory=fake", "env.image_size=256", "image_resolution=512",
            "num_diffusion_steps=5", "guidance_scale=0.0", f"episode_length={EVAL_EPISODE_LENGTH}",
            f"execution_horizon={EVAL_HORIZON}", "device=cuda", "num_eval_episodes=1"]
    logs, probe = _run_eval_cli(pa, argv, _BatchedEvalProbe)
    results = logs["results"]
    if results["total_episodes"] != 1 or results["env_exception_episodes"]:
        raise AssertionError(f"taesd eval: results {results}")
    for delta in probe.generate_calls:
        if sum(delta.values()) != LAUNCHES_PER_STEP or {k[0] for k in delta} != {1}:
            raise AssertionError(f"taesd eval: a generate launched B1 {dict(delta)}")
    dag = probe.load["diffusion_params_s_owner"]
    loaded = dag.params["tiny_vae"].state_dict() if dag.pipe.use_tiny_vae else {}
    bad = [k for k, v in tiny_master.items()
           if k not in loaded or not torch.equal(loaded[k], v.to("cuda", loaded[k].dtype))]
    if bad:
        raise AssertionError(f"taesd eval: the loaded tiny VAE differs at {bad[:3]}")
    # the KL decoder on the fused convs: the tiny VAE decodes, so no B4 runs
    dag.params["vae"].decoder.conv_backend = OPT_CONV_BACKEND
    fc.fused_conv3x3.launches = 0
    b1 = pa.packed_flash_attention.launches
    obs = torch.randint(0, 256, (1, 512, 512, 3), dtype=torch.uint8, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
    target = dag.infer_device(obs, ["reach the target"])
    torch.cuda.synchronize()
    fused_launches = {"B1": pa.packed_flash_attention.launches - b1,
                      "B4": fc.fused_conv3x3.launches}
    if fused_launches != {"B1": LAUNCHES_PER_STEP, "B4": 0} or target.shape != (1, 512, 512, 3):
        raise AssertionError(f"taesd under conv_backend=fused: {fused_launches}")
    dag.params["vae"].decoder.conv_backend = "xla"
    z = torch.randn(1, 4, 64, 64, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(6)).to(dag.pipe.dtype)
    with torch.inference_mode():
        tiny_ms = cuda_ms(lambda: dag.params["tiny_vae"].decode(z), DECODE_ITERS)
        full_ms = cuda_ms(lambda: dag.params["vae"].decode(z / pipe.vae_cfg.scaling_factor),
                          DECODE_ITERS)
    metrics = _last_metrics(ctrl_dir)
    out = {"psnr_db": psnr, "distill_steps": DISTILL_STEPS, "distill_s": distill_s,
           "distill_step_ms": step_ms, "base_save_s": save_s,
           "base_bytes": _tree_bytes(root / "base"),
           "eval_generates": len(probe.generate_calls),
           "eval_fused_step_time_s": metrics.get("eval_genima/fused_step_time"),
           "eval_agent_load_s": probe.load["diffusion_params_s"],
           "fused_conv_launches": fused_launches,
           "tiny_decode_ms": tiny_ms, "full_decode_ms": full_ms}
    del probe, dag
    torch.cuda.empty_cache()
    return out


def pix2pix_phase(pa, card: str, ctrl_dir: Path) -> dict:
    """Phase 13: the pix2pix fine-tune, its eval and opt-in step, and the
    tiny VAE, at sd-turbo width; everything written under a temporary
    directory removed when the phase ends."""
    import gc

    t_phase = time.time()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        train = _pix2pix_train(pa, root)
        ema = train.pop("ema")
        out["train"] = train
        gc.collect()
        torch.cuda.empty_cache()
        out["eval"] = _variant_eval(pa, ctrl_dir, root / "out" / "unet", ema, PIX2PIX_AGENT,
                                    "unet", PIX2PIX_LAUNCHES_PER_STEP, "pix2pix")
        del ema
        gc.collect()
        torch.cuda.empty_cache()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30  # _serve resets the count
        out["opt_in"] = _serve("pix2pix", 512, OPT_BACKEND, OPT_CONV_BACKEND,
                               PIX2PIX_OPT_LAUNCHES, steps=1)
        gc.collect()
        torch.cuda.empty_cache()
        out["tiny_vae"] = _tiny_vae(pa, root, ctrl_dir)
    out["peak_mem_gb"] = max(peak_gb, torch.cuda.max_memory_allocated() / 2**30)
    out["phase_s"] = time.time() - t_phase
    return out


# phase 14: data-parallel training and mesh serving on one card
DP_WORLD, DP_BATCH, DP_STEPS = 2, 2, 2  # ranks on cuda:0, per-rank batch, steps
DP_LEVELS = [(DP_BATCH, s, c, h) for _, s, c, h in SD_LEVELS]
# the data-parallel step 1 vs one process at batch 4 on the same weights and
# draws: the averaged gradients within DP_REL_TOL; the update within
# DP_UPDATE_REL_TOL of one process's optimizer on those gradients. Against
# the batch-4 step's own update Adam's first step (~lr x sign(g), eps 1e-8)
# follows bf16 rounding wherever |g| is near the two gradients' disagreement:
# printed, not held
DP_REL_TOL = 1e-2
DP_UPDATE_REL_TOL = 1e-6
DP_TIMEOUT_S = 300  # each collective: a lost rank fails the phase well inside the limit
# the TP-sharded noise prediction vs the whole UNet + ControlNet on the same
# bf16 inputs: max abs error over max abs within EPS_REL_TOL (the limit of
# the kernel-vs-library check: a split layer's cuBLAS calls round otherwise),
# and no further from the same models in f32 than TP_F32_RATIO times the
# whole bf16 models are
TP_F32_RATIO = 1.5
TP_STEPS = 3


def _checksum(tensors: dict) -> list:
    """Per tensor, the sum of its 32-bit words as int64: equal bits give equal
    sums (a bit-level fingerprint, made on the card)."""
    return [int(t.detach().contiguous().view(torch.int32).sum(dtype=torch.int64))
            for _, t in sorted(tensors.items())]


def _dp_argv(data_dir: str, out_dir: str, steps: int) -> list[str]:
    return ["--data_path", data_dir, "--tasks", "toy_task", "--resolution", "512",
            "--train_batch_size", str(DP_BATCH), "--max_train_steps", str(steps),
            "--lr_scheduler", "constant", "--seed", "0", "--device", "cuda",
            "--mixed_precision", "bf16", "--enable_xformers_memory_efficient_attention",
            "--dataloader_num_workers", "2", "--output_dir", out_dir, "--report_to", "none",
            "--checkpointing_steps", "0"]


def _dp_finetune_rank(rank: int, world: int, backend: str, init_file: str, data_dir: str,
                      out_dir: str, steps: int, reference: bool) -> None:
    """One rank of phase 14 (a) / (b): ``run_training`` at full width over
    the process group, its launches, step and all-reduce times, a checksum
    of the ControlNet's masters after each step; with ``reference``, rank 0
    then leaves the group and takes one single-process step on the
    concatenated global batch from the same initial weights and draws."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from genima_torch.cli.train_controlnet_genima import parse_args
    from genima_torch.core import distributed as dist
    from genima_torch.diffusion import driver, training
    from genima_torch.kernels import packed_attention as pa

    t_start = time.perf_counter()
    dist.initialize(init_method=f"file://{init_file}", world_size=world, rank=rank,
                    backend=backend, device="cuda:0", timeout_s=DP_TIMEOUT_S)
    args = parse_args(_dp_argv(data_dir, str(Path(out_dir) / "run"), steps))
    pipe = driver.build_pipeline(args)
    params = driver.init_model_params(pipe, args)
    cn_init = {k: t.clone() for k, t in params["controlnet"].state_dict().items()}
    counters = {"B1": pa.packed_flash_attention, "B2a": pa.packed_attention_forward_lse,
                "B2b": pa.packed_attention_backward}
    for fn in counters.values():
        fn.launches = 0
        fn.launches_by_shape.clear()
    pa.PackedFlashAttention.fallbacks = 0
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    rec = {"rank": rank, "world": world, "backend": torch.distributed.get_backend(),
           "all_reduce_ms": [], "step_ms": [], "losses": [], "launches": [], "checksums": []}
    first: dict = {}
    real_reduce, real_step = training.all_reduce_mean_, training.ControlNetTrainer.step_with_draws

    def timed_reduce(grads, *scalars):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_reduce(grads, *scalars)
        torch.cuda.synchronize()
        rec["all_reduce_ms"].append((time.perf_counter() - t0) * 1e3)
        first.setdefault("grads", {k: v.clone() for k, v in grads.items()})
        return out

    def recording_step(self, state, batch, draws):
        first.setdefault("batch", {k: v.cpu() for k, v in batch.items()})
        first.setdefault("draws", draws)
        return real_step(self, state, batch, draws)

    marks = [time.perf_counter()]

    def hook(step, state, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        rec["step_ms"].append((marks[-1] - marks[-2]) * 1e3)
        counts = {k: fn.launches for k, fn in counters.items()}
        counts["fallbacks"] = pa.PackedFlashAttention.fallbacks
        rec["launches"].append(counts)
        rec["losses"].append(float(metrics["loss"]))
        rec["checksums"].append(_checksum(state.params))
        if step == 1:
            first["params"] = {k: v.clone() for k, v in state.params.items()}

    training.all_reduce_mean_ = timed_reduce
    training.ControlNetTrainer.step_with_draws = recording_step
    torch.cuda.reset_peak_memory_stats()
    try:
        result = driver.run_training(args, pipe=pipe, params=params, step_hook=hook)
    finally:
        training.all_reduce_mean_ = real_reduce
        training.ControlNetTrainer.step_with_draws = real_step
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    rec["global_step"] = result["global_step"]
    rec["launches_by_shape"] = {k: {"x".join(map(str, s)): n for s, n in fn.launches_by_shape.items()}
                                for k, fn in counters.items()}
    batches = [first["batch"]]
    if world > 1:
        batches = [None] * world
        torch.distributed.all_gather_object(batches, first["batch"])
    dist.shutdown()
    if reference and rank == 0:
        # one process, the concatenated batch, the same initial weights and draws
        params["controlnet"].load_state_dict(cn_init)
        trainer = training.ControlNetTrainer(pipe, driver.train_config(args, steps, world))
        state = trainer.create_state(params)
        start = {k: v.clone() for k, v in state.params.items()}
        batch = {k: torch.cat([b[k] for b in batches]).to(pipe.device) for k in batches[0]}
        gen = torch.Generator(device=pipe.device).manual_seed((args.seed or 0) + 1234)
        draws = trainer.sample_draws(DP_BATCH * world, 512, gen)
        rows = slice(0, DP_BATCH)
        rec["draws_equal_global_rows"] = all(
            torch.equal(getattr(first["draws"], f)[...], getattr(draws, f)[rows])
            for f in ("sample_noise", "noise", "timesteps"))
        got = {}
        training.all_reduce_mean_ = lambda g, *s: (got.update({k: v.clone() for k, v in g.items()})
                                                   or s)
        try:
            state, metrics = trainer.step_with_draws(state, batch, draws)
        finally:
            training.all_reduce_mean_ = real_reduce

        def rel(a: dict, b: dict) -> float:
            num = sum(float((a[k].double() - b[k].double()).norm() ** 2) for k in b)
            return (num / sum(float(b[k].double().norm() ** 2) for k in b)) ** 0.5

        rec["grad_rel_norm_diff_vs_one_process"] = rel(first["grads"], got)
        upd = {k: first["params"][k] - start[k] for k in start}
        ref_upd = {k: state.params[k] - start[k] for k in start}
        rec["update_rel_norm_diff_vs_one_process"] = rel(upd, ref_upd)
        n = sum(t.numel() for t in upd.values())
        rec["sign_flipped_share"] = sum(
            int((torch.sign(upd[k]) != torch.sign(ref_upd[k])).sum()) for k in upd) / n
        # one process's optimizer on the ranks' averaged gradients
        mine = {k: v.clone() for k, v in start.items()}
        trainer.tx.step_(mine, {k: v.clone() for k, v in first["grads"].items()},
                         trainer.tx.init(mine))
        rec["update_rel_norm_diff_vs_one_process_on_the_same_gradients"] = rel(
            upd, {k: mine[k] - start[k] for k in start})
        rec["update_bit_equal_to_one_process_on_the_same_gradients"] = all(
            torch.equal(mine[k], first["params"][k]) for k in start)
        rec["one_process_loss"] = float(metrics["loss"])
    rec["process_s"] = time.perf_counter() - t_start
    Path(out_dir, f"{backend}_rank{rank}.json").write_text(json.dumps(rec))


def _act_dp_rank(rank: int, init_file: str, work_dir: str, out_dir: str) -> None:
    """One rank of phase 14 (c): ``train_act`` at phase 9's cut for one
    epoch over a 2-rank gloo group on the card."""
    from genima_torch.cli import train_act
    from genima_torch.core import distributed as dist

    t0 = time.perf_counter()
    dist.initialize(init_method=f"file://{init_file}", world_size=DP_WORLD, rank=rank,
                    backend="gloo", device="cuda:0", timeout_s=DP_TIMEOUT_S)
    torch.cuda.reset_peak_memory_stats()
    ws = train_act.main([f"work_dir={work_dir}", "device=cuda", "env.factory=fake",
                         "env.task=fake_reach", "env.image_size=256", f"num_demos={ACT_DEMOS}",
                         f"batch_size={ACT_BATCH}", "checkpoint_every=1", "num_train_epochs=1"])
    rec = {"rank": rank, "updates": ws._num_iters, "update_failures": len(ws.update_failures),
           "checksums": _checksum(ws.state.master), "mesh": ws.mesh is not None,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "process_s": time.perf_counter() - t0}
    dist.shutdown()
    Path(out_dir, f"act_rank{rank}.json").write_text(json.dumps(rec))


def _spawn(jobs: list) -> None:
    """Start every (target, args) in a spawned process at once and wait for
    all; any that fails fails the phase."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=a) for fn, a in jobs]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    bad = [(p.name, p.exitcode) for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"phase 14: processes failed: {bad}")


def _dp_checks(recs: list, steps: int) -> None:
    for r in recs:
        if r["global_step"] != steps or len(r["launches"]) != steps:
            raise AssertionError(f"dp rank {r['rank']}: {r['global_step']} steps")
        prev = {k: 0 for k in r["launches"][0]}
        for i, c in enumerate(r["launches"]):
            d = {k: c[k] - prev[k] for k in c}
            prev = c
            if d != TRAIN_LAUNCHES:
                raise AssertionError(f"dp rank {r['rank']} step {i + 1} launches {d}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"dp rank {r['rank']} losses {r['losses']}")
    for step in range(steps):
        sums = {tuple(r["checksums"][step]) for r in recs}
        if len(sums) != 1:
            raise AssertionError(f"dp: the ranks' ControlNets differ after step {step + 1}")


def _mesh_serving(pa, written: dict) -> dict:
    """Phase 14 (d): the eval CLI over a 1x1 mesh, then the TP-sharded
    control step through the API."""
    from genima_torch.core.mesh import make_mesh
    from genima_torch.core.tp import ColumnSharded, shard_params_tp
    from genima_torch.eval.main_path import build_main_path
    from genima_torch.eval.parallel import BatchedGenimaStep
    from genima_torch.nn.layers import set_attention_backend

    out = {}
    ctrl_dir = written["controller_dir"]
    argv = [f"controller_ckpt={ctrl_dir}", f"diffusion_ckpt={written['diffusion_dir']}",
            "task=fake_reach", "env.factory=fake", "env.image_size=256", "image_resolution=512",
            "num_diffusion_steps=5", f"episode_length={EVAL_HORIZON}",
            f"execution_horizon={EVAL_HORIZON}", "device=cuda", "guidance_scale=0.0",
            "num_parallel_envs=2", "num_eval_episodes=2", "eval_data_parallel=true"]
    t0 = time.perf_counter()
    logs, probe = _run_eval_cli(pa, argv)
    results = logs["results"]
    if results["total_episodes"] != 2 or results["env_exception_episodes"]:
        raise AssertionError(f"mesh eval: results {results}")
    for delta in probe.generate_calls:
        if sum(delta.values()) != LAUNCHES_PER_STEP or {k[0] for k in delta} != {1}:
            raise AssertionError(f"mesh eval: a generate launched B1 {dict(delta)}")
    out["eval"] = {"generates": len(probe.generate_calls), "s": time.perf_counter() - t0,
                   "steps": [e["steps"] for e in logs["eval_episodes"]],
                   "launches_by_shape": {"x".join(map(str, k)): v for k, v in
                                         pa.packed_flash_attention.launches_by_shape.items()}}

    # the API: sd-turbo's weights split over a 1x2 (data x fsdp) mesh of one card
    step, args = build_main_path(device="cuda", seed=0)
    mesh = make_mesh(n_data=1, n_fsdp=2, devices=["cuda:0", "cuda:0"])
    params = args["diffusion_params"]
    sharded = shard_params_tp(params, mesh)
    out["column_sharded_layers"] = sum(isinstance(m, ColumnSharded)
                                       for mod in sharded.values() for m in mod.modules())
    pipe = step.pipe
    embeds = args["prompt_embeds"]
    state = pipe.scheduler.set_timesteps(5)
    # the same models in f32 (library attention: the kernels take bf16)
    f32 = {k: copy.deepcopy(params[k]).float() for k in ("unet", "controlnet")}
    for m in f32.values():
        set_attention_backend(m, "xla")
    with torch.inference_mode():
        x = args["latents"].permute(0, 3, 1, 2) * float(state.init_noise_sigma)
        x = pipe.scheduler.scale_model_input(state, x.contiguous(), 0).to(pipe.dtype)
        t = torch.full((1,), float(state.timesteps[0]), device="cuda")
        cond = args["tiled_u8"].permute(0, 3, 1, 2).to(pipe.dtype).contiguous() / 255.0
        eps = {}
        for name, models in (("whole", params), ("tp", sharded)):
            down, mid = models["controlnet"](x, t, embeds, cond, cond_is_embedded=False)
            eps[name] = models["unet"](x, t, embeds, down, mid).float()
        down, mid = f32["controlnet"](x.float(), t, embeds.float(), cond.float(),
                                      cond_is_embedded=False)
        eps["f32"] = f32["unet"](x.float(), t, embeds.float(), down, mid)
        del f32, down, mid

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    rel_max = ((eps["tp"] - eps["whole"]).abs().max() / eps["whole"].abs().max()).item()
    out.update(tp_eps_rel_norm_diff=rel(eps["tp"], eps["whole"]), tp_eps_rel_max_err=rel_max,
               tp_eps_rel_norm_diff_vs_f32=rel(eps["tp"], eps["f32"]),
               whole_eps_rel_norm_diff_vs_f32=rel(eps["whole"], eps["f32"]))
    if not (torch.isfinite(eps["tp"]).all() and rel_max <= EPS_REL_TOL
            and out["tp_eps_rel_norm_diff_vs_f32"]
            <= TP_F32_RATIO * out["whole_eps_rel_norm_diff_vs_f32"]):
        raise AssertionError(f"TP noise prediction: {json.dumps(out)}")
    del sharded, eps

    tp_step = BatchedGenimaStep(step.diffusion_agent, step.controller, step.obs_size, mesh=mesh)
    timings, outs = {}, {}
    try:
        # the whole models first, then the TP step with the counts zeroed just before
        for name, fn in (("whole", step), ("tp", tp_step)):
            pa.packed_flash_attention.launches = 0
            pa.packed_flash_attention.launches_by_shape.clear()
            timings[name] = []
            for _ in range(TP_STEPS):
                before = pa.packed_flash_attention.launches
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                actions, target = fn(**args)
                torch.cuda.synchronize()
                timings[name].append((time.perf_counter() - h0) * 1e3)
                n = pa.packed_flash_attention.launches - before
                if n != LAUNCHES_PER_STEP:
                    raise AssertionError(f"{name} control step launched B1 {n} times")
                if actions.shape != (1, 20, 8) or not torch.isfinite(actions.float()).all():
                    raise AssertionError(f"{name} actions {tuple(actions.shape)}")
                if target.shape != (1, 512, 512, 3) or target.dtype != torch.uint8:
                    raise AssertionError(f"{name} target {tuple(target.shape)} {target.dtype}")
            outs[name] = (actions.float().cpu(), target.cpu())
    finally:
        tp_step.close()
    out["tp_step_ms"], out["whole_step_ms"] = timings["tp"], timings["whole"]
    out["tp_launches_by_shape"] = {
        "x".join(map(str, k)): v for k, v in pa.packed_flash_attention.launches_by_shape.items()}
    out["tp_vs_whole_actions_max_abs"] = (outs["tp"][0] - outs["whole"][0]).abs().max().item()
    out["tp_vs_whole_target_max_levels"] = (
        outs["tp"][1].int() - outs["whole"][1].int()).abs().max().item()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def distributed_phase(pa, card: str, written: dict) -> dict:
    """Phase 14: (a) 2 gloo ranks fine-tune data-parallel on one card, held
    to one process on the concatenated batch; (b) one NCCL rank; (c) 2
    gloo ranks of ACT training; (d) mesh serving."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_rendered_dataset(root / "data")
        t0 = time.perf_counter()
        _spawn([(_dp_finetune_rank, (r, DP_WORLD, "gloo", str(root / "rdv_a"), str(root / "data"),
                                     tmp, DP_STEPS, True)) for r in range(DP_WORLD)])
        out["a_s"] = time.perf_counter() - t0
        recs = [json.loads((root / f"gloo_rank{r}.json").read_text()) for r in range(DP_WORLD)]
        _dp_checks(recs, DP_STEPS)
        ref = recs[0]
        if not ref["draws_equal_global_rows"]:
            raise AssertionError("dp: rank 0's draws are not the global draws' first rows")
        same = ref["update_rel_norm_diff_vs_one_process_on_the_same_gradients"]
        if not (ref["grad_rel_norm_diff_vs_one_process"] <= DP_REL_TOL
                and same <= DP_UPDATE_REL_TOL):
            raise AssertionError(
                f"dp: step 1 vs one process: gradients rel norm diff "
                f"{ref['grad_rel_norm_diff_vs_one_process']}, update on the same gradients "
                f"{same} (against the batch-4 step's update "
                f"{ref['update_rel_norm_diff_vs_one_process']})")
        run = root / "run"
        names = sorted(p.name for p in run.iterdir())
        lines = (run / "logs" / "metrics.jsonl").read_text().splitlines()
        if names != ["controlnet", "logs"] or len(lines) != 1:
            raise AssertionError(f"dp: rank 0 alone must write: {names}, {len(lines)} lines")
        out["a"] = recs

        t0 = time.perf_counter()
        _spawn([(_dp_finetune_rank, (0, 1, "nccl", str(root / "rdv_b"), str(root / "data"),
                                     str(root / "b"), 1, False))]
               + [(_act_dp_rank, (r, str(root / "rdv_c"), str(root / "act"), tmp))
                  for r in range(DP_WORLD)])
        out["bc_s"] = time.perf_counter() - t0
        nccl = json.loads((root / "b" / "nccl_rank0.json").read_text())
        _dp_checks([nccl], 1)
        if nccl["backend"] != "nccl":
            raise AssertionError(f"(b) ran on {nccl['backend']}")
        out["b"] = nccl
        act = [json.loads((root / f"act_rank{r}.json").read_text()) for r in range(DP_WORLD)]
        if (act[0]["checksums"] != act[1]["checksums"] or act[0]["updates"] != act[1]["updates"]
                or not act[0]["updates"] or any(a["update_failures"] or not a["mesh"] for a in act)):
            raise AssertionError(f"act dp: ranks {[(a['updates'], a['update_failures']) for a in act]}"
                                 " differ or failed")
        act_lines = (root / "act" / "metrics.jsonl").read_text().splitlines()
        if len(act_lines) != 1 or not (root / "act" / "latest.ckpt").exists():
            raise AssertionError(f"act dp: rank 0 alone must write ({len(act_lines)} lines)")
        loss = json.loads(act_lines[0])["train_act/loss"]
        if not math.isfinite(loss):
            raise AssertionError(f"act dp: loss {loss}")
        out["c"] = {"ranks": act, "loss": loss}
    torch.cuda.reset_peak_memory_stats()
    out["d"] = _mesh_serving(pa, written)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 15: SD-1.5's geometry (head dims 40/80/160) and the SD path at 768x768
# ---------------------------------------------------------------------------

def _sd_finetune(pa, root: Path, resolution: int, want: dict, pipe_factory=None,
                 grad_check: bool = False, precision: str = "bf16",
                 steps: int = SD15_TRAIN_STEPS, grad_tol: float = TRAIN_GRAD_REL_TOL) -> dict:
    """``run_training(args, "sd", pipe=)`` for ``steps`` steps at the
    trainer CLI's batch 4, ``--resolution`` and ``--mixed_precision
    precision``, the pipeline ``pipe_factory(args)`` (else
    ``driver.build_pipeline``): launches pinned at ``want`` a step, finite
    losses, the frozen models bit-unchanged, the ControlNet moving; with
    ``grad_check`` one step's ControlNet gradients against the library
    attention (as phase 12), held to ``grad_tol``."""
    from genima_torch.cli.train_controlnet_genima import parse_args
    from genima_torch.data.dataset import to_device
    from genima_torch.data.tokenizer import HashTokenizer
    from genima_torch.diffusion import driver
    from genima_torch.diffusion.training import ControlNetTrainer, TrainState
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from genima_torch.nn.layers import set_attention_backend

    write_rendered_dataset(root / "data", size=resolution)
    args = parse_args([
        "--data_path", str(root / "data"), "--tasks", "toy_task",
        "--resolution", str(resolution), "--train_batch_size", str(TRAIN_BATCH),
        "--max_train_steps", str(steps), "--seed", "0", "--device", "cuda",
        "--mixed_precision", precision, "--enable_xformers_memory_efficient_attention",
        "--dataloader_num_workers", "4", "--output_dir", str(root / "out"),
        "--report_to", "none",
    ])
    torch.cuda.empty_cache()
    t0 = time.time()
    pipe = pipe_factory(args) if pipe_factory else driver.build_pipeline(args)
    params = driver.init_model_params(pipe, args)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    frozen = {name: {k: t.clone() for k, t in params[name].state_dict().items()}
              for name in ("unet", "vae", "text_encoder")}
    cn_init = {k: p.detach().float().clone() for k, p in params["controlnet"].named_parameters()}
    records, last = [], {}

    def hook(step, state, metrics):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), _ft_counts(pa)
        records.append({"ms": (now - last["mark"]) * 1e3, "loss": float(metrics["loss"]),
                      "launches": {k: counts[k] - last["counts"][k] for k in counts}})
        last["mark"], last["counts"] = now, counts
        if step == steps:
            last["moved"] = max((state.params[k] - v).abs().max().item()
                                for k, v in cn_init.items())

    _ft_zero(pa)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    last["mark"], last["counts"] = time.perf_counter(), _ft_counts(pa)
    result = driver.run_training(args, "sd", pipe=pipe, params=params, step_hook=hook)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches_by_shape = {
        k: {"x".join(map(str, sh)): n for sh, n in fn.launches_by_shape.items()}
        for k, fn in (("B1", pa.packed_flash_attention),
                      ("B2a", pa.packed_attention_forward_lse),
                      ("B2b", pa.packed_attention_backward))}
    tag = f"fine-tune at {resolution} ({precision})"
    if result["global_step"] != steps or len(records) != steps:
        raise AssertionError(f"{tag} took {result['global_step']} steps")
    for i, st in enumerate(records):
        if st["launches"] != want:
            raise AssertionError(f"{tag} step {i + 1} launches {st['launches']}, want {want}")
        if not math.isfinite(st["loss"]):
            raise AssertionError(f"{tag} step {i + 1} loss {st['loss']}")
    for name, before in frozen.items():
        after = params[name].state_dict()
        changed = [k for k, t in before.items() if not torch.equal(t, after[k])]
        if changed:
            raise AssertionError(f"{tag}: frozen {name} changed: {changed[:3]}")
    if not last["moved"] > 0:
        raise AssertionError(f"{tag}: the ControlNet did not move")
    del frozen, cn_init
    out = {"setup_s": setup_s, "step_ms": [st["ms"] for st in records],
           "losses": [st["loss"] for st in records],
           "launches_per_step": [st["launches"] for st in records],
           "launches_by_shape": launches_by_shape, "controlnet_max_move": last["moved"],
           "peak_mem_gb": peak_gb}
    if grad_check:
        trainer = ControlNetTrainer(pipe, driver.train_config(args, steps))
        state = trainer.create_state(params)
        state = TrainState(state.params, None, 0)
        batch = to_device(next(iter(driver.make_train_dataset(args, HashTokenizer()))),
                          pipe.device)
        draws = trainer.sample_draws(TRAIN_BATCH, resolution,
                                     torch.Generator(device="cuda").manual_seed(7))
        grads = {}
        for run, backend, sdpa in (("fused", "fused", None), ("xla", "xla", None),
                                   ("xla_efficient", "xla", SDPBackend.EFFICIENT_ATTENTION)):
            for name in ("unet", "controlnet"):
                set_attention_backend(params[name], backend)
            with sdpa_kernel(sdpa) if sdpa is not None else contextlib.nullcontext():
                grads[run] = _to_host(trainer.gradients(state, batch, draws)[1])
        for name in ("unet", "controlnet"):
            set_attention_backend(params[name], "fused")
        report = _grad_report(grads["fused"], grads["xla"], grads["xla_efficient"])
        if not (report["global_rel"] <= grad_tol and report["attn_rel_floored"] <= grad_tol):
            raise AssertionError(f"{tag} ControlNet grads kernels vs library: "
                                 f"{json.dumps(report)}")
        out.update(grad_rel_norm_diff_vs_library_attention=report["global_rel"],
                   grad_attn_proj_rel_floored=report["attn_rel_floored"],
                   grad_library_backends_rel_norm_diff=report["lib_global_rel"])
    return out


def head_dims_phase(pa, card: str) -> tuple[dict, dict]:
    """Phase 15: B1/B2a/B2b/B3 at SD-1.5's head dims and B1/B2a/B2b at the
    768x768 levels against their plain versions, then (a) SD-1.5 serving
    with its opt-in step, (b) the SD-1.5 fine-tune, (c) the SD fine-tune at
    768x768 and (d) one control step at 768x768. Returns the paths' results
    and the kernel rows by path."""
    t_phase = time.time()
    rows = {
        "sd15_control": kernel_phase(pa, SD15_LEVELS, seed=6),
        "sd15_train": training_kernel_phase(pa, SD15_TRAIN_LEVELS, seed=7),
        "sd15_opt_in": opt_kernel_phase(SD15_FLASH_SHAPES, [], [], seed=8),
        "sd768_control": kernel_phase(pa, SD768_LEVELS, seed=9),
        "sd768_train": training_kernel_phase(pa, SD768_TRAIN_LEVELS, seed=10),
    }
    kernel_s = time.time() - t_phase
    torch.cuda.empty_cache()
    out = {"card": card, "kernel_checks_s": kernel_s}
    out["sd15_serve"] = _sd_serve(pa, "sd15", 512, SD15_STEPS, LAUNCHES_PER_STEP, opt_in=True)
    with tempfile.TemporaryDirectory() as tmp:
        from genima_torch.eval.main_path import sd15_pipeline

        out["sd15_train"] = _sd_finetune(
            pa, Path(tmp) / "sd15", 512, TRAIN_LAUNCHES, grad_check=True,
            pipe_factory=lambda args: sd15_pipeline(
                dtype=torch.bfloat16, backend="fused", device=args.device, vae_encoder=True))
        out["sd768_train"] = _sd_finetune(pa, Path(tmp) / "sd768", RES_768,
                                          SD768_TRAIN_LAUNCHES)
    out["sd768_serve"] = _sd_serve(pa, "sd", RES_768, SD768_STEPS, SD768_LAUNCHES_PER_STEP,
                                   opt_in=False)
    _fill_launches(rows["sd15_control"], {"B1": out["sd15_serve"]["launches_by_shape"]})
    _fill_launches(rows["sd15_opt_in"], {"B3": out["sd15_serve"]["opt_in"]["launches_by_shape"]})
    _fill_launches(rows["sd768_control"], {"B1": out["sd768_serve"]["launches_by_shape"]})
    for name, run in (("sd15_train", "sd15_train"), ("sd768_train", "sd768_train")):
        _fill_launches(rows[name], out[run]["launches_by_shape"])
    for name, rs in rows.items():
        for r in rs:
            r["path"] = f"{name} (phase 15)"
    out["phase_s"] = time.time() - t_phase
    return out, rows



# ---------------------------------------------------------------------------
# phase 16: the opt-in backends on every geometry the JAX package builds,
# InstructPix2Pix at SD-1.5 geometry, and the attention kernels at any head dim
# ---------------------------------------------------------------------------

# B1/B2a/B2b/B3 at head dims that are not a multiple of 8 (36: zero-padded to
# 40; 40 beside it gives the pad's cost), of three atoms past 160 (168) and
# of four (200, 256), 8 heads, at ragged lengths: B1 at batch 1 x 4096, B2a
# and B2b at batch 4 x 1024, B3 over 1000 queries, self and cross
SWEEP_HEAD_DIMS = [36, 40, 100, 168, 200, 256]
SWEEP_HEADS = 8
# per control step (5 denoise steps); B1 none under the opt-in backends
# SD-1.5 under "pallas+w8": 46 attentions a denoise step as SD's; 10 int8
# linears a transformer block, not 12: proj_in / proj_out are 1x1 convs
# (use_linear_projection=False), float as in JAX; x 23 blocks x 5 = 1150
SD15_W8_LAUNCHES = {"B1": 0, "B3": 230, "B4": 25, "B5": 1150}
# SD at 768x768 under "pallas+w8": SD's counts at 96x96 latents
SD768_W8_LAUNCHES = {"B1": 0, "B3": 230, "B4": 25, "B5": 1380}
# SDXL: 104 transformer blocks a denoise step (UNet 70, ControlNet 34), self
# and cross attention each; under "+w8" 10 int8 linears a block and 2 linear
# projections for each of the 16 Transformer2D models: 1072 a denoise step
SDXL_PALLAS_LAUNCHES = {"B1": 0, "B3": 1040, "B4": 0, "B5": 0}
SDXL_W8_LAUNCHES = {"B1": 0, "B3": 1040, "B4": 25, "B5": 5360}
# InstructPix2Pix at SD-1.5 geometry: phase 13's counts less SD-1.5's two
# float projections a block under "+w8" (16 blocks x 10 x 5 = 800)
PIX2PIX15_LAUNCHES = {"B1": PIX2PIX_LAUNCHES_PER_STEP, "B3": 0, "B4": 0, "B5": 0}
PIX2PIX15_OPT_LAUNCHES = {"B1": 0, "B3": 160, "B4": 25, "B5": 800}
PIX2PIX15_TRAIN_STEPS = 2  # the first carries the warm-up
# the new kernel shapes: SD at 768x768 (96x96 latents: 9216/2304/576/144
# tokens, 144 a ragged tile; the decoder from 96^2 to 768^2), and the
# cross-attention K/V projections of SD-1.5's CLIP-L (K = 768) and SDXL's
# two towers side by side (K = 2048)
SD768_OPT_LEVELS = [(9216, 320, 5), (2304, 640, 10), (576, 1280, 20), (144, 1280, 20)]
SD768_FLASH_SHAPES = [(1, s, s, c, h) for s, c, h in SD768_OPT_LEVELS] + [
    (1, s, CONTEXT[0], c, h) for s, c, h in SD768_OPT_LEVELS]
SD768_CONV_SHAPES = [
    (1, 96, 96, 512, 512), (1, 192, 192, 512, 512), (1, 384, 384, 512, 256),
    (1, 384, 384, 256, 256), (1, 768, 768, 256, 128), (1, 768, 768, 128, 128),
    (1, 768, 768, 128, 3),
]
SD768_W8_SHAPES = sorted(
    {(m, k, n) for m, c, _ in SD768_OPT_LEVELS for k, n in ((c, c), (c, 8 * c), (4 * c, c))}
    | {(CONTEXT[0], CONTEXT[1], c) for _, c, _ in SD768_OPT_LEVELS})
CROSS_W8_SHAPES = [(CONTEXT[0], k, c) for k in (768, 2048) for c in (320, 640, 1280)
                   if k == 768 or c != 320]


def head_dim_sweep(pa) -> list[dict]:
    """B1, B2a, B2b and B3 at ``SWEEP_HEAD_DIMS`` against their plain
    versions (the limits of phases 2 and 4), timed beside their bound and
    SDPA. No path runs these head dims: the rows are printed apart from the
    kernels line."""
    rows = []
    for i, d in enumerate(SWEEP_HEAD_DIMS):
        c = SWEEP_HEADS * d
        new = (kernel_phase(pa, [(1, 4096, c, SWEEP_HEADS)], seed=20 + i)
               + training_kernel_phase(pa, [(TRAIN_BATCH, 1024, c, SWEEP_HEADS)], seed=30 + i)
               + opt_kernel_phase([(1, 1000, 1000, c, SWEEP_HEADS),
                                   (1, 1000, CONTEXT[0], c, SWEEP_HEADS)], [], [], seed=40 + i))
        for r in new:
            r["head_dim"] = d
            r["path"] = "none (head-dim sweep)"
            del r["key"]
        rows += new
        torch.cuda.empty_cache()
    return rows


def _pix2pix15_train(pa, root: Path) -> dict:
    """``run_training(args, "pix2pix", pipe=pix2pix15_pipeline(...))`` with
    the pix2pix trainer CLI's defaults (batch 4, 512x512), ``--use_ema
    --conditioning_dropout_prob 0.05``, ``PIX2PIX15_TRAIN_STEPS`` steps:
    launches pinned as phase 13's, finite losses, the UNet moving, the EMA
    trailing it, the VAE and CLIP bit-unchanged; the final save written."""
    from genima_torch.cli.train_instruct_pix2pix_genima import parse_args
    from genima_torch.diffusion import driver
    from genima_torch.eval.main_path import pix2pix15_pipeline

    write_rendered_dataset(root / "data")
    args = parse_args([
        "--data_path", str(root / "data"), "--tasks", "toy_task", "--seed", "0",
        "--device", "cuda", "--enable_xformers_memory_efficient_attention",
        "--dataloader_num_workers", "4", "--output_dir", str(root / "out"),
        "--report_to", "none", "--use_ema", "--conditioning_dropout_prob", "0.05",
        "--max_train_steps", str(PIX2PIX15_TRAIN_STEPS), "--checkpointing_steps", "0",
        "--validation_steps", "0"])
    if (args.train_batch_size, args.resolution) != (TRAIN_BATCH, 512):
        raise AssertionError("the pix2pix parser's defaults moved")
    torch.cuda.empty_cache()
    t0 = time.time()
    pipe = pix2pix15_pipeline(dtype=torch.bfloat16, backend="fused", device=args.device,
                              vae_encoder=True)
    params = driver.init_model_params(pipe, args)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    frozen = {name: _to_host(params[name]) for name in ("vae", "text_encoder")}
    unet_init = _to_host(params["unet"])
    steps, last = [], {}

    def hook(step, state, metrics):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), _ft_counts(pa)
        steps.append({"ms": (now - last["mark"]) * 1e3, "loss": float(metrics["loss"]),
                      "launches": {k: counts[k] - last["counts"][k] for k in counts}})
        last["mark"], last["counts"] = now, counts
        if step == PIX2PIX15_TRAIN_STEPS:
            last["ema"], last["master"] = _to_host(state.ema), _to_host(state.params)

    _ft_zero(pa)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    last["mark"], last["counts"] = time.perf_counter(), _ft_counts(pa)
    result = driver.run_training(args, "pix2pix", pipe=pipe, params=params, step_hook=hook)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches_by_shape = {
        k: {"x".join(map(str, sh)): n for sh, n in fn.launches_by_shape.items()}
        for k, fn in (("B1", pa.packed_flash_attention), ("B2a", pa.packed_attention_forward_lse),
                      ("B2b", pa.packed_attention_backward))}
    if result["global_step"] != PIX2PIX15_TRAIN_STEPS or len(steps) != PIX2PIX15_TRAIN_STEPS:
        raise AssertionError(f"pix2pix15 fine-tune took {result['global_step']} steps")
    for i, st in enumerate(steps):
        if st["launches"] != PIX2PIX_TRAIN_LAUNCHES or not math.isfinite(st["loss"]):
            raise AssertionError(f"pix2pix15 train step {i + 1}: launches {st['launches']}, "
                                 f"want {PIX2PIX_TRAIN_LAUNCHES}; loss {st['loss']}")
    for name, before in frozen.items():
        after = params[name].state_dict()
        changed = [k for k, t in before.items() if not torch.equal(t.to("cuda"), after[k])]
        if changed:
            raise AssertionError(f"pix2pix15 frozen {name} changed: {changed[:3]}")
    moved = max((last["master"][k] - v.float()).abs().max().item() for k, v in unet_init.items())
    lag = max((last["ema"][k] - last["master"][k]).abs().max().item() for k in last["ema"])
    if not (moved > 0 and lag > 0):
        raise AssertionError(f"pix2pix15: the UNet moved {moved}, the EMA trails by {lag}")
    final = root / "out" / "unet" / "params.msgpack"
    if not final.is_file():
        raise AssertionError("pix2pix15: no final save")
    del frozen, unet_init, last, params, pipe
    torch.cuda.empty_cache()
    return {"setup_s": setup_s, "step_ms": [st["ms"] for st in steps],
            "steady_step_ms": [st["ms"] for st in steps[1:]],
            "losses": [st["loss"] for st in steps],
            "launches_per_step": [st["launches"] for st in steps],
            "launches_by_shape": launches_by_shape, "unet_max_move": moved, "ema_lag": lag,
            "final_save_bytes": final.stat().st_size, "peak_mem_gb": peak_gb}


def _path_rows(pool, launches_by_shape: dict, path: str) -> list[dict]:
    """Copies of the rows of ``pool`` at the shapes the path launched their
    kernel at, each with the path's launches; fails if the path launched a
    kernel at a shape no row of ``pool`` measures."""
    rows, seen = [], set()
    for r in pool:
        kernel = COUNTERS[r["name"]]
        n = launches_by_shape.get(kernel, {}).get(r["key"], 0)
        if n and (kernel, r["key"]) not in seen:
            seen.add((kernel, r["key"]))
            rows.append(dict(r, path=path, launches=n))
    missing = [(k, key) for k, by_shape in launches_by_shape.items() for key, n in by_shape.items()
               if n and (k, key) not in seen]
    if missing:
        raise AssertionError(f"{path}: no kernel row measures {missing}")
    return rows


def opt_geometries_phase(pa, card: str, pools: dict) -> tuple[dict, dict, list]:
    """Phase 16: the attention kernels at any head dim, the new opt-in
    kernel shapes against their plain versions, then the paths: (a)
    InstructPix2Pix at SD-1.5 geometry served on the default backend and
    under ``pallas+w8`` / fused, and trained with EMA; (b) SD-1.5 and (c) SD
    at 768x768 under ``pallas+w8`` / fused; (d) SDXL-turbo under ``pallas``
    and (e) under ``pallas+w8`` / fused. ``pools``: the kernel rows of the
    earlier phases the paths share shapes with ("sd_opt": phase 4's,
    "sd15_*": phase 15's). Returns the paths, the kernel rows by path and
    the head-dim sweep's rows."""
    t_phase = time.time()
    sweep = head_dim_sweep(pa)
    measured = opt_kernel_phase(SD768_FLASH_SHAPES, SD768_CONV_SHAPES, SD768_W8_SHAPES, seed=50)
    cross = opt_kernel_phase([], [], CROSS_W8_SHAPES, seed=51)
    out = {"card": card, "kernel_checks_s": time.time() - t_phase}
    torch.cuda.empty_cache()
    runs = {
        "pix2pix15_serve": ("pix2pix15", 512, "fused", "xla", PIX2PIX15_LAUNCHES),
        "pix2pix15_opt_in": ("pix2pix15", 512, OPT_BACKEND, OPT_CONV_BACKEND,
                             PIX2PIX15_OPT_LAUNCHES),
        "sd15_opt_in_w8": ("sd15", 512, OPT_BACKEND, OPT_CONV_BACKEND, SD15_W8_LAUNCHES),
        "sd768_opt_in_w8": ("sd", RES_768, OPT_BACKEND, OPT_CONV_BACKEND, SD768_W8_LAUNCHES),
        "sdxl_pallas": ("sdxl", 512, "pallas", "xla", SDXL_PALLAS_LAUNCHES),
        "sdxl_opt_in_w8": ("sdxl", 512, OPT_BACKEND, OPT_CONV_BACKEND, SDXL_W8_LAUNCHES),
    }
    for name, run in runs.items():
        t0 = time.time()
        out[name] = _serve(*run)
        out[name]["s"] = time.time() - t0
        if name == "pix2pix15_serve":
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.time()
                out["pix2pix15_train"] = _pix2pix15_train(pa, Path(tmp))
                out["pix2pix15_train"]["s"] = time.time() - t0
    b3_b4_b5 = ("flash_attention", "fused_conv3x3", "w8_matmul")
    sd_b4_b5 = [r for r in pools["sd_opt"] if r["name"] in b3_b4_b5[1:]]
    sd15_opt = pools["sd15_opt_in"] + sd_b4_b5 + cross
    pool_of = {
        "pix2pix15_serve": pools["sd15_control"],
        "pix2pix15_train": pools["sd15_train"],
        "pix2pix15_opt_in": sd15_opt,
        "sd15_opt_in_w8": sd15_opt,
        "sd768_opt_in_w8": measured,
        "sdxl_pallas": pools["sd_opt"],
        "sdxl_opt_in_w8": pools["sd_opt"] + cross,
    }
    rows = {name: _path_rows(pool, out[name]["launches_by_shape"], f"{name} (phase 16)")
            for name, pool in pool_of.items()}
    out["phase_s"] = time.time() - t_phase
    return out, rows, sweep


# ---------------------------------------------------------------------------
# phase 17: float32 through every kernel (--mixed_precision no, f32 serving)
# ---------------------------------------------------------------------------

# the f32 kernels split each f32 product into three TF32 ones on the tensor
# cores (3xTF32: 495 TFLOP/s dense for TF32, a third for f32): the attention
# kernels (B1, B2a, B2b, B3) and B4's; B5's f32-x kernel multiplies bf16 x
# int8 on the bf16 tensor cores (PEAK_BF16_FLOPS). Every f32 row keeps the
# FFMA bound (H100 SXM FP32, 67 TFLOP/s) as ``ffma_bound_ms``.
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
# f32 kernels against their f32 plain versions: attention's max abs err at
# unit-scale inputs and L's; B2b's and B4's max err over max |grad| or |y|
F32_TOL = 1e-4
# B5 keeps the TPU body's bf16 product: as phase 4's, error / max |y|
F32_W8_REL_TOL = W8_REL_TOL
F32_EPS_REL_TOL = 1e-3  # a full-width f32 noise prediction against the library path's
F32_GRAD_REL_TOL = 1e-3  # step 1's ControlNet gradients against the library attention's
F32_SERVE_LAUNCHES = {"B1": LAUNCHES_PER_STEP, "B3": 0, "B4": 0, "B5": 0}
F32_SERVE_STEPS = 2
F32_TRAIN_STEPS = 2
F32_SWEEP_DIMS = (1, 36, 64, 100, 160, 200, 256)
F32_SOURCES = {"B1": "genima_torch/csrc/attention_f32_hopper.cuh",
               "B2b": "genima_torch/csrc/packed_attention_bwd.cu",
               "B4": "genima_torch/csrc/fused_conv.cu", "B5": "genima_torch/csrc/w8_matmul.cu"}


def _f32_bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """``_bound`` against an f32 kernel's peak, FFMA's unless given."""
    ops_s, bytes_s = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s > bytes_s else "bytes"


def _f32_attn_bounds(flops: float, nbytes: float) -> dict:
    """An f32 attention row's bound at 3xTF32's peak, FFMA's beside it."""
    bound_ms, bound_by = _f32_bound(flops, nbytes, PEAK_3XTF32_FLOPS)
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "ffma_bound_ms": _f32_bound(flops, nbytes)[0]}


def _f32_fwd_plan(plan) -> dict:
    return {"query_rows": plan.rows, "consumer_warpgroups": plan.nwg, "key_tile": plan.bn,
            "stages": plan.stages, "threads": plan.threads, "blocks": plan.blocks,
            "head_atoms": plan.atoms, "column_chunks": plan.chunks, "cluster": plan.cluster}


def _f32_kernel_key(plan, with_lse: bool) -> str:
    """``ptxas_report``'s key of the f32 forward a plan launches."""
    from genima_torch.kernels import flash_attention as fa

    lse = int(with_lse)
    if plan.cluster > 1:
        return f"f32_cluster_{lse}"
    if plan.chunks > 1:
        return f"f32_wide_{fa.wide_chunking(plan.atoms)[1]}x{lse}"
    return f"f32_{plan.atoms}x{plan.nwg}x{plan.bn}x{lse}"


def f32_attention_rows(pa, levels, seed: int, train: bool, iters: int = 5) -> list[dict]:
    """B1 (with ``train`` also B2a and B2b) on seeded f32 (B, S, C) inputs
    at ``levels`` against their plain versions at ``F32_TOL``; B2a's output
    must be B1's bit for bit and two B2b calls must give the same bits.
    Bounds at 3xTF32's peak (``ffma_bound_ms``: FFMA's)."""
    import torch.nn.functional as F

    from genima_torch.kernels import _build
    from genima_torch.kernels import flash_attention as fa

    regs = ptxas_report(_build.build_log("packed_attention"))
    bregs = ptxas_report(_build.build_log("packed_attention_bwd"))
    lib, blib = pa._library(), pa._bwd_library()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for b, s, c, h in levels:
        d = c // h
        dp = fa.f32_padded_head_dim(d)
        q, k, v, do = (torch.randn(b, s, c, generator=gen, device="cuda") for _ in range(4))
        tag = f"f32 {b}x{s}x{c}/{h}"
        plan = pa._plan_for(b, s, s, h, d, dtype=torch.float32)
        if lib.packed_attention_f32_smem_bytes(plan.nwg, plan.bn, plan.stages, dp) != plan.smem_bytes:
            raise AssertionError(f"{tag}: f32 plan's shared memory {plan.smem_bytes} != the kernel's")
        o1 = pa.packed_flash_attention(q, k, v, h)
        o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
        torch.cuda.synchronize()
        err = (o1 - o_ref).abs().max().item()
        if not (o1.dtype == torch.float32 and err <= F32_TOL):
            raise AssertionError(f"B1 {tag}: {o1.dtype}, max abs err {err}")
        heads = [x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v)]
        common = {"route": "cuda", "dtype": "float32", "source": F32_SOURCES["B1"],
                  "shape": f"{b}x{s}x{c}/{h}", "key": f"{b}x{s}x{s}x{c}", "launches": None,
                  "plan": _f32_fwd_plan(plan), "smem_bytes": plan.smem_bytes}
        rows.append({"name": "packed_flash_attention",
                     "replaces": "genima_tpu/kernels/packed_attention.py:194", **common,
                     "max_abs_err": err,
                     "ms": cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), iters),
                     "plain_ms": cuda_ms(lambda: pa.packed_attention_reference(q, k, v, h), 2),
                     "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), iters),
                     **_f32_attn_bounds(4 * b * s * s * c, 4 * 4 * b * s * c),
                     **regs.get(_f32_kernel_key(plan, False), {})})
        if not train:
            continue
        o, lse = pa.packed_attention_forward_lse(q, k, v, h)
        torch.cuda.synchronize()
        o_err, lse_err = (o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item()
        if not (o_err <= F32_TOL and lse_err <= F32_TOL and torch.equal(o, o1)):
            raise AssertionError(f"B2a {tag}: o err {o_err}, L err {lse_err}, "
                                 f"o == B1's {torch.equal(o, o1)}")
        rows.append({"name": "packed_attention_forward_lse",
                     "replaces": "genima_tpu/kernels/packed_attention.py:274", **common,
                     "max_abs_err": max(o_err, lse_err), "o_abs_err": o_err,
                     "lse_abs_err": lse_err,
                     "ms": cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), iters),
                     "plain_ms": cuda_ms(lambda: pa.packed_attention_lse_reference(q, k, v, h), 2),
                     "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), iters),
                     **_f32_attn_bounds(4 * b * s * s * c, 4 * 4 * b * s * c + 4 * b * s * h),
                     **regs.get(_f32_kernel_key(plan, True), {})})
        got = pa.packed_attention_backward(q, k, v, o, lse, do, h)
        again = pa.packed_attention_backward(q, k, v, o, lse, do, h)
        want = pa.packed_attention_backward_reference(q, k, v, o, lse, do, h)
        torch.cuda.synchronize()
        rel = max(_rel_err(x, y) for x, y in zip(got, want))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if not (rel <= F32_TOL and same and got[0].dtype == torch.float32):
            raise AssertionError(f"B2b {tag}: max err {rel} of max |grad|, repeat equal {same}")
        bp = pa.backward_plan(b, s, s, h, d, dtype=torch.float32)
        wide = bp.atoms > fa.NARROW_ATOMS
        smem = [blib.packed_attention_bwd_f32_smem_bytes(x, dp) for x in (0, 1, 2)]
        if smem != [bp.dq_smem_bytes, bp.dkdv_smem_bytes, bp.dv_smem_bytes]:
            raise AssertionError(f"B2b {tag}: f32 plan's shared memory != the kernels' {smem}")
        leaves = [x.detach().requires_grad_() for x in heads]
        out = F.scaled_dot_product_attention(*leaves)
        go = do.view(b, s, h, d).transpose(1, 2)
        rows.append({
            "name": "packed_attention_backward",
            "replaces": "genima_tpu/kernels/packed_attention.py:380", **common,
            "source": F32_SOURCES["B2b"],
            "plan": {"kernels": "dq, then dV and dK" if wide else "dq, then dk/dv",
                     "rows_per_block": bp.rows,
                     "tile_rows": [bp.tile, bp.dkdv_tile], "stages": [bp.stages, bp.dkdv_stages],
                     "dkdv_passes": bp.passes, "threads": bp.threads, "head_atoms": bp.atoms,
                     "column_chunks": bp.chunks, "out_atoms_per_warpgroup": bp.out_atoms,
                     "tile_splits": [bp.splits, bp.dkdv_splits],
                     "blocks": [math.prod(bp.dq_grid), math.prod(bp.dkdv_grid)]},
            "smem_bytes": smem,
            "max_abs_err": max((x - y).abs().max().item() for x, y in zip(got, want)),
            "max_rel_err": rel,
            "ms": cuda_ms(lambda: pa.packed_attention_backward(q, k, v, o, lse, do, h), iters),
            "plain_ms": cuda_ms(
                lambda: pa.packed_attention_backward_reference(q, k, v, o, lse, do, h), 2),
            "library_ms": cuda_ms(
                lambda: torch.autograd.grad(out, leaves, go, retain_graph=True), iters),
            **_f32_attn_bounds(10 * b * s * s * c, 4 * 8 * b * s * c + 4 * b * s * h),
            **({"dq": bregs.get(f"f32_dq{bp.atoms}", {}),
                "dkdv": bregs.get(f"f32_dkdv{bp.atoms}", {})} if not wide else
               {name: bregs.get(key, {})
                for name, key in _wide_bwd_keys(bp.atoms, f32=True).items()}),
        })
        del out, leaves, got, again, want
    return rows


def f32_opt_rows(flash_shapes, conv_shapes, w8_shapes, seed: int, iters: int = 5) -> list[dict]:
    """B3, B4 and B5 on seeded f32 inputs at the opt-in path's shapes
    against their plain versions (B3 and B4 at ``F32_TOL``, B5 at
    ``F32_W8_REL_TOL`` and bit-equal over two calls), timed beside their
    bound and the library call in f32 (TF32 off). B3's and B4's bounds are
    3xTF32's and B5's the bf16 tensor cores', each row keeping FFMA's as
    ``ffma_bound_ms``."""
    import torch.nn.functional as F

    from genima_torch.kernels import _build
    from genima_torch.kernels import flash_attention as fa
    from genima_torch.kernels import fused_conv as fc
    from genima_torch.kernels import w8_matmul as w8

    regs = {name: ptxas_report(_build.build_log(name))
            for name in ("flash_attention", "fused_conv", "w8_matmul")}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for b, sq, sk, c, h in flash_shapes:
        d = c // h
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda") for s in (sq, sk, sk))
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not (got.dtype == torch.float32 and err <= F32_TOL):
            raise AssertionError(f"B3 f32 {b}x{sq}x{sk}x{c}/{h}: {got.dtype}, max abs err {err}")
        plan = fa._plan_for(b, sq, sk, h, d, dtype=torch.float32)
        smem = fa._library().flash_attention_f32_smem_bytes(plan.nwg, plan.bn, plan.stages,
                                                             fa.f32_padded_head_dim(d))
        if smem != plan.smem_bytes:
            raise AssertionError("B3 f32 plan's shared memory != the kernel's")
        heads = [t.transpose(1, 2) for t in (q, k, v)]
        rows.append({
            "name": "flash_attention", "route": "cuda", "dtype": "float32",
            "source": F32_SOURCES["B1"], "replaces": "genima_tpu/kernels/flash_attention.py:129",
            "shape": f"{b}x{sq}x{sk}x{c}/{h}", "key": f"{b}x{sq}x{sk}x{c}",
            "launches": None, "max_abs_err": err,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), iters),
            "plain_ms": cuda_ms(lambda: fa.flash_attention_reference(q, k, v), 2),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), iters),
            "library": "scaled_dot_product_attention forward in f32 on the same views",
            **_f32_attn_bounds(4 * b * sq * sk * c, 4 * b * (2 * sq + 2 * sk) * c),
            "plan": _f32_fwd_plan(plan), "smem_bytes": plan.smem_bytes,
            **regs["flash_attention"].get(_f32_kernel_key(plan, False), {}),
        })

    for b, hh, ww, c, o in conv_shapes:
        x = torch.randn(b, hh, ww, c, generator=gen, device="cuda")
        gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
        scale, shift = fc.fold_group_norm(x, gamma, beta, 32, 1e-6)
        wt = torch.randn(3, 3, c, o, generator=gen, device="cuda") / (3 * c ** 0.5)
        bias = torch.randn(o, generator=gen, device="cuda")
        res = torch.randn(b, hh, ww, o, generator=gen, device="cuda") if c == o else None
        args = (x, wt, bias, scale, shift, None, res)
        got = fc.fused_conv3x3(*args)
        want = fc.fused_conv3x3_reference(*args)
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        if not (got.dtype == torch.float32 and rel <= F32_TOL):
            raise AssertionError(f"B4 f32 {b}x{hh}x{ww}x{c}->{o}: max err {rel} of max |y|")
        plan = fc._plan_for(b, hh, ww, c, o, dtype=torch.float32)
        if fc._library().fused_conv3x3_f32_smem_bytes(plan.bn, plan.rows) != plan.smem_bytes:
            raise AssertionError("B4 f32 plan's shared memory != the kernel's")
        act = x * scale[:, None, None] + shift[:, None, None]
        act = (act * torch.sigmoid(act)).permute(0, 3, 1, 2)
        w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        nbytes = 4 * (b * hh * ww * (c + o + (o if res is not None else 0)) + 9 * c * o + o
                      + 2 * b * c)
        bound_ms, bound_by = _f32_bound(2 * b * hh * ww * o * 9 * c, nbytes, PEAK_3XTF32_FLOPS)
        rows.append({
            "name": "fused_conv3x3", "route": "cuda", "dtype": "float32",
            "source": F32_SOURCES["B4"], "replaces": "genima_tpu/kernels/fused_conv.py:380",
            "shape": f"{b}x{hh}x{ww}x{c}->{o}" + ("+res" if res is not None else ""),
            "key": f"{b}x{hh}x{ww}x{c}x{o}", "launches": None,
            "max_abs_err": (got - want).abs().max().item(), "max_rel_err": rel,
            "ms": cuda_ms(lambda: fc.fused_conv3x3(*args), iters),
            "plain_ms": cuda_ms(lambda: fc.fused_conv3x3_reference(*args), 2),
            "library_ms": cuda_ms(lambda: F.conv2d(act, w_cl, bias, padding=1), iters),
            "library": "cuDNN conv2d alone in f32 (TF32 off), channels_last, on the "
                       "pre-activated input (it skips the GN/SiLU prologue and the residual)",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ffma_bound_ms": _f32_bound(2 * b * hh * ww * o * 9 * c, nbytes)[0],
            "plan": {"tile": f"{plan.rows * 64} pixels x {plan.bn} channels",
                     "chunks": plan.chunks, "tiles": plan.n_tiles, "blocks": plan.blocks},
            "smem_bytes": plan.smem_bytes,
            **regs["fused_conv"].get(f"f32_{plan.bn}x{plan.rows}", {}),
        })

    for m, k, n in w8_shapes:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w_q, scale = w8.quantize_weight(torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5)
        got = w8.w8_matmul(x, w_q, scale)
        again = w8.w8_matmul(x, w_q, scale)
        want = w8.w8_matmul_reference(x, w_q, scale)
        torch.cuda.synchronize()
        rel = _rel_err(got, want)
        if not (got.dtype == torch.float32 and rel <= F32_W8_REL_TOL and torch.equal(got, again)):
            raise AssertionError(f"B5 f32 {m}x{k}x{n}: max err {rel} of max |y|, repeat equal "
                                 f"{torch.equal(got, again)}")
        plan = w8._plan_for(m, k, n, dtype=torch.float32)
        if w8._library().w8_matmul_f32_smem_bytes(plan.bt, plan.stages) != plan.smem_bytes:
            raise AssertionError("B5 f32 plan's shared memory != the kernel's")
        w_deq = (w_q.float() * scale[:, None]).t()
        nbytes = 4 * m * k + k * n + 4 * n + 4 * m * n
        bound_ms, bound_by = _f32_bound(2 * m * k * n, nbytes, PEAK_BF16_FLOPS)
        rows.append({
            "name": "w8_matmul", "route": "cuda", "dtype": "float32",
            "source": F32_SOURCES["B5"], "replaces": "genima_tpu/kernels/w8_matmul.py:94",
            "shape": f"{m}x{k}x{n}", "key": f"{m}x{k}x{n}", "launches": None,
            "max_abs_err": (got - want).abs().max().item(), "max_rel_err": rel,
            "ms": cuda_ms(lambda: w8.w8_matmul(x, w_q, scale), iters * 4),
            "plain_ms": cuda_ms(lambda: w8.w8_matmul_reference(x, w_q, scale), 3),
            "library_ms": cuda_ms(lambda: torch.matmul(x, w_deq), iters * 4),
            "library": "torch.matmul in f32 (TF32 off) on the pre-dequantised f32 weight",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ffma_bound_ms": _f32_bound(2 * m * k * n, nbytes)[0],
            "plan": {"tile": f"{plan.bt} tokens x {w8.BN} rows", "split": plan.split,
                     "stages": plan.stages, "blocks": plan.blocks},
            "smem_bytes": plan.smem_bytes, **regs["w8_matmul"].get(f"{plan.bt}x1", {}),
        })
    return rows


def f32_phase(pa, card: str) -> tuple[dict, dict, dict]:
    """Phase 17: every kernel family on f32 against its f32 plain version
    at the f32 paths' shapes, SD-1.5's, 768x768's and a head-dim sweep;
    then (a) f32 serving on the default backend (105 B1 a step) and (b)
    under ``pallas+w8`` / fused (230 B3 / 25 B4 / 1380 B5 / 0 B1), each
    noise prediction held to the library path's at ``F32_EPS_REL_TOL``;
    (c) the ``--mixed_precision no`` ControlNet fine-tune at batch 4,
    512x512 (6 B1 / 15 B2a / 15 B2b / 0 fallbacks a step), step 1's
    ControlNet gradients held to the library attention's at
    ``F32_GRAD_REL_TOL``. TF32 is off throughout (``main``). Returns the
    paths' results, the kernel rows by path and the shape checks no path
    runs."""
    t_phase = time.time()
    rows = {"f32_control": f32_attention_rows(pa, SD_LEVELS, seed=70, train=False),
            "f32_train": f32_attention_rows(pa, TRAIN_LEVELS, seed=71, train=True),
            "f32_opt_in": f32_opt_rows(FLASH_SHAPES, CONV_SHAPES, W8_SHAPES, seed=72)}
    checks = {
        "sd15_control": f32_attention_rows(pa, SD15_LEVELS, seed=73, train=False, iters=2),
        "sd15_train": f32_attention_rows(pa, SD15_TRAIN_LEVELS, seed=74, train=True, iters=2),
        "sd15_opt_in": f32_opt_rows(SD15_FLASH_SHAPES, [], [], seed=75, iters=2),
        "sd768_control": f32_attention_rows(pa, SD768_LEVELS, seed=76, train=False, iters=2),
        "sd768_train": f32_attention_rows(pa, SD768_TRAIN_LEVELS, seed=77, train=True, iters=2),
        "head_dim_sweep": [
            r for i, dd in enumerate(F32_SWEEP_DIMS)
            for r in f32_attention_rows(pa, [(2, 256, 8 * dd, 8)], seed=80 + i, train=True,
                                        iters=2)
            + f32_opt_rows([(1, 1000, 1000, 8 * dd, 8), (1, 1000, 77, 8 * dd, 8)], [], [],
                           seed=90 + i, iters=2)],
    }
    out = {"kernel_checks_s": time.time() - t_phase}
    t0 = time.time()
    out["serve"] = _serve("sd", 512, "fused", "xla", F32_SERVE_LAUNCHES, F32_SERVE_STEPS,
                          dtype=torch.float32, eps_tol=F32_EPS_REL_TOL)
    out["serve"]["s"] = time.time() - t0
    t0 = time.time()
    out["opt_in"] = _serve("sd", 512, OPT_BACKEND, OPT_CONV_BACKEND, OPT_LAUNCHES,
                           F32_SERVE_STEPS, dtype=torch.float32, eps_tol=F32_EPS_REL_TOL)
    out["opt_in"]["s"] = time.time() - t0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out["train"] = _sd_finetune(pa, Path(tmp), 512, TRAIN_LAUNCHES, grad_check=True,
                                    precision="no", steps=F32_TRAIN_STEPS,
                                    grad_tol=F32_GRAD_REL_TOL)
    out["train"]["s"] = time.time() - t0
    _fill_launches(rows["f32_control"], {"B1": out["serve"]["launches_by_shape"]["B1"]})
    _fill_launches(rows["f32_opt_in"], out["opt_in"]["launches_by_shape"])
    _fill_launches(rows["f32_train"], out["train"]["launches_by_shape"])
    out["phase_s"] = time.time() - t_phase
    return out, rows, checks


# ---------------------------------------------------------------------------
# phase 18: heads wider than 256 columns (the wide kernels) and B1 at every
# length the TPU kernel takes
# ---------------------------------------------------------------------------

# the wide-head SD path (sd-turbo's widths, num_heads (1, 1, 2, 2)): head
# dims 320 at 4096 tokens and 640 at 1024, 256 and 64; SD's lengths, so SD's
# launch pins
WIDE_LEVELS = [(1, 4096, 320, 1), (1, 1024, 640, 1), (1, 256, 1280, 2)]
WIDE_TRAIN_LEVELS = [(TRAIN_BATCH, s, c, h) for _, s, c, h in WIDE_LEVELS]
WIDE_OPT_LEVELS = [(4096, 320, 1), (1024, 640, 1), (256, 1280, 2), (64, 1280, 2)]
WIDE_FLASH_SHAPES = [(1, s, s, c, h) for s, c, h in WIDE_OPT_LEVELS] + [
    (1, s, CONTEXT[0], c, h) for s, c, h in WIDE_OPT_LEVELS]
WIDE_STEPS = 2  # control steps a path, the first carrying the warm-up
WIDE_TRAIN_STEPS = 2
# steps over which phase 18's rows count their launches, by path (else WIDE_STEPS)
WIDE_PATH_STEPS = {"wide_train": WIDE_TRAIN_STEPS, "wide_f32_train": WIDE_TRAIN_STEPS,
                   "wide_f32_control": F32_SERVE_STEPS}
# the sweep: B1 at 1 x 4096 in one head, B2a/B2b at 4 x 1024 and B3 over
# 1000 queries (self and over 77 keys) in 2-8 heads, bf16 and f32
WIDE_SWEEP_DIMS = (264, 320, 384, 512, 640, 1024)
# B1 and B2a at lengths off a multiple of 64, (Sq, Sk), at (d, heads)
RAGGED_LENGTHS = [(128, 77), (96, 4096), (77, 77), (256, 77)]
RAGGED_HEADS = [(64, 5), (320, 1)]
KV77_SHAPE = (1, 128, 77, 320, 5)  # (B, Sq, Sk, C, heads): the fallback's autograd call


def _sweep_heads(d: int) -> int:
    return max(2, min(8, 2048 // d))


def wide_sweep(pa, f32: bool) -> list[dict]:
    """B1, B2a, B2b and B3 at ``WIDE_SWEEP_DIMS`` against their plain
    versions (bf16: phases 2 and 4's limits; f32: phase 17's), timed beside
    their bound and SDPA. No path runs these shapes."""
    rows = []
    for i, d in enumerate(WIDE_SWEEP_DIMS):
        h = _sweep_heads(d)
        flash = [(1, 1000, 1000, h * d, h), (1, 1000, CONTEXT[0], h * d, h)]
        if f32:
            new = (f32_attention_rows(pa, [(1, 4096, d, 1)], seed=150 + i, train=False, iters=2)
                   + f32_attention_rows(pa, [(TRAIN_BATCH, 1024, h * d, h)], seed=160 + i,
                                        train=True, iters=2)
                   + f32_opt_rows(flash, [], [], seed=170 + i, iters=2))
        else:
            new = (kernel_phase(pa, [(1, 4096, d, 1)], seed=120 + i)
                   + training_kernel_phase(pa, [(TRAIN_BATCH, 1024, h * d, h)], seed=130 + i)
                   + opt_kernel_phase(flash, [], [], seed=140 + i))
        for r in new:
            r["head_dim"] = d
            r["path"] = "none (wide head-dim sweep)"
            del r["key"]
        rows += new
        torch.cuda.empty_cache()
    return rows


def ragged_rows(pa, dtype, seed: int) -> list[dict]:
    """B1 and B2a at ``RAGGED_LENGTHS`` x ``RAGGED_HEADS`` against their
    plain versions (attention at ``ATTN_TOL`` / L at ``LSE_TOL`` in bf16,
    both at ``F32_TOL`` in f32; B2a's output B1's bit for bit), timed beside
    the bound and SDPA."""
    import torch.nn.functional as F

    f32 = dtype == torch.float32
    tol, lse_tol = (F32_TOL, F32_TOL) if f32 else (ATTN_TOL, LSE_TOL)
    nbytes = 4 if f32 else 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for d, h in RAGGED_HEADS:
        c = h * d
        for sq, sk in RAGGED_LENGTHS:
            q = torch.randn(1, sq, c, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(1, sk, c, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            tag = f"{'f32' if f32 else 'bf16'} 1x{sq}x{sk}x{c}/{h}"
            o1 = pa.packed_flash_attention(q, k, v, h)
            o, lse = pa.packed_attention_forward_lse(q, k, v, h)
            o_ref, lse_ref = pa.packed_attention_lse_reference(q, k, v, h)
            torch.cuda.synchronize()
            err = (o1.float() - o_ref.float()).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            if not (err <= tol and lse_err <= lse_tol and torch.equal(o, o1)):
                raise AssertionError(f"ragged B1/B2a {tag}: o err {err}, L err {lse_err}, "
                                     f"B2a's o == B1's {torch.equal(o, o1)}")
            heads = [x.view(1, x.shape[1], h, d).transpose(1, 2) for x in (q, k, v)]
            flops, io = 4 * sq * sk * c, nbytes * (2 * sq + 2 * sk) * c
            bounds = (_f32_attn_bounds(flops, io) if f32
                      else dict(zip(("bound_ms", "bound_by"), _bound(flops, io))))
            common = {"route": "cuda", "dtype": "float32" if f32 else "bfloat16",
                      "source": F32_SOURCES["B1"] if f32
                      else "genima_torch/csrc/packed_attention.cu",
                      "shape": f"1x{sq}x{sk}x{c}/{h}", "head_dim": d, "launches": None,
                      "path": "none (ragged lengths)",
                      "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads), 20),
                      **bounds}
            rows.append({"name": "packed_flash_attention",
                         "replaces": "genima_tpu/kernels/packed_attention.py:194", **common,
                         "max_abs_err": err,
                         "ms": cuda_ms(lambda: pa.packed_flash_attention(q, k, v, h), 20),
                         "plain_ms": cuda_ms(lambda: pa.packed_attention_reference(q, k, v, h), 3)})
            rows.append({"name": "packed_attention_forward_lse",
                         "replaces": "genima_tpu/kernels/packed_attention.py:274", **common,
                         "max_abs_err": max(err, lse_err), "lse_abs_err": lse_err,
                         "ms": cuda_ms(lambda: pa.packed_attention_forward_lse(q, k, v, h), 20),
                         "plain_ms": cuda_ms(
                             lambda: pa.packed_attention_lse_reference(q, k, v, h), 3)})
    return rows


def kv77_autograd(pa, seed: int = 180) -> dict:
    """The repaired fallback: one autograd call at ``KV77_SHAPE`` (B, Sq, Sk,
    C, heads; bf16, kv = 77, which B2b's tiles do not cover) runs B1's
    kernel forward (one launch, no B2a, no B2b) and recomputes the gradient
    through the plain version (one fallback), as JAX's ``_fwd`` / ``_bwd``
    do; output and gradients held to the plain version's autograd."""
    b, sq, sk, c, h = KV77_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, sq, c, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, sk, c, generator=gen, device="cuda").bfloat16() for _ in range(2))
    do = torch.randn(b, sq, c, generator=gen, device="cuda").bfloat16()
    fns = {"B1": pa.packed_flash_attention, "B2a": pa.packed_attention_forward_lse,
           "B2b": pa.packed_attention_backward}
    before = {n: f.launches for n, f in fns.items()}
    before["fallbacks"] = pa.PackedFlashAttention.fallbacks
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = pa.packed_flash_attention(*leaves, h)
    out.backward(do)
    torch.cuda.synchronize()
    counts = {n: f.launches - before[n] for n, f in fns.items()}
    counts["fallbacks"] = pa.PackedFlashAttention.fallbacks - before["fallbacks"]
    want_counts = {"B1": 1, "B2a": 0, "B2b": 0, "fallbacks": 1}
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_out = pa.packed_attention_reference(*ref, h)
    ref_out.backward(do)
    err = (out.float() - ref_out.float()).abs().max().item()
    grad_rel = max(_rel_err(x.grad, y.grad) for x, y in zip(leaves, ref))
    if counts != want_counts or not (err <= ATTN_TOL and grad_rel <= GRAD_TOL):
        raise AssertionError(f"kv=77 autograd: launches {counts} (want {want_counts}), "
                             f"o err {err}, grads {grad_rel} of max |grad|")
    return {"shape": f"{b}x{sq}x{sk}x{c}/{h}", "launches": counts, "o_abs_err": err,
            "grad_rel_err_vs_plain_autograd": grad_rel}


def wide_heads_phase(pa, card: str) -> tuple[dict, dict, dict]:
    """Phase 18: the wide kernels (heads past 256 columns) against their
    plain versions at the wide-head path's shapes and a head-dim sweep,
    bf16 and f32; B1 and B2a at ragged lengths and the kv = 77 autograd
    call; then (a) ``build_main_path(variant="sd_wide")``, 105 B1 a step;
    (b) the same under ``pallas+w8`` / fused, 230 B3 / 25 B4 / 1380 B5 / 0
    B1; (c) ``run_training(args, "sd", pipe=wide_head_pipeline(...))`` at
    batch 4, 512x512, 6 B1 / 15 B2a / 15 B2b / 0 fallbacks a step, frozen
    models bit-unchanged, step 1's ControlNet gradients held to the library
    attention's; (d) f32 serving (TF32 off), 105 B1 a step, within
    ``F32_EPS_REL_TOL``; (e) the f32 fine-tune (``--mixed_precision no``,
    TF32 off), 6 B1 / 15 B2a / 15 B2b / 0 fallbacks a step, step 1's
    gradients within ``F32_GRAD_REL_TOL`` of the library attention's.
    Returns the paths' results, the kernel rows by path and the checks no
    path runs."""
    from genima_torch.eval.main_path import wide_head_pipeline

    t_phase = time.time()
    rows = {"wide_control": kernel_phase(pa, WIDE_LEVELS, seed=100),
            "wide_train": training_kernel_phase(pa, WIDE_TRAIN_LEVELS, seed=101),
            "wide_opt_in": opt_kernel_phase(WIDE_FLASH_SHAPES, [], [], seed=102),
            "wide_f32_control": f32_attention_rows(pa, WIDE_LEVELS, seed=103, train=False,
                                                   iters=3),
            "wide_f32_train": f32_attention_rows(pa, WIDE_TRAIN_LEVELS, seed=104, train=True,
                                                 iters=3)}
    checks = {"head_dim_sweep": wide_sweep(pa, f32=False),
              "f32_head_dim_sweep": wide_sweep(pa, f32=True),
              "ragged": ragged_rows(pa, torch.bfloat16, seed=110)
              + ragged_rows(pa, torch.float32, seed=111),
              "kv77_autograd": kv77_autograd(pa)}
    out = {"card": card, "kernel_checks_s": time.time() - t_phase}
    torch.cuda.empty_cache()
    t0 = time.time()
    out["serve"] = _sd_serve(pa, "sd_wide", 512, WIDE_STEPS, LAUNCHES_PER_STEP, opt_in=False)
    out["serve"]["s"] = time.time() - t0
    t0 = time.time()
    out["opt_in"] = _serve("sd_wide", 512, OPT_BACKEND, OPT_CONV_BACKEND, OPT_LAUNCHES,
                           WIDE_STEPS)
    out["opt_in"]["s"] = time.time() - t0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out["train"] = _sd_finetune(
            pa, Path(tmp), 512, TRAIN_LAUNCHES, grad_check=True, steps=WIDE_TRAIN_STEPS,
            pipe_factory=lambda args: wide_head_pipeline(
                dtype=torch.bfloat16, backend="fused", device=args.device, vae_encoder=True))
    out["train"]["s"] = time.time() - t0
    t0 = time.time()
    out["f32_serve"] = _serve("sd_wide", 512, "fused", "xla", F32_SERVE_LAUNCHES,
                              F32_SERVE_STEPS, dtype=torch.float32, eps_tol=F32_EPS_REL_TOL)
    out["f32_serve"]["s"] = time.time() - t0
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out["f32_train"] = _sd_finetune(
            pa, Path(tmp), 512, TRAIN_LAUNCHES, precision="no", steps=WIDE_TRAIN_STEPS,
            grad_check=True, grad_tol=F32_GRAD_REL_TOL,
            pipe_factory=lambda args: wide_head_pipeline(
                dtype=torch.float32, backend="fused", device=args.device, vae_encoder=True))
    out["f32_train"]["s"] = time.time() - t0
    _fill_launches(rows["wide_control"], {"B1": out["serve"]["launches_by_shape"]})
    _fill_launches(rows["wide_opt_in"], out["opt_in"]["launches_by_shape"])
    _fill_launches(rows["wide_train"], out["train"]["launches_by_shape"])
    _fill_launches(rows["wide_f32_control"], {"B1": out["f32_serve"]["launches_by_shape"]["B1"]})
    _fill_launches(rows["wide_f32_train"], out["f32_train"]["launches_by_shape"])
    for name, rs in rows.items():
        for r in rs:
            r["path"] = f"{name} (phase 18)"
    out["phase_s"] = time.time() - t_phase
    return out, rows, checks


def per_step_sums(rows) -> dict:
    """Per path and kernel, launches per step x ms summed over its shapes,
    beside the same sum of its bound and of its library yardstick: (path,
    row, steps the row's launches were counted over)."""
    out: dict[str, dict] = {}
    for path, row, steps in rows:
        d = out.setdefault(path, {}).setdefault(
            row["name"], {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "launches": 0})
        per = row["launches"] / steps
        d["launches"] += per
        d["ms"] += per * row["ms"]
        d["bound_ms"] += per * row["bound_ms"]
        d["library_ms"] += per * row["library_ms"]
        if "ffma_bound_ms" in row:
            d["ffma_bound_ms"] = d.get("ffma_bound_ms", 0.0) + per * row["ffma_bound_ms"]
    return out


def _fill_launches(rows, launches_by_shape: dict) -> None:
    """Each row's launches on its path, from the counter of its kernel
    (``COUNTERS[name]``) by shape key; a kernel the path never launched at
    a row's shape fails the run."""
    for row in rows:
        row["launches"] = launches_by_shape[COUNTERS[row["name"]]].get(row["key"], 0)
        if row["launches"] == 0:
            raise AssertionError(f"kernel {row['name']} {row['shape']} never launched")


@contextlib.contextmanager
def _timed(seconds: dict, name: str):
    """Adds the host seconds of the block to ``seconds[name]``."""
    t0 = time.time()
    try:
        yield
    finally:
        seconds[name] = round(seconds.get(name, 0.0) + time.time() - t0, 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from genima_torch.kernels import _build
    from genima_torch.kernels import packed_attention as pa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off: torch.backends.cuda.matmul.allow_tf32 = "
          "torch.backends.cudnn.allow_tf32 = False")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t_start = t0 = time.time()
    phase_s: dict[str, float] = {}  # host seconds of each phase, printed before the kernels line
    with _timed(phase_s, "1 build"):
        _build.build_all(KERNEL_SOURCES)
    print(f"built kernels in {time.time() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        for key, report in ptxas_report(_build.build_log(name)).items():
            print(f"  {name} <{key}>: {json.dumps(report)}")

    with _timed(phase_s, "2 kernel checks"):
        kernels = kernel_phase(pa)
        cfg_kernels = kernel_phase(pa, CFG_LEVELS, seed=3)
        train_kernels = training_kernel_phase(pa)
    # B2a and B2b in phase 11's UNet pretrain run at the trainer's batch-4
    # shapes: the same rows, their launches counted on that path
    pretrain_kernels = [dict(r, path="pretrain UNet (phase 11)") for r in train_kernels
                        if r["name"] != "packed_flash_attention"]
    with _timed(phase_s, "4 opt-in kernel checks"):
        opt_kernels = opt_kernel_phase()
        batched_kernels = opt_kernel_phase(BATCHED_FLASH_SHAPES, BATCHED_CONV_SHAPES,
                                           BATCHED_W8_SHAPES, seed=4)
    # B1 in phase 10 runs at the shapes of the CFG rows (a cohort of 2 envs)
    # and of the trainer's batch-4 rows (4 envs): the same rows, their
    # launches counted on that path
    cohort_kernels = [dict(r, path=f"eval num_parallel_envs={PARALLEL_ENVS}, overlap on")
                      for r in cfg_kernels]
    batch4_kernels = [dict(r, path=f"eval num_parallel_envs={PARALLEL_ENVS}, overlap off")
                      for r in train_kernels if r["name"] == "packed_flash_attention"]
    for r in batched_kernels:
        r["path"] = f"opt-in batched step, {PARALLEL_ENVS} envs"
    # phase 12 runs B1 at SD's levels 1 and 2 (batch 1 serving, batch 4 in
    # the trainer's frozen path) and B2a/B2b at the batch-4 ones: the same rows
    sdxl_kernels = [dict(r, path="sdxl control step") for r in kernels if r["key"] in SDXL_KEYS]
    sdxl_train_kernels = [dict(r, path="sdxl train step") for r in train_kernels
                          if r["key"] in SDXL_KEYS]
    # phase 13 runs B1 at the SD control shapes (batch 1 serially, batch 2 in
    # the lockstep eval), B2a/B2b at the trainer's batch-4 ones and B3/B4/B5
    # at the opt-in step's: the same rows, their launches counted on its paths
    pix2pix_kernels = [dict(r, path="pix2pix control step (eval, serial)") for r in kernels]
    pix2pix_n2_kernels = [dict(r, path="pix2pix eval num_parallel_envs=2") for r in cfg_kernels]
    pix2pix_train_kernels = [dict(r, path="pix2pix train step") for r in train_kernels
                             if r["name"] != "packed_flash_attention"]
    pix2pix_opt_kernels = [dict(r, path="pix2pix opt-in step") for r in opt_kernels]
    # phase 14: each rank of the data-parallel fine-tune runs B1/B2a/B2b at
    # its batch of 2; mesh serving runs B1 at the control step's batch 1
    with _timed(phase_s, "2 kernel checks"):
        dp_kernels = [dict(r, path=f"data-parallel fine-tune, rank 0 of {DP_WORLD} (phase 14)")
                      for r in training_kernel_phase(pa, DP_LEVELS, seed=5)]
    mesh_eval_kernels = [dict(r, path="eval over a 1x1 mesh (phase 14)") for r in kernels]
    tp_kernels = [dict(r, path="TP-sharded control step, 1x2 mesh (phase 14)") for r in kernels]
    with _timed(phase_s, "3 serve"):
        path = _sd_serve(pa, "sd", 512, PATH_STEPS, LAUNCHES_PER_STEP, opt_in=False)
    _fill_launches(kernels, {"B1": path["launches_by_shape"]})
    print("path " + json.dumps(path))
    with _timed(phase_s, "6 train"):
        train = train_phase(pa)
    _fill_launches(train_kernels, train["launches_by_shape"])
    print("train " + json.dumps(train))
    with _timed(phase_s, "5 opt-in serve"):
        opt = _serve("sd", 512, OPT_BACKEND, OPT_CONV_BACKEND, OPT_LAUNCHES, OPT_STEPS)
    _fill_launches(opt_kernels, opt["launches_by_shape"])
    print("opt_path " + json.dumps(opt))
    with tempfile.TemporaryDirectory() as tmp:
        # phases 7 and 10 evaluate the same checkpoints
        with _timed(phase_s, "7 eval"):
            written = write_eval_checkpoints(Path(tmp))
            ev = eval_phase(pa, card, written)
        del written["controlnet_state"]
        with _timed(phase_s, "10 batched eval"):
            bt = batched_eval_phase(pa, card, written)
        with _timed(phase_s, "12 sdxl"):
            sx = sdxl_phase(pa, card, written["controller_dir"], Path(tmp) / "sdxl")
        shutil.rmtree(Path(tmp) / "sdxl", ignore_errors=True)
        with _timed(phase_s, "13 pix2pix"):
            px = pix2pix_phase(pa, card, written["controller_dir"])
        with _timed(phase_s, "14 distributed"):
            dp = distributed_phase(pa, card, written)
    _fill_launches(cfg_kernels, {"B1": ev["cfg_launches_by_shape"]})
    print("eval " + json.dumps(ev))
    for name in ("fused", "cfg"):
        e = ev[name]
        print(f"eval {name} ({card}): gen {e['gen_time_s']:.4f} s, control "
              f"{e['control_time_s']:.4f} s, fused step {e['fused_step_time_s']} s, "
              f"ControlNet checkpoint write {ev['controlnet_write_s']:.2f} s, load (agent "
              f"weights) {e['diffusion_params_load_s']:.2f} s")
    with _timed(phase_s, "8 finetune"):
        ft = finetune_phase(pa, card)
    print("finetune " + json.dumps(ft))
    gb = 1e9
    print(f"finetune ({card}): checkpoint {ft['checkpoint_bytes'] / gb:.3f} GB, async writes "
          f"{ft['async_write_s']} s, sync writes {ft['sync_write_s']} s, submits "
          + ", ".join(f"checkpoint-{x['step']} wait {x['wait_ms']:.1f} + copy "
                      f"{x['copy_ms']:.1f} ms" for x in ft["submits"])
          + f"; step before submit "
          f"{ft['step_before_submit_ms']:.1f} ms, after {ft['step_after_submit_ms']:.1f} ms "
          f"(blocked {ft['blocked_ms']:.1f} ms), run B {ft['run_b_step_ms']} ms; resume "
          f"load {ft['resume_load_s']:.2f} s; validation {ft['validation_s']} s, val_mse "
          f"{ft['val_mse']}; moments f32 {ft['f32_moment_bytes'] / gb:.3f} GB, 8-bit "
          f"{ft['q8_moment_bytes'] / gb:.3f} GB; run C steps update "
          f"{ft['run_c_update_step_ms']} ms, accumulate {ft['run_c_accumulate_step_ms']} ms; "
          f"peak {ft['peak_mem_gb_a']:.2f} / {ft['peak_mem_gb_c']:.2f} GiB")
    with _timed(phase_s, "9 act train"):
        at = act_train_phase(card)
    print("act_train " + json.dumps(at))
    print(f"act_train ({card}): step {at['step_ms_median']:.1f} ms (update "
          f"{at['update_ms_median']:.1f}: augmentation {at['augment_ms_median']:.2f}, "
          f"forward + backward {at['fwd_bwd_ms_median']:.1f}, optimizer "
          f"{at['optimizer_ms_median']:.2f}), {at['samples_per_s']:.1f} samples/s, epochs "
          f"{[round(x, 3) for x in at['epoch_s']]} s; checkpoint {at['checkpoint_bytes'] / 1e6:.1f} "
          f"MB written in {at['checkpoint_write_s']} s, resume load {at['resume_load_s']:.3f} s; "
          f"first loss {at['first_loss_card']:.6f} (CPU {at['first_loss_cpu']:.6f}); update "
          f"with cuDNN TF32 off / on {at['update_ms_median_cudnn_tf32_off']:.1f} / "
          f"{at['update_ms_median_cudnn_tf32_on']:.1f} ms; peak {at['peak_mem_gb']:.2f} GiB")
    with _timed(phase_s, "11 render, pretrain"):
        rp = render_pretrain_phase(pa, card)
    _fill_launches(pretrain_kernels, rp["pretrain_launches_by_shape"])
    print("render_pretrain " + json.dumps(rp))
    print(f"render_pretrain ({card}): render {rp['render_frames_per_s']:.1f} frames/s by the host "
          f"clock ({rp['render_frames']} frames at {RENDER_SIZE}^2 in {rp['render_s']:.2f} s, "
          f"{RENDER_THREADS} episode threads), one camera-episode's render call "
          f"({rp['render_call_frames']} frames) {rp['render_call_ms']:.2f} ms by events; card vs "
          f"CPU {rp['render_vs_cpu_far_pixels']} of {rp['render_vs_cpu_pixels']} pixels > 1 level; "
          f"VAE steps {[round(x, 1) for x in rp['vae_step_ms']]} ms, UNet steps "
          f"{[round(x, 1) for x in rp['unet_step_ms']]} ms (batch {PRETRAIN_BATCH}, 512^2), peak "
          f"{rp['pretrain_peak_mem_gb']:.2f} GiB; base model {rp['base_bytes'] / 1e9:.3f} GB written "
          f"in {rp['base_write_s']:.2f} s, loaded in {rp['base_load_s']:.2f} s; fine-tune from it "
          f"{[round(x, 1) for x in rp['base_finetune_step_ms']]} ms; PNG decoder "
          f"{rp['decoder']} (native build error: {rp['native_build_error']}); train_act on the "
          f"rendered tree {rp['act_updates']} updates in {rp['act_epoch_s']:.1f} s; cut gate "
          f"{rp['gate_cut_s']:.1f} s; phase {rp['phase_s']:.1f} s")
    _fill_launches(batched_kernels, bt["opt_launches_by_shape"])
    _fill_launches(cohort_kernels, {"B1": bt["A"]["launches_by_shape"]})
    _fill_launches(batch4_kernels, {"B1": bt["B"]["launches_by_shape"]})
    print("batched_eval " + json.dumps(bt))
    ms = bt["step_ms"]
    print(f"batched_eval ({card}): step ms by events on the worker stream (host clock) "
          + ", ".join(f"{k} {min(v['events_ms']):.1f} ({min(v['host_ms']):.1f})"
                      for k, v in ms.items())
          + f"; run S (serial): {bt['S']['control_steps_per_s']:.2f} control steps/s, fused step "
          f"{bt['S']['fused_step_time_s']:.4f} s; " + "; ".join(
              f"run {r} ({bt[r]['batch']} a step): {bt[r]['rounds_per_s']:.2f} rounds/s, "
              f"{bt[r]['control_steps_per_s']:.2f} control steps/s "
              f"({bt[r]['control_steps_per_s_per_env']:.2f} per env), gen probe "
              f"{bt[r]['gen_time_s']:.4f} s, fused step {bt[r]['fused_step_time_s']:.4f} s, env "
              f"chunk {bt[r]['env_chunk_ms_median']:.1f} ms" for r in ("A", "B"))
          + f"; rows max |d target| default {max(bt['rows_default']['target_max_levels'])} "
          f"opt-in {max(bt['rows_opt_in']['target_max_levels'])} levels; peak "
          f"{bt['peak_mem_gb']:.2f} GiB; phase {bt['phase_s']:.1f} s")
    _fill_launches(sdxl_kernels, {"B1": sx["serve"]["launches_by_shape"]})
    _fill_launches(sdxl_train_kernels, sx["train"]["launches_by_shape"])
    print("sdxl " + json.dumps(sx))
    sv, tr, ev12 = sx["serve"], sx["train"], sx["eval"]
    print(f"sdxl ({card}): control step {[round(x, 1) for x in sv['step_ms']]} ms by events "
          f"(host {[round(x, 1) for x in sv['host_step_ms']]}), eps rel err "
          f"{sv['eps_rel_err_vs_library_attention']:.4f}, peak {sv['peak_mem_gb']:.2f} GiB; "
          f"train steps {[round(x, 1) for x in tr['step_ms']]} ms (batch {TRAIN_BATCH}), grads "
          f"rel {tr['grad_rel_norm_diff_vs_library_attention']:.4f} (the library's two SDPA "
          f"backends {tr['grad_library_backends_rel_norm_diff']:.4f}), worst projection "
          f"{tr['grad_attn_proj_rel_norm_diff_vs_library_attention']:.3f} (floored "
          f"{tr['grad_attn_proj_rel_floored']:.4f}), peak "
          f"{tr['peak_mem_gb']:.2f} GiB, final save {tr['final_save_bytes'] / 1e9:.3f} GB; eval "
          + "; ".join(f"run {r}: {ev12[r]['control_steps']} steps, fused step "
                      f"{ev12[r]['fused_step_time_s']:.4f} s, agent load "
                      f"{ev12[r]['diffusion_params_load_s']:.2f} s, loop {ev12[r]['loop_s']:.2f} s"
                      for r in ("S", "B"))
          + f"; phase {sx['phase_s']:.1f} s")
    _fill_launches(pix2pix_kernels, {"B1": px["eval"]["S"]["launches_by_shape"]})
    _fill_launches(pix2pix_n2_kernels, {"B1": px["eval"]["B"]["launches_by_shape"]})
    _fill_launches(pix2pix_train_kernels, px["train"]["launches_by_shape"])
    _fill_launches(pix2pix_opt_kernels, px["opt_in"]["launches_by_shape"])
    print("pix2pix " + json.dumps(px))
    tr13, ev13, tv = px["train"], px["eval"], px["tiny_vae"]
    print(f"pix2pix ({card}): train steps {[round(x, 1) for x in tr13['steady_step_ms']]} ms by "
          f"the host clock after each run's first (batch {TRAIN_BATCH}, 512^2, EMA, dropout 0.05), "
          f"peak {tr13['peak_mem_gb']:.2f} "
          f"GiB; checkpoint {tr13['checkpoint_bytes'] / 1e9:.3f} GB written in "
          f"{tr13['checkpoint_write_s']:.2f} s, resumed in {tr13['resume_s']:.2f} s; final save "
          f"{tr13['final_save_bytes'] / 1e9:.3f} GB; grads rel "
          f"{tr13['grad_rel_norm_diff_vs_library_attention']:.4f} (the library's two SDPA backends "
          f"{tr13['grad_library_backends_rel_norm_diff']:.4f}), worst projection floored "
          f"{tr13['grad_attn_proj_rel_floored']:.4f}; eval "
          + "; ".join(f"run {r}: {ev13[r]['control_steps']} steps, fused step "
                      f"{ev13[r]['fused_step_time_s']:.4f} s, agent load "
                      f"{ev13[r]['diffusion_params_load_s']:.2f} s" for r in ("S", "B"))
          + f"; opt-in step {px['opt_in']['launches_per_step'][0]}; tiny VAE PSNR "
          f"{tv['psnr_db'][0]:.2f} -> {tv['psnr_db'][1]:.2f} dB over {tv['distill_steps']} steps "
          f"({tv['distill_s']:.1f} s), decode at batch 1 {tv['tiny_decode_ms']:.3f} ms vs the KL "
          f"decoder's {tv['full_decode_ms']:.3f} ms by events; phase {px['phase_s']:.1f} s")
    _fill_launches(dp_kernels, dp["a"][0]["launches_by_shape"])
    _fill_launches(mesh_eval_kernels, {"B1": dp["d"]["eval"]["launches_by_shape"]})
    _fill_launches(tp_kernels, {"B1": dp["d"]["tp_launches_by_shape"]})
    print("distributed " + json.dumps(dp))
    a0, d14 = dp["a"][0], dp["d"]
    print(f"distributed ({card}): (a) {DP_WORLD} gloo ranks on one card, batch {DP_BATCH} each: "
          + "; ".join(f"rank {r['rank']} steps {[round(x, 1) for x in r['step_ms']]} ms, "
                      f"all-reduce {[round(x, 1) for x in r['all_reduce_ms']]} ms, peak "
                      f"{r['peak_mem_gb']:.2f} GiB" for r in dp["a"])
          + f"; step 1 vs one process at batch {DP_BATCH * DP_WORLD}: gradients rel norm diff "
          f"{a0['grad_rel_norm_diff_vs_one_process']:.3e}; update vs one process's optimizer on "
          f"the same gradients {a0['update_rel_norm_diff_vs_one_process_on_the_same_gradients']:.3e}"
          f" (bit-equal {a0['update_bit_equal_to_one_process_on_the_same_gradients']}), vs the "
          f"batch-4 step's update {a0['update_rel_norm_diff_vs_one_process']:.3e} "
          f"({a0['sign_flipped_share']:.2e} of signs flipped); {dp['a_s']:.1f} s. (b) nccl at world "
          f"1: step {[round(x, 1) for x in dp['b']['step_ms']]} ms, all-reduce "
          f"{[round(x, 2) for x in dp['b']['all_reduce_ms']]} ms. (c) ACT on {DP_WORLD} ranks: "
          f"{dp['c']['ranks'][0]['updates']} updates each, peak "
          f"{[round(r['peak_mem_gb'], 2) for r in dp['c']['ranks']]} GiB; (b)+(c) "
          f"{dp['bc_s']:.1f} s. (d) eval over a 1x1 mesh {d14['eval']['generates']} generates in "
          f"{d14['eval']['s']:.1f} s; TP 1x2 step {[round(x, 1) for x in d14['tp_step_ms']]} ms "
          f"vs whole {[round(x, 1) for x in d14['whole_step_ms']]} ms by the host clock, eps rel "
          f"norm diff {d14['tp_eps_rel_norm_diff']:.3e} (max err / max "
          f"{d14['tp_eps_rel_max_err']:.3e}); vs f32 TP {d14['tp_eps_rel_norm_diff_vs_f32']:.3e}, "
          f"whole {d14['whole_eps_rel_norm_diff_vs_f32']:.3e}; "
          f"{d14['column_sharded_layers']} layers split, peak "
          f"{d14['peak_mem_gb']:.2f} GiB; phase {dp['phase_s']:.1f} s")
    with _timed(phase_s, "15 head dims"):
        hd, hd_rows = head_dims_phase(pa, card)
    print("head_dims " + json.dumps(hd))
    s15, t15, t768, s768 = hd["sd15_serve"], hd["sd15_train"], hd["sd768_train"], hd["sd768_serve"]
    print(f"head_dims ({card}): SD-1.5 control step {[round(x, 1) for x in s15['step_ms']]} ms "
          f"by events (opt-in {s15['opt_in']['step_ms']:.1f}), eps rel err "
          f"{s15['eps_rel_err_vs_library_attention']:.4f} (opt-in "
          f"{s15['opt_in']['eps_rel_err_vs_library_attention']:.4f}), peak "
          f"{s15['peak_mem_gb']:.2f} GiB; SD-1.5 "
          f"train steps {[round(x, 1) for x in t15['step_ms']]} ms (batch {TRAIN_BATCH}, 512^2), "
          f"grads rel {t15['grad_rel_norm_diff_vs_library_attention']:.4f} (the library's two "
          f"SDPA backends {t15['grad_library_backends_rel_norm_diff']:.4f}), peak "
          f"{t15['peak_mem_gb']:.2f} GiB; SD at 768^2: train steps "
          f"{[round(x, 1) for x in t768['step_ms']]} ms, peak {t768['peak_mem_gb']:.2f} GiB, "
          f"control step {[round(x, 1) for x in s768['step_ms']]} ms, eps rel err "
          f"{s768['eps_rel_err_vs_library_attention']:.4f}, peak {s768['peak_mem_gb']:.2f} GiB; "
          f"kernel checks {hd['kernel_checks_s']:.1f} s; phase {hd['phase_s']:.1f} s")
    with _timed(phase_s, "16 opt-in geometries"):
        p16, p16_rows, sweep = opt_geometries_phase(pa, card, {
            "sd_opt": opt_kernels, "sd15_control": hd_rows["sd15_control"],
            "sd15_train": hd_rows["sd15_train"], "sd15_opt_in": hd_rows["sd15_opt_in"]})
    print("opt_geometries " + json.dumps(p16))
    print("head_dim_sweep " + json.dumps(sweep))
    print(f"opt_geometries ({card}): " + "; ".join(
        f"{name} steps {[round(x, 1) for x in p16[name]['step_ms']]} ms by events, eps "
        f"{p16[name]['eps_rel_err_vs_library_attention']:.4f}"
        + (f", int8 {p16[name]['eps_int8_vs_dequantised_float']:.4f}"
           if "eps_int8_vs_dequantised_float" in p16[name] else "")
        + (f", decode {p16[name]['vae_fused_vs_default_decode']:.4f}"
           if "vae_fused_vs_default_decode" in p16[name] else "")
        + f", build peak {p16[name]['build_peak_mem_gb']:.2f} GiB, step peak "
        f"{p16[name]['step_peak_mem_gb']:.2f} GiB, {p16[name]['s']:.1f} s"
        for name in p16 if isinstance(p16[name], dict) and "step_peak_mem_gb" in p16[name])
        + f"; pix2pix15 train steps {[round(x, 1) for x in p16['pix2pix15_train']['step_ms']]} "
        f"ms, peak {p16['pix2pix15_train']['peak_mem_gb']:.2f} GiB; kernel checks "
        f"{p16['kernel_checks_s']:.1f} s; phase {p16['phase_s']:.1f} s")
    with _timed(phase_s, "17 f32"):
        p17, p17_rows, p17_checks = f32_phase(pa, card)
    print("f32 " + json.dumps(p17))
    print("f32_shape_checks " + json.dumps(p17_checks))
    sv17, op17, tr17 = p17["serve"], p17["opt_in"], p17["train"]
    print(f"f32 ({card}; TF32 off): default serving steps "
          f"{[round(x, 1) for x in sv17['step_ms']]} ms by events, eps rel err "
          f"{sv17['eps_rel_err_vs_library_attention']:.3e}, step peak "
          f"{sv17['step_peak_mem_gb']:.2f} GiB; pallas+w8 / fused steps "
          f"{[round(x, 1) for x in op17['step_ms']]} ms, eps rel err {op17['eps_rel_err_vs_library_attention']:.3e}"
          f" (float models {op17['eps_float_models_rel_err_vs_library_attention']:.3e}), int8 "
          f"{op17['eps_int8_vs_dequantised_float']:.3e}, decode "
          f"{op17['vae_fused_vs_default_decode']:.3e}, step peak {op17['step_peak_mem_gb']:.2f} "
          f"GiB; fine-tune steps {[round(x, 1) for x in tr17['step_ms']]} ms (batch "
          f"{TRAIN_BATCH}, 512^2, --mixed_precision no), grads rel "
          f"{tr17['grad_rel_norm_diff_vs_library_attention']:.3e} (floored projections "
          f"{tr17['grad_attn_proj_rel_floored']:.3e}, the library's two SDPA backends "
          f"{tr17['grad_library_backends_rel_norm_diff']:.3e}), peak {tr17['peak_mem_gb']:.2f} "
          f"GiB; kernel checks {p17['kernel_checks_s']:.1f} s; phase {p17['phase_s']:.1f} s")
    with _timed(phase_s, "18 wide heads"):
        p18, p18_rows, p18_checks = wide_heads_phase(pa, card)
    print("wide_heads " + json.dumps(p18))
    print("wide_head_checks " + json.dumps(p18_checks))
    sv18, op18, tr18, f18 = p18["serve"], p18["opt_in"], p18["train"], p18["f32_serve"]
    ft18 = p18["f32_train"]
    print(f"wide_heads ({card}): control steps {[round(x, 1) for x in sv18['step_ms']]} ms by "
          f"events, eps rel err {sv18['eps_rel_err_vs_library_attention']:.4f}, peak "
          f"{sv18['peak_mem_gb']:.2f} GiB; pallas+w8 / fused steps "
          f"{[round(x, 1) for x in op18['step_ms']]} ms, eps rel err "
          f"{op18['eps_rel_err_vs_library_attention']:.4f}, step peak "
          f"{op18['step_peak_mem_gb']:.2f} GiB; fine-tune steps "
          f"{[round(x, 1) for x in tr18['step_ms']]} ms (batch {TRAIN_BATCH}, 512^2), grads rel "
          f"{tr18['grad_rel_norm_diff_vs_library_attention']:.4f} (the library's two SDPA "
          f"backends {tr18['grad_library_backends_rel_norm_diff']:.4f}), peak "
          f"{tr18['peak_mem_gb']:.2f} GiB; f32 steps {[round(x, 1) for x in f18['step_ms']]} ms, "
          f"eps rel err {f18['eps_rel_err_vs_library_attention']:.3e}, step peak "
          f"{f18['step_peak_mem_gb']:.2f} GiB; f32 fine-tune steps "
          f"{[round(x, 1) for x in ft18['step_ms']]} ms, grads rel "
          f"{ft18['grad_rel_norm_diff_vs_library_attention']:.3e}; kv=77 autograd "
          f"{p18_checks['kv77_autograd']['launches']}; kernel checks "
          f"{p18['kernel_checks_s']:.1f} s; phase {p18['phase_s']:.1f} s")
    phase_s["total"] = round(time.time() - t_start, 1)
    print("phase_seconds " + json.dumps(phase_s))
    print("per_step " + json.dumps(per_step_sums(
        [("control", r, PATH_STEPS) for r in kernels]
        + [("train", r, TRAIN_STEPS) for r in train_kernels]
        + [("opt_in", r, OPT_STEPS) for r in opt_kernels]
        + [("cfg_control", r, ev["cfg"]["control_steps"]) for r in cfg_kernels]
        + [("eval_cohort_n2", r, bt["A"]["generates"]) for r in cohort_kernels]
        + [("eval_batched_n4", r, bt["B"]["generates"]) for r in batch4_kernels]
        + [("opt_in_batched_n4", r, BATCHED_STEPS) for r in batched_kernels]
        + [("pretrain_unet", r, PRETRAIN_STEPS) for r in pretrain_kernels]
        + [("sdxl_control", r, SDXL_STEPS) for r in sdxl_kernels]
        + [("sdxl_train", r, SDXL_STEPS) for r in sdxl_train_kernels]
        + [("pix2pix_control", r, px["eval"]["S"]["generates"]) for r in pix2pix_kernels]
        + [("pix2pix_control_n2", r, px["eval"]["B"]["generates"]) for r in pix2pix_n2_kernels]
        + [("pix2pix_train", r, PIX2PIX_CKPT_AT) for r in pix2pix_train_kernels]
        + [("pix2pix_opt_in", r, 1) for r in pix2pix_opt_kernels]
        + [("dp_finetune_rank0", r, DP_STEPS) for r in dp_kernels]
        + [("mesh_eval_1x1", r, dp["d"]["eval"]["generates"]) for r in mesh_eval_kernels]
        + [("tp_control_1x2", r, TP_STEPS) for r in tp_kernels]
        + [("sd15_control", r, SD15_STEPS) for r in hd_rows["sd15_control"]]
        + [("sd15_opt_in", r, 1) for r in hd_rows["sd15_opt_in"]]
        + [("sd15_train", r, SD15_TRAIN_STEPS) for r in hd_rows["sd15_train"]]
        + [("sd768_control", r, SD768_STEPS) for r in hd_rows["sd768_control"]]
        + [("sd768_train", r, SD15_TRAIN_STEPS) for r in hd_rows["sd768_train"]]
        + [(name, r, PIX2PIX15_TRAIN_STEPS if name == "pix2pix15_train" else OPT16_STEPS)
           for name, rs in p16_rows.items() for r in rs]
        + [(name, r, F32_TRAIN_STEPS if name == "f32_train" else F32_SERVE_STEPS)
           for name, rs in p17_rows.items() for r in rs]
        + [(name, r, WIDE_PATH_STEPS.get(name, WIDE_STEPS))
           for name, rs in p18_rows.items() for r in rs])))
    rows = (kernels + cfg_kernels + train_kernels + opt_kernels + cohort_kernels
            + batch4_kernels + batched_kernels + pretrain_kernels + sdxl_kernels
            + sdxl_train_kernels + pix2pix_kernels + pix2pix_n2_kernels + pix2pix_train_kernels
            + pix2pix_opt_kernels + dp_kernels + mesh_eval_kernels + tp_kernels
            + [r for rs in hd_rows.values() for r in rs]
            + [r for rs in p16_rows.values() for r in rs]
            + [r for rs in p17_rows.values() for r in rs]
            + [r for rs in p18_rows.values() for r in rs])
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "key"} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def wide_main() -> int:
    """``python3 chip_smoke.py --wide``: phase 18 alone (the wide kernels'
    checks, the head-dim sweep, the ragged rows, the kv = 77 call and the
    four ``sd_wide`` paths with their pins), after the build, with TF32 off;
    prints its rows, its checks and its ``per_step`` sums. Fails as the
    whole run does."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from genima_torch.kernels import _build
    from genima_torch.kernels import packed_attention as pa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build_all(KERNEL_SOURCES)
    print(f"built kernels in {time.time() - t0:.1f} s")
    for name in ("packed_attention", "flash_attention"):
        for key, report in ptxas_report(_build.build_log(name)).items():
            if key.startswith(("pair_", "wide_", "f32_cluster_", "f32_wide_")):
                print(f"  {name} <{key}>: {json.dumps(report)}")
    p18, p18_rows, p18_checks = wide_heads_phase(pa, card)
    print("wide_heads " + json.dumps(p18))
    print("wide_head_checks " + json.dumps(p18_checks))
    print("per_step " + json.dumps(per_step_sums(
        [(name, r, WIDE_PATH_STEPS.get(name, WIDE_STEPS))
         for name, rs in p18_rows.items() for r in rs])))
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "key"}
                                  for rs in p18_rows.values() for r in rs]}))
    print(f"wide phase passed in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(wide_main() if sys.argv[1:] == ["--wide"] else main())
