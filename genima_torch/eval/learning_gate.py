"""The offline learning gate: does the stack train policies that win?

    python -m genima_torch.eval.learning_gate [work_dir] [device=cpu]

Counterpart of ``genima_tpu/eval/learning_gate.py`` (and of
``scripts/run_learning_gate.py``). The reference's correctness currency is
the closed-loop success rate (``controller/eval_genima.py:322-330``); this
chains the port's own stages on the goal-observable fake task and measures
it:

1. demos on the goal-observable fake task (the goal is in the scene, as
   the real env's objects are),
2. export to the RLBench layout (``envs.export``),
3. sphere-target rendering at t + horizon (``rendering.render_data``),
4. base-model pretraining (``diffusion.pretrain``, the offline stand-in for
   downloading sd-turbo),
5. the ControlNet fine-tune through the CLI's driver
   (``diffusion.driver.run_training``), with the generation MSE before and
   after,
6. ACT controller training on the rendered tree from disk
   (``control.trainer`` + ``envs.rendered``),
7. closed-loop eval through the diffusion agent on unseen episode seeds
   (``eval.harness``), trained controller against a fresh one.

It passes when the trained stack's success rate reaches
``min_trained_success``, the untrained controller's stays at or below
``max_untrained_success`` and the fine-tune lowered the generation MSE.
``learning_gate.json`` holds the JAX package's keys. Numpy draws
(``RandomState``) are the JAX package's; the torch generators that seed the
models and latents draw other numbers than JAX's keys, so the two gates are
not expected to agree run for run. Every stage runs on ``device``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from genima_torch import resolve_device


@dataclasses.dataclass
class GateConfig:
    # task geometry
    image_size: int = 48
    demo_length: int = 24
    horizon: int = 8  # sphere lookahead == BC action chunk == exec horizon
    episode_length: int = 48
    success_tol: float = 0.25
    num_demos: int = 48
    # diffusion
    vae_steps: int = 300
    unet_steps: int = 350
    cn_steps: int = 500
    diffusion_batch: int = 8
    diffusion_lr: float = 1e-3
    num_inference_steps: int = 5
    # controller
    act_epochs: int = 6
    act_batch: int = 8
    act_lr: float = 1e-3
    resnet_width: int = 16
    # eval
    eval_episodes: int = 10
    eval_seed: int = 31337
    # pass/fail bars
    min_trained_success: float = 0.6
    max_untrained_success: float = 0.2
    task: str = "fake_reach_visual"
    seed: int = 0


def _build_pipe(cfg: GateConfig, device: Any = "cuda"):
    from genima_torch.diffusion.pipeline import SDControlNetPipeline
    from genima_torch.nn.clip_text import CLIPTextConfig
    from genima_torch.nn.unet import UNetConfig
    from genima_torch.nn.vae import VAEConfig

    return SDControlNetPipeline(
        # attention at the downsampled level only: the 2x-tiled latents are
        # large and the scene -> sphere map is local
        unet_cfg=UNetConfig.tiny(down_block_has_attn=(False, True)),
        vae_cfg=VAEConfig.tiny_test(),
        # full CLIP vocab so the hash tokenizer's ids are in range
        text_cfg=CLIPTextConfig.tiny(vocab_size=49408),
        dtype=torch.float32,
        device=device,
        vae_encoder=True,
    )


def _render_config(cfg: GateConfig, raw_root: Path, work: Path) -> dict:
    cams = ["wrist", "front", "right_shoulder", "left_shoulder"]
    return {
        "dataset_root": str(raw_root),
        "save_path": str(work),
        "task": cfg.task,
        "variation": 0,
        "episodes": cfg.num_demos,
        "episode_offset": 0,
        "num_processes": 1,
        "image_width": cfg.image_size,
        "image_height": cfg.image_size,
        "action_horizon": cfg.horizon,
        "alpha_blend": 0.7,
        "cameras": cams,
        "camera_scales": [1.0, 1.0, 1.0, 1.0],
        "render": {
            "sphere": {"radius": 0.11},
            "joints": {c: [1, 3, 5] for c in cams},
        },
        # rgb_rendered only: the gate does not exercise background
        # randomization (rnd_bg doubles render and IO time)
        "draw": {"rgb_rendered": True, "rnd_bg": False},
        "seed": cfg.seed,
    }


def measure_generation_mse(pipe, params: dict, samples: list, resolution: int, tokenizer,
                           n: int = 4, seed: int = 7) -> float:
    """Mean per-pixel MSE of 5-step guidance-0 generations against ground
    truth on a fixed validation slice (the reference's val_mse artifact,
    ``train_controlnet_genima.py:641-650``); sample ``j``'s latents come from
    a generator seeded ``seed + j``."""
    from genima_torch.data.dataset import DiffusionDataLoader

    loader = DiffusionDataLoader(samples, tokenizer, batch_size=1, resolution=resolution)
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(samples), size=min(n, len(samples)), replace=False)
    lat = resolution // pipe.vae_scale_factor
    mses = []
    for j, i in enumerate(idx):
        sample = samples[int(i)]
        gt, cond = loader._load_one(sample)
        embeds = pipe.encode_prompt(params, np.asarray(tokenizer([sample.text]), np.int32))
        gen = torch.Generator(device=pipe.device).manual_seed(seed + j)
        latents = torch.randn(1, lat, lat, pipe.vae_cfg.latent_channels, generator=gen,
                              device=pipe.device)
        image = pipe.generate(params, torch.from_numpy(cond[None]), embeds, latents,
                              num_inference_steps=5, guidance_scale=0.0)
        gt_img = ((gt + 1) * 127.5).astype(np.float32)
        mses.append(float(np.mean((image[0].cpu().numpy().astype(np.float32) - gt_img) ** 2)))
    return float(np.mean(mses))


def run_learning_gate(work_dir: str | Path, cfg: GateConfig | None = None,
                      device: Any = "cuda") -> dict:
    cfg = cfg or GateConfig()
    device = resolve_device(device)
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    t_start = time.time()
    results: dict = {"config": dataclasses.asdict(cfg)}

    # ---- 1. demos on the goal-observable task -----------------------------
    from genima_torch.envs.fake import FakeRLBenchFactory

    factory = FakeRLBenchFactory(
        task_name=cfg.task, image_size=cfg.image_size, demo_length=cfg.demo_length,
        episode_length=cfg.episode_length, goal_observable=True,
        success_tol=cfg.success_tol, seed=cfg.seed,
    )
    demos = factory.collect_or_fetch_demos(cfg.num_demos)
    print(f"[gate] collected {len(demos)} demos")

    # ---- 2. export to the RLBench dataset layout --------------------------
    from genima_torch.envs.export import export_demos_rlbench_format

    raw_root = work / "raw"
    export_demos_rlbench_format(demos, raw_root, cfg.task)

    # ---- 3. sphere-target rendering at t+horizon --------------------------
    from genima_torch.rendering.render_data import RenderData

    RenderData(_render_config(cfg, raw_root, work), device=device).generate()
    rendered_root = work / "raw_rgb_rendered"
    print(f"[gate] rendered dataset at {rendered_root} ({time.time() - t_start:.0f}s)")

    # ---- 4. base-model pretraining ----------------------------------------
    from genima_torch.data.dataset import DiffusionDataLoader, index_rendered_dataset
    from genima_torch.data.tokenizer import load_tokenizer
    from genima_torch.diffusion.pretrain import pretrain_base_model, save_base_model

    pipe = _build_pipe(cfg, device)
    resolution = 2 * cfg.image_size
    tokenizer = load_tokenizer(None)
    samples = index_rendered_dataset(rendered_root, tasks=[cfg.task], num_demos=cfg.num_demos)
    loader = DiffusionDataLoader(samples, tokenizer, batch_size=cfg.diffusion_batch,
                                 resolution=resolution, seed=cfg.seed, emit_uint8=True)
    params = pipe.init_params(torch.Generator(device=device).manual_seed(cfg.seed))
    masters: dict = {}
    params = pretrain_base_model(pipe, params, loader, vae_steps=cfg.vae_steps,
                                 unet_steps=cfg.unet_steps, seed=cfg.seed, masters=masters)
    base_dir = save_base_model(work / "base", params, masters)
    print(f"[gate] base model pretrained ({time.time() - t_start:.0f}s)")

    # ---- 5. ControlNet fine-tune through the CLI driver -------------------
    from genima_torch.cli.train_controlnet_genima import parse_args
    from genima_torch.core import checkpoint as ckpt
    from genima_torch.diffusion.driver import run_training
    from genima_torch.nn.controlnet import controlnet_params_from_unet

    # init-quality baseline: the base model + the from-unet ControlNet init
    # (the reference's starting point, train_controlnet_genima.py:1066-1071)
    cn = params["controlnet"]
    cn.load_state_dict(controlnet_params_from_unet(params["unet"].state_dict(), cn.state_dict()))
    val_mse_init = measure_generation_mse(pipe, params, samples, resolution, tokenizer)
    results["val_mse_init"] = val_mse_init
    print(f"[gate] val_mse(init) = {val_mse_init:.2f}")

    cn_dir = work / "cn"
    args = parse_args([
        "--data_path", str(rendered_root),
        "--tasks", cfg.task,
        "--output_dir", str(cn_dir),
        "--pretrained_model_name_or_path", str(base_dir),
        "--resolution", str(resolution),
        "--train_batch_size", str(cfg.diffusion_batch),
        "--max_train_steps", str(cfg.cn_steps),
        "--checkpointing_steps", str(cfg.cn_steps),
        "--validation_steps", "0",
        "--learning_rate", str(cfg.diffusion_lr),
        "--lr_scheduler", "cosine",
        "--lr_warmup_steps", "50",
        "--train_scheduler", "euler_discrete",
        "--seed", str(cfg.seed),
        "--mixed_precision", "no",
        "--report_to", "none",  # metrics.jsonl only
        "--device", device.type,
    ])
    train_result = run_training(args, pipe=pipe)
    results["cn_final_loss"] = train_result["final_loss"]

    pipe.load_tree(params, "controlnet", ckpt.load_pytree(cn_dir / "controlnet" / "params.msgpack"))
    val_mse_final = measure_generation_mse(pipe, params, samples, resolution, tokenizer)
    results["val_mse_final"] = val_mse_final
    print(f"[gate] val_mse(fine-tuned) = {val_mse_final:.2f} "
          f"(init {val_mse_init:.2f}, {time.time() - t_start:.0f}s)")

    # ---- 6. ACT controller on the rendered dataset ------------------------
    from genima_torch.control.policy import GenimaACTAgent
    from genima_torch.control.trainer import ControllerWorkspace
    from genima_torch.core.config import Config
    from genima_torch.envs.rendered import RenderedDemoFactory
    from genima_torch.nn.act import ACTConfig
    from genima_torch.nn.clip_text import CLIPTextConfig

    def make_act_agent():
        return GenimaACTAgent(
            act_cfg=ACTConfig.tiny(num_queries=cfg.horizon),
            clip_cfg=CLIPTextConfig.tiny(projection_dim=16),
            image_size=cfg.image_size,
            resnet_width=cfg.resnet_width,
            num_views=4,
            lr=cfg.act_lr,
            lr_backbone=cfg.act_lr,
            data_augmentation=False,
            dtype=torch.float32,
            device=device,
        )

    def seeded(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    rendered_factory = RenderedDemoFactory(rendered_root, task_names=[cfg.task],
                                           eval_factory=factory)
    ctrl_dir = work / "ctrl"
    act_cfg = Config.from_dict({
        "num_train_epochs": cfg.act_epochs,
        "checkpoint_every": cfg.act_epochs,
        "num_checkpoints": 1,
        "batch_size": cfg.act_batch,
        "action_sequence": cfg.horizon,
        "frame_stack": 1,
        "seed": cfg.seed,
    })
    ControllerWorkspace(act_cfg, make_act_agent(), rendered_factory, ctrl_dir,
                        num_demos=cfg.num_demos).train()
    print(f"[gate] controller trained ({time.time() - t_start:.0f}s)")

    # fresh-init controller checkpoint: the "no learning" control arm
    untrained_dir = work / "ctrl_untrained"
    untrained_dir.mkdir(exist_ok=True)
    fresh = make_act_agent()
    fresh_state = fresh.create_state(*fresh.init_params(seeded(cfg.seed + 99)))
    ckpt.save_epoch_checkpoint(untrained_dir, epoch=0, num_iters=0,
                               agent_params=fresh_state.tree(), config=act_cfg.to_dict(),
                               num_checkpoints=1)

    # ---- 7. closed-loop eval through the diffusion agent ------------------
    from genima_torch.eval.agents import SDControlNetAgent
    from genima_torch.eval.harness import GenimaEvalWorkspace

    diffusion_agent = SDControlNetAgent(
        pipe=pipe, resolution=resolution, diffusion_ckpt=str(cn_dir), sd_ckpt=str(base_dir),
        num_inference_steps=cfg.num_inference_steps, device=device,
    )

    def closed_loop(ckpt_dir: Path, tag: str) -> float:
        # UNSEEN episodes: a different base seed than every training demo
        eval_factory = FakeRLBenchFactory(
            task_name=cfg.task, image_size=cfg.image_size, demo_length=cfg.demo_length,
            episode_length=cfg.episode_length, goal_observable=True,
            success_tol=cfg.success_tol, seed=cfg.eval_seed,
        )
        eval_env = eval_factory.make_eval_env(
            frame_stack=1, action_sequence=cfg.horizon,
            action_stats=rendered_factory.action_stats,
            proprio_stats=rendered_factory.proprio_stats, stats_path=str(ckpt_dir),
        )
        eval_cfg = Config.from_dict({
            "task": cfg.task,
            "controller_ckpt": str(ckpt_dir),
            "eval_type": "latest",
            "num_eval_episodes": cfg.eval_episodes,
            "execution_horizon": cfg.horizon,
            "episode_length": cfg.episode_length,
            "num_diffusion_steps": cfg.num_inference_steps,
            "guidance_scale": 0.0,
            "save_video": False,
        })
        # the clip tower of training (ControllerWorkspace inits with
        # cfg.seed; the frozen CLIP is not in the controller checkpoint) and
        # the same hash tokenizer, so eval-time language conditioning
        # matches what the controller trained on
        eval_agent = make_act_agent()
        eval_agent.create_state(*eval_agent.init_params(seeded(cfg.seed)))
        logs = GenimaEvalWorkspace(eval_cfg, eval_env, eval_agent, diffusion_agent,
                                   tokenizer=tokenizer).eval()
        success = float(logs["results"]["avg_success"])
        print(f"[gate] closed-loop success ({tag}): {success:.2f}")
        return success

    results["trained_success"] = closed_loop(ctrl_dir, "trained")
    results["untrained_success"] = closed_loop(untrained_dir, "untrained")
    results["elapsed_s"] = time.time() - t_start
    results["passed"] = bool(
        results["trained_success"] >= cfg.min_trained_success
        and results["untrained_success"] <= cfg.max_untrained_success
        and val_mse_final < val_mse_init
    )
    with open(work / "learning_gate.json", "w") as f:
        json.dump(results, f, indent=2)
    print(f"[gate] {'PASS' if results['passed'] else 'FAIL'}: trained="
          f"{results['trained_success']:.2f} untrained={results['untrained_success']:.2f} "
          f"val_mse {val_mse_init:.1f}->{val_mse_final:.1f} ({results['elapsed_s']:.0f}s)")
    return results


def main(argv=None) -> dict:
    """``[work_dir] [device=cuda|cpu]``: the default ``GateConfig()`` gate."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for a in [a for a in argv if a.startswith("device=")]:
        device = a.split("=", 1)[1]
        argv.remove(a)
    return run_learning_gate(argv[0] if argv else "./learning_gate_run", device=device)


if __name__ == "__main__":
    main()
