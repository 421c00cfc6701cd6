"""Closed-loop Genima evaluation CLI, hydra-style ``key=value`` overrides:

    python -m genima_torch.cli.eval_genima controller_ckpt=/path/ckpt \\
        diffusion_ckpt=/path/diffusion task=open_box env.factory=fake

Counterpart of ``genima_tpu/cli/eval_genima.py`` and its config
``genima_tpu/cfgs/eval_genima.yaml``, whose defaults ``EVAL_GENIMA`` keeps
as Python data. The saved train config is read from the selected controller
checkpoint's ``config_json`` (the JAX trainer writes the same dict there and
to ``config.yaml``; the latter is read, with PyYAML, only where the
checkpoint has no JSON). ``device=`` picks the card (``cuda``, the default)
or ``cpu``. Differences from the JAX defaults: ``controller_ckpt`` must be
given, ``diffusion_ckpt`` defaults to none (the seeded random ControlNet)
and media go under the controller directory unless ``save_image_path`` is
set. ``num_parallel_envs > 1`` runs the lockstep-batched eval
(``eval/parallel.py``): on the fake factory N envs in this process, on any
other factory N spawned children (``envs/subprocess_env.py``), whose
simulator the port does not drive yet (``envs/rlbench.py`` raises in each
child). ``diffusion_agent._target_`` picks the agent
(``genima_torch.eval.agents.SDControlNetAgent`` by default,
``SDXLControlNetAgent``, ``SDPix2PixAgent``, or a ``make_tiny_*`` factory);
``autoencoder=taesd`` decodes with its tiny VAE. Mesh serving
(``eval_data_parallel``, ``eval_tensor_parallel > 1``) and Colosseum
variations are not ported and raise. The reference's speed toggles
(``torch_compile``, ``channel_last``, ``allow_tf32``, ``vae_slicing``,
``upcast_vae``, ``fused_projections``) and ``temporal_agg`` are accepted
and change nothing, as in the JAX package, whose modules read none of
them; a line names the ones that are set. ``wandb.use`` sends the metrics
to W&B where it is installed (``metrics.jsonl`` always).
"""

from __future__ import annotations

import sys
from pathlib import Path

from genima_torch.core import checkpoint as ckpt
from genima_torch.core.config import Config, build_config, instantiate, load_yaml, parse_cli
from genima_torch.core.logging import MetricLogger
from genima_torch.core.rng import seed_everything
from genima_torch.data.tokenizer import load_tokenizer

CAMERAS = ["wrist", "front", "right_shoulder", "left_shoulder"]

EVAL_GENIMA = {
    "diffusion_ckpt": None,
    "controller_ckpt": None,
    "sd_ckpt": None,  # dir with the base models' params.msgpack
    "device": "cuda",
    "task": "take_lid_off_saucepan",
    "episode_length": 200,
    "eval_type": "latest",  # latest | last | last_three | <epoch>
    "train_cfg_path": "${controller_ckpt}/config.yaml",
    "num_eval_episodes": 50,
    "num_parallel_envs": 1,
    # with num_parallel_envs > 1: two cohorts, one stepping its envs while
    # the card runs the other's step
    "eval_overlap": True,
    "eval_data_parallel": False,
    "eval_mesh_devices": 0,
    "eval_tensor_parallel": 0,
    "dataset_root": None,
    "save_video": False,
    "video_fps": 30,
    "headless": True,
    "save_gen_image": False,
    "save_input_image": False,
    "save_image_path": None,
    "seed": 2,
    "env": {"factory": "rlbench", "cameras": list(CAMERAS), "image_size": 256},
    "colosseum_use": False,
    "colosseum_task_config": None,
    "diffusion_agent": {"_target_": "genima_torch.eval.agents.SDControlNetAgent"},
    "execution_horizon": 20,
    "num_diffusion_steps": 10,
    "guidance_scale": 0.0,
    "diffusion_seed": 2,
    "temporal_agg": False,
    "image_resolution": 512,
    # true: long self-attention through the packed kernel ("fused"); false:
    # the library attention ("xla")
    "enable_xformers_memory_efficient_attention": True,
    # the reference's other speed toggles: accepted, no effect (NO_OP_KEYS)
    "torch_compile": False,
    "channel_last": False,
    "allow_tf32": False,
    "autoencoder": "",
    "vae_slicing": False,
    "upcast_vae": False,
    "fused_projections": False,
    "tokenizer_merges": None,
    "clip_weights": None,  # defaults to the saved train config's clip_weights
    "wandb": {"use": False, "project": "genima", "name": "eval_genima"},
}

# keys the JAX config declares and no JAX module reads
NO_OP_KEYS = ("torch_compile", "channel_last", "allow_tf32", "vae_slicing", "upcast_vae",
              "fused_projections", "temporal_agg")
_NOT_PORTED = ("colosseum_use", "eval_data_parallel")


def load_train_cfg(eval_cfg) -> Config | None:
    """The train config saved with the controller checkpoint to evaluate."""
    ckpt_dir = Path(eval_cfg.controller_ckpt)
    names = ckpt.select_eval_checkpoints(ckpt_dir, eval_cfg.get("eval_type", "latest"))
    payload = ckpt.load_epoch_checkpoint(ckpt_dir / names[-1])
    if "config" in payload:
        return Config.from_dict(payload["config"])
    if (ckpt_dir / "config.yaml").exists():
        return load_yaml(ckpt_dir / "config.yaml")
    return None


def load_train_and_eval_cfg(argv, defaults: dict = EVAL_GENIMA):
    overrides, flags = parse_cli(argv)
    if "config_name" in flags:
        eval_cfg = build_config(load_yaml(flags["config_name"]), overrides)
    else:
        eval_cfg = build_config(defaults, overrides)
    if not eval_cfg.get("controller_ckpt"):
        raise ValueError("controller_ckpt=<dir with latest.ckpt> is required")
    return eval_cfg, load_train_cfg(eval_cfg)


def build_controller_agent(train_cfg, eval_cfg):
    from genima_torch.control.policy import GenimaACTAgent, build_agent

    device = eval_cfg.get("device", "cuda")
    if train_cfg is not None and "method" in train_cfg:
        return build_agent(train_cfg, device=device)
    return GenimaACTAgent(device=device)


def load_eval_clip(eval_cfg, train_cfg, agent) -> None:
    """The frozen CLIP text tower from the file ``clip_weights`` names (the
    eval config's, else the saved train config's); the checkpoint does not
    hold it. A named file that is missing raises: a controller trained on
    pretrained CLIP embeddings would otherwise be evaluated on random ones."""
    path = eval_cfg.get("clip_weights")
    source = "eval config"
    if not path:
        path = (train_cfg or {}).get("clip_weights")
        source = "saved train config"
    if not path:
        return
    if not Path(path).exists():
        raise FileNotFoundError(
            f"clip_weights={path} (from the {source}) does not exist at eval time. The "
            "controller was trained with pretrained CLIP language embeddings; evaluating "
            "with random-init CLIP would silently break language conditioning. Provide the "
            "file or override clip_weights explicitly."
        )
    from genima_torch.weights.openai_clip import load_openai_clip_text

    load_openai_clip_text(agent.clip_params, path)
    print(f"loaded CLIP text tower from {path}")


def build_eval_env(eval_cfg, train_cfg, stats_path):
    from genima_torch.envs.rlbench import make_factory

    env_cfg = dict(eval_cfg.get("env", {}))
    env_cfg.setdefault("task", eval_cfg.task)
    env_cfg["episode_length"] = eval_cfg.get("episode_length", 200)
    factory = make_factory(env_cfg)
    train_cfg = train_cfg or {}
    return factory.make_eval_env(
        episode_length=eval_cfg.get("episode_length", 200),
        frame_stack=train_cfg.get("frame_stack", 1),
        action_sequence=train_cfg.get("action_sequence", 20),
        stats_path=str(stats_path),
        action_stats=None,  # reloaded from the JSON files beside the checkpoint
        proprio_stats=None,
        # the train config's: the wrapper changed the observation the
        # controller was trained on
        use_onehot_time=bool(train_cfg.get("use_onehot_time", False)),
        task_name=env_cfg.get("task"),
    )


def build_diffusion_agent(eval_cfg):
    node = dict(eval_cfg.get("diffusion_agent", {}))
    node.setdefault("_target_", "genima_torch.eval.agents.SDControlNetAgent")
    node.setdefault("diffusion_ckpt", eval_cfg.get("diffusion_ckpt"))
    node.setdefault("sd_ckpt", eval_cfg.get("sd_ckpt"))
    node.setdefault("resolution", eval_cfg.get("image_resolution", 512))
    node.setdefault("num_inference_steps", eval_cfg.get("num_diffusion_steps", 5))
    node.setdefault("guidance_scale", eval_cfg.get("guidance_scale", 0.0))
    node.setdefault("seed", eval_cfg.get("diffusion_seed", 2))
    node.setdefault("tokenizer_merges", eval_cfg.get("tokenizer_merges"))
    node.setdefault("autoencoder", eval_cfg.get("autoencoder", ""))
    node.setdefault("device", eval_cfg.get("device", "cuda"))
    node.setdefault(
        "backend",
        "fused" if eval_cfg.get("enable_xformers_memory_efficient_attention", True) else "xla",
    )
    return instantiate(node)


def main(argv=None, with_diffusion: bool = True, defaults: dict = EVAL_GENIMA):
    eval_cfg, train_cfg = load_train_and_eval_cfg(
        argv if argv is not None else sys.argv[1:], defaults)
    set_options = [k for k in _NOT_PORTED if eval_cfg.get(k)]
    if int(eval_cfg.get("eval_tensor_parallel", 0) or 1) > 1:
        set_options.append("eval_tensor_parallel")
    if set_options:
        raise NotImplementedError(f"not ported: {', '.join(set_options)}")
    no_ops = [k for k in NO_OP_KEYS if eval_cfg.get(k)]
    if no_ops:
        print(f"no effect here, as in the JAX package: {', '.join(no_ops)}")
    seed = eval_cfg.get("seed", 2)
    seed_everything(seed)

    n_par = int(eval_cfg.get("num_parallel_envs", 1))
    # the real-simulator parallel path builds its envs in child processes:
    # no env is made in this process for it
    real_parallel = n_par > 1 and eval_cfg.get("env", {}).get("factory", "rlbench") != "fake"
    eval_env = None if real_parallel else build_eval_env(
        eval_cfg, train_cfg, eval_cfg.controller_ckpt)
    controller_agent = build_controller_agent(train_cfg, eval_cfg)
    import torch

    controller_agent.init_params(
        torch.Generator(device=controller_agent.device).manual_seed(seed))
    load_eval_clip(eval_cfg, train_cfg, controller_agent)

    diffusion_agent = build_diffusion_agent(eval_cfg) if with_diffusion else None
    wandb_cfg = eval_cfg.get("wandb", {})
    logger = MetricLogger(
        Path(eval_cfg.controller_ckpt) / "eval_logs", use_wandb=wandb_cfg.get("use", False),
        wandb_kwargs={"project": wandb_cfg.get("project"), "name": wandb_cfg.get("name")})
    kwargs = dict(diffusion_agent=diffusion_agent,
                  cameras=eval_cfg.get("env", {}).get("cameras", CAMERAS), logger=logger,
                  tokenizer=load_tokenizer(eval_cfg.get("tokenizer_merges")))
    envs = []
    try:
        if n_par > 1:
            from genima_torch.eval.parallel import ParallelGenimaEvalWorkspace

            if real_parallel:
                from genima_torch.envs.subprocess_env import start_subprocess_envs

                # one simulator per process: each env in a spawned child,
                # their start-ups overlapping
                envs = start_subprocess_envs(build_eval_env, n_par, eval_cfg=eval_cfg,
                                             train_cfg=train_cfg,
                                             stats_path=str(eval_cfg.controller_ckpt))
            else:
                envs = [eval_env] + [build_eval_env(eval_cfg, train_cfg, eval_cfg.controller_ckpt)
                                     for _ in range(n_par - 1)]
            workspace = ParallelGenimaEvalWorkspace(eval_cfg, envs, controller_agent, **kwargs)
            try:
                return workspace.eval()
            finally:
                workspace.close()

        from genima_torch.eval.harness import GenimaEvalWorkspace

        return GenimaEvalWorkspace(eval_cfg, eval_env, controller_agent, **kwargs).eval()
    finally:
        for env in envs if real_parallel else []:
            env.close()
        logger.close()


if __name__ == "__main__":
    main()
