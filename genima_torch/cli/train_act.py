"""Controller (ACT) training CLI, hydra-style ``key=value`` overrides:

    python -m genima_torch.cli.train_act env.factory=fake work_dir=./ckpt [device=cpu]

Counterpart of ``genima_tpu/cli/train_act.py`` and its config
``genima_tpu/cfgs/controller.yaml``, whose defaults ``CONTROLLER`` keeps as
Python data (``--config-name F`` reads a YAML file instead, with PyYAML).
``device=`` picks the card (``cuda``, the default) or ``cpu``; the agent
computes in f32, as the JAX agent does by default. ``env.factory=fake``
collects demos from the fake env, ``env.factory=rendered`` reads them from
the rendered dataset at ``env.dataset_root`` (closed-loop envs from
``env.eval_env_factory=fake``); ``env.factory=rlbench`` (with
``env.colosseum_use`` / ``env.colosseum_task_config``) meets the simulator
gate and raises, as the JAX CLI does without RLBench.

Data-parallel: ``torchrun --nproc_per_node=N -m genima_torch.cli.train_act
...`` trains one process per GPU (``device=cuda`` becomes
``cuda:<LOCAL_RANK>``), each at ``batch_size`` on its slice of the demos,
the gradients averaged over the group (``control/trainer.py``). JAX's rule
``n_dev > 1 and batch_size % n_dev == 0`` is not copied: the port averages
whenever more than one process trains, whatever the batch.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from genima_torch.control.policy import build_agent
from genima_torch.control.trainer import ControllerWorkspace
from genima_torch.core import distributed as dist
from genima_torch.core.config import build_config, load_yaml, parse_cli
from genima_torch.core.logging import MetricLogger
from genima_torch.core.mesh import process_mesh
from genima_torch.core.rng import seed_everything

CONTROLLER = {
    "work_dir": "./exp_local/genima_controller",
    "device": "cuda",
    "pixels": True,
    "visual_observation_shape": [256, 256],
    "num_train_epochs": 1000,
    "checkpoint_every": 10,
    "num_checkpoints": 3,
    "experiment_name": "genima_controller",
    "seed": 0,
    "batch_size": 8,
    "frame_stack": 1,
    "action_sequence": 20,
    "use_onehot_time": False,
    "nstep": 1,
    "num_demos": 25,
    "env": {
        "factory": "rlbench",
        "train_tasks": ["take_lid_off_saucepan"],
        "task": "take_lid_off_saucepan",
        "demo_cache_dir": None,
        "dataset_root": "/tmp/rlbench_rnd_bg",
        "episode_length": 200,
        "cameras": ["wrist", "front", "right_shoulder", "left_shoulder"],
        "image_size": 256,
        "headless": True,
        "colosseum_use": False,
        "colosseum_task_config": None,
        "action_mode": "JOINT_POSITION",
    },
    "method": {
        "_target_": "genima_torch.control.policy.GenimaACTAgent",
        "lr": 5.0e-05,
        "lr_backbone": 1.0e-05,
        "weight_decay": 0.0001,
        "actor_grad_clip": None,
        "num_views": 4,
        "frame_stack": "${frame_stack}",
        "image_size": 256,
        "data_augmentation": True,
        "act_cfg": {
            "hidden_dim": 256, "enc_layers": 4, "dec_layers": 6, "dim_feedforward": 2048,
            "dropout": 0.1, "nheads": 8, "num_queries": "${action_sequence}", "state_dim": 8,
            "action_dim": 8, "latent_dim": 32, "kl_weight": 10.0, "use_lang_cond": True,
            "lang_dim": 512,
        },
    },
    "tokenizer_merges": None,  # CLIP BPE merges (else the vendored table)
    "clip_weights": None,  # an OpenAI CLIP checkpoint (text tower)
    "resnet_weights": None,  # torchvision resnet18 weights
    "wandb": {"use": False, "project": "genima", "name": "train_act"},
    "tb": {"use": False},
}


def load_agent_pretrained(agent, cfg, state, resumed: bool = False):
    """Pretrained weights from files: a torchvision ``resnet18`` into the
    backbone (not on resume: the checkpoint holds the trained one) and the
    OpenAI CLIP text tower, which no checkpoint holds. Returns the train
    state over the loaded modules, with fresh optimizer state (the JAX
    package's, before any update)."""
    from genima_torch.weights.load_pretrained import load_torchvision_resnet
    from genima_torch.weights.openai_clip import load_openai_clip_text

    resnet = cfg.get("resnet_weights")
    if resumed and resnet:
        print("resumed from a checkpoint: keeping the checkpointed ResNet backbone "
              f"(ignoring resnet_weights={resnet})")
    elif resnet and Path(resnet).exists():
        load_torchvision_resnet(state.params["encoder"].backbone, resnet)
        print(f"loaded resnet18 backbone from {resnet}")
    clip = cfg.get("clip_weights")
    if clip and Path(clip).exists():
        load_openai_clip_text(agent.clip_params, clip)
        print(f"loaded CLIP text tower from {clip}")
    return agent.create_state(state.params, agent.clip_params)


def main(argv=None) -> ControllerWorkspace:
    overrides, flags = parse_cli(argv if argv is not None else sys.argv[1:])
    defaults = load_yaml(flags["config_name"]) if "config_name" in flags else CONTROLLER
    cfg = build_config(defaults, overrides)
    device = dist.process_device(cfg.get("device", "cuda"))
    dist.initialize(device=device)  # a no-op without a launcher
    seed_everything(cfg.get("seed", 0))
    from genima_torch.envs.rlbench import make_factory

    factory = make_factory(dict(cfg.env))
    agent = build_agent(cfg, device=device, dtype=torch.float32)
    work_dir = Path(cfg.get("work_dir") or "./exp_local/genima_controller")
    logger = MetricLogger(
        work_dir,
        use_tb=cfg.get("tb", {}).get("use", False),
        use_wandb=cfg.get("wandb", {}).get("use", False),
        wandb_kwargs={"project": cfg.get("wandb", {}).get("project"),
                      "name": cfg.get("wandb", {}).get("name")},
    )
    mesh = process_mesh(agent.device) if dist.process_count() > 1 else None
    workspace = ControllerWorkspace(cfg, agent, factory, work_dir,
                                    num_demos=cfg.get("num_demos", 25), mesh=mesh, logger=logger)
    workspace.state = load_agent_pretrained(agent, cfg, workspace.state,
                                            resumed=workspace.resumed)
    workspace.train()
    return workspace


if __name__ == "__main__":
    main()
