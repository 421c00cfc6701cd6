"""ACT-only evaluation CLI (no diffusion stage):

    python -m genima_torch.cli.eval_act controller_ckpt=/path/ckpt env.factory=fake

Counterpart of ``genima_tpu/cli/eval_act.py`` and its config
``genima_tpu/cfgs/eval_act.yaml``, kept here as ``EVAL_ACT``; runs
``eval_genima.main`` without the diffusion agent.
"""

from __future__ import annotations

import sys

from genima_torch.cli.eval_genima import CAMERAS, main as eval_main

EVAL_ACT = {
    "controller_ckpt": None,
    "device": "cuda",
    "task": "take_lid_off_saucepan",
    "episode_length": 200,
    "eval_type": "latest",
    "train_cfg_path": "${controller_ckpt}/config.yaml",
    "num_eval_episodes": 50,
    "num_parallel_envs": 1,  # > 1: lockstep-batched ACT over N envs
    "dataset_root": None,
    "save_video": False,
    "video_fps": 30,
    "headless": True,
    "save_image_path": None,
    "seed": 2,
    "env": {"factory": "rlbench", "cameras": list(CAMERAS), "image_size": 256},
    "colosseum_use": False,
    "colosseum_task_config": None,
    "execution_horizon": 20,
    "tokenizer_merges": None,
    "clip_weights": None,  # defaults to the saved train config's clip_weights
    "wandb": {"use": False, "project": "genima", "name": "eval_act"},
}


def main(argv=None):
    return eval_main(argv if argv is not None else sys.argv[1:], with_diffusion=False,
                     defaults=EVAL_ACT)


if __name__ == "__main__":
    main()
