"""Demo factory over an on-disk (rendered) RLBench dataset tree.

Counterpart of ``genima_tpu/envs/rendered.py``. The reference's controller
trains on demos loaded from disk: ``train_act`` points ``env.dataset_root``
at a rendered dataset (the output of ``render/render_data.py``) and
RoboBase loads the saved demos (``controller/env/rlbench.py:301-383``).
This factory is that flow for any RLBench-layout tree, those written by
``envs.export.export_demos_rlbench_format`` and then drawn on by
``rendering.render_data.RenderData`` included: the demos' camera images are
the dataset's PNGs (for a rendered tree, scene plus target spheres, the
images the diffusion agent makes at eval time).

It offers what ``ControllerWorkspace`` takes from the live factories
(``collect_or_fetch_demos``, the stats, ``load_demos_into_replay``,
``make_eval_env``); closed-loop eval needs a live env, which an inner env
factory (the fake one here) provides. PIL is imported where PNGs are read.
"""

from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Sequence

import numpy as np

from genima_torch.envs.demo import DemoStep, compute_action_stats, compute_proprio_stats


def _natsort_key(name: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def load_episode_as_demo(ep_dir: Path, cameras: Sequence[str],
                         description: str = "") -> list[DemoStep]:
    """One ``episode<N>`` dir -> DemoStep list: images from the dir's
    ``{cam}_rgb`` PNGs (CHW), state and actions from ``low_dim_obs.pkl``."""
    from PIL import Image

    with open(ep_dir / "low_dim_obs.pkl", "rb") as f:
        low_dim = pickle.load(f)

    def _get(rec, attr, default=None):
        if isinstance(rec, dict):
            return rec.get(attr, default)
        return getattr(rec, attr, default)

    steps = []
    for t, rec in enumerate(low_dim):
        if not all((ep_dir / f"{cam}_rgb" / f"{t}.png").exists() for cam in cameras):
            # rendered trees drop the final frame (no t+horizon target,
            # reference render_data.py:235-243): stop at the last full one
            break
        obs = {}
        for cam in cameras:
            with Image.open(ep_dir / f"{cam}_rgb" / f"{t}.png") as img:
                obs[f"{cam}_rgb"] = np.transpose(np.asarray(img.convert("RGB")), (2, 0, 1))
        joints = np.asarray(_get(rec, "joint_positions"), np.float32)
        gripper_open = float(_get(rec, "gripper_open"))
        obs["low_dim_state"] = np.concatenate([[gripper_open], joints]).astype(np.float32)
        misc = dict(_get(rec, "misc", {}) or {})
        misc.setdefault("descriptions", description)
        steps.append(DemoStep(
            joint_positions=joints,
            gripper_open=gripper_open,
            observation=obs,
            gripper_matrix=_get(rec, "gripper_matrix"),
            misc=misc,
        ))
    return steps


class RenderedDemoFactory:
    """``collect_or_fetch_demos`` reads episodes from disk instead of
    stepping a simulator; eval envs come from ``eval_factory``."""

    def __init__(
        self,
        dataset_root: str | Path,
        task_names: Sequence[str] | None = None,
        task_name: str | None = None,
        variation: int = 0,
        cameras: Sequence[str] = ("wrist", "front", "right_shoulder", "left_shoulder"),
        eval_factory=None,
    ):
        self.dataset_root = Path(dataset_root)
        self.task_names = list(task_names if task_names else [task_name or "fake_reach"])
        self.variation = variation
        self.cameras = list(cameras)
        self.eval_factory = eval_factory
        self._raw_demos = None
        self.action_stats = None
        self.proprio_stats = None

    def _episodes_dir(self, task: str) -> Path:
        var = f"variation{self.variation}" if self.variation != -1 else "all_variations"
        return self.dataset_root / task / var / "episodes"

    def _description(self, task: str) -> str:
        desc_file = self._episodes_dir(task).parent / "variation_descriptions.pkl"
        if desc_file.exists():
            # a file of the dataset tree this factory was pointed at
            with open(desc_file, "rb") as f:
                descs = pickle.load(f)
            if descs:
                return str(descs[0])
        return task.replace("_", " ")

    def collect_or_fetch_demos(self, num_demos: int):
        self._raw_demos = []
        for task in self.task_names:
            eps_dir = self._episodes_dir(task)
            episodes = sorted((d for d in eps_dir.iterdir() if d.is_dir()),
                              key=lambda p: _natsort_key(p.name))[:num_demos]
            if not episodes:
                raise FileNotFoundError(f"no episodes under {eps_dir}")
            desc = self._description(task)
            for ep in episodes:
                self._raw_demos.append(load_episode_as_demo(ep, self.cameras, desc))
            print(f"Loaded {len(episodes)} rendered demos for {task} from {eps_dir}")
        self.action_stats = compute_action_stats(self._raw_demos)
        self.proprio_stats = compute_proprio_stats(self._raw_demos)
        return self._raw_demos

    def load_demos_into_replay(self, buffer, cameras=None, lang_tokens=None, tokenizer=None,
                               onehot_time_len=None) -> None:
        from genima_torch.envs.demo import load_demos_into_replay

        if self._raw_demos is None:
            raise RuntimeError("collect_or_fetch_demos first")
        load_demos_into_replay(
            buffer, self._raw_demos, list(cameras or self.cameras), self.action_stats,
            self.proprio_stats, lang_tokens=lang_tokens, tokenizer=tokenizer,
            onehot_time_len=onehot_time_len,
        )

    def make_eval_env(self, *, action_stats=None, proprio_stats=None, **kw):
        if self.eval_factory is None:
            raise RuntimeError(
                "RenderedDemoFactory has no live env: pass eval_factory= (the fake "
                "factory, env.eval_env_factory=fake) to evaluate closed-loop")
        return self.eval_factory.make_eval_env(
            action_stats=action_stats if action_stats is not None else self.action_stats,
            proprio_stats=proprio_stats if proprio_stats is not None else self.proprio_stats,
            **kw,
        )
