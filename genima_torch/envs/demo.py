"""Demonstration handling: DemoStep format, action extraction, statistics.

A copy of ``genima_tpu/envs/demo.py`` (numpy only). It rebuilds the
reference's demo plumbing
(``controller/env/rlbench_utils.py:20-81``, ``controller/env/rlbench.py:317-383``):

* ``DemoStep`` — the common per-timestep record,
* action extraction between consecutive steps: the *next* step's
  ``joint_position_action`` (the reference asserts its presence in fresh
  datasets, ``rlbench.py:196-206``) or raw joint positions, plus a one-hot
  gripper; out-of-bounds actions are rejected (returns None),
* action statistics with the gripper dim hard-coded to mean 1/2 std 1/6
  (gripper is LAST in actions, FIRST in low_dim_state),
* demo -> normalized training episode conversion (the rescale +
  load-into-replay path).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

import numpy as np


class ActionModeType(enum.Enum):
    """Reference robobase enum (``rlbench_utils.py:164-215``): Genima uses
    absolute JOINT_POSITION; END_EFFECTOR_POSE exists but demo rescaling for
    it is unimplemented in the reference too (``rlbench.py:327-330``)."""

    JOINT_POSITION = "JOINT_POSITION"
    END_EFFECTOR_POSE = "END_EFFECTOR_POSE"


@dataclasses.dataclass
class DemoStep:
    joint_positions: np.ndarray  # (7,)
    gripper_open: float
    observation: dict  # {"{cam}_rgb": (3,H,W) uint8, "low_dim_state": (D,)}
    gripper_matrix: np.ndarray | None = None
    misc: dict = dataclasses.field(default_factory=dict)


def observations_to_action_with_onehot_gripper(
    current: DemoStep, next_step: DemoStep, action_low=None, action_high=None
) -> np.ndarray | None:
    """Action linking two sequential observations
    (reference ``rlbench_utils.py:50-81``)."""
    joints = next_step.misc.get("joint_position_action")
    if joints is not None:
        joints = np.asarray(joints)[:-1]
    else:
        joints = np.asarray(next_step.joint_positions)
    action = np.concatenate(
        [joints, [1.0 if next_step.gripper_open == 1 else 0.0]]
    ).astype(np.float32)
    if action_low is not None and (
        np.any(action[:-1] > action_high[:-1]) or np.any(action[:-1] < action_low[:-1])
    ):
        return None
    return action


def extract_demo_actions(
    demo: List[DemoStep], action_low=None, action_high=None
) -> list[np.ndarray]:
    """Per-step actions for a demo (one fewer than observations)."""
    actions = []
    for cur, nxt in zip(demo[:-1], demo[1:]):
        a = observations_to_action_with_onehot_gripper(
            cur, nxt, action_low, action_high
        )
        if a is not None:
            actions.append(a)
    return actions


def compute_action_stats(demos: List[List[DemoStep]]) -> dict:
    """Mean/std/min/max of demo actions; gripper (last dim) hard-coded to
    mean 1/2, std 1/6 (robobase convention the reference inherits)."""
    actions = np.stack(
        [a for demo in demos for a in extract_demo_actions(demo)]
    )
    return {
        "mean": np.hstack([np.mean(actions, 0)[:-1], 1 / 2]),
        "std": np.hstack([np.std(actions, 0)[:-1], 1 / 6]),
        "max": np.hstack([np.max(actions, 0)[:-1], 1]),
        "min": np.hstack([np.min(actions, 0)[:-1], 0]),
    }


def compute_proprio_stats(demos: List[List[DemoStep]]) -> dict:
    """low_dim_state stats from demo actions with the gripper dim FIRST
    (reference ``rlbench.py:353-383``)."""
    actions = np.stack(
        [a for demo in demos for a in extract_demo_actions(demo)]
    )
    return {
        "mean": np.hstack([1 / 2, np.mean(actions, 0)[:-1]]),
        "std": np.hstack([1 / 6, np.std(actions, 0)[:-1]]),
        "max": np.hstack([1, np.max(actions, 0)[:-1]]),
        "min": np.hstack([0, np.min(actions, 0)[:-1]]),
    }


def demo_to_episode(
    demo: List[DemoStep],
    cameras: list[str],
    action_stats: dict,
    proprio_stats: dict,
    lang_tokens: np.ndarray | None = None,
    onehot_time_len: int | None = None,
) -> dict:
    """Convert a demo into normalized replay-buffer arrays.

    Returns dict with images (T, V, H, W, 3) uint8, low_dim_state (T, D)
    normalized, actions (T, A) normalized, rewards (T,), lang_tokens (77,).
    Mirrors the reference's demo ingestion through the wrapper stack
    (``rlbench_utils.py:220-254`` + ``rlbench.py:322-336``).
    """
    from genima_torch.envs.wrappers import JointNormalization, NormProprioFromStats

    raw_actions = extract_demo_actions(demo)
    T = len(raw_actions)
    actions = np.stack(
        [
            JointNormalization.transform_to_norm(
                a, action_stats["mean"], action_stats["std"]
            )
            for a in raw_actions
        ]
    )
    images, low_dims = [], []
    for t, step in enumerate(demo[:T]):
        obs = step.observation
        # CHW (reference obs layout) -> HWC per camera
        views = np.stack(
            [np.transpose(obs[f"{cam}_rgb"], (1, 2, 0)) for cam in cameras]
        )
        images.append(views)
        low_dim = NormProprioFromStats.transform_to_norm(
            obs["low_dim_state"], proprio_stats["mean"], proprio_stats["std"]
        )
        if onehot_time_len:
            # demos go through the same wrapper stack as rollouts in the
            # reference (rlbench_utils.py:220-254); OnehotTime appends the
            # time index AFTER proprio normalization (wrapper order)
            onehot = np.zeros(onehot_time_len, np.float32)
            onehot[min(t, onehot_time_len - 1)] = 1.0
            low_dim = np.concatenate([low_dim, onehot])
        low_dims.append(low_dim)
    rewards = np.zeros(T, np.float32)
    rewards[-1] = 1.0
    return {
        "images": np.stack(images),
        "low_dim_state": np.stack(low_dims).astype(np.float32),
        "actions": actions.astype(np.float32),
        "rewards": rewards,
        "lang_tokens": (
            lang_tokens if lang_tokens is not None else np.zeros(77, np.int32)
        ),
    }


def demo_description(demo: List[DemoStep]) -> str:
    """The episode's own variation description, from the first step's misc
    (the reference stamps ``misc["descriptions"]`` on every timestep at
    conversion, ``rlbench_utils.py:16-27``, and tokenizes it per obs,
    ``rlbench_utils.py:156-157``)."""
    for step in demo:
        desc = step.misc.get("descriptions")
        if desc:
            return desc[0] if isinstance(desc, (list, tuple)) else str(desc)
    return ""


def load_demos_into_replay(
    buffer,
    demos: List[List[DemoStep]],
    cameras: list[str],
    action_stats: dict,
    proprio_stats: dict,
    lang_tokens: np.ndarray | None = None,
    tokenizer=None,
    onehot_time_len: int | None = None,
) -> None:
    """Ingest demos, tokenizing EACH episode's own description into its
    lang_tokens (per-episode language conditioning; with task variations or
    multi-task training every episode may carry different text —
    reference ``rlbench_utils.py:156-157``). A fixed ``lang_tokens`` array
    overrides per-episode tokenization when given (tests / no tokenizer)."""
    token_cache: dict[str, np.ndarray] = {}
    for demo in demos:
        ep_tokens = lang_tokens
        if ep_tokens is None and tokenizer is not None:
            desc = demo_description(demo)
            if desc not in token_cache:
                token_cache[desc] = np.asarray(
                    tokenizer([desc])[0], np.int32
                )
            ep_tokens = token_cache[desc]
        ep = demo_to_episode(
            demo, cameras, action_stats, proprio_stats, ep_tokens,
            onehot_time_len=onehot_time_len,
        )
        buffer.add_episode(
            images=ep["images"],
            low_dim_state=ep["low_dim_state"],
            actions=ep["actions"],
            rewards=ep["rewards"],
            lang_tokens=ep["lang_tokens"],
        )
