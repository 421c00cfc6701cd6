"""The controller's env wrapper stack.

Counterpart of ``genima_tpu/envs/wrappers.py``, on the port's own
gymnasium-free bases (``envs/core.py``): JointNormalization ->
NormProprioFromStats -> TimeLimit -> (OnehotTime) -> FrameStack ->
ActionSequence -> AppendDemoInfo. The two normalization wrappers keep the
stats-JSON contract: with stats they write ``action_stats.json`` /
``proprio_stats.json`` beside the checkpoint, without they load them from
there (eval).
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict

import numpy as np

from genima_torch.envs import core
from genima_torch.envs.core import Box


def _persist_or_load_stats(stats: Dict | None, path: str | None, filename: str):
    """With stats, write them as JSON under ``path`` (when given); without,
    load them from there."""
    if stats is None and path is None:
        raise ValueError(f"either provide stats dictionary or a path containing {filename}")
    if stats is not None:
        if path is not None:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, filename), "w") as f:
                json.dump({"mean": np.asarray(stats["mean"]).tolist(),
                           "std": np.asarray(stats["std"]).tolist()}, f)
        return np.asarray(stats["mean"]), np.asarray(stats["std"])
    with open(os.path.join(path, filename)) as f:
        loaded = json.load(f)
    return np.asarray(loaded["mean"]), np.asarray(loaded["std"])


class JointNormalization(core.ActionWrapper):
    """De-normalizes incoming actions: z-score on all dims except the last
    (gripper). The policy lives in normalized action space."""

    def __init__(self, env, action_stats: Dict | None = None,
                 action_stats_path: str | None = None):
        super().__init__(env)
        self.action_space = Box(-np.inf, np.inf, shape=env.action_space.shape,
                                dtype=env.action_space.dtype)
        self.mean, self.std = _persist_or_load_stats(
            action_stats, action_stats_path, "action_stats.json")

    @staticmethod
    def transform_from_norm(action, mean, std):
        action = np.array(action, dtype=np.float32)
        action[..., :-1] = action[..., :-1] * std[:-1] + mean[:-1]
        return action

    @staticmethod
    def transform_to_norm(action, mean, std):
        action = np.array(action, dtype=np.float32)
        action[..., :-1] = (action[..., :-1] - mean[:-1]) / std[:-1]
        return action

    def action(self, action):
        return self.transform_from_norm(action, self.mean, self.std)


class NormProprioFromStats(core.ObservationWrapper):
    """Z-scores ``low_dim_state[1:]`` (element 0 is the raw gripper-open),
    epsilon 1e-10."""

    EPS = 1e-10

    def __init__(self, env, proprio_stats: Dict | None = None,
                 proprio_stats_path: str | None = None):
        super().__init__(env)
        self.mean, self.std = _persist_or_load_stats(
            proprio_stats, proprio_stats_path, "proprio_stats.json")

    @staticmethod
    def transform_to_norm(state, mean, std):
        state = np.array(state, dtype=np.float32)
        state[1:] = (state[1:] - mean[1:]) / (std[1:] + NormProprioFromStats.EPS)
        return state

    def observation(self, observation):
        observation = dict(observation)
        observation["low_dim_state"] = self.transform_to_norm(
            observation["low_dim_state"], self.mean, self.std)
        return observation


class TimeLimit(core.Wrapper):
    def __init__(self, env, max_episode_steps: int):
        super().__init__(env)
        self._max_episode_steps = max_episode_steps
        self._elapsed = 0

    def reset(self, **kwargs):
        self._elapsed = 0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed += 1
        if self._elapsed >= self._max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info


class OnehotTime(core.ObservationWrapper):
    """Appends a one-hot time index to low_dim_state."""

    def __init__(self, env, episode_length: int):
        super().__init__(env)
        self._episode_length = episode_length
        self._t = 0
        old = env.observation_space["low_dim_state"]
        new_spaces = dict(env.observation_space.spaces)
        new_spaces["low_dim_state"] = Box(-np.inf, np.inf,
                                          shape=(old.shape[0] + episode_length,))
        self.observation_space = core.Dict(new_spaces)

    def reset(self, **kwargs):
        self._t = 0
        return super().reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._t = min(self._t + 1, self._episode_length - 1)
        return self.observation(obs), reward, terminated, truncated, info

    def observation(self, observation):
        observation = dict(observation)
        onehot = np.zeros(self._episode_length, np.float32)
        onehot[self._t] = 1.0
        observation["low_dim_state"] = np.concatenate([observation["low_dim_state"], onehot])
        return observation


class FrameStack(core.Wrapper):
    """Stacks the last k observations on a new leading axis per key."""

    def __init__(self, env, k: int):
        super().__init__(env)
        self._k = k
        self._frames: dict[str, deque] = {}
        new_spaces = {}
        for key, space in env.observation_space.spaces.items():
            if np.issubdtype(space.dtype, np.floating):
                low, high = -np.inf, np.inf
            else:
                low, high = space.low.min(), space.high.max()
            new_spaces[key] = Box(low, high, shape=(k, *space.shape), dtype=space.dtype)
        self.observation_space = core.Dict(new_spaces)

    def _stacked(self):
        return {k: np.stack(v) for k, v in self._frames.items()}

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        self._frames = {k: deque([v] * self._k, maxlen=self._k) for k, v in obs.items()}
        return self._stacked(), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        for k, v in obs.items():
            self._frames[k].append(v)
        return self._stacked(), reward, terminated, truncated, info


class ActionSequence(core.Wrapper):
    """Executes a whole (T, A) action chunk per policy call, returning the
    final observation and the summed reward."""

    def __init__(self, env, sequence_length: int):
        super().__init__(env)
        self._seq = sequence_length
        self.action_space = Box(-np.inf, np.inf, shape=(sequence_length, *env.action_space.shape))

    def step(self, actions):
        if len(actions) > self._seq:
            raise ValueError(f"chunk of {len(actions)} exceeds action_sequence {self._seq}")
        total_reward = 0.0
        terminated = truncated = False
        obs, info = None, {}
        for action in actions:
            obs, reward, terminated, truncated, info = self.env.step(action)
            total_reward += reward
            if terminated or truncated:
                break
        return obs, total_reward, terminated, truncated, info


class AppendDemoInfo(core.Wrapper):
    """Adds the ``demo`` flag to info."""

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        info.setdefault("demo", 0)
        return obs, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        info.setdefault("demo", 0)
        return obs, reward, terminated, truncated, info


def wrap_env(env, *, episode_length: int, frame_stack: int = 1, action_sequence: int = 20,
             action_stats: Dict | None = None, proprio_stats: Dict | None = None,
             stats_path: str | None = None, use_onehot_time: bool = False):
    """The wrapper stack in order."""
    env = JointNormalization(env, action_stats, stats_path)
    env = NormProprioFromStats(env, proprio_stats, stats_path)
    env = TimeLimit(env, episode_length)
    if use_onehot_time:
        env = OnehotTime(env, episode_length)
    env = FrameStack(env, frame_stack)
    env = ActionSequence(env, action_sequence)
    return AppendDemoInfo(env)


def rewrap_obs(env, raw_obs, wrapped_obs):
    """Re-apply the full observation wrapper chain to an unwrapped obs.

    ``reset_to_demo`` returns an unwrapped obs: every observation
    transformation in ``env``'s chain is applied innermost first, and
    FrameStack's buffer is refilled so later steps do not mix pre-demo
    frames into the stack."""
    if raw_obs is None:
        return wrapped_obs
    chain = []
    e = env
    while isinstance(e, core.Wrapper):
        chain.append(e)
        e = e.env
    obs = dict(raw_obs)
    stacked = None
    for w in reversed(chain):  # innermost wrapper first
        if isinstance(w, core.ObservationWrapper):
            obs = w.observation(obs)
        elif isinstance(w, FrameStack):
            w._frames = {k: deque([v] * w._k, maxlen=w._k) for k, v in obs.items()}
            stacked = w._stacked()
            obs = stacked
    if stacked is None:  # no FrameStack in the chain: stack manually
        rgb = next(k for k in wrapped_obs if k.endswith("_rgb"))
        fs = wrapped_obs[rgb].shape[0]
        return {k: np.stack([v] * fs) for k, v in obs.items()}
    return obs
