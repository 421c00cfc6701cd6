"""The small part of gymnasium's API the eval envs and wrappers use.

The port's envs do not depend on gymnasium: ``Env``, ``Wrapper``,
``ObservationWrapper`` and ``ActionWrapper`` here keep gymnasium's
``reset() -> (obs, info)`` / ``step() -> (obs, reward, terminated,
truncated, info)`` contract, ``.env``, ``.unwrapped`` and attribute
forwarding to the wrapped env; ``Box`` and ``Dict`` carry the shape, dtype
and bounds the wrappers read.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class Box:
    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low)
        self.shape = tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape)


class Dict:
    def __init__(self, spaces: dict):
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Box:
        return self.spaces[key]


class Env:
    observation_space: Any = None
    action_space: Any = None

    def reset(self, seed=None, options=None):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def close(self) -> None:
        """Release what the env holds (gymnasium's ``Env.close``)."""

    @property
    def unwrapped(self) -> "Env":
        return self


class Wrapper(Env):
    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def __getattr__(self, name: str) -> Any:
        # only reached for names the wrapper lacks; ``env`` itself must exist
        if name == "env" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.env, name)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        return self.env.step(action)

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped


class ObservationWrapper(Wrapper):
    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self.observation(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.observation(obs), reward, terminated, truncated, info

    def observation(self, observation):
        raise NotImplementedError


class ActionWrapper(Wrapper):
    def step(self, action):
        return self.env.step(self.action(action))

    def action(self, action):
        raise NotImplementedError
