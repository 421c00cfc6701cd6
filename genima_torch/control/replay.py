"""Epoch-based episodic replay buffer for BC training.

A copy of ``genima_tpu/control/replay.py`` (numpy only): the same batches
under the same seed, and under several processes the same strided slice
of each epoch's order per rank. It rebuilds the reference's
``EpochReplayBuffer`` (``controller/utils/dataloader.py:16-97``, extending
RoboBase's uniform buffer):

* episodic storage of observations / actions / rewards / language tokens,
* per-sample: frame-stacked observation window (clipped at the episode
  start, ``dataloader.py:25-40``), the next ``action_sequence`` actions as
  the chunk target with ``is_pad`` marking steps past the episode end (the
  ActionSequence convention), n-step reward with a discount vector,
* epoch semantics: every ``__iter__`` reshuffles ALL global indices and
  yields batches until the epoch is exhausted (``dataloader.py:75-97``) —
  epoch-exact coverage rather than uniform-with-replacement,
* batches come out as a dict of stacked numpy arrays, which the trainer
  copies to the device;
* with more than one process (``core.distributed``), each rank takes the
  strided slice ``order[rank::world]`` of the same permutation; with
  ``drop_last`` every rank then yields the same number of batches (that of
  the smallest slice), so data-parallel updates stay paired.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from genima_torch.core.distributed import process_count, process_index


@dataclasses.dataclass
class Episode:
    images: np.ndarray  # (T, V, H, W, 3) uint8
    low_dim_state: np.ndarray  # (T, D) float32
    actions: np.ndarray  # (T, A) float32 (normalized)
    rewards: np.ndarray  # (T,) float32
    lang_tokens: np.ndarray  # (77,) int32

    def __len__(self) -> int:
        return len(self.actions)


class EpochReplayBuffer:
    def __init__(
        self,
        batch_size: int = 8,
        action_sequence: int = 20,
        frame_stack: int = 1,
        nstep: int = 1,
        discount: float = 0.99,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.batch_size = batch_size
        self.action_sequence = action_sequence
        self.frame_stack = frame_stack
        self.nstep = nstep
        self.discount = discount
        self.drop_last = drop_last
        self._episodes: list[Episode] = []
        self._index: list[tuple[int, int]] = []  # (episode_idx, t)
        self._rng = np.random.RandomState(seed)

    def add_episode(
        self,
        images: np.ndarray,
        low_dim_state: np.ndarray,
        actions: np.ndarray,
        rewards: np.ndarray | None = None,
        lang_tokens: np.ndarray | None = None,
    ) -> None:
        t = len(actions)
        assert len(images) == t and len(low_dim_state) == t
        if rewards is None:
            rewards = np.zeros(t, np.float32)
            rewards[-1] = 1.0  # demo success at the terminal step
        if lang_tokens is None:
            lang_tokens = np.zeros(77, np.int32)
        ep = Episode(
            np.asarray(images),
            np.asarray(low_dim_state, np.float32),
            np.asarray(actions, np.float32),
            np.asarray(rewards, np.float32),
            np.asarray(lang_tokens, np.int32),
        )
        ep_idx = len(self._episodes)
        self._episodes.append(ep)
        self._index.extend((ep_idx, t_) for t_ in range(t))

    def __len__(self) -> int:
        return len(self._index)

    @property
    def num_episodes(self) -> int:
        return len(self._episodes)

    def _sample_one(self, ep_idx: int, t: int) -> dict:
        ep = self._episodes[ep_idx]
        T = len(ep)
        fs, seq = self.frame_stack, self.action_sequence

        # frame-stack window, clipped at episode start
        frame_ids = np.clip(np.arange(t - fs + 1, t + 1), 0, T - 1)
        images = ep.images[frame_ids]  # (fs, V, H, W, 3)
        v = images.shape[1]
        images = images.reshape(fs * v, *images.shape[2:])  # views*frames axis
        qpos = ep.low_dim_state[frame_ids].reshape(-1)  # (fs*D,)

        # action chunk with padding past the episode end
        act_ids = np.arange(t, t + seq)
        is_pad = act_ids >= T
        act_ids = np.clip(act_ids, 0, T - 1)
        actions = ep.actions[act_ids]

        # n-step discounted reward (dataloader.py:49-62)
        r_ids = np.clip(np.arange(t, t + self.nstep), 0, T - 1)
        valid = np.arange(t, t + self.nstep) < T
        disc = self.discount ** np.arange(self.nstep)
        reward = float(np.sum(ep.rewards[r_ids] * disc * valid))

        return {
            "images": images.astype(np.float32),
            "qpos": qpos.astype(np.float32),
            "actions": actions,
            "is_pad": is_pad,
            "reward": np.float32(reward),
            "lang_tokens": ep.lang_tokens,
        }

    def sample(self, batch_size: int | None = None) -> dict:
        """Uniform sample (the underlying UniformReplayBuffer behavior)."""
        bs = batch_size or self.batch_size
        picks = self._rng.randint(0, len(self._index), bs)
        return self._collate([self._sample_one(*self._index[i]) for i in picks])

    @staticmethod
    def _collate(samples: list[dict]) -> dict:
        return {
            k: np.stack([s[k] for s in samples]) for k in samples[0]
        }

    def __iter__(self) -> Iterator[dict]:
        """One epoch: shuffled pass over every index."""
        order = self._rng.permutation(len(self._index))
        count = process_count()
        if count > 1:
            n_full = len(order) // count  # the smallest rank's slice
            order = order[process_index()::count]
            if self.drop_last:
                order = order[:n_full - n_full % self.batch_size]
        for start in range(0, len(order), self.batch_size):
            chunk = order[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield self._collate(
                [self._sample_one(*self._index[i]) for i in chunk]
            )
