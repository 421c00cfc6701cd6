"""Controller training workspace: BC of the ACT agent on demonstrations.

Counterpart of ``genima_tpu/control/trainer.py`` (the reference's
``ControllerWorkspace``, ``controller/train_act.py``), on one device or
data-parallel over a process group (``mesh=``, one process per GPU):

* demos collected through the env factory, pooled over its tasks; the
  action and proprio stats written as JSON beside the checkpoints (by the
  eval env the factory makes once with ``stats_path``);
* each episode's own description tokenized into its ``lang_tokens``; with
  ``clip_weights`` set, the tokenizer's hash stand-in is refused;
* the demos in the epoch replay buffer; seeded init, then resume from
  ``latest.ckpt`` when the work dir holds one: params only, with fresh
  optimizer state, as the JAX package resumes;
* epochs of updates; an update that raises is logged and skipped, as the
  reference does (``train_act.py:228-230``), and kept in
  ``update_failures``; epoch means of the loss parts logged;
* every ``checkpoint_every`` epochs and at the last, ``latest.ckpt``
  rotated and written by the async writer, and ``config.yaml`` beside it;
* SIGTERM (``PreemptionGuard``): a snapshot at the end of the epoch, then
  a clean stop.

Batches go to the device through pinned memory. The random draws of each
update come from one ``torch.Generator`` on the agent's device, seeded from
``seed + 7``.

With ``mesh`` (``core/mesh.py::process_mesh``) each rank trains on its
strided slice of every epoch's order at ``batch_size`` (ragged tails
dropped, so every rank makes the same updates), draws at the global batch
and keeps its rows, and averages gradients over the group; rank 0 alone
writes the stats, the checkpoints, ``config.yaml`` and the metrics.
SIGTERM on any rank stops every rank at the same epoch.
"""

from __future__ import annotations

import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from genima_torch.core import checkpoint as ckpt
from genima_torch.core import distributed as dist
from genima_torch.core.config import save_yaml
from genima_torch.core.logging import MetricLogger
from genima_torch.core.preemption import PreemptionGuard
from genima_torch.control.replay import EpochReplayBuffer
from genima_torch.data.tokenizer import load_tokenizer

BATCH_KEYS = ("images", "qpos", "actions", "is_pad", "lang_tokens")


def controller_tokenizer(cfg):
    """The tokenizer the demos' descriptions go through. With real CLIP
    weights (``clip_weights``) the hash stand-in would silently break the
    language conditioning, so a missing merge table raises."""
    clip_w = cfg.get("clip_weights")
    try:
        return load_tokenizer(cfg.get("tokenizer_merges"), allow_hash_fallback=not clip_w,
                              model_dir=Path(clip_w).parent if clip_w else None)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"{e}\nclip_weights={clip_w} is set: training a controller with real CLIP "
            "embeddings but hash-tokenized language would silently break conditioning. "
            "Pass tokenizer_merges= or place merges.txt alongside the CLIP checkpoint."
        ) from e


class ControllerWorkspace:
    def __init__(self, cfg, agent, factory, work_dir: str | Path, num_demos: int = 25,
                 mesh=None, logger: Optional[MetricLogger] = None):
        self.cfg = cfg
        self.agent = agent
        self.factory = factory
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.mesh = mesh
        self.logger = logger or MetricLogger(self.work_dir)
        self.update_failures: list[str] = []

        demos = factory.collect_or_fetch_demos(num_demos)
        if not demos:
            raise RuntimeError("no demonstrations collected")
        tokenizer = controller_tokenizer(cfg)
        # the eval env, made once, writes the stats JSON files (one writer)
        if dist.is_main_process():
            factory.make_eval_env(
                frame_stack=cfg.get("frame_stack", 1),
                action_sequence=cfg.get("action_sequence", 20),
                stats_path=str(self.work_dir),
                use_onehot_time=cfg.get("use_onehot_time", False),
            ).close()

        self.replay = EpochReplayBuffer(
            batch_size=cfg.get("batch_size", 8),
            action_sequence=cfg.get("action_sequence", 20),
            frame_stack=cfg.get("frame_stack", 1),
            nstep=cfg.get("nstep", 1),
            # data-parallel batches must pair up across ranks: drop ragged tails
            drop_last=mesh is not None,
        )
        onehot_len = (int(cfg["env"].get("episode_length", 200))
                      if cfg.get("use_onehot_time", False) else None)
        factory.load_demos_into_replay(self.replay, tokenizer=tokenizer,
                                       onehot_time_len=onehot_len)

        seed = cfg.get("seed", 0)
        params, clip = agent.init_params(
            torch.Generator(device=agent.device).manual_seed(seed))
        self.state = agent.create_state(params, clip)
        self.generator = torch.Generator(device=agent.device).manual_seed(seed + 7)
        self._epoch = 0
        self._num_iters = 0
        self._writer: Optional[ckpt.AsyncCheckpointer] = None
        self._maybe_resume()

    # -- checkpoints ------------------------------------------------------------------

    def _maybe_resume(self) -> None:
        self.resumed = False
        latest = self.work_dir / ckpt.LATEST_NAME
        if latest.exists():
            payload = ckpt.load_epoch_checkpoint(latest)
            self._epoch = int(payload["epoch"])
            self._num_iters = int(payload["num_iters"])
            params = self.agent.load_params(payload["agent"])
            self.state = self.agent.create_state(params, self.agent.clip_params)
            self.resumed = True
            print(f"Resumed from {latest} at epoch {self._epoch}")

    def _config_dict(self) -> dict:
        return self.cfg.to_dict() if hasattr(self.cfg, "to_dict") else dict(self.cfg)

    def save_snapshot(self) -> None:
        """Rotate and write ``latest.ckpt`` on the writer thread (the master
        weights are copied before this returns), and ``config.yaml``."""
        cfg_dict = self._config_dict()
        if self._writer is None:
            self._writer = ckpt.AsyncCheckpointer()
        self._writer.submit(
            ckpt.save_epoch_checkpoint, self.work_dir, epoch=self._epoch,
            num_iters=self._num_iters, agent_params=self.state.tree(), config=cfg_dict,
            num_checkpoints=self.cfg.get("num_checkpoints", 3))
        if dist.is_main_process():
            save_yaml(cfg_dict, self.work_dir / "config.yaml")

    # -- training ---------------------------------------------------------------------

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k in BATCH_KEYS:
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if self.agent.device.type == "cuda":
                out[k] = t.pin_memory().to(self.agent.device, non_blocking=True)
            else:
                out[k] = t.to(self.agent.device)
        return out

    def train(self, preemption: Optional[PreemptionGuard] = None) -> None:
        """Train to ``num_train_epochs``. A caller's ``preemption`` guard is
        polled, not installed; without one, SIGTERM is watched here."""
        num_epochs = self.cfg.get("num_train_epochs", 1000)
        checkpoint_every = self.cfg.get("checkpoint_every", 10)
        guard = preemption or PreemptionGuard.install()
        try:
            self._train_loop(num_epochs, checkpoint_every, guard)
        finally:
            # flush the writer while the guard still absorbs a second SIGTERM
            try:
                if self._writer is not None:
                    self._writer.close()
                    self._writer = None
            finally:
                if preemption is None:
                    guard.uninstall()

    def _train_loop(self, num_epochs: int, checkpoint_every: int,
                    preemption: PreemptionGuard) -> None:
        while self._epoch < num_epochs:
            epoch_metrics = []
            for batch in self.replay:
                try:
                    batch = self._to_device(batch)
                    draws = self.agent.sample_draws(batch, self.generator, mesh=self.mesh)
                    self.state, metrics = self.agent.update(self.state, batch, draws)
                    self._num_iters += 1
                    epoch_metrics.append(metrics)
                except Exception:
                    # the reference swallows update exceptions and goes on
                    self.update_failures.append(traceback.format_exc())
                    traceback.print_exc()
                    continue
            self._epoch += 1
            if epoch_metrics:
                means = {k: torch.stack([m[k] for m in epoch_metrics]).double().mean().item()
                         for k in epoch_metrics[0]}
                self.logger.log_metrics(means, self._epoch, prefix="train_act", echo=True)
            due = self._epoch % checkpoint_every == 0 or self._epoch == num_epochs
            if due:
                self.save_snapshot()
            if dist.any_process(preemption.requested, self.agent.device):
                if not due:
                    self.save_snapshot()
                print(f"Preemption requested: saved latest.ckpt at epoch {self._epoch}, "
                      "exiting (restart auto-resumes)")
                break
