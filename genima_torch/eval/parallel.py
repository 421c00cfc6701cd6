"""Lockstep-batched closed-loop evaluation: N episodes per control step.

Counterpart of ``genima_tpu/eval/parallel.py`` on one card. Every control
step uploads all live observations, runs the denoise loop at batch
``N * frame_stack``, untiles, runs ACT at batch N, and downloads all action
chunks at once: the launches a step makes do not grow with N, so the card
does N episodes' work for each launch the host makes.

Episode semantics are the serial harness's: a ``reset_to_demo`` restore per
episode, a latent generator per episode seeded with the agent's ``seed``
and an ancestral-noise generator seeded ``seed + 1`` (SDXL; the port's
serial contract, ``eval/agents.py``), so a batched episode draws what its
serial run draws whatever its cohort, the same success
accounting, JSON schema and running printout. Environments step in a
thread pool. Episodes that end early stay in the batch with their last
observation (a static batch) but are not stepped or counted.

All device work runs on one device worker: a single thread that owns one
CUDA stream and returns each cohort's actions as host arrays through a
future. The main thread assembles numpy batches and waits on futures, and
with ``eval_overlap`` (the default) one half of the slots steps its
environments while the worker runs the other half's step. Only the worker
launches kernels, so the kernels' launch counters stay exact.

On real simulators each env lives in a spawned child
(``envs/subprocess_env.py``; ``cli/eval_genima.py`` builds them), with the
demo restore and the observation's re-wrap done there. Classifier-free
guidance (``guidance_scale > 1``) needs the serial harness: the batched
step runs positive prompts only. Mesh serving (JAX's ``mesh=``) is not
ported.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from genima_torch.envs.wrappers import rewrap_obs
from genima_torch.eval.fused import FusedGenimaStep
from genima_torch.eval.harness import GenimaEvalWorkspace


def _cat_rows(parts: list):
    """Row-concatenate prompt embeddings: tensors, or SDXL's (hidden,
    pooled) pairs element by element."""
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(xs) for xs in zip(*parts))
    return torch.cat(parts)


class BatchedGenimaStep(FusedGenimaStep):
    """The fused control step for N environments: tiled obs (N*fs, 2S, 2S, 3)
    uint8 -> one ``fused_generate`` at batch N*fs -> untile -> per env, the
    views camera-major then by frame -> ACT at batch N -> (N, T, A) action
    chunks and the (N*fs, 2S, 2S, 3) targets. The call signature is
    ``FusedGenimaStep``'s, under ``torch.inference_mode``. The port decodes
    the whole batch in one pass, so JAX's ``decode_mode`` has no
    counterpart here."""


class DeviceWorker:
    """One thread that runs every device call of the workspace, on a CUDA
    stream of its own (none on the CPU), under ``torch.inference_mode``.
    Each call first waits for the default stream, where weights and
    checkpoints are loaded."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="genima-device")
        self.stream = None
        if self.device.type == "cuda":
            idx = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            self.device = torch.device("cuda", idx)
            self.stream = self._pool.submit(self._init_cuda).result()

    def _init_cuda(self) -> torch.cuda.Stream:
        torch.cuda.set_device(self.device)  # a new thread has no current device
        return torch.cuda.Stream(self.device)

    def _run(self, fn, args):
        if self.stream is None:
            with torch.inference_mode():
                return fn(*args)
        self.stream.wait_stream(torch.cuda.default_stream(self.device))
        with torch.cuda.stream(self.stream), torch.inference_mode():
            return fn(*args)

    def submit(self, fn, *args) -> Future:
        return self._pool.submit(self._run, fn, args)

    def upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array onto the device from pinned memory, on the worker's
        stream (call it from a submitted function)."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.stream is None:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def synchronize(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()

    def close(self) -> None:
        self._pool.shutdown(wait=True)


class ParallelGenimaEvalWorkspace(GenimaEvalWorkspace):
    """Evaluates ``num_eval_episodes`` across ``len(eval_envs)`` lockstep
    environments. ``GenimaEvalWorkspace``'s constructor plus a list of envs,
    its ``eval()`` / ``eval_checkpoints`` surface and log schema; ``close()``
    stops the worker threads."""

    def __init__(
        self,
        eval_cfg,
        eval_envs,
        controller_agent,
        diffusion_agent=None,
        cameras=("wrist", "front", "right_shoulder", "left_shoulder"),
        logger=None,
        tokenizer=None,
    ):
        eval_envs = list(eval_envs)
        super().__init__(eval_cfg, eval_envs[0], controller_agent, diffusion_agent,
                         cameras=cameras, logger=logger, tokenizer=tokenizer)
        if diffusion_agent is not None and float(eval_cfg.get("guidance_scale", 0.0)) > 1.0:
            # the batched step runs positive prompts only (the genima protocol
            # is guidance 0.0); CFG would silently differ from the serial path
            raise ValueError(
                "num_parallel_envs > 1 does not support classifier-free "
                "guidance (guidance_scale > 1.0); use the serial harness "
                "(num_parallel_envs=1) or guidance_scale <= 1.0"
            )
        self.eval_envs = eval_envs
        self._pool = ThreadPoolExecutor(max_workers=len(eval_envs))
        self._worker = DeviceWorker(controller_agent.device)
        self._batched_step = None
        self._batched_gen_est = None
        # a simulator crash ends an episode, never the run
        self._retired: set[int] = set()  # slots whose env is gone
        self._needs_revive: set[int] = set()  # errored mid-episode last round
        self._any_obs = None  # (obs, goal, lang) for placeholder slots

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        self._worker.close()

    # -- device work (on the worker) ---------------------------------------------

    def _batched(self, obs_size: int) -> BatchedGenimaStep:
        if self._batched_step is None:
            self._batched_step = BatchedGenimaStep(
                self.diffusion_agent, self.controller_agent, obs_size)
        return self._batched_step

    def _latent_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.controller_agent.device).manual_seed(seed)

    def _slot_latents(self, slot, fs: int) -> torch.Tensor:
        """The slot's next (fs, h, w, 4) latents, from its episode's own
        generator (the serial agent's contract: a fixed seed per episode)."""
        return self.diffusion_agent.draw_latents(fs, slot["gen"])

    def _cohort_noise(self, csl, fs: int, steps: int):
        """The cohort's (steps, n*fs, h, w, 4) ancestral noise, each slot's
        block from its episode's own noise generator; None for a sampler
        that injects none."""
        blocks = [self.diffusion_agent.draw_noise(steps, fs, s["noise_gen"]) for s in csl]
        return None if blocks[0] is None else torch.cat(blocks, dim=1)

    def _cohort_step(self, csl, tiled, qpos, lang, fs: int, obs_size: int):
        """One cohort's batched step: the upload, prompt embeddings, latent
        and noise draws, the step and the actions' download, all on the
        worker."""
        dag = self.diffusion_agent
        steps = self.eval_cfg.get("num_diffusion_steps", 5)
        embeds = _cat_rows([dag._embed_prompts(self._prompts(s["goal"], fs)[0]) for s in csl])
        latents = torch.cat([self._slot_latents(s, fs) for s in csl])
        noise = self._cohort_noise(csl, fs, steps)
        tiled = self._worker.upload(tiled)
        actions, _ = self._batched(obs_size)(
            dag.params, self.controller_params, self.controller_agent.clip_params,
            tiled, embeds, latents, torch.from_numpy(qpos), torch.from_numpy(lang),
            noise=noise, num_inference_steps=steps,
        )
        return actions.float().cpu().numpy(), (tiled, embeds, latents, noise)

    def _measure_batched_gen(self, tiled, embeds, latents, noise) -> float:
        """The batched diffusion half timed once (after one warm-up) on a
        cohort's own inputs, to split the step's time into the reference's
        gen / control phases. It draws nothing from any slot's generator."""
        dag = self.diffusion_agent
        steps = self.eval_cfg.get("num_diffusion_steps", 5)

        def gen():
            dag.fused_generate(dag.params, tiled, embeds, latents, noise,
                               num_inference_steps=steps)
            self._worker.synchronize()

        gen()
        t0 = time.time()
        gen()
        return time.time() - t0

    def _act_only_step(self, images, qpos, lang):
        """ACT-only (no diffusion): raw RGB views batched over N."""
        actions = self.controller_agent.act(
            self.controller_params, self._worker.upload(images), torch.from_numpy(qpos),
            torch.from_numpy(lang))
        return actions.float().cpu().numpy()

    # -- cohort pipelining ---------------------------------------------------------
    #
    # Strictly alternating lockstep leaves the card idle while the envs
    # execute their chunks, and the envs idle during the step. Two cohorts,
    # software-pipelined (one cohort's envs step while the worker runs the
    # other's step), make a round cost max(T_device, T_env) rather than
    # the sum. Per-slot generators make the split invisible to every episode.

    def _cohort_partition(self, slots) -> list[list[int]]:
        """Slot-index cohorts: two halves when pipelining is on and possible
        (the diffusion path, an even batch), else one."""
        n = len(slots)
        if (not bool(self.eval_cfg.get("eval_overlap", True)) or self.diffusion_agent is None
                or n < 2 or n % 2):
            return [list(range(n))]
        return [list(range(n // 2)), list(range(n // 2, n))]

    @staticmethod
    def _cohort_live(slots, idxs) -> bool:
        return any(slots[i]["counted"] and not slots[i]["done"] for i in idxs)

    def _dispatch_cohort(self, slots, idxs, fs: int) -> dict:
        """Assemble one cohort's numpy batch and hand its step to the worker;
        the returned handle's future is read once the other cohort's envs
        have been handed their chunks."""
        csl = [slots[i] for i in idxs]
        qpos = np.concatenate(
            [s["obs"]["low_dim_state"].reshape(1, -1).astype(np.float32) for s in csl])
        lang = np.concatenate([s["lang"] for s in csl])
        if self.diffusion_agent is None:
            images = np.stack([self._act_views(s["obs"], fs) for s in csl]).astype(np.float32)
            t0 = time.time()
            return {"future": self._worker.submit(self._act_only_step, images, qpos, lang),
                    "t0": t0, "act_only": True}
        tiled = np.concatenate([self._tile_obs(s["obs"], fs) for s in csl])
        obs_size = csl[0]["obs"][f"{self.cameras[0]}_rgb"].shape[-1]
        t0 = time.time()
        return {"future": self._worker.submit(self._cohort_step, csl, tiled, qpos, lang, fs,
                                              obs_size),
                "t0": t0, "act_only": False}

    def _run_lockstep(self, slots, fs: int, timings, execution_horizon: int,
                      episode_length: int, ref_slot) -> None:
        """Run one slot batch to completion, pipelined over cohorts. One
        cohort is the plain alternating loop; two overlap the worker's step
        with env stepping."""
        parts = self._cohort_partition(slots)
        k = len(parts)
        handle: dict[int, dict | None] = {c: None for c in range(k)}
        env_futs: dict[int, list] = {c: [] for c in range(k)}
        stepped = {c: False for c in range(k)}
        ref_idx = slots.index(ref_slot)
        # the reference slot's liveness at dispatch: record while its episode
        # is live, its last step included, as the serial recorder does
        ref_live_at = {c: False for c in range(k)}

        def launch(c: int) -> None:
            # wait for this cohort's env steps (the other cohort's device
            # step runs meanwhile), then dispatch it again if still live
            for f in env_futs[c]:
                f.result()
            env_futs[c] = []
            if stepped[c] and ref_idx in parts[c]:
                stepped[c] = False
                # a failed slot's env may be dead: leave it, and never let a
                # recording error end the other slots' episodes
                if ref_live_at[c] and not ref_slot.get("error"):
                    try:
                        self.video.record(ref_slot["env"])
                    except Exception as e:
                        print(f"video recording disabled: {e}")
                        self.video.enabled = False
            if self._cohort_live(slots, parts[c]):
                if ref_idx in parts[c]:
                    ref_live_at[c] = not ref_slot["done"]
                handle[c] = self._dispatch_cohort(slots, parts[c], fs)

        for c in range(k):
            launch(c)
        ci = 0
        while any(h is not None for h in handle.values()):
            h = handle[ci]
            if h is not None:
                handle[ci] = None
                out = h["future"].result()
                dt = time.time() - h["t0"]
                live = sum(1 for i in parts[ci] if slots[i]["counted"] and not slots[i]["done"])
                if h["act_only"]:
                    actions = out
                    timings["control_time"].append(dt / max(live, 1))
                else:
                    actions, probe = out
                    timings["fused_step_time"].append(dt)
                    if self._batched_gen_est is None:
                        self._batched_gen_est = self._worker.submit(
                            self._measure_batched_gen, *probe).result()
                    gen_est = min(self._batched_gen_est, dt)
                    timings["gen_time"].append(gen_est / max(live, 1))
                    timings["control_time"].append((dt - gen_est) / max(live, 1))
                env_futs[ci] = [
                    self._pool.submit(self._step_slot, slots[i], actions[j], execution_horizon,
                                      episode_length)
                    for j, i in enumerate(parts[ci])
                    if slots[i]["counted"] and not slots[i]["done"]
                ]
                stepped[ci] = True
            launch(ci)
            ci = (ci + 1) % k

    # -- slots ---------------------------------------------------------------------

    def _reset_slot(self, env, episode_idx: int) -> dict:
        if hasattr(env, "reset_to_demo_wrapped"):
            # SubprocessEnv: the restore and the re-wrap happen in the child,
            # where the wrapper chain lives
            obs, info = env.reset_to_demo_wrapped(episode_idx)
        else:
            obs, info = env.reset()
            if hasattr(env.unwrapped, "reset_to_demo"):
                _, raw_obs = env.unwrapped.reset_to_demo(idx=episode_idx)
                obs = rewrap_obs(env, raw_obs, obs)
        goal = info.get("descriptions", "")
        pose_fn = getattr(env.unwrapped, "initial_object_pose", None)
        seed = getattr(self.diffusion_agent, "seed", 2)
        return {
            "env": env, "ep": episode_idx, "obs": obs, "goal": goal,
            "lang": self._lang_tokens(goal, obs), "gen": self._latent_generator(seed),
            "noise_gen": self._latent_generator(seed + 1), "done": False, "reward": 0.0,
            "steps": 0, "pose": pose_fn() if callable(pose_fn) else None,
        }

    def _revive(self, si: int) -> bool:
        """Bring slot ``si``'s env back after a mid-episode error. A
        ``SubprocessEnv`` is respawned from its spec; an in-process env gets
        one more chance (its next reset retires it if it is dead)."""
        respawn = getattr(self.eval_envs[si], "respawn", None)
        if not callable(respawn):
            return True
        try:
            respawn()
            print(f"slot {si}: respawned its environment after a sim error")
            return True
        except Exception as e:
            print(f"slot {si}: respawn failed, retiring the slot: {e}")
            return False

    def _try_reset(self, si: int, episode_idx: int):
        """``_reset_slot``, guarded: on failure, respawn and retry once where
        the env can respawn, else retire the slot. Returns the slot, or None
        when it retired (the caller re-queues the episode)."""
        env = self.eval_envs[si]
        attempts = 2 if callable(getattr(env, "respawn", None)) else 1
        for attempt in range(attempts):
            try:
                slot = self._reset_slot(env, episode_idx)
                self._any_obs = (slot["obs"], slot["goal"], slot["lang"])
                return slot
            except Exception as e:
                print(f"Error (env slot {si} reset, episode {episode_idx}): {e}")
                if attempt + 1 < attempts and not self._revive(si):
                    break
        self._retired.add(si)
        print(f"slot {si}: environment retired; continuing with "
              f"{len(self.eval_envs) - len(self._retired)} live slots")
        return None

    def _placeholder_slot(self) -> dict:
        """A done, uncounted slot for a retired env: keeps the batch at its
        size without touching any environment. Its generators are its own."""
        obs, goal, lang = self._any_obs
        return {
            "env": None, "ep": -1, "obs": obs, "goal": goal, "lang": lang,
            "gen": self._latent_generator(0), "noise_gen": self._latent_generator(1),
            "done": True, "counted": False, "reward": 0.0, "steps": 0, "pose": None,
        }

    def _step_slot(self, slot, actions, execution_horizon, episode_length) -> None:
        actions = actions[:execution_horizon]
        try:
            obs, reward, term, trunc, _info = slot["env"].step(actions)
            slot["obs"] = obs
            slot["reward"] = reward
            slot["done"] = term or trunc
        except Exception as e:  # a simulator failure ends this episode
            # the serial harness breaks before counting the failed chunk
            print(f"Error (env slot, episode {slot['ep']}): {e}")
            slot["done"] = True
            slot["error"] = True  # its env may be dead: do not touch it again
            return
        slot["steps"] += len(actions)
        if slot["steps"] > episode_length:
            slot["done"] = True

    # -- the lockstep loop -----------------------------------------------------------

    def eval_checkpoints(self, eval_ckpts: list[str]) -> dict:
        cfg = self.eval_cfg
        n_envs = len(self.eval_envs)
        logs = {"eval_episodes": []}
        logs_path = Path(cfg.controller_ckpt) / f"eval_genima_{cfg.task}.json"
        execution_horizon = cfg.get("execution_horizon", 20)
        episode_length = cfg.get("episode_length", 200)
        num_eps = cfg.get("num_eval_episodes", 10)

        global_episode, global_total_reward = 0, 0.0
        for run_id, eval_ckpt in enumerate(eval_ckpts):
            print(f"\n-------- Run {run_id} (parallel x{n_envs}) ---------")
            self.load_controller_ckpt(Path(cfg.controller_ckpt) / eval_ckpt)
            # the gen / control split is a probe per checkpoint: re-probe
            # after a swap so that a reload cannot serve a stale estimate
            self._batched_gen_est = None
            run_episode, run_total_reward = 0, 0.0
            timings = {"gen_time": [], "control_time": [], "fused_step_time": []}

            pending = list(range(num_eps))
            while pending:
                # revive the envs that errored mid-episode last round; a
                # failed revival retires the slot
                for si in sorted(self._needs_revive):
                    if si not in self._retired and not self._revive(si):
                        self._retired.add(si)
                self._needs_revive.clear()
                live_sis = [si for si in range(n_envs) if si not in self._retired]
                if not live_sis:
                    raise RuntimeError(
                        f"all {n_envs} parallel environments have died; "
                        f"{len(pending)} episodes remain")
                eps = pending[: len(live_sis)]
                del pending[: len(eps)]
                # episodes to live slots; extra live slots re-run an episode
                # uncounted and retired slots get done placeholders (the
                # batch never changes size)
                slots = [None] * n_envs
                requeue = []
                for idx, si in enumerate(live_sis):
                    ep = eps[idx % len(eps)]
                    slot = self._try_reset(si, ep)
                    if slot is None:
                        if idx < len(eps):
                            requeue.append(ep)
                        continue
                    slot["counted"] = idx < len(eps)
                    slots[si] = slot
                pending[:0] = requeue
                if not any(s is not None and s["counted"] for s in slots):
                    continue  # every reset failed; the episodes were re-queued
                for si in range(n_envs):
                    if slots[si] is None:
                        slots[si] = self._placeholder_slot()
                ref_slot = next(s for s in slots if s["counted"])
                fs = ref_slot["obs"][f"{self.cameras[0]}_rgb"].shape[0]
                self.video.init(ref_slot["env"], enabled=cfg.get("save_video", False))

                self._run_lockstep(slots, fs, timings, execution_horizon, episode_length,
                                   ref_slot)

                for si, s in enumerate(slots):
                    if s.get("error"):
                        self._needs_revive.add(si)
                        if s["counted"]:
                            self.env_exception_episodes += 1
                for s in (s for s in slots if s["counted"]):
                    episode_success = float(np.clip(s["reward"], 0.0, 1.0))
                    run_total_reward += episode_success
                    run_episode += 1
                    global_total_reward += episode_success
                    global_episode += 1
                    logs["eval_episodes"].append({
                        "episode": run_episode,
                        "reward": float(s["reward"]),
                        "global_episode": global_episode,
                        "global_reward": global_total_reward,
                        "steps": s["steps"],
                        "run_id": run_id,
                        "controller_ckpt": eval_ckpt,
                        "initial_object_pose": s["pose"],
                    })
                    print(
                        f"Episode {run_episode:>02}\t| Reward - run{run_id}: "
                        f"{s['reward']:.1f} ({int(run_total_reward)}/{run_episode}="
                        f"{run_total_reward / run_episode * 100:.1f}%)\t| "
                        f"Steps: {s['steps']}\t| Gen Time: "
                        f"{np.mean(timings['gen_time'] or [0]):.4f}s\t| "
                        f"Control Time: {np.mean(timings['control_time'] or [0]):.4f}s"
                    )
                logs_path.parent.mkdir(parents=True, exist_ok=True)
                with open(logs_path, "w") as f:
                    json.dump(logs, f, indent=4)
                if cfg.get("save_video", False):
                    success = "succ" if ref_slot["reward"] > 0.9 else "fail"
                    self.video.save(f"{cfg.task}_ep{ref_slot['ep'] + 1}_{success}.mp4")
                if self.logger is not None:
                    self.logger.log_metrics(
                        {
                            "success": global_total_reward / float(max(global_episode, 1)),
                            "episode": global_episode,
                            "gen_time": float(np.mean(timings["gen_time"] or [0])),
                            "control_time": float(np.mean(timings["control_time"] or [0])),
                            "fused_step_time": float(
                                np.mean(timings["fused_step_time"] or [0])),
                            "num_parallel_envs": n_envs,
                        },
                        global_episode, prefix="eval_genima", echo=False,
                    )

        logs["results"] = {
            "avg_success": f"{global_total_reward / float(max(global_episode, 1))}",
            "total_success": global_total_reward,
            "total_episodes": global_episode,
            "eval_type": self.eval_cfg.get("eval_type", "latest"),
            "num_parallel_envs": n_envs,
            # gen_time / control_time come from a probe per checkpoint,
            # amortised per live episode (the serial harness measures them
            # live per step)
            "timing_attribution": "estimated",
            "env_exception_episodes": self.env_exception_episodes,
        }
        with open(logs_path, "w") as f:
            json.dump(logs, f, indent=4)
        print("----------------------")
        print(
            f"Average of {global_episode} episodes "
            f"(parallel x{n_envs}, {len(eval_ckpts)} runs): "
            f"{global_total_reward / float(max(global_episode, 1)) * 100:.2f}%"
        )
        return logs
