"""The closed-loop evaluation workspace: observe -> tile -> diffuse ->
untile -> ACT -> execute a chunk.

Counterpart of ``genima_tpu/eval/harness.py::GenimaEvalWorkspace``:
checkpoint selection (latest / last / last_three / epoch-N), the
diffusion agent's fixed per-episode seed, ``reset_to_demo`` episodes
re-wrapped by ``rewrap_obs``, per-episode JSON logs, success accounting,
videos ``<task>_ep<N>_{succ,fail}.mp4`` and the debug tile images. A
control step takes one of three paths:

- ``guidance_scale <= 1``: ``FusedGenimaStep`` (denoise, decode, untile and
  ACT in one call); its time is ``fused_step_time``, and the gen / control
  split is attributed from one timing of the diffusion half alone
  (``_measure_gen_time``), as the reference does;
- ``guidance_scale > 1``: the agent's ``infer_device`` with classifier-free
  guidance (the denoise batch doubles), then untile and ACT on the device;
- no diffusion agent: the ACT-only harness (raw camera views to ACT).

Every timing synchronises the card before it reads the clock. An env step
that raises ends its episode (the reference's tolerance of simulator
failures); ``env_exception_episodes`` in the results counts those ends.
"""

from __future__ import annotations

import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from genima_torch.core import checkpoint as ckpt
from genima_torch.data.tiling import tile_images, untile_to_cameras
from genima_torch.envs.wrappers import rewrap_obs
from genima_torch.eval.video import VideoRecorder


class GenimaEvalWorkspace:
    def __init__(
        self,
        eval_cfg,
        eval_env,
        controller_agent,
        diffusion_agent=None,
        cameras=("wrist", "front", "right_shoulder", "left_shoulder"),
        logger=None,
        tokenizer=None,
    ):
        self.eval_cfg = eval_cfg
        self.eval_env = eval_env
        self.controller_agent = controller_agent
        self.diffusion_agent = diffusion_agent
        self.cameras = list(cameras)
        self.logger = logger
        self.tokenizer = tokenizer
        self.controller_params = None
        self._fused_step = None
        # one timing of the diffusion half alone, to split the fused step's
        # time into the reference's gen / control phases
        self._fused_gen_est = None
        self.env_exception_episodes = 0
        media = eval_cfg.get("save_image_path") or eval_cfg.controller_ckpt
        self.video = VideoRecorder(Path(media) / "videos", fps=eval_cfg.get("video_fps", 30))

    def _sync(self) -> None:
        if self.controller_agent.device.type == "cuda":
            torch.cuda.synchronize(self.controller_agent.device)

    # -- checkpoint handling ---------------------------------------------------

    def load_controller_ckpt(self, path: str | Path) -> None:
        """The checkpoint's ``agent`` tree into the controller's modules, once
        per checkpoint; the CLIP tower the agent holds stays."""
        agent_params = ckpt.load_epoch_checkpoint(path)["agent"]
        missing = {"encoder", "actor"} - set(agent_params)
        if missing:
            raise ValueError(f"Missing keys in controller checkpoint: {missing}")
        self.controller_params = self.controller_agent.load_params(agent_params)
        print(f"Loaded controller checkpoint from {path}")

    def select_checkpoints(self) -> list[str]:
        return ckpt.select_eval_checkpoints(
            self.eval_cfg.controller_ckpt, self.eval_cfg.get("eval_type", "latest"))

    # -- the closed loop -------------------------------------------------------

    def _act_views(self, obs, fs: int) -> np.ndarray:
        """Camera-major (V*fs, H, W, 3) HWC views from a frame-stacked CHW
        obs dict: the one definition of the controller's view order."""
        views = []
        for cam in self.cameras:
            for t in range(fs):
                views.append(np.transpose(obs[f"{cam}_rgb"][t], (1, 2, 0)))
        return np.stack(views)

    def _controller_act(self, obs, lang_tokens: np.ndarray) -> np.ndarray:
        """obs dict (frame-stacked, CHW cams) -> (T, A) normalized chunk."""
        fs = obs[f"{self.cameras[0]}_rgb"].shape[0]
        images = self._act_views(obs, fs)[None].astype(np.float32)
        return self._controller_act_device(torch.from_numpy(images), obs, lang_tokens)

    def _controller_act_device(self, act_images, obs, lang_tokens) -> np.ndarray:
        qpos = obs["low_dim_state"].reshape(1, -1).astype(np.float32)
        actions = self.controller_agent.act(
            self.controller_params, act_images, torch.from_numpy(qpos),
            torch.from_numpy(np.asarray(lang_tokens)))
        return actions[0].float().cpu().numpy()

    def _tile_obs(self, obs, fs: int) -> np.ndarray:
        """(fs, 2H, 2W, 3) uint8: each frame's camera views tiled 2x2."""
        frames = []
        for t in range(fs):
            views = np.stack([np.transpose(obs[f"{cam}_rgb"][t], (1, 2, 0))
                              for cam in self.cameras]).astype(np.uint8)
            frames.append(tile_images(torch.from_numpy(views)).numpy())
        return np.stack(frames)

    def _prompts(self, goal: str, fs: int):
        prompts = [f"tiled perspectives of a robot arm executing '{goal}'"] * fs
        negative = ["monochrome, lowres, bad anatomy, worst quality, low quality"] * fs
        return prompts, negative

    def _fused(self, obs_size: int):
        if self._fused_step is None:
            from genima_torch.eval.fused import FusedGenimaStep

            self._fused_step = FusedGenimaStep(
                self.diffusion_agent, self.controller_agent, obs_size)
        return self._fused_step

    def _fused_control_step(self, obs, goal: str, fs: int, lang_tokens):
        """One call: tiled obs -> diffusion -> untile -> ACT."""
        tiled = self._tile_obs(obs, fs)
        prompts, _ = self._prompts(goal, fs)
        dag = self.diffusion_agent
        embeds = dag._embed_prompts(prompts)
        latents = dag._next_latents(fs)
        steps = self.eval_cfg.get("num_diffusion_steps", 5)
        noise = dag._next_noise(fs, steps)
        qpos = obs["low_dim_state"].reshape(1, -1).astype(np.float32)
        obs_size = obs[f"{self.cameras[0]}_rgb"].shape[-1]
        actions, target = self._fused(obs_size)(
            dag.params,
            self.controller_params,
            self.controller_agent.clip_params,
            torch.from_numpy(tiled),
            embeds,
            latents,
            torch.from_numpy(qpos),
            torch.from_numpy(np.asarray(lang_tokens)),
            noise=noise,
            num_inference_steps=steps,
        )
        return actions[0].float().cpu().numpy(), target

    def _generate_targets_device(self, obs, goal: str, fs: int):
        """The generated targets stay on the device: untile and the ACT
        input assembly happen there; one uint8 upload per step."""
        tiled = self._tile_obs(obs, fs)
        prompts, negative = self._prompts(goal, fs)
        target = self.diffusion_agent.infer_device(
            tiled, prompts, negative,
            num_inference_steps=self.eval_cfg.get("num_diffusion_steps", 5),
            guidance_scale=self.eval_cfg.get("guidance_scale", 0.0),
        )  # (fs, 2S, 2S, 3) uint8 on the device
        obs_size = obs[f"{self.cameras[0]}_rgb"].shape[-1]
        cams = untile_to_cameras(target.float(), target_size=obs_size)  # (fs, 4, S, S, 3)
        # camera-major view order, as _act_views
        act_images = cams.transpose(0, 1).reshape(1, -1, obs_size, obs_size, 3)
        return act_images, target

    def _measure_gen_time(self, obs, goal: str, fs: int) -> float:
        """One timing of the diffusion half on the live obs (after one
        warm-up call), used to split the fused step's time."""
        self._generate_targets_device(obs, goal, fs)
        self._sync()
        t0 = time.time()
        self._generate_targets_device(obs, goal, fs)
        self._sync()
        return time.time() - t0

    def eval_checkpoints(self, eval_ckpts: list[str]) -> dict:
        cfg = self.eval_cfg
        logs = {"eval_episodes": []}
        logs_path = Path(cfg.controller_ckpt) / f"eval_genima_{cfg.task}.json"
        execution_horizon = cfg.get("execution_horizon", 20)
        episode_length = cfg.get("episode_length", 200)

        global_episode, global_total_reward = 0, 0.0
        for run_id, eval_ckpt in enumerate(eval_ckpts):
            print(f"\n-------- Run {run_id} ---------")
            self.load_controller_ckpt(Path(cfg.controller_ckpt) / eval_ckpt)
            run_episode, run_total_reward = 0, 0.0
            timings = {"gen_time": [], "control_time": [], "fused_step_time": []}

            while run_episode < cfg.get("num_eval_episodes", 10):
                if self.diffusion_agent is not None:
                    self.diffusion_agent.new_episode()
                obs, info = self.eval_env.reset()
                goal = info.get("descriptions", "")
                if hasattr(self.eval_env.unwrapped, "reset_to_demo"):
                    _, raw_obs = self.eval_env.unwrapped.reset_to_demo(idx=run_episode)
                    obs = rewrap_obs(self.eval_env, raw_obs, obs)
                lang_tokens = self._lang_tokens(goal, obs)
                pose_fn = getattr(self.eval_env.unwrapped, "initial_object_pose", None)
                initial_object_pose = pose_fn() if callable(pose_fn) else None

                self.video.init(self.eval_env, enabled=cfg.get("save_video", False))
                termination, episode_step, reward = False, 0, 0.0
                fs = obs[f"{self.cameras[0]}_rgb"].shape[0]
                use_fused = (self.diffusion_agent is not None
                             and cfg.get("guidance_scale", 0.0) <= 1.0)

                while not termination:
                    act_images_dev = None
                    actions = None
                    if use_fused:
                        t0 = time.time()
                        actions, gen_dev = self._fused_control_step(obs, goal, fs, lang_tokens)
                        dt = time.time() - t0  # the actions are on the host: synchronised
                        timings["fused_step_time"].append(dt)
                        if self._fused_gen_est is None:
                            self._fused_gen_est = self._measure_gen_time(obs, goal, fs)
                        gen_est = min(self._fused_gen_est, dt)
                        timings["gen_time"].append(gen_est)
                        timings["control_time"].append(dt - gen_est)
                    elif self.diffusion_agent is not None:
                        t0 = time.time()
                        act_images_dev, gen_dev = self._generate_targets_device(obs, goal, fs)
                        self._sync()
                        timings["gen_time"].append(time.time() - t0)
                    else:
                        gen_dev = None

                    if self.diffusion_agent is not None and (
                        cfg.get("save_gen_image") or cfg.get("save_input_image")
                    ):
                        self._save_debug_images(
                            obs, gen_dev.cpu().numpy(), global_episode, episode_step)

                    if actions is None:
                        t0 = time.time()
                        if act_images_dev is not None:
                            actions = self._controller_act_device(act_images_dev, obs, lang_tokens)
                        else:
                            actions = self._controller_act(obs, lang_tokens)
                        timings["control_time"].append(time.time() - t0)

                    actions = actions[:execution_horizon]
                    try:
                        obs, reward, termination, truncated, info = self.eval_env.step(actions)
                        termination = termination or truncated
                    except Exception:  # a simulator failure ends the episode
                        traceback.print_exc()
                        self.env_exception_episodes += 1
                        termination = True
                        break
                    episode_step += len(actions)
                    self.video.record(self.eval_env)
                    if episode_step > episode_length:
                        termination = True

                # sparse 0/1 rewards, the env terminating on success: clamp
                # so a shaped env cannot push the success rate above 1
                episode_success = float(np.clip(reward, 0.0, 1.0))
                run_total_reward += episode_success
                run_episode += 1
                global_total_reward += episode_success
                global_episode += 1

                logs["eval_episodes"].append({
                    "episode": run_episode,
                    "reward": float(reward),
                    "global_episode": global_episode,
                    "global_reward": global_total_reward,
                    "steps": episode_step,
                    "run_id": run_id,
                    "controller_ckpt": eval_ckpt,
                    "initial_object_pose": initial_object_pose,
                })
                logs_path.parent.mkdir(parents=True, exist_ok=True)
                with open(logs_path, "w") as f:
                    json.dump(logs, f, indent=4)

                metrics = {
                    "reward": float(reward),
                    "success": global_total_reward / float(global_episode),
                    "episode": global_episode,
                    "gen_time": float(np.mean(timings["gen_time"] or [0])),
                    "control_time": float(np.mean(timings["control_time"] or [0])),
                }
                if timings["fused_step_time"]:
                    metrics["fused_step_time"] = float(np.mean(timings["fused_step_time"]))
                if cfg.get("save_video", False):
                    success = "succ" if reward > 0.9 else "fail"
                    self.video.save(f"{cfg.task}_ep{global_episode}_{success}.mp4")
                if self.logger is not None:
                    self.logger.log_metrics(metrics, global_episode, prefix="eval_genima",
                                            echo=False)
                print(
                    f"Episode {run_episode:>02}\t| Reward - run{run_id}: "
                    f"{reward:.1f} ({int(run_total_reward)}/{run_episode}="
                    f"{run_total_reward / run_episode * 100:.1f}%)\t| Steps: "
                    f"{episode_step}\t| Gen Time: "
                    f"{np.mean(timings['gen_time'] or [0]):.4f}s\t| Control Time: "
                    f"{np.mean(timings['control_time'] or [0]):.4f}s"
                )

        logs["results"] = {
            "avg_success": f"{global_total_reward / float(global_episode)}",
            "total_success": global_total_reward,
            "total_episodes": global_episode,
            "eval_type": self.eval_cfg.get("eval_type", "latest"),
            "env_exception_episodes": self.env_exception_episodes,
        }
        with open(logs_path, "w") as f:
            json.dump(logs, f, indent=4)
        print("----------------------")
        print(
            f"Average of {run_episode} episodes (across {len(eval_ckpts)} runs): "
            f"{global_total_reward / float(global_episode) * 100:.2f}%"
        )
        return logs

    def eval(self) -> dict:
        return self.eval_checkpoints(self.select_checkpoints())

    # -- helpers ---------------------------------------------------------------

    def _save_debug_images(self, obs, gen_tiles: np.ndarray, episode: int, step: int) -> None:
        from PIL import Image

        out = Path(self.eval_cfg.get("save_image_path") or self.eval_cfg.controller_ckpt)
        out.mkdir(parents=True, exist_ok=True)
        fs = gen_tiles.shape[0]
        if self.eval_cfg.get("save_input_image"):
            tiled = self._tile_obs(obs, fs)
        for t in range(fs):
            if self.eval_cfg.get("save_input_image"):
                Image.fromarray(tiled[t]).save(out / f"input_ep{episode}_step{step}_frame{t}.png")
            if self.eval_cfg.get("save_gen_image"):
                Image.fromarray(gen_tiles[t]).save(
                    out / f"gen_target_ep{episode}_step{step}_frame{t}.png")

    def _lang_tokens(self, goal: str, obs) -> np.ndarray:
        if "lang_tokens" in obs and np.any(obs["lang_tokens"]):
            return np.asarray(obs["lang_tokens"]).reshape(1, -1)[:, -77:]
        if self.tokenizer is not None:
            return np.asarray(self.tokenizer([goal]), np.int32)
        return np.zeros((1, 77), np.int32)
