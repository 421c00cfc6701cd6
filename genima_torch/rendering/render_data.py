"""Dataset builder: draw future joint positions onto RLBench episodes.

Counterpart of ``genima_tpu/rendering/render_data.py`` (the reference's
``render/render_data.py``): for each episode and timestep, render the
gripper and joints 1/3/5 at t + action_horizon as striped spheres per
camera, composite them onto the original RGB (the *rgb_rendered* set) and
onto random backgrounds with alpha blending (the *rnd_bg* set), and write
the 2x2 ``tiled_rgb`` / ``tiled_rgb_rendered`` images of the 4
non-overhead cameras. The output trees mirror the input dataset minus its
depth, mask and point-cloud dirs, and each holds a snapshot of the config
(``render_data_config.yaml``).

The rasterization and compositing of one camera's episode is one batch of
tensor ops on ``device`` (the card unless ``device="cpu"``); the host reads
and writes PNGs, and a thread pool runs episodes side by side. Textures and
blends come from ``RandomState(seed + episode)`` in the JAX package's order,
so both packages draw the same backgrounds.
"""

from __future__ import annotations

import os
import pickle
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from genima_torch import resolve_device
from genima_torch.rendering.compositor import composite_rgb_rendered, composite_rnd_bg
from genima_torch.rendering.spheres import render_spheres, sphere_params_for_timestep

_FRAME_KEYS = ("intr", "pose", "centers", "rots", "radii", "stripes", "factors")


def _get(obs, attr: str):
    """Attribute or dict access (RLBench Observation objects vs plain dicts)."""
    if isinstance(obs, dict):
        return obs[attr]
    return getattr(obs, attr)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] floats -> uint8, rounding half to even as ``jnp.round`` does
    (a bare ``.to(torch.uint8)`` would truncate)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def render_frames(frames: dict[str, torch.Tensor], rgb: torch.Tensor, textures: torch.Tensor,
                  blends: torch.Tensor, height: int, width: int, with_rnd: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One camera's episode, on the inputs' device: the per-frame sphere
    sets (``frames[k]`` stacked over N frames), the (N, H, W, 3) uint8
    originals, the (N, H, W, 3) or (N, 1, 1, 3) f32 backgrounds and the (N,)
    blends -> (rgb_rendered, rnd_bg) uint8 (N, H, W, 3) (rnd_bg None unless
    ``with_rnd``)."""
    img, mask = render_spheres(*(frames[k] for k in _FRAME_KEYS), height, width)
    full = to_uint8(composite_rgb_rendered(img, mask, rgb.float() / 255.0))
    if not with_rnd:
        return full, None
    return full, to_uint8(composite_rnd_bg(img, mask, textures, blends[:, None, None, None]))


def render_batch(frames: dict[str, np.ndarray], rgb: np.ndarray, textures: np.ndarray,
                 blends: np.ndarray, height: int, width: int, device: torch.device,
                 with_rnd: bool = True) -> tuple[np.ndarray, np.ndarray | None]:
    """``render_frames`` on host arrays: one copy in to ``device``, the
    uint8 results back."""
    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    full, rnd = render_frames({k: put(frames[k]) for k in _FRAME_KEYS}, put(rgb), put(textures),
                              put(blends), height, width, with_rnd)
    return full.cpu().numpy(), None if rnd is None else rnd.cpu().numpy()


class RenderData:
    def __init__(self, cfg: dict, device: Any = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        textures_path = cfg.get("textures_path")
        self._texture_files = (
            sorted(os.path.join(textures_path, f) for f in os.listdir(textures_path))
            if textures_path and os.path.isdir(textures_path)
            else []
        )
        self._iw, self._ih = cfg["image_width"], cfg["image_height"]

        dataset_root = os.path.abspath(cfg["dataset_root"]).rstrip("/")
        name = os.path.basename(dataset_root)
        parent = cfg.get("save_path") or os.path.dirname(dataset_root)
        self.full_ctx_path = Path(parent) / f"{name}_rgb_rendered"
        self.rnd_ctx_path = Path(parent) / f"{name}_rnd_bg"
        self.dataset_root = Path(dataset_root)

        draw = cfg.get("draw", {"rgb_rendered": True, "rnd_bg": True})
        self.draw_full = draw.get("rgb_rendered", True)
        self.draw_rnd = draw.get("rnd_bg", True)
        for enabled, dst in ((self.draw_full, self.full_ctx_path),
                             (self.draw_rnd, self.rnd_ctx_path)):
            if enabled:
                self._copy_source_tree(self.dataset_root / cfg["task"], dst / cfg["task"])
                self._save_config(dst)

    def _save_config(self, dst: Path) -> None:
        from genima_torch.core.config import save_yaml

        save_yaml(dict(self.cfg), dst / "render_data_config.yaml")

    @staticmethod
    def _copy_source_tree(src: Path, dst: Path) -> None:
        """Copy the dataset minus depth/mask/point-cloud dirs
        (reference ``render_data.py:369-395``)."""
        if not src.exists():
            raise FileNotFoundError(src)

        def ignore(dirname, names):
            return [n for n in names
                    if any(tag in n for tag in ("_depth", "_mask", "_point_cloud"))]

        shutil.copytree(src, dst, ignore=ignore, dirs_exist_ok=True)

    def _episode_dir(self, root: Path, episode: int) -> Path:
        var = self.cfg.get("variation", 0)
        var_dir = f"variation{var}" if var != -1 else "all_variations"
        return root / self.cfg["task"] / var_dir / "episodes" / f"episode{episode}"

    def _background(self, rng: np.random.RandomState) -> np.ndarray:
        """One frame's random background: a texture file resized to the
        image, else one uniform colour, (1, 1, 3)."""
        if self._texture_files:
            from PIL import Image

            with Image.open(rng.choice(self._texture_files)) as img:
                tex = img.convert("RGB").resize((self._iw, self._ih))
            return np.asarray(tex, np.float32) / 255.0
        return rng.uniform(0, 1, 3).astype(np.float32)[None, None]

    def render_demo(self, episode: int) -> None:
        from PIL import Image

        from genima_torch.data.tiling import tile_images

        cfg = self.cfg
        cameras = list(cfg["cameras"])
        camera_scales = list(cfg["camera_scales"])
        horizon = cfg.get("action_horizon", 20)
        radius = cfg.get("render", {}).get("sphere", {}).get("radius", 0.01)
        joints_cfg = cfg.get("render", {}).get("joints", {})
        alpha = cfg.get("alpha_blend", 0.7)
        rng = np.random.RandomState(cfg.get("seed", 0) + episode)

        src_ep = self._episode_dir(self.dataset_root, episode)
        with open(src_ep / "low_dim_obs.pkl", "rb") as f:
            low_dim_obs = pickle.load(f)
        T = len(low_dim_obs)

        def read(path: Path) -> np.ndarray:
            with Image.open(path) as img:
                return np.asarray(img.convert("RGB"))

        rgb_imgs = {cam: np.stack([read(src_ep / f"{cam}_rgb" / f"{i}.png") for i in range(T)])
                    for cam in cameras}
        full_ep = self._episode_dir(self.full_ctx_path, episode)
        rnd_ep = self._episode_dir(self.rnd_ctx_path, episode)
        rendered = {}

        for c_idx, camera in enumerate(cameras):
            joints = list(joints_cfg.get(camera, []))
            frames = {k: [] for k in _FRAME_KEYS}
            textures, blends = [], []
            for ts in range(T - 1):
                obs_now = low_dim_obs[ts]
                # lookahead target: obs at min(ts+1+horizon, T-1) - 1
                # (reference render_data.py:235-243); at ts == T-2 the range
                # is empty and NO spheres are drawn
                target_idx = min(ts + 1 + horizon, T - 1) - 1
                obs_t = low_dim_obs[max(target_idx, ts)]
                misc = _get(obs_now, "misc")
                sp = sphere_params_for_timestep(
                    np.asarray(_get(obs_t, "gripper_matrix")),
                    float(_get(obs_t, "gripper_open")),
                    _get(obs_t, "misc")["joint_poses"],
                    joints,
                    radius,
                    camera_scales[c_idx],
                )
                if target_idx <= ts:
                    sp["radii"] = np.zeros_like(sp["radii"])
                frames["intr"].append(np.asarray(misc[f"{camera}_camera_intrinsics"], np.float32))
                frames["pose"].append(np.asarray(misc[f"{camera}_camera_extrinsics"], np.float32))
                frames["centers"].append(sp["centers"])
                frames["rots"].append(sp["rotations"])
                frames["radii"].append(sp["radii"])
                frames["stripes"].append(sp["stripe_colors"])
                frames["factors"].append(sp["base_factors"])
                textures.append(self._background(rng))
                blends.append(np.float32(rng.uniform(alpha, 1.0)))

            full_u8, rnd_u8 = render_batch(
                {k: np.stack(v) for k, v in frames.items()}, rgb_imgs[camera][: T - 1],
                np.stack(textures), np.asarray(blends, np.float32), self._ih, self._iw,
                self.device, with_rnd=self.draw_rnd,
            )
            rendered[camera] = full_u8
            for ts in range(T - 1):
                if self.draw_full:
                    out = full_ep / f"{camera}_rgb"
                    out.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(full_u8[ts]).save(out / f"{ts}.png")
                if self.draw_rnd:
                    out = rnd_ep / f"{camera}_rgb"
                    out.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(rnd_u8[ts]).save(out / f"{ts}.png")

        # tiled images from the 4 non-overhead cameras (render_data.py:313-323)
        if self.draw_full:
            (full_ep / "tiled_rgb").mkdir(parents=True, exist_ok=True)
            (full_ep / "tiled_rgb_rendered").mkdir(parents=True, exist_ok=True)
            tiled_cams = [c for c in cameras if "overhead" not in c][:4]
            raw = tile_images(torch.from_numpy(
                np.stack([rgb_imgs[c][: T - 1] for c in tiled_cams], axis=1))).numpy()
            drawn = tile_images(torch.from_numpy(
                np.stack([rendered[c] for c in tiled_cams], axis=1))).numpy()
            for ts in range(T - 1):
                Image.fromarray(raw[ts]).save(full_ep / "tiled_rgb" / f"{ts}.png")
                Image.fromarray(drawn[ts]).save(full_ep / "tiled_rgb_rendered" / f"{ts}.png")

    def generate(self) -> None:
        episodes = range(self.cfg.get("episode_offset", 0), self.cfg.get("episodes", 1))
        num_workers = self.cfg.get("num_processes", 1)
        if num_workers <= 1:
            for ep in episodes:
                self.render_demo(ep)
        else:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                list(pool.map(self.render_demo, episodes))
