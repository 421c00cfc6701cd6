"""Episode recording, files named ``<task>_ep<N>_{succ,fail}.mp4``.

Counterpart of ``genima_tpu/eval/video.py``. Frames are host numpy arrays;
``imageio`` writes the mp4 where it is installed, else the frames go to an
``.npz`` stack beside it (the reference's own fallback).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def frame_from_env(env) -> np.ndarray | None:
    """A uint8 HWC frame: ``render_frame()`` where the base env has it, else
    the first ``*_rgb`` camera of its observation; ``None`` when neither."""
    base = getattr(env, "unwrapped", env)
    if hasattr(base, "render_frame"):
        frame = base.render_frame()
        return None if frame is None else np.asarray(frame, np.uint8)
    if hasattr(base, "_obs"):
        obs = base._obs()
        cams = [k for k in obs if k.endswith("_rgb")]
        if cams:
            return np.transpose(obs[cams[0]], (1, 2, 0)).astype(np.uint8)
    return None


class VideoRecorder:
    def __init__(self, save_dir: str | Path, fps: int = 30):
        self.save_dir = Path(save_dir)
        self.fps = fps
        self.frames: list[np.ndarray] = []
        self.enabled = False

    def init(self, env=None, enabled: bool = True) -> None:
        self.frames = []
        self.enabled = enabled
        if enabled:
            self.record(env)

    def record(self, env) -> None:
        if not self.enabled or env is None:
            return
        frame = frame_from_env(env)
        if frame is not None:
            self.frames.append(np.asarray(frame, np.uint8))

    def save(self, file_name: str) -> Path | None:
        if not self.enabled or not self.frames:
            return None
        self.save_dir.mkdir(parents=True, exist_ok=True)
        path = self.save_dir / file_name
        try:
            import imageio

            imageio.mimsave(str(path), self.frames, fps=self.fps)
        except (ImportError, ValueError, RuntimeError, OSError):
            # no imageio, or no mp4 codec for it: keep the frames as an npz
            path = path.with_suffix(".npz")
            np.savez_compressed(path, frames=np.stack(self.frames))
        return path
