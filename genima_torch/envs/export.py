"""Export collected demos to the RLBench dataset layout on disk.

Counterpart of ``genima_tpu/envs/export.py``. The reference consumes
datasets produced by RLBench's dataset generator:
``<root>/<task>/variation<V>/episodes/episode<N>/`` holding per-camera
``{cam}_rgb/<t>.png`` frame dirs, a ``low_dim_obs.pkl`` list of
per-timestep observations (``gripper_matrix``, ``gripper_open`` and a
``misc`` dict with ``joint_poses`` and per-camera ``*_camera_intrinsics`` /
``*_camera_extrinsics``), and ``variation_descriptions.pkl``. This module
writes that layout from ``DemoStep`` lists, so any env that makes demos
(the fake env's goal-observable mode, with its synthetic camera model,
included) feeds the rendering -> diffusion training -> controller training
chain without a simulator.

The ``low_dim_obs`` entries are plain dicts that also carry
``joint_positions`` and ``misc["joint_position_action"]``, so the tree
loads back as controller demos (``envs.rendered.RenderedDemoFactory``).
PIL is imported where the frames are written.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import List, Sequence

import numpy as np

from genima_torch.envs.demo import DemoStep


def _step_record(step: DemoStep) -> dict:
    rec = {
        "gripper_open": float(step.gripper_open),
        "joint_positions": np.asarray(step.joint_positions, np.float32),
        "misc": dict(step.misc),
    }
    if step.gripper_matrix is not None:
        rec["gripper_matrix"] = np.asarray(step.gripper_matrix, np.float32)
    return rec


def export_demos_rlbench_format(
    demos: List[List[DemoStep]],
    root: str | Path,
    task: str,
    variation: int = 0,
    cameras: Sequence[str] = ("wrist", "front", "right_shoulder", "left_shoulder"),
    descriptions: Sequence[str] | None = None,
) -> Path:
    """Write ``demos`` as ``<root>/<task>/variation<V>/episodes/episode<N>``
    trees; returns the dataset root. Frames come from each step's
    ``observation["{cam}_rgb"]`` (CHW uint8, the reference obs layout)."""
    from PIL import Image

    root = Path(root)
    var_dir = root / task / f"variation{variation}" / "episodes"
    var_dir.mkdir(parents=True, exist_ok=True)

    if descriptions is None:
        desc = ""
        for demo in demos:
            for step in demo:
                d = step.misc.get("descriptions")
                if d:
                    desc = d[0] if isinstance(d, (list, tuple)) else str(d)
                    break
            if desc:
                break
        descriptions = [desc or task.replace("_", " ")]
    with open(var_dir.parent / "variation_descriptions.pkl", "wb") as f:
        pickle.dump(list(descriptions), f)

    for ep_idx, demo in enumerate(demos):
        ep_dir = var_dir / f"episode{ep_idx}"
        low_dim = []
        for t, step in enumerate(demo):
            low_dim.append(_step_record(step))
            for cam in cameras:
                img = np.asarray(step.observation[f"{cam}_rgb"])
                if img.ndim == 3 and img.shape[0] in (1, 3):
                    img = np.transpose(img, (1, 2, 0))  # CHW -> HWC
                d = ep_dir / f"{cam}_rgb"
                d.mkdir(parents=True, exist_ok=True)
                Image.fromarray(img.astype(np.uint8)).save(d / f"{t}.png")
        with open(ep_dir / "low_dim_obs.pkl", "wb") as f:
            pickle.dump(low_dim, f)
    return root
