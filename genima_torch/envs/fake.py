"""Fake RLBench environment: a pure-numpy, simulator-free stand-in.

Counterpart of ``genima_tpu/envs/fake.py`` (the env, its renderers and the
factory's eval env): a scripted 7-DoF "reach the joint configuration" task
with 4 cameras whose images encode the joint state (colored bars, or the
goal-observable marker scene), seeded ``reset_to_demo`` for reproducible
eval episodes, and the RLBench observation dict (CHW ``{cam}_rgb``,
``low_dim_state`` = [gripper_open, joints], ``lang_tokens``), and the
scripted demos the controller trainer learns from.
"""

from __future__ import annotations

import numpy as np

from genima_torch.envs import core
from genima_torch.envs.core import Box
from genima_torch.envs.demo import DemoStep, compute_action_stats, compute_proprio_stats

CAMERAS = ("wrist", "front", "right_shoulder", "left_shoulder")
# per-camera color tints so views are distinguishable
_CAM_TINTS = {
    "wrist": (1.0, 0.9, 0.9),
    "front": (0.9, 1.0, 0.9),
    "right_shoulder": (0.9, 0.9, 1.0),
    "left_shoulder": (1.0, 1.0, 0.9),
}

JOINT_LOW = -np.pi * np.ones(7, np.float32)
JOINT_HIGH = np.pi * np.ones(7, np.float32)

# -- goal-observable scene geometry (the learning gate's "objects") ----------
#
# The real env's success currency is visible objects: the diffusion model
# reads WHERE TO GO from the scene, not from privileged state. The default
# fake obs encodes only the current joints, so no policy — however well
# trained — can beat chance. ``goal_observable``
# mode adds the goal to the scene the way objects do, and gives the env a
# synthetic camera model (intrinsics/extrinsics + joint "poses" on a marker
# plane) so the REAL sphere renderer (``rendering/spheres.py``) can draw
# t+horizon joint targets on exported episodes with the SAME projection the
# scene itself uses — ticks, current markers, and rendered spheres all live
# in one world geometry, exactly like RLBench's objects and markers do.
_MARKER_Z = 2.0  # world plane the markers live on (CV +Z forward)
_X_SCALE = 1.6 / np.pi  # joint angle (rad) -> world x
_ROW_DY = 0.26  # vertical spacing between joint rows
_GOAL_ROW_OFFSET = 0.13  # goal ticks sit on an interleaved half-row
_GRIPPER_Y = -0.88  # gripper marker row (below the joint rows)
_GRIPPER_X_CUR, _GRIPPER_X_GOAL = -0.45, 0.45  # scene markers; sphere at x=0
_GOAL_TICK_COLOR = np.array([255, 40, 255], np.float32)  # magenta
# gripper GOAL tick uses the sphere color code (spheres.py: cyan=open,
# yellow=closed) so the diffusion model's color mapping is an identity
_GRIPPER_GOAL_OPEN = np.array([8, 239, 235], np.float32)
_GRIPPER_GOAL_CLOSED = np.array([255, 255, 0], np.float32)
_GRIPPER_CUR_OPEN = np.array([255, 255, 255], np.float32)
_GRIPPER_CUR_CLOSED = np.array([30, 30, 30], np.float32)
# per-camera world offsets so the 4 views see genuinely different projections
_CAM_OFFSETS = {
    "wrist": (0.00, 0.00),
    "front": (0.08, -0.05),
    "right_shoulder": (-0.08, 0.05),
    "left_shoulder": (0.05, 0.08),
}
# the joints that get rendered target spheres (reference render config:
# joints 1/3/5 + the gripper, render/render_data.py:15-19); the
# goal-observable task only moves these so every controlled DoF is visible
# to the diffusion agent the way the real arm is
CONTROLLED_JOINTS = (1, 3, 5)


def joint_marker_positions(joints: np.ndarray) -> np.ndarray:
    """(7, 3) world positions: x encodes the angle, y the joint row."""
    joints = np.asarray(joints, np.float32)
    x = joints * _X_SCALE
    y = (np.arange(7, dtype=np.float32) - 3.0) * _ROW_DY
    z = np.full(7, _MARKER_Z, np.float32)
    return np.stack([x, y, z], axis=-1)


def goal_marker_positions(goal_joints: np.ndarray) -> np.ndarray:
    """(7, 3) goal-tick positions: the interleaved half-row below each joint."""
    pos = joint_marker_positions(goal_joints)
    pos[:, 1] += _GOAL_ROW_OFFSET
    return pos


def gripper_marker_position() -> np.ndarray:
    """Fixed world position of the rendered gripper sphere (its color, not
    its position, carries the open/closed signal — ``spheres.py:136-139``)."""
    return np.array([0.0, _GRIPPER_Y, _MARKER_Z], np.float32)


def fake_camera_intrinsics(size: int) -> np.ndarray:
    f = float(size - 4)
    return np.array(
        [[f, 0.0, size / 2.0], [0.0, f, size / 2.0], [0.0, 0.0, 1.0]],
        np.float32,
    )


def fake_camera_extrinsics(camera: str) -> np.ndarray:
    """Camera-to-world, CV convention (+Z forward) — what
    ``rendering.spheres.render_spheres`` consumes directly."""
    ox, oy = _CAM_OFFSETS.get(camera, (0.0, 0.0))
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3], pose[1, 3] = ox, oy
    return pose


def _project(points: np.ndarray, camera: str, size: int) -> np.ndarray:
    """(N, 3) world -> (N, 2) pixel (u, v) through the fake camera model —
    the same math ``rendering.spheres.render_spheres`` ray-traces."""
    intr = fake_camera_intrinsics(size)
    ox, oy = _CAM_OFFSETS.get(camera, (0.0, 0.0))
    p = np.asarray(points, np.float32)
    u = intr[0, 0] * (p[:, 0] - ox) / p[:, 2] + intr[0, 2]
    v = intr[1, 1] * (p[:, 1] - oy) / p[:, 2] + intr[1, 2]
    return np.stack([u, v], axis=-1)


def _splat(img: np.ndarray, uv: np.ndarray, color, radius: float = 1.6):
    """Anti-aliased disc at sub-pixel center (u, v): coverage-weighted blend.
    Sub-pixel placement matters — a conv net recovers the marker center to
    well under a pixel from the AA intensity profile; integer drawing would
    floor-quantize the goal signal below the task's success tolerance."""
    size = img.shape[0]
    u, v = float(uv[0]), float(uv[1])
    r0 = max(int(np.floor(v - radius - 1)), 0)
    r1 = min(int(np.ceil(v + radius + 2)), size)
    c0 = max(int(np.floor(u - radius - 1)), 0)
    c1 = min(int(np.ceil(u + radius + 2)), size)
    if r0 >= r1 or c0 >= c1:
        return
    rr, cc = np.meshgrid(
        np.arange(r0, r1, dtype=np.float32),
        np.arange(c0, c1, dtype=np.float32),
        indexing="ij",
    )
    dist = np.sqrt((rr - v) ** 2 + (cc - u) ** 2)
    w = np.clip(radius + 0.5 - dist, 0.0, 1.0)[..., None]
    img[r0:r1, c0:c1] = (1 - w) * img[r0:r1, c0:c1] + w * np.asarray(
        color, np.float32
    )


def render_goal_scene(
    joints: np.ndarray,
    gripper_open: float,
    goal_joints: np.ndarray,
    goal_gripper: float,
    camera: str,
    size: int = 64,
) -> np.ndarray:
    """(3, size, size) uint8 goal-observable scene.

    Per joint: a colored current-state marker (legacy bar colors) and a
    magenta goal tick on an interleaved half-row, both PROJECTED from the
    same world-plane geometry the sphere renderer uses — so the diffusion
    model's job ("draw the target sphere between the current marker and the
    goal tick on this row") is a local, translation-equivariant image map.
    Gripper row: current-state marker (white=open/dark=closed) at x<0, goal
    tick at x>0 colored with the sphere code (cyan=open / yellow=closed)."""
    img = np.full((size, size, 3), 128, np.float32)
    cur_uv = _project(joint_marker_positions(joints), camera, size)
    goal_uv = _project(goal_marker_positions(goal_joints), camera, size)
    for j in range(7):
        _splat(img, cur_uv[j], (40 + 25 * j, 200 - 20 * j, 90))
        _splat(img, goal_uv[j], _GOAL_TICK_COLOR, radius=1.4)
    grip = np.array(
        [[_GRIPPER_X_CUR, _GRIPPER_Y, _MARKER_Z],
         [_GRIPPER_X_GOAL, _GRIPPER_Y, _MARKER_Z]],
        np.float32,
    )
    grip_uv = _project(grip, camera, size)
    _splat(
        img, grip_uv[0],
        _GRIPPER_CUR_OPEN if gripper_open > 0.5 else _GRIPPER_CUR_CLOSED,
    )
    _splat(
        img, grip_uv[1],
        _GRIPPER_GOAL_OPEN if goal_gripper > 0.5 else _GRIPPER_GOAL_CLOSED,
        radius=1.4,
    )
    tint = np.array(_CAM_TINTS[camera])
    img = np.clip(img * tint, 0, 255).astype(np.uint8)
    return np.transpose(img, (2, 0, 1))  # CHW, reference obs layout


def render_joint_bars(
    joints: np.ndarray, gripper_open: float, camera: str, size: int = 64
) -> np.ndarray:
    """(3, size, size) uint8 image encoding joints as vertical bars."""
    img = np.full((size, size, 3), 128, np.uint8)
    bar_w = max(size // 9, 1)
    frac = (joints - JOINT_LOW) / (JOINT_HIGH - JOINT_LOW)
    for j, f in enumerate(frac):
        h = int(np.clip(f, 0, 1) * (size - 1))
        x0 = int((j + 1) * size / 9)
        img[size - 1 - h :, x0 : x0 + bar_w] = (40 + 25 * j, 200 - 20 * j, 90)
    # gripper state indicator in the corner
    g = int(np.clip(gripper_open, 0, 1) * 255)
    img[: size // 8, : size // 8] = (g, 255 - g, 128)
    tint = np.array(_CAM_TINTS[camera])
    img = np.clip(img.astype(np.float32) * tint, 0, 255).astype(np.uint8)
    return np.transpose(img, (2, 0, 1))  # CHW, reference obs layout


class FakeRLBenchEnv(core.Env):
    """Scripted reach-task env with the RLBench observation/action contract."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(
        self,
        task_name: str = "fake_reach",
        episode_length: int = 60,
        image_size: int = 64,
        demo_length: int = 40,
        cameras: tuple = CAMERAS,
        seed: int = 0,
        descriptions: tuple = ("reach the target configuration",),
        goal_observable: bool = False,
        success_tol: float = 0.1,
    ):
        self.task_name = task_name
        self.episode_length = episode_length
        self.image_size = image_size
        self.demo_length = demo_length
        self.cameras = cameras
        self.descriptions = list(descriptions)
        # goal_observable: the task the learning gate trains on — the goal
        # is IN the scene (like the real env's objects), only the sphere-
        # rendered joints (1/3/5) + gripper move, and demos carry the
        # camera model so episodes export to the RLBench dataset format
        self.goal_observable = goal_observable
        self.success_tol = float(success_tol)
        self._base_seed = seed
        self._episode_idx = -1
        self._rng = np.random.RandomState(seed)
        self._joints = np.zeros(7, np.float32)
        self._gripper_open = 1.0
        self._target = np.zeros(7, np.float32)
        self._target_gripper = 0.0

        obs_spaces = {
            f"{cam}_rgb": Box(
                0, 255, shape=(3, image_size, image_size), dtype=np.uint8
            )
            for cam in cameras
        }
        obs_spaces["low_dim_state"] = Box(
            -np.inf, np.inf, shape=(8,), dtype=np.float32
        )
        obs_spaces["lang_tokens"] = Box(
            0, 50000, shape=(1, 77), dtype=np.int32
        )
        self.observation_space = core.Dict(obs_spaces)
        self.action_space = Box(
            np.concatenate([JOINT_LOW, [0.0]]).astype(np.float32),
            np.concatenate([JOINT_HIGH, [1.0]]).astype(np.float32),
            dtype=np.float32,
        )
        self._lang_tokens = np.zeros((1, 77), np.int32)

    # -- episode setup -----------------------------------------------------

    def _episode_init(self, idx: int):
        rng = np.random.RandomState(self._base_seed + 1000 + idx)
        self._joints = rng.uniform(-0.5, 0.5, 7).astype(np.float32)
        self._target = rng.uniform(-1.5, 1.5, 7).astype(np.float32)
        if self.goal_observable:
            # only the sphere-marked joints move (the rendered dataset
            # draws spheres for joints 1/3/5 + gripper, matching the
            # reference's render config); the rest hold their start pose,
            # which the controller reads from proprio
            target = self._joints.copy()
            target[list(CONTROLLED_JOINTS)] = self._target[
                list(CONTROLLED_JOINTS)
            ]
            self._target = target
        self._gripper_open = 1.0
        self._target_gripper = float(rng.randint(0, 2))
        self._steps = 0

    def _render_cam(self, cam: str) -> np.ndarray:
        if self.goal_observable:
            return render_goal_scene(
                self._joints, self._gripper_open, self._target,
                self._target_gripper, cam, self.image_size,
            )
        return render_joint_bars(
            self._joints, self._gripper_open, cam, self.image_size
        )

    def _obs(self) -> dict:
        obs = {
            f"{cam}_rgb": self._render_cam(cam) for cam in self.cameras
        }
        obs["low_dim_state"] = np.concatenate(
            [[self._gripper_open], self._joints]
        ).astype(np.float32)
        obs["lang_tokens"] = self._lang_tokens.copy()
        return obs

    def set_lang_tokens(self, tokens: np.ndarray) -> None:
        self._lang_tokens = np.asarray(tokens, np.int32).reshape(1, 77)

    def reset(self, seed=None, options=None):
        self._episode_idx += 1
        self._episode_init(self._episode_idx)
        return self._obs(), {"descriptions": self.descriptions[0], "demo": 0}

    def reset_to_demo(self, idx: int):
        """Restore the initial state of demo ``idx`` (reference
        ``reset_to_demo``, ``rlbench.py:234-252``)."""
        self._episode_init(idx)
        return None, self._obs()

    def initial_object_pose(self):
        """Synthetic stand-in for RLBench's waypoint0 pose (7-vector)."""
        return list(np.asarray(self._target, np.float64)[:7])

    def step(self, action):
        action = np.asarray(action, np.float32)
        self._joints = np.clip(action[:7], JOINT_LOW, JOINT_HIGH)
        self._gripper_open = float(action[7] > 0.5)
        self._steps += 1
        success = (
            np.all(np.abs(self._joints - self._target) < self.success_tol)
            and self._gripper_open == self._target_gripper
        )
        reward = 1.0 if success else 0.0
        terminated = bool(success)
        return self._obs(), reward, terminated, False, {"task_success": success}

    # -- demos ---------------------------------------------------------------

    def get_demo(self, idx: int) -> list[DemoStep]:
        """Scripted linear-interpolation demo with joint_position_action."""
        self._episode_init(idx)
        start, target = self._joints.copy(), self._target.copy()
        steps = []
        T = self.demo_length
        for t in range(T):
            alpha = t / (T - 1)
            joints = (1 - alpha) * start + alpha * target
            gripper = 1.0 if alpha < 0.8 else self._target_gripper
            self._joints, self._gripper_open = joints.astype(np.float32), gripper
            obs = self._obs()
            misc = {
                "joint_position_action": np.concatenate([joints, [gripper]]),
                "descriptions": self.descriptions[0],
            }
            gripper_matrix = None
            if self.goal_observable:
                # the synthetic camera model + marker "FK" that lets these
                # demos export to the RLBench dataset format and feed the
                # REAL sphere renderer (rendering/render_data.py reads
                # joint_poses + per-camera intrinsics/extrinsics from misc)
                markers = joint_marker_positions(joints)
                misc["joint_poses"] = {
                    j: np.concatenate(
                        [markers[j], [0.0, 0.0, 0.0, 1.0]]
                    ).astype(np.float32)
                    for j in CONTROLLED_JOINTS
                }
                for cam in self.cameras:
                    misc[f"{cam}_camera_intrinsics"] = fake_camera_intrinsics(
                        self.image_size
                    )
                    misc[f"{cam}_camera_extrinsics"] = fake_camera_extrinsics(
                        cam
                    )
                gripper_matrix = np.eye(4, dtype=np.float32)
                gripper_matrix[:3, 3] = gripper_marker_position()
            steps.append(
                DemoStep(
                    joint_positions=joints.astype(np.float32),
                    gripper_open=gripper,
                    observation={
                        k: v for k, v in obs.items() if k != "lang_tokens"
                    },
                    gripper_matrix=gripper_matrix,
                    misc=misc,
                )
            )
        return steps

    def get_demos(self, n: int) -> list[list[DemoStep]]:
        return [self.get_demo(i) for i in range(n)]


class FakeRLBenchFactory:
    """The fake env's factory (``GenimaRLBenchFactory``'s API,
    ``controller/env/rlbench.py:255-383``): ``make_eval_env`` wraps a fresh
    env in the controller's wrapper stack, with the normalization stats
    loaded from ``stats_path`` (or given). Multi-task: each task gets its
    own description and episode stream; ``collect_or_fetch_demos`` takes
    ``num_demos`` per task and pools them, stats over the pool, as RoboBase
    does."""

    def __init__(self, task_names=None, **env_kwargs):
        self.env_kwargs = env_kwargs
        self.task_names = list(
            task_names if task_names else [env_kwargs.get("task_name", "fake_reach")]
        )
        self._raw_demos = None
        self.action_stats = None
        self.proprio_stats = None

    def _task_kwargs(self, task_name: str) -> dict:
        kw = dict(self.env_kwargs)
        kw["task_name"] = task_name
        # distinct description + distinct episode stream per task
        kw.setdefault("descriptions", (f"{task_name.replace('_', ' ')} task",))
        idx = self.task_names.index(task_name) if task_name in self.task_names else 0
        kw["seed"] = kw.get("seed", 0) + idx * 7919
        return kw

    def make_env(self, task_name: str | None = None) -> FakeRLBenchEnv:
        return FakeRLBenchEnv(**self._task_kwargs(task_name or self.task_names[0]))

    def make_eval_env(self, *, episode_length=None, frame_stack=1, action_sequence=20,
                      stats_path=None, action_stats=None, proprio_stats=None,
                      use_onehot_time=False, task_name=None):
        from genima_torch.envs.wrappers import wrap_env

        env = self.make_env(task_name)
        return wrap_env(
            env,
            episode_length=episode_length or env.episode_length,
            frame_stack=frame_stack,
            action_sequence=action_sequence,
            action_stats=action_stats if action_stats is not None else self.action_stats,
            proprio_stats=proprio_stats if proprio_stats is not None else self.proprio_stats,
            stats_path=stats_path,
            use_onehot_time=use_onehot_time,
        )

    def collect_or_fetch_demos(self, num_demos: int) -> list[list[DemoStep]]:
        self._raw_demos = []
        for task in self.task_names:
            self._raw_demos.extend(self.make_env(task).get_demos(num_demos))
        self.action_stats = compute_action_stats(self._raw_demos)
        self.proprio_stats = compute_proprio_stats(self._raw_demos)
        return self._raw_demos

    def load_demos_into_replay(self, buffer, cameras=CAMERAS, lang_tokens=None,
                               tokenizer=None, onehot_time_len=None) -> None:
        from genima_torch.envs.demo import load_demos_into_replay

        if self._raw_demos is None:
            raise RuntimeError("collect_or_fetch_demos first")
        load_demos_into_replay(
            buffer, self._raw_demos, list(cameras), self.action_stats, self.proprio_stats,
            lang_tokens=lang_tokens, tokenizer=tokenizer, onehot_time_len=onehot_time_len,
        )
