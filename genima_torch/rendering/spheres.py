"""Analytic sphere rendering as batched tensor ops on the device.

Counterpart of ``genima_tpu/rendering/spheres.py``, which replaces the
reference's pyrender/EGL offscreen renderer (``render/joint_marker.py``)
with exactly ray-traced spheres. Here a leading frame axis takes the place
of the JAX package's ``vmap``: one call renders a whole camera's episode.

The look is the reference's (the diffusion agent is trained on it):

* up to 4 spheres per frame: the gripper at t + action_horizon (cyan
  stripes if ``gripper_open > 0.1``, else yellow) and joints 1/3/5 (red,
  green and purple stripes, rendered with the "open" base factor);
* flat shading: stripe colour x baseColorFactor, no lighting; the stripes
  are vertical bands (24 px colour, 24 px black over a 256 px texture)
  indexed by the hit point's sphere-local x (the planar UV);
* RLBench extrinsics are camera-to-world in the CV convention (+Z
  forward), which the rays use directly;
* white background; the per-camera scale multiplies the base radius.

``sphere_params_for_timestep`` stays host numpy (scipy for the joint
quaternions).
"""

from __future__ import annotations

import numpy as np
import torch

# stripe colors measured from the reference textures (render/sphere_textures)
STRIPE_COLORS = {
    "cyan": np.array([8, 239, 235], np.float32) / 255.0,
    "red": np.array([255, 0, 0], np.float32) / 255.0,
    "green": np.array([71, 240, 62], np.float32) / 255.0,
    "purple": np.array([218, 120, 240], np.float32) / 255.0,
    "yellow": np.array([255, 255, 0], np.float32) / 255.0,
}

# baseColorFactor (joint_marker.py:168-173): cyan-ish when open, yellow when
# closed; multiplies the texture sample
SPHERE_BASE_FACTORS = {
    "open": np.array([0.60392156862, 0.86274509803, 1.0], np.float32),
    "closed": np.array([1.0, 1.0, 0.0], np.float32),
}

JOINT_COLOR_MAP = {1: "red", 3: "green", 5: "purple"}  # render_data.py:15-19

# texture geometry: 256-px wide, stripe period 48 px, color band 24 px
_TEX_W = 256.0
_STRIPE_PERIOD = 48.0
_STRIPE_ON = 24.0


def render_spheres(
    intrinsics: torch.Tensor,  # (N, 3, 3)
    cam_pose: torch.Tensor,  # (N, 4, 4) camera-to-world, RLBench CV convention
    centers: torch.Tensor,  # (N, S, 3) world positions
    rotations: torch.Tensor,  # (N, S, 3, 3) world-from-local sphere rotations
    radii: torch.Tensor,  # (N, S)
    stripe_colors: torch.Tensor,  # (N, S, 3) in [0, 1]
    base_factors: torch.Tensor,  # (N, S, 3)
    height: int,
    width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """N frames -> (images (N, H, W, 3) f32 in [0, 1] on white, hit masks
    (N, H, W) bool), on the inputs' device."""
    dev = intrinsics.device
    n = intrinsics.shape[0]
    fx, fy = intrinsics[:, 0, 0], intrinsics[:, 1, 1]
    cx, cy = intrinsics[:, 0, 2], intrinsics[:, 1, 2]
    r_wc = cam_pose[:, :3, :3]
    origin = cam_pose[:, :3, 3]  # (N, 3)

    # per-pixel rays in the camera frame (+Z forward), then to world
    v, u = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    per = (slice(None), None, None)  # (N,) -> (N, 1, 1)
    dirs_cam = torch.stack(
        [(u - cx[per]) / fx[per], (v - cy[per]) / fy[per], torch.ones_like(u).expand(n, -1, -1)],
        dim=-1,
    )  # (N, H, W, 3)
    dirs = (dirs_cam.reshape(n, -1, 3) @ r_wc.transpose(1, 2)).reshape(n, height, width, 3)

    # ray-sphere intersection per sphere: |o + t d - c|^2 = r^2
    oc = origin[:, None, :] - centers  # (N, S, 3)
    a = torch.sum(dirs * dirs, dim=-1)  # (N, H, W)
    b = 2.0 * (dirs.reshape(n, -1, 3) @ oc.transpose(1, 2)).reshape(n, height, width, -1)
    c = torch.sum(oc * oc, dim=-1) - radii**2  # (N, S)
    disc = b**2 - 4.0 * a[..., None] * c[:, None, None, :]
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    t_hit = (-b - sqrt_disc) / (2.0 * a[..., None])  # nearest root
    valid = (disc > 0.0) & (t_hit > 1e-6)
    t_hit = torch.where(valid, t_hit, torch.full_like(t_hit, float("inf")))

    # z-order: nearest sphere per pixel (index 0 where nothing is hit)
    t_min, nearest = torch.min(t_hit, dim=-1)  # (N, H, W)
    any_hit = torch.isfinite(t_min)
    hit_world = origin[:, None, None, :] + t_min[..., None] * dirs  # (N, H, W, 3)

    frame = torch.arange(n, device=dev)[:, None, None]
    centers_sel = centers[frame, nearest]  # (N, H, W, 3)
    # hit point in sphere-local coords -> planar UV from local x: the first
    # row of R^T, which is R's first column
    x_axis_sel = rotations[..., :, 0][frame, nearest]  # (N, H, W, 3)
    radii_sel = radii[frame, nearest]  # (N, H, W)
    local_x = torch.sum(x_axis_sel * (hit_world - centers_sel), dim=-1)
    u_tex = (local_x + radii_sel) / (2.0 * radii_sel)
    tex_x = torch.clamp(u_tex, 0.0, 1.0) * _TEX_W
    stripe_on = torch.remainder(tex_x, _STRIPE_PERIOD) < _STRIPE_ON

    stripe_sel = stripe_colors[frame, nearest]
    color = torch.where(stripe_on[..., None], stripe_sel, torch.zeros_like(stripe_sel))
    color = color * base_factors[frame, nearest]
    image = torch.where(any_hit[..., None], color, torch.ones_like(color))  # white background
    return image, any_hit


def sphere_params_for_timestep(
    gripper_matrix: np.ndarray,  # (4, 4)
    gripper_open: float,
    joint_poses: dict[int, np.ndarray],  # joint idx -> (7,) [xyz, quat xyzw]
    joints_to_render: list[int],
    radius: float,
    camera_scale: float,
) -> dict[str, np.ndarray]:
    """Host-side assembly of one frame's sphere set (the reference's
    render_demo inner logic, ``render_data.py:235-267``)."""
    from scipy.spatial.transform import Rotation

    centers = [np.asarray(gripper_matrix)[:3, 3]]
    rotations = [np.asarray(gripper_matrix)[:3, :3]]
    gripper_stripe = "cyan" if gripper_open > 0.1 else "yellow"
    stripes = [STRIPE_COLORS[gripper_stripe]]
    factors = [SPHERE_BASE_FACTORS["open" if gripper_open > 0.1 else "closed"]]
    for j in joints_to_render:
        pose = np.asarray(joint_poses[j])
        centers.append(pose[:3])
        rotations.append(Rotation.from_quat(pose[3:7]).as_matrix())
        stripes.append(STRIPE_COLORS[JOINT_COLOR_MAP[j]])
        # joints are rendered with gripper_open=1.0 -> "open" base factor
        factors.append(SPHERE_BASE_FACTORS["open"])
    s = len(centers)
    return {
        "centers": np.stack(centers).astype(np.float32),
        "rotations": np.stack(rotations).astype(np.float32),
        "radii": np.full(s, radius * camera_scale, np.float32),
        "stripe_colors": np.stack(stripes),
        "base_factors": np.stack(factors),
    }
