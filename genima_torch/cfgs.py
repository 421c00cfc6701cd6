"""The Colosseum perturbation configs as Python data.

Counterpart of ``genima_tpu/cfgs/colosseum/*.yaml``: ``COLOSSEUM`` maps each
file's stem to its contents. Every file shares the ``data`` section (the
RLBench collection settings) and names one scene-factor family under
``env.scene.factors``.
"""

from __future__ import annotations

import copy

_DATA = {
    "save_path": "/tmp/rlbench_data/",
    "image_size": [256, 256],
    "renderer": "opengl",
    "episodes_per_task": 5,
    "images": {"rgb": True, "depth": False, "mask": False, "point_cloud": False},
    "cameras": {"left_shoulder": True, "right_shoulder": True, "overhead": False,
                "wrist": True, "front": True},
    "depth_in_meters": False,
    "masks_as_one_channel": False,
}

_FACTORS = {
    "distractor_objects": [
        {"variation": "distractor_object", "name": "distractors", "enabled": True,
         "targets": ["spawn_boundary"], "num_objects": [1, 3], "seed": 42},
    ],
    "lighting_variations": [
        {"variation": "light_color", "name": "light_color", "enabled": True,
         "targets": ["DefaultLightA", "DefaultLightB", "DefaultLightC"],
         "color_range": [[0.4, 0.4, 0.4], [1.0, 1.0, 1.0]], "seed": 42},
    ],
    "random_background_textures": [
        {"variation": "background_texture", "name": "background_texture", "enabled": True,
         "seed": 42},
    ],
    "random_camera_poses": [
        {"variation": "camera_pose", "name": "camera_pose", "enabled": True,
         "targets": ["cam_front", "cam_over_shoulder_left", "cam_over_shoulder_right",
                     "cam_wrist"],
         "euler_range": [[-0.05, -0.05, -0.05], [0.05, 0.05, 0.05]],
         "position_range": [[-0.05, -0.05, -0.05], [0.05, 0.05, 0.05]], "seed": 42},
    ],
    "random_object_color": [
        {"variation": "object_color", "name": "manip_obj_color", "enabled": True,
         "targets": [],  # filled per task
         "color_names": ["red", "green", "blue", "yellow", "purple", "cyan", "orange", "white"],
         "seed": 42},
    ],
    "random_table_textures": [
        {"variation": "table_texture", "name": "table_texture", "enabled": True, "seed": 42},
        {"variation": "table_color", "name": "table_color", "enabled": True,
         "color_range": [[0.25, 0.25, 0.25], [1.0, 1.0, 1.0]], "seed": 42},
    ],
}

COLOSSEUM: dict[str, dict] = {
    name: {"data": copy.deepcopy(_DATA),
           "env": {"task_name": "open_drawer", "seed": 42, "scene": {"factors": factors}}}
    for name, factors in _FACTORS.items()
}

