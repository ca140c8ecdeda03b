"""Scene configuration table (copy of pointcloud_tpu/envs/scenes.py).

The port keeps its own copy of the whole table so that it imports nothing of
the JAX package; tests/test_torch_ae_slice.py checks that the two copies stay
equal. The model path reads `sample_points`, `bbox` and `class_latent_dim`.

Three declarative dicts, merged with `|`:
  robo_kwargs[scene]  — robosuite constructor kwargs
  cfg_scene[scene]    — camera poses, point budget, sampler, bbox, and the
                        per-class metadata consumed by sensors/encoders/
                        training (classes / states / state_dim /
                        class_latent_dim / class_colors / class_distribution)
  cfg_task[task]      — per-task overrides (empty placeholder)

`scene_config(name)` returns a SimpleNamespace view.
"""

from __future__ import annotations

from types import SimpleNamespace

robo_kwargs: dict = {}
cfg_scene: dict = {}
cfg_task: dict = {}

########## Base Configs ##########

robo_kwargs["Base"] = {
    "has_renderer": False,
    "has_offscreen_renderer": True,
    "render_gpu_device_id": 0,
    "reward_shaping": False,  # sparse reward
    "ignore_done": True,  # unlimited horizon (gym TimeLimit instead)
}

cfg_scene["Base"] = {
    "camera_size": (256, 256),  # width, height
    "sample_points": 2048,  # points in the point cloud
    "sampler": "FPS",  # 'FPS' or 'RS'
    "cameras": {  # name: (position, quaternion)
        "frontview": ([1.5, 0, 1], [0.53, 0.53, 0.46, 0.46]),
    },
    "bbox": [[-0.8, 0.8], [-0.8, 0.8], [0.5, 2.0]],
}

cfg_scene["Base_full"] = cfg_scene["Base"] | {
    "cameras": {
        "frontview": ([1.5, 0, 1], [0.53, 0.53, 0.46, 0.46]),
        "agentview": ([-0.15, -1.2, 2.3], [0.3972332, 0, 0, 0.9177177]),
        "birdview": ([-0.15, 1.2, 2.3], [0, 0.3972332, 0.9177177, 0]),
    },
}

########## Table Scene (Lift without the cube in play) ##########

robo_kwargs["Table"] = robo_kwargs["Base"] | {
    "env_name": "Lift",
    "robots": "Panda",
    # resolved to load_controller_config(...) by RobosuiteBackend only when
    # robosuite is importable (reference passes the loaded config directly,
    # envs.py:60)
    "controller": "OSC_POSITION",
}

cfg_scene["Table"] = cfg_scene["Base_full"] | {
    "scene": "Table",
    "classes": ["env", "cube", "arm", "base", "gripper"],
    "states": [None, None, None, None, "robot0_eef_pos"],
    "state_dim": [0, 0, 0, 0, 3],
    "class_latent_dim": [0, 0, 0, 0, 3],
    "class_colors": [[0, 0, 0], [1, 0, 0], [0.5, 0.5, 0.5], [0, 0.4, 0], [0, 0, 1]],
    "class_distribution": [0.3, 0, 0.4, 0.05, 0.05],
}

########## Cube Scene (Lift with the cube) ##########

robo_kwargs["Cube"] = robo_kwargs["Table"]

cfg_scene["Cube"] = cfg_scene["Base_full"] | {
    "scene": "Cube",
    "classes": ["env", "cube", "arm", "base", "gripper"],
    "states": [None, "cube_pos", None, None, "robot0_eef_pos"],
    "state_dim": [0, 3, 0, 0, 3],
    "class_latent_dim": [0, 3, 7, 0, 3],
    "class_colors": [[0, 0, 0], [1, 0, 0], [0.8, 0.8, 0.8], [0, 1, 0], [0, 0, 1]],
    "class_distribution": [0.3, 0.01, 0.4, 0.05, 0.05],
}

########## PegInHole Scene (two-arm) ##########

robo_kwargs["PegInHole"] = robo_kwargs["Base"] | {
    "env_name": "TwoArmPegInHole",
    "robots": ["Panda", "Panda"],
    "controller": "OSC_POSE",  # reference envs.py:95
}

cfg_scene["PegInHole"] = cfg_scene["Base"] | {
    "scene": "PegInHole",
    "camera_size": (256, 128),
    "cameras": {
        "frontview": (
            [1.82528550e00, -7.45058060e-09, 1.76897722e00],
            [0.43064612, 0.43064612, 0.56084215, 0.56084215],
        ),
        "agentview": (
            [-1.94923647, -0.03970403, 1.57617048],
            [0.44933245, -0.43759465, -0.54293281, 0.55842209],
        ),
    },
    "bbox": [[-1.4, 1.8], [-2, 2], [0.2, 2.0]],
    "classes": ["peg_hole", "robot0", "base0", "env", "robot1", "base1"],
    "states": ["peg_to_hole", "peg_quat", "hole_pos", "hole_quat", "t", "d", "angle"],
    "state_dim": [3, 4, 3, 4, 1, 1, 1],
    "class_latent_dim": [14, 7, 0, 0, 7, 0],
    "class_colors": [
        [1, 0, 0],
        [0.3, 0.3, 0.3],
        [0.2, 0.2, 0.2],
        [0, 0, 0],
        [0.7, 0.7, 0.7],
        [0.5, 0.5, 0.5],
    ],
    "class_distribution": [0.4, 0.3, 0, 0, 0.3, 0],
}


def scene_config(name: str) -> SimpleNamespace:
    """Scene config as attribute-style namespace (reference train.py:73)."""
    return SimpleNamespace(**cfg_scene[name])
