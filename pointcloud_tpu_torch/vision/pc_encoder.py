"""Trained-model observation encoders (port of
pointcloud_tpu/vision/pc_encoder.py; reference: pointcloud_vision/pc_encoder.py).

Checkpoint discovery (latest version_N / step_M), metadata sidecar for the
calibrated latent threshold, and the concrete encoder zoo:
GlobalAEEncoder / GlobalSegmenterEncoder (global latent), MultiSegmenterEncoder
(per-class latents), StatePredictor(+VisualGoal) (predicted GT states).

The checkpoints are the port's (`step_M/checkpoint.pt`, written by
`train_torch.py` or converted from the JAX package's by
`convert_checkpoint_torch.py`). Every encoder runs its model in eval mode
under torch.no_grad() on the env's device, one cloud a call; encodings come
back as float32 numpy in the order of the encoder's obs / goal keys.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pointcloud_tpu_torch.envs.encoders import ObservationEncoder
from pointcloud_tpu_torch.envs.spaces import Box
from pointcloud_tpu_torch.utils import resolve_device
from pointcloud_tpu_torch.utils.profiling import count, span

OUTPUT_ROOT = os.environ.get("PCTPU_OUTPUT_ROOT", "output")


####### checkpoint / metadata resolution (reference pc_encoder.py:15-46) #######


def model_path(scene, model, backbone="PointNet2", version=None, output_root=None):
    """The latest (or the given version's) step_M directory: versions
    ordered by (length, name), steps by their number."""
    root = output_root or OUTPUT_ROOT
    base = os.path.join(root, scene, f"{model}_{backbone}")
    if not os.path.isdir(base):
        raise FileNotFoundError(
            f"no trained {model}_{backbone} checkpoints for scene {scene!r} "
            f"under {base!r} — train one first, e.g.: "
            f"python train_torch.py {scene} {model} --backbone {backbone}"
        )
    if version is None:
        versions = sorted(
            (d for d in os.listdir(base) if d.startswith("version_")),
            key=lambda n: (len(n), n),
        )
        version_dir = versions[-1]
    else:
        version_dir = f"version_{version}"
    ckpt_dir = os.path.join(base, version_dir, "checkpoints")
    steps = sorted(
        (d for d in os.listdir(ckpt_dir) if d.startswith("step_")),
        key=lambda n: int(n[5:]),
    )
    return os.path.join(ckpt_dir, steps[-1])


def metadata_path(scene, model, backbone="PointNet2", version=None, output_root=None):
    """Sidecar npz next to the checkpoint: version_N/metadata/step_M.npz
    (reference pc_encoder.py:28-31)."""
    ckpt = model_path(scene, model, backbone, version, output_root)
    step = os.path.basename(ckpt)
    return os.path.join(os.path.dirname(os.path.dirname(ckpt)), "metadata", step + ".npz")


def save_metadata(data_dict, file):
    os.makedirs(os.path.dirname(file), exist_ok=True)
    np.savez(file, **data_dict)
    return file


def load_metadata(file):
    return np.load(file)


def flatten_classes(class_encodings, classes):
    """Concatenate per-class encodings in a fixed order
    (reference pc_encoder.py:48-50)."""
    return np.concatenate(
        [np.asarray(class_encodings[c]).reshape(-1) for c in classes], axis=0
    )


def _check_port_checkpoint(ckpt):
    from pointcloud_tpu_torch.train.harness import CHECKPOINT_FILE

    if not os.path.isfile(os.path.join(ckpt, CHECKPOINT_FILE)):
        raise FileNotFoundError(
            f"{ckpt!r} holds no {CHECKPOINT_FILE}: a checkpoint of the JAX "
            f"package is converted with: python convert_checkpoint_torch.py "
            f"{ckpt} <checkpoints dir> <model> --backbone <backbone> --scene <scene>"
        )


def load_model(scene, model, backbone, version=None, whitelist=None, output_root=None,
               device="cuda"):
    """(module, spec) with the encoder weights of the latest checkpoint on
    `device`, in eval mode; decoders keep their fresh init (encoder_only
    load, reference pc_encoder.py:33-36).

    whitelist: for Multi* models, keep only these class/state heads
    (reference model.remove_unused): the module is rebuilt without the
    others, and their keys are dropped from the checkpoint before the exact
    load."""
    from pointcloud_tpu_torch.train.harness import (
        create_model,
        load_checkpoint_variables,
        load_state,
    )

    ckpt = model_path(scene, model, backbone, version, output_root)
    _check_port_checkpoint(ckpt)
    if whitelist is None:
        spec = create_model(model, backbone, scene, load_dir=ckpt, encoder_only=True,
                            device=device)
        return spec.model, spec
    spec = create_model(model, backbone, scene, device=device)
    module = _remove_unused(spec.model, whitelist)
    pruned = spec.model.state_dict().keys() - module.state_dict().keys()
    state = load_checkpoint_variables(ckpt, encoder_only=True)["model"]
    state = {k: v for k, v in state.items() if k not in pruned}
    load_state(module, state, keep_fresh=True)
    spec.model = module.eval()
    return spec.model, spec


def _remove_unused(module, whitelist):
    """Rebuild a Multi* module keeping only whitelisted heads, in the
    module's order, over the same backbone and heads (reference
    MultiBottle.remove_unused, architectures.py:60-62)."""
    from pointcloud_tpu_torch.models.architectures import MultiGTEncoder, MultiSegAE

    if isinstance(module, MultiSegAE):
        keep = tuple(
            t for t in module.name_points_dims if t[0] in set(whitelist)
        )
        pruned = MultiSegAE(
            module.preencoder,
            class_labels=module.class_labels,
            name_points_dims=keep,
        )
        heads = [f"{part}_{name}" for name, _, _ in keep
                 for part in ("bottleneck", "decoder")]
    elif isinstance(module, MultiGTEncoder):
        keep = {k: v for k, v in module.state_dims.items() if k in set(whitelist)}
        pruned = MultiGTEncoder(module.preencoder, state_dims=keep)
        heads = [f"head_{name}" for name in keep]
    else:
        return module
    for head in heads:  # the module's own heads, not the fresh ones
        setattr(pruned, head, getattr(module, head))
    return pruned


def _normalize_pc(obs, features):
    """Normalize(obs bbox) o obs_to_pc, as numpy (pc_encoder.py:106-112)."""
    from pointcloud_tpu_torch.data.dataset import obs_to_pc

    with span("encode.normalize"):
        pc = obs_to_pc(obs, features)
        bbox = np.asarray(obs["boundingbox"], dtype=np.float32)
        lo, extent = bbox[:, 0], bbox[:, 1] - bbox[:, 0]
        pc = pc.copy()
        pc[:, :3] = (pc[:, :3] - lo) / extent
        return pc


def _run(fn, pc, device):
    """fn on one normalized cloud (N, C) as a (1, N, C) batch on `device`,
    in eval mode without autograd; the outputs' row 0 as float32 numpy (a
    tensor, or a dict of them)."""
    with span("encode.h2d"):
        x = torch.from_numpy(pc[None]).to(device)
    with span("encode.forward"), torch.no_grad():
        out = fn(x)
    with span("encode.d2h"):
        if isinstance(out, dict):
            count("host_sync", len(out))
            return {k: v[0].float().cpu().numpy() for k, v in out.items()}
        count("host_sync")
        return out[0].float().cpu().numpy()


class LatentEncoder(ObservationEncoder):
    """Base for encoders producing latent encodings; manages the calibrated
    per-dim latent success threshold sidecar (reference pc_encoder.py:53-77)."""

    latent_encoding = True

    def __init__(self, env, obs_keys, goal_keys, metadata_dir):
        super().__init__(env, obs_keys, goal_keys)
        self.metadata_dir = metadata_dir
        self.latent_threshold = self.load_latent_threshold()

    def load_latent_threshold(self):
        try:
            return load_metadata(self.metadata_dir)["latent_threshold"]
        except (FileNotFoundError, KeyError):
            print("No latent threshold found! Make sure to calibrate the encoder!")
            return None

    def save_latent_threshold(self, threshold, all_before_succ=None, all_dists=None):
        data = {"latent_threshold": threshold}
        if all_before_succ is not None:
            data["all_before_succ"] = all_before_succ
        if all_dists is not None:
            data["all_dists"] = all_dists
        save_metadata(data, self.metadata_dir)
        self.latent_threshold = threshold


class GlobalSceneEncoder(LatentEncoder):
    """Single global latent vector for the whole scene: Autoencoder or
    Segmenter bottleneck (reference pc_encoder.py:80-123)."""

    requires_vision = True
    latent_encoding = True
    global_encoding = True

    def __init__(self, env, obs_keys, goal_keys, model, backbone, version=None):
        super().__init__(
            env, obs_keys, goal_keys, metadata_path(env.scene, model, backbone, version)
        )
        if model not in ("Autoencoder", "Segmenter"):
            raise NotImplementedError(model)
        self.features = ["rgb"]
        self.encoding_dim = sum(env.class_latent_dim)
        self.device = resolve_device(env.device)
        self.model, _ = load_model(env.scene, model, backbone, version, device=self.device)

    def encode_observation(self, obs):
        with span("encode.observe"):
            pc = _normalize_pc(obs, self.features)
            return _run(self.model.encode, pc, self.device)

    def encode_goal(self, obs):
        return self.encode_observation(obs)

    def __call__(self, obs):
        enc = self.encode_observation(obs)
        return enc, enc

    def get_encoding_space(self, robo_env):
        return Box(
            low=self.dtype(-np.inf), high=self.dtype(np.inf),
            shape=(self.encoding_dim,),
        )

    def get_goal_space(self, robo_env):
        return self.get_encoding_space(robo_env)


class GlobalAEEncoder(GlobalSceneEncoder):
    backbone = "PointNet2"

    def __init__(self, env, obs_keys, goal_keys):
        super().__init__(env, obs_keys, goal_keys, "Autoencoder", self.backbone)


class GlobalSegmenterEncoder(GlobalSceneEncoder):
    backbone = "PointNet2"

    def __init__(self, env, obs_keys, goal_keys):
        super().__init__(env, obs_keys, goal_keys, "Segmenter", self.backbone)


class MultiSegmenterEncoder(LatentEncoder):
    """Per-class latent vectors from the MultiSegAE bottlenecks; obs and goal
    spaces can differ (reference pc_encoder.py:138-210)."""

    requires_vision = True
    latent_encoding = True
    global_encoding = False

    state_to_class = {
        "cube_pos": "cube",
        "robot0_eef_pos": "gripper",
        "peg_to_hole": "peg_hole",
        "peg_quat": "robot0",
        "hole_pos": "robot1",
        "hole_quat": None,
        "t": "peg_hole",
        "d": None,
        "angle": None,
    }

    backbone = "PointNet2"

    def __init__(self, env, obs_keys, goal_keys):
        super().__init__(
            env, obs_keys, goal_keys,
            metadata_path(env.scene, "MultiSegmenter", self.backbone),
        )
        self.features = ["rgb"]
        self.obs_classes = [
            self.state_to_class[c] for c in self.obs_keys if self.state_to_class[c]
        ]
        self.goal_classes = [
            self.state_to_class[c] for c in self.goal_keys if self.state_to_class[c]
        ]
        self.all_classes = set(self.obs_classes + self.goal_classes)

        class_dims = {
            c: d
            for c, d in zip(env.classes, env.class_latent_dim)
            if c and d > 0
        }
        self.encoding_dim = sum(class_dims[c] for c in self.obs_classes)
        self.goal_encoding_dim = sum(class_dims[c] for c in self.goal_classes)
        self.device = resolve_device(env.device)
        self.model, _ = load_model(env.scene, "MultiSegmenter", self.backbone,
                                   whitelist=self.all_classes, device=self.device)

    def encode_classes(self, obs):
        pc = _normalize_pc(obs, self.features)
        return _run(self.model.encode, pc, self.device)

    def encode_observation(self, obs):
        return flatten_classes(self.encode_classes(obs), self.obs_classes)

    def encode_goal(self, obs):
        return flatten_classes(self.encode_classes(obs), self.goal_classes)

    def __call__(self, obs):
        enc = self.encode_classes(obs)
        return (
            flatten_classes(enc, self.obs_classes),
            flatten_classes(enc, self.goal_classes),
        )

    def get_encoding_space(self, robo_env):
        return Box(
            low=self.dtype(-np.inf), high=self.dtype(np.inf),
            shape=(self.encoding_dim,),
        )

    def get_goal_space(self, robo_env):
        return Box(
            low=self.dtype(-np.inf), high=self.dtype(np.inf),
            shape=(self.goal_encoding_dim,),
        )


class StatePredictor(ObservationEncoder):
    """Predicts ground-truth states from the cloud; encodings live in state
    space (reference pc_encoder.py:214-294). passthrough_goal short-circuits
    goal encoding to the GT goal state and disables visual goals."""

    requires_vision = True
    latent_encoding = False
    global_encoding = False

    @staticmethod
    def to_state(env):
        from pointcloud_tpu_torch.transforms import Unnormalize

        un = Unnormalize(env.bbox)
        f = lambda x: un(torch.as_tensor(np.asarray(x)))[0].numpy()  # noqa: E731
        return {"cube_pos": f, "robot0_eef_pos": f, "hole_pos": f}

    @staticmethod
    def from_state(env):
        from pointcloud_tpu_torch.transforms import Normalize

        n = Normalize(env.bbox)
        f = lambda x: n(torch.as_tensor(np.asarray(x)))[0].numpy()  # noqa: E731
        return {"cube_pos": f, "robot0_eef_pos": f, "hole_pos": f}

    backbone = "PointNet2"

    def __init__(self, env, obs_keys, goal_keys, passthrough_goal=True):
        super().__init__(env, obs_keys, goal_keys)
        self.features = ["rgb"]
        self.all_keys = set(self.obs_keys + self.goal_keys)

        state_dims = {
            s: d for s, d in zip(env.states, env.state_dim) if s and d > 0
        }
        self.encoding_dim = sum(state_dims[s] for s in self.obs_keys)
        self.goal_encoding_dim = sum(state_dims[s] for s in self.goal_keys)
        self.device = resolve_device(env.device)
        self.model, _ = load_model(env.scene, "StatePredictor", self.backbone,
                                   whitelist=self.all_keys, device=self.device)
        self.postprocessors = StatePredictor.to_state(env)
        self.passthrough_goal = passthrough_goal
        if self.passthrough_goal:
            self.env.visual_goal = False

    def predict_states(self, obs):
        pc = _normalize_pc(obs, self.features)
        out = _run(self.model, pc, self.device)
        return {
            k: self.postprocessors[k](v) if k in self.postprocessors else v
            for k, v in out.items()
        }

    def encode_observation(self, obs):
        return flatten_classes(self.predict_states(obs), self.obs_keys)

    def encode_goal(self, obs):
        if self.passthrough_goal:
            return flatten_classes(obs, self.goal_keys)
        return flatten_classes(self.predict_states(obs), self.goal_keys)

    def __call__(self, obs):
        states = self.predict_states(obs)
        enc = flatten_classes(states, self.obs_keys)
        goal = (
            flatten_classes(obs, self.goal_keys)
            if self.passthrough_goal
            else flatten_classes(states, self.goal_keys)
        )
        return enc, goal

    def get_encoding_space(self, robo_env):
        return Box(
            low=self.dtype(-np.inf), high=self.dtype(np.inf),
            shape=(self.encoding_dim,),
        )

    def get_goal_space(self, robo_env):
        return Box(
            low=self.dtype(-np.inf), high=self.dtype(np.inf),
            shape=(self.goal_encoding_dim,),
        )


class StatePredictorVisualGoal(StatePredictor):
    """StatePredictor that also encodes goals visually
    (reference pc_encoder.py:296-298)."""

    def __init__(self, env, obs_keys, goal_keys):
        super().__init__(env, obs_keys, goal_keys, passthrough_goal=False)
