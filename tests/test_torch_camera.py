"""The port's camera math (envs/camera.py) and its robosuite backend
against the JAX package's on the CPU.

Tolerance: the numpy helpers exactly; the tensor functions 1e-5 relative
to the largest entry (both invert the 4x4 camera matrix in float32, by
different routines). RobosuiteBackend runs against tests/fake_robosuite.py,
as tests/test_robosuite_contract.py runs the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_utils  # noqa: F401  (one torch thread per worker)
from torch_bridge_utils import close_to

from pointcloud_tpu.envs import camera as jcam
from pointcloud_tpu_torch.envs import camera as tcam
from tests import fake_robosuite

H, W = 24, 40


def views(seed, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pos = rng.uniform(-1.5, 1.5, 3)
        quat = rng.standard_normal(4)
        K = jcam.make_intrinsics(np.deg2rad(40.0 + 5 * i), H, W)
        out.append({
            "depth": rng.uniform(0.5, 3.0, (H, W)).astype(np.float32),
            "camera_matrix": jcam.camera_matrix(K, jcam.extrinsics(pos, quat / np.linalg.norm(quat))),
            "rgb": rng.random((H, W, 3), dtype=np.float32),
            "segmentation": rng.integers(0, 5, (H, W, 1)).astype(np.int32),
        })
    return out


def test_numpy_helpers_equal():
    rng = np.random.default_rng(0)
    for _ in range(4):
        quat = rng.standard_normal(4)
        pos = rng.standard_normal(3)
        np.testing.assert_array_equal(tcam.quat_to_rotmat(quat), jcam.quat_to_rotmat(quat))
        np.testing.assert_array_equal(tcam.extrinsics(pos, quat), jcam.extrinsics(pos, quat))
        K = tcam.make_intrinsics(0.7, 64, 32)
        np.testing.assert_array_equal(K, jcam.make_intrinsics(0.7, 64, 32))
        E = tcam.extrinsics(pos, quat)
        np.testing.assert_array_equal(tcam.camera_matrix(K, E), jcam.camera_matrix(K, E))


def test_project_and_pixel_to_world():
    v = views(1, 1)[0]
    cam = v["camera_matrix"]
    pts = np.random.default_rng(2).uniform(-1, 1, (50, 3)).astype(np.float32)
    (uv, d), (juv, jd) = (tcam.project(torch.from_numpy(pts), torch.from_numpy(cam)),
                          jcam.project(jnp.asarray(pts), jnp.asarray(cam)))
    close_to(uv.numpy(), np.asarray(juv), 1e-5, "pixels")
    close_to(d.numpy(), np.asarray(jd), 1e-5, "depth")
    inv = np.linalg.inv(cam.astype(np.float64)).astype(np.float32)
    got = tcam.pixel_to_world(torch.from_numpy(v["depth"]), torch.from_numpy(inv))
    want = jcam.pixel_to_world(jnp.asarray(v["depth"]), jnp.asarray(inv))
    assert got.shape == (H * W, 3)
    close_to(got.numpy(), np.asarray(want), 1e-5, "pixel_to_world")
    # the unprojected points project back onto their pixels at their depth
    uv, d = tcam.project(got.double(), torch.from_numpy(cam).double())
    close_to(d.reshape(H, W).numpy(), v["depth"], 1e-5, "round trip")


def test_to_pointcloud_and_multiview():
    vs = views(3)
    pts, feats = tcam.to_pointcloud(vs[0]["depth"], {"rgb": vs[0]["rgb"]},
                                    vs[0]["camera_matrix"], device="cpu")
    jpts, jfeats = jcam.to_pointcloud(vs[0]["depth"], {"rgb": vs[0]["rgb"]},
                                      vs[0]["camera_matrix"])
    close_to(pts.numpy(), np.asarray(jpts), 1e-5, "to_pointcloud")
    np.testing.assert_array_equal(feats["rgb"].numpy(), np.asarray(jfeats["rgb"]))
    features = ("rgb", "segmentation")
    pts, feats = tcam.multiview_pointcloud(vs, features=features, device="cpu")
    jpts, jfeats = jcam.multiview_pointcloud(vs, features=features)
    assert pts.shape == (3 * H * W, 3) and feats["segmentation"].shape == (3 * H * W, 1)
    close_to(pts.numpy(), np.asarray(jpts), 1e-5, "multiview")
    for f in features:
        np.testing.assert_array_equal(feats[f].numpy(), np.asarray(jfeats[f]))
    # with the sensor's filter: the mask is the transform's, the rows stay
    from pointcloud_tpu_torch.transforms import Compose, FilterBBox

    box = [[-1, 1], [-1, 1], [-1, 1]]
    fpts, _ = tcam.multiview_pointcloud(vs, transform=Compose([FilterBBox(box)]),
                                        features=features, device="cpu")
    torch.testing.assert_close(fpts, pts, rtol=0, atol=0)


@pytest.fixture
def backends(monkeypatch):
    fake_robosuite.install(monkeypatch)
    from pointcloud_tpu.envs.backends import RobosuiteBackend as JBackend
    from pointcloud_tpu.envs.scenes import cfg_scene, robo_kwargs
    from pointcloud_tpu_torch.envs.backends import RobosuiteBackend as TBackend
    from pointcloud_tpu_torch.envs.backends import robosuite_available

    assert robosuite_available()
    sc = cfg_scene["Cube"]
    kw = dict(cameras=list(sc["cameras"]), camera_poses=list(sc["cameras"].values()),
              camera_size=(64, 32))
    rk = robo_kwargs["Cube"] | {"camera_depths": True, "camera_segmentations": "instance"}
    j = JBackend(rk, **kw)
    t = TBackend(rk, device="cpu", **kw)
    yield j, t
    j.close()
    t.close()


def test_robosuite_capture_pointcloud(backends):
    """The fused cloud of the fake's three cameras: as the JAX backend's,
    one point per pixel per camera at the served 2 m depth."""
    j, t = backends
    j.reset()
    t.reset()
    assert fake_robosuite.calls["make_kwargs"]["camera_names"] == [
        "frontview", "agentview", "birdview"]
    pts, feats = t.capture_pointcloud(features=("rgb", "segmentation"))
    jpts, jfeats = j.capture_pointcloud(features=("rgb", "segmentation"))
    n = 3 * 32 * 64
    assert pts.shape == (n, 3) and feats["segmentation"].shape == (n, 1)
    assert isinstance(pts, np.ndarray)
    close_to(pts, jpts, 1e-5, "fused cloud")
    for f in ("rgb", "segmentation"):
        np.testing.assert_array_equal(feats[f], jfeats[f])
    from robosuite.utils.camera_utils import get_camera_transform_matrix

    for i, cam in enumerate(t.cameras):
        cam_mat = get_camera_transform_matrix(None, cam, 32, 64)
        chunk = torch.from_numpy(pts[i * 32 * 64:(i + 1) * 32 * 64])
        _, depth = tcam.project(chunk, torch.from_numpy(np.asarray(cam_mat, np.float32)))
        np.testing.assert_allclose(depth.numpy(), 2.0, atol=1e-3)


def test_robosuite_goal_env_through_the_fake(monkeypatch):
    """gym.make of the port's id takes the robosuite backend where robosuite
    imports; the GoalEnv API runs on it."""
    fake_robosuite.install(monkeypatch)
    import gymnasium as gym

    import pointcloud_tpu_torch  # noqa: F401
    from pointcloud_tpu_torch.envs.backends import RobosuiteBackend
    from pointcloud_tpu_torch.envs.envs import RoboReach

    env = gym.make("pointcloud_tpu_torch/RoboReach-v0", device="cpu").unwrapped
    assert isinstance(env, RoboReach) and isinstance(env.backend, RobosuiteBackend)
    obs, info = env.reset(seed=0)
    assert set(obs) == {"observation", "achieved_goal", "desired_goal"}
    _, reward, _, _, _ = env.step(np.zeros(7, np.float32))
    assert reward in (-1, 0)
    env.close()
