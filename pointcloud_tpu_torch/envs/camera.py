"""Depth-map -> point-cloud math (port of pointcloud_tpu/envs/camera.py;
reference: robosuite_envs/utils.py:48-177).

`make_intrinsics`, `quat_to_rotmat`, `extrinsics` and `camera_matrix` are
numpy, as in the JAX package; `project`, `pixel_to_world`, `to_pointcloud`
and `multiview_pointcloud` run on tensors, on the device of their tensor
inputs (numpy inputs go to `device`). Conventions:

  * intrinsics K (3x3): pixel = K @ (x_cam/z, y_cam/z, 1), pixel = (u, v)
    with u = column (x right), v = row (y down).
  * extrinsic E (4x4): world -> camera (OpenCV-style: +z forward).
  * `camera_matrix` = K_hom @ E (4x4), the analog of robosuite's
    get_camera_transform_matrix (world -> pixel); unprojection inverts it
    exactly like the reference's pixel_to_world (utils.py:48-74).

`multiview_pointcloud(views, transform, features)` fuses per-camera clouds
and applies the sensor preprocessing chain on the device
(utils.py:129-177).
"""

from __future__ import annotations

import numpy as np
import torch


def make_intrinsics(fovy_rad: float, height: int, width: int) -> np.ndarray:
    """Pinhole K from a vertical field of view (MuJoCo convention)."""
    f = 0.5 * height / np.tan(fovy_rad / 2)
    return np.array(
        [[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]], dtype=np.float32
    )


def quat_to_rotmat(quat) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(quat, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n if n > 0 else 0.0
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ],
        dtype=np.float32,
    )


def extrinsics(cam_pos, cam_quat) -> np.ndarray:
    """World -> camera 4x4 from camera pose (position + (w,x,y,z) quat of the
    camera-to-world rotation)."""
    R_c2w = quat_to_rotmat(cam_quat)
    t = np.asarray(cam_pos, dtype=np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = R_c2w.T
    E[:3, 3] = -R_c2w.T @ t
    return E


def camera_matrix(K: np.ndarray, E: np.ndarray) -> np.ndarray:
    """World -> pixel 4x4 (robosuite get_camera_transform_matrix analog)."""
    K_hom = np.eye(4, dtype=np.float32)
    K_hom[:3, :3] = K
    return K_hom @ E


def _tensor(x, device) -> torch.Tensor:
    """x as a float32 tensor: a tensor stays on its device, numpy (flipped
    views, as robosuite's bottom-up images give, included) goes to
    `device`."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=device)


def project(points, cam_mat):
    """World points (N, 3) -> (pixels (N, 2) as (u, v), depth (N,))."""
    p = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    q = p @ cam_mat.T
    depth = q[..., 2]
    return q[..., :2] / depth[..., None], depth


def pixel_to_world(depth, inv_cam_mat):
    """Unproject a full (H, W) real-depth map to world points (H*W, 3)
    (reference pixel_to_world, utils.py:48-74)."""
    H, W = depth.shape
    dev = depth.device
    u = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W) + 0.5
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W) + 0.5
    d = depth
    # pixel-homogeneous scaled by depth: (u*d, v*d, d, 1)
    ph = torch.stack([u * d, v * d, d, torch.ones_like(d)], dim=-1).reshape(-1, 4)
    world = ph @ inv_cam_mat.T
    return world[:, :3] / world[:, 3:4]


def to_pointcloud(depth, feature_maps: dict, cam_mat, device="cuda"):
    """Depth + per-pixel feature maps -> (points (H*W, 3), {name: (H*W, C)})
    (reference to_pointcloud, utils.py:96-126)."""
    depth = _tensor(depth, device)
    inv = torch.linalg.inv(_tensor(cam_mat, depth.device))
    pts = pixel_to_world(depth, inv)
    feats = {}
    for name, fmap in feature_maps.items():
        fmap = _tensor(fmap, depth.device)
        C = fmap.shape[-1] if fmap.ndim == 3 else 1
        feats[name] = fmap.reshape(-1, C)
    return pts, feats


def multiview_pointcloud(views, transform=None, features=("rgb",), device="cuda"):
    """Fuse per-camera depth observations into one preprocessed cloud
    (reference multiview_pointcloud, utils.py:129-177).

    views: list of dicts with 'depth' (H, W) real depth, 'camera_matrix'
    (4, 4) world->pixel, and per-pixel feature maps named in `features`
    ('rgb' in [0,1], 'segmentation' integer labels, ...), numpy or tensors.
    transform: a transforms.Compose applied to the fused (points || feats)
    cloud on the device (a sampler that draws holds its own generator).
    Returns (points (K, 3), {feature: (K, C)}) as tensors.
    """
    all_pts, all_feats = [], []
    dims = {}
    for view in views:
        fmaps = {f: view[f] for f in features}
        pts, feats = to_pointcloud(view["depth"], fmaps, view["camera_matrix"], device)
        all_pts.append(pts)
        all_feats.append(feats)
        dims = {f: all_feats[0][f].shape[-1] for f in features}
    points = torch.cat(all_pts, dim=0)
    feats = {f: torch.cat([v[f] for v in all_feats], dim=0) for f in features}
    pc = torch.cat([points] + [feats[f] for f in features], dim=-1)
    if transform is not None:
        pc, _ = transform(pc)
    # split back by feature dims (utils.py:172-175)
    out_points = pc[:, :3]
    out_feats = {}
    off = 3
    for f in features:
        out_feats[f] = pc[:, off : off + dims[f]]
        off += dims[f]
    return out_points, out_feats
