"""Camera model with the reference's transposed (row-vector) matrices.

Port of ``gaussian_garments_tpu/utils/camera.py``: the matrices are built in
numpy exactly as the JAX version builds them, then held as torch tensors on
one device, the card unless the caller passes ``device="cpu"``.
``p_clip = [p, 1] @ full_proj_transform``. A camera may carry its
ground-truth image (3,H,W) and penalized mask (1,H,W), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gaussian_garments_tpu_torch import resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_world2view2(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """World->view 4x4 (non-transposed); reference ``getWorld2View2``."""
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.float32(np.linalg.inv(C2W))


def get_projection_matrix(znear, zfar, fx, fy, cx, cy, w, h) -> np.ndarray:
    """Principal-point-aware perspective projection (non-transposed)."""
    top = cy / fy * znear
    bottom = -(h - cy) / fy * znear
    right = cx / fx * znear
    left = -(w - cx) / fx * znear

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """One pinhole camera. ``world_view_transform[i, j] = W2V[j, i]``."""

    world_view_transform: torch.Tensor  # (4,4) transposed world->view
    full_proj_transform: torch.Tensor   # (4,4) transposed proj @ world->view
    camera_center: torch.Tensor         # (3,)
    original_image: Optional[torch.Tensor] = None  # (3,H,W) in [0,1]
    gt_alpha_mask: Optional[torch.Tensor] = None   # (1,H,W) penalized mask
    image_width: int = 0
    image_height: int = 0
    FoVx: float = 0.0
    FoVy: float = 0.0
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    znear: float = 0.01
    zfar: float = 100.0
    uid: int = 0
    image_name: str = ""

    @property
    def tanfovx(self) -> float:
        return math.tan(self.FoVx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.FoVy * 0.5)

    @property
    def R(self) -> np.ndarray:
        """world_view_transform[:3, :3] as numpy (the JAX package's ``R``)."""
        return self.world_view_transform[:3, :3].cpu().numpy()

    @property
    def T(self) -> np.ndarray:
        return self.world_view_transform[3, :3].cpu().numpy()

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)


def make_camera(R: np.ndarray, T: np.ndarray, fx: float, fy: float, cx: float, cy: float,
                width: int, height: int, *, image: Optional[np.ndarray] = None,
                gt_alpha_mask: Optional[np.ndarray] = None, znear: float = 0.01,
                zfar: float = 100.0, trans=None, scale: float = 1.0, uid: int = 0,
                image_name: str = "", device=None) -> Camera:
    """Reference ``scene/cameras.py:17-62``: R is the camera-to-world rotation,
    T the world-to-view translation (COLMAP convention). The image is clipped
    to [0, 1]."""
    device = resolve_device(device)
    w2v = get_world2view2(np.asarray(R), np.asarray(T), trans, scale)
    proj = get_projection_matrix(znear, zfar, fx, fy, cx, cy, width, height)
    world_view_transform = w2v.T
    full_proj_transform = (proj @ w2v).T
    camera_center = np.linalg.inv(world_view_transform)[3, :3]
    img = None if image is None else torch.clamp(
        torch.as_tensor(np.asarray(image), dtype=torch.float32, device=device), 0.0, 1.0)
    mask = None if gt_alpha_mask is None else torch.as_tensor(
        np.asarray(gt_alpha_mask), dtype=torch.float32, device=device)
    return Camera(
        world_view_transform=torch.as_tensor(np.ascontiguousarray(world_view_transform),
                                             dtype=torch.float32, device=device),
        full_proj_transform=torch.as_tensor(np.ascontiguousarray(full_proj_transform),
                                            dtype=torch.float32, device=device),
        camera_center=torch.as_tensor(camera_center.astype(np.float32), device=device),
        original_image=img, gt_alpha_mask=mask, image_width=int(width), image_height=int(height),
        FoVx=float(focal2fov(fx, width)), FoVy=float(focal2fov(fy, height)),
        fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
        znear=float(znear), zfar=float(zfar), uid=int(uid), image_name=image_name)


def camera_from_json_params(params: dict, h: int = 1280, w: int = 940, device=None) -> Camera:
    """Reference ``scene/cameras.py:78-89``: a camera from an
    {intrinsics, extrinsics} dict."""
    intrinsic = np.asarray(params["intrinsics"])
    extrinsic = np.asarray(params["extrinsics"])
    R, T = np.transpose(extrinsic[:, :3]), extrinsic[:, 3]
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    return make_camera(R=R, T=T, fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h,
                       device=device)


def camera_to_json(id: int, camera: Camera) -> dict:
    """Serialize like the reference ``utils/camera_utils.py:64-84``."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = camera.R.T
    Rt[:3, 3] = camera.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": id,
        "img_name": camera.image_name,
        "width": camera.image_width,
        "height": camera.image_height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": fov2focal(camera.FoVy, camera.image_height),
        "fx": fov2focal(camera.FoVx, camera.image_width),
    }
