"""Point-to-point ICP on the host in numpy (the port's own copy of
``gaussian_garments_tpu/ops/icp.py``, which holds no jax).

Replaces open3d's ``registration_icp`` used by the cross-scene first-frame
global alignment (``scene/cross_scene.py:145-187``): nearest-neighbor
correspondences + Kabsch rigid fit, iterated with a distance gate. Also the
voxel-downsample / radius-outlier helpers the reference applies first
(``binary_to_o3d`` :177-187).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv, points)
    return sums / counts[:, None]


def remove_radius_outliers(points: np.ndarray, nb_points: int = 5, radius: float = 0.05) -> np.ndarray:
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    neigh = tree.query_ball_point(points, r=radius, return_length=True)
    return points[np.asarray(neigh) >= nb_points]


def kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Best-fit rigid transform (4,4) mapping src -> dst."""
    cs, cd = src.mean(0), dst.mean(0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = cd - R @ cs
    return T


def registration_icp(source: np.ndarray, target: np.ndarray,
                     max_correspondence_distance: float,
                     max_iterations: int = 30, tol: float = 1e-7) -> np.ndarray:
    """Returns the (4,4) transformation aligning source onto target
    (open3d ``registration_icp`` point-to-point semantics)."""
    from scipy.spatial import cKDTree

    T = np.eye(4)
    src = np.asarray(source, np.float64).copy()
    tree = cKDTree(np.asarray(target, np.float64))
    prev_rmse = np.inf
    for _ in range(max_iterations):
        d, idx = tree.query(src)
        gate = d < max_correspondence_distance
        if gate.sum() < 3:
            break
        step = kabsch(src[gate], np.asarray(target)[idx[gate]])
        src = src @ step[:3, :3].T + step[:3, 3]
        T = step @ T
        rmse = float(np.sqrt((d[gate] ** 2).mean()))
        if abs(prev_rmse - rmse) < tol:
            break
        prev_rmse = rmse
    return T


def transform_points(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    return points @ T[:3, :3].T + T[:3, 3]
