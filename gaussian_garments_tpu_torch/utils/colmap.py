"""COLMAP binary/text model parsers (the port's own copy of
``gaussian_garments_tpu/utils/colmap.py``, which holds no jax).

Reference ``scene/colmap_loader.py``: readers for the COLMAP
``cameras`` / ``images`` / ``points3D`` files, used by the cross-scene
sparse-ICP alignment (``scene/cross_scene.py:37,145-187``) and by stage-1
tooling. Self-contained struct parsing; no COLMAP python deps.
"""
from __future__ import annotations

import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray   # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * n_params))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64).reshape(n_pts, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].view(np.int64)[...]
            out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id,
                                      name.decode("utf-8"), xys, ids.copy())
    return out


def read_points3D_binary(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz (N,3), rgb (N,3), errors (N,1)) like the reference
    ``read_points3D_binary``."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty((n, 1))
        for i in range(n):
            data = _read(f, "<QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


def read_points3D_text(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            e = line.split()
            xyz.append([float(x) for x in e[1:4]])
            rgb.append([float(x) for x in e[4:7]])
            err.append([float(e[7])])
    return np.array(xyz), np.array(rgb), np.array(err)


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
