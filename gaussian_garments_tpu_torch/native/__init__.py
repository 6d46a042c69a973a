"""Native (C++) BVH ray caster, built with g++ and loaded with ctypes.

The port's own copy of ``gaussian_garments_tpu/native``: ``raytrace.cpp``
replaces the reference's open3d/embree ``RaycastingScene``. The library is
built at first use into the git-ignored ``gaussian_garments_tpu_torch/build/``,
keyed by a hash of the source and flags. A failed build raises: there is no
slower fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "raytrace.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libgg_raytrace_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``raytrace.cpp`` unless a library of the same source and flags
    is already built. Raises RuntimeError if g++ fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {SOURCE}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
            lib.bvh_build.restype = ctypes.c_void_p
            lib.bvh_build.argtypes = [fp, ctypes.c_int32, ip, ctypes.c_int32]
            lib.bvh_free.argtypes = [ctypes.c_void_p]
            lib.bvh_free.restype = None
            lib.bvh_raycast.argtypes = [ctypes.c_void_p, fp, fp, ctypes.c_int32, fp, ip]
            lib.bvh_raycast.restype = None
            _lib = lib
        return _lib


class BVH:
    """Reusable BVH handle for repeated casts against the same mesh."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self._lib = _load()
        v = np.ascontiguousarray(vertices, np.float32)
        f = np.ascontiguousarray(faces, np.int32)
        self._keepalive = (v, f)
        self._h = self._lib.bvh_build(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(f))

    def raycast(self, origins: np.ndarray, dirs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """First hit per ray: (t (R,) float64, face id (R,) int64, -1 on a miss)."""
        o = np.ascontiguousarray(origins, np.float32)
        d = np.ascontiguousarray(dirs, np.float32)
        n = len(o)
        t = np.empty((n,), np.float32)
        pid = np.empty((n,), np.int32)
        self._lib.bvh_raycast(
            self._h, o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            pid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return t.astype(np.float64), pid.astype(np.int64)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.bvh_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
