"""Per-step scalar logging, step timing and the stage-2 debug panel (port of
``gaussian_garments_tpu/utils/logging.py``; the reference's observability is
tqdm postfix dicts and debug renders, ``s2_registration.py:65-78,98-122``).

- ``MetricLogger``: cumulative averages like the reference's logger, plus an
  append-only JSONL stream;
- ``StepTimer``: wall-clock per-phase timing with exponential smoothing;
- ``shaded_mesh_image`` and ``debug_panel``: GT | penalized mask | render |
  abs-diff | shaded mesh, the stage-2 saver's panel.

The JAX package's ``trace`` (``jax.profiler``) has no counterpart here:
``torch.profiler`` is called directly where it is needed.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None):
        self.sums: Dict[str, float] = {}
        self.count = 0
        self._f = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._f = open(jsonl_path, "a")

    def log(self, step: int, scalars: Dict[str, float], **extra):
        vals = {k: float(v) for k, v in scalars.items()}
        self.count += 1
        for k, v in vals.items():
            self.sums[k] = self.sums.get(k, 0.0) + v
        if self._f is not None:
            rec = {"step": int(step), **vals,
                   **{k: (v if isinstance(v, str) else float(v)) for k, v in extra.items()},
                   "time": time.time()}
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return self.averages()

    def averages(self) -> Dict[str, float]:
        """Cumulative averages (the reference's tqdm postfix)."""
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}

    def close(self):
        if self._f is not None:
            self._f.close()


class StepTimer:
    """Per-phase wall timing with exponential smoothing."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.avg: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.avg[name] = dt if name not in self.avg else \
            (1 - self.alpha) * self.avg[name] + self.alpha * dt


def shaded_mesh_image(verts, faces, camera, body_v=None, body_f=None) -> np.ndarray:
    """Flat-shaded render of the tracked garment (tinted blue) over the body
    (grey), depth-correct by rasterizing both meshes together on the camera's
    device: the role of the reference saver's aitviewer column
    (s2_registration.py:40-62,110-113). Returns (3,H,W) in [0,1] on a white
    background."""
    import torch

    from gaussian_garments_tpu_torch.ops.mesh_raster import rasterize_mesh

    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    n_garment = len(f)
    if body_v is not None and len(body_v):
        f = np.concatenate([f, np.asarray(body_f, np.int64) + len(v)])
        v = np.concatenate([v, np.asarray(body_v, np.float32)])
    dev = camera.world_view_transform.device
    with torch.no_grad():
        p2f, _ = rasterize_mesh(torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev),
                                camera.world_view_transform, camera.full_proj_transform,
                                image_width=camera.image_width, image_height=camera.image_height)
    p2f = p2f.cpu().numpy()

    normals = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    view = camera.camera_center.cpu().numpy()[None] - v[f].mean(axis=1)
    view /= np.maximum(np.linalg.norm(view, axis=1, keepdims=True), 1e-12)
    shade = 0.3 + 0.7 * np.abs((normals * view).sum(axis=1))          # headlight
    tint = np.where((np.arange(len(f)) < n_garment)[:, None],
                    np.array([[0.55, 0.70, 1.00]]), np.array([[0.80, 0.80, 0.80]]))
    face_rgb = shade[:, None] * tint

    img = np.ones((camera.image_height, camera.image_width, 3), np.float32)
    hit = p2f >= 0
    img[hit] = face_rgb[p2f[hit]]
    return img.transpose(2, 0, 1)


def debug_panel(gt_image: np.ndarray, penalized_mask: np.ndarray, render: np.ndarray,
                path: Optional[str] = None, mesh_render: Optional[np.ndarray] = None) -> np.ndarray:
    """GT | penalized mask | render | abs-diff [| shaded mesh] row panel
    (s2_registration.py:98-122). Inputs (3,H,W)/(1,H,W) in [0,1]."""
    gt = np.asarray(gt_image).transpose(1, 2, 0)
    rd = np.clip(np.asarray(render), 0, 1).transpose(1, 2, 0)
    mask = np.repeat(np.asarray(penalized_mask).transpose(1, 2, 0), 3, axis=2)
    cols = [gt, mask, rd, np.abs(gt - rd)]
    if mesh_render is not None:
        cols.append(np.clip(np.asarray(mesh_render), 0, 1).transpose(1, 2, 0))
    panel = np.concatenate(cols, axis=1)
    if path is not None:
        from gaussian_garments_tpu_torch.utils.io import save_image

        save_image(path, panel)
    return panel
