"""Ray casting: the brute-force Möller–Trumbore first hit on the device, and
the host BVH.

``raycast`` ports ``raycast_jnp`` from ``gaussian_garments_tpu/ops/raytrace.py``:
every ray against every triangle in tensor ops, rays in chunks that hold the
(chunk, F, 3) intermediates to a byte budget. It serves the exact visibility
(the reference's open3d first-hit test, ``inference.py:295-316`` and
``avatar_gaussian_model.py:227-263``). ``raycast_first_hit`` ports the host
path through the C++ BVH of ``gaussian_garments_tpu_torch.native``, which
raises when the library cannot be built: the numpy sweep would take hours at
262K texels × 64 AO samples.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_EPS = 1e-9
# bytes of one (chunk, F, 3) float32 intermediate of a chunk of rays, so that
# the chunk shrinks as the mesh grows: 5,063 rays at 4,418 faces. On an H100
# (700 W) 262,144 rays × 4,418 faces took 345 / 219 / 197 / 190 ms at chunks
# of 256 / 1,024 / 4,096 / 16,384 (chip_smoke.py)
BUDGET = 256 << 20


def chunk_rays(n_faces: int, budget: int = BUDGET) -> int:
    """Rays per chunk whose (chunk, F, 3) float32 intermediates fit ``budget`` bytes."""
    return max(1, budget // (12 * n_faces))


def _moller_trumbore(origins, dirs, v0, e1, e2) -> torch.Tensor:
    """origins, dirs (R,3); v0, e1, e2 (F,3). Returns t (R,F), +inf for a miss."""
    pvec = torch.linalg.cross(dirs[:, None, :], e2[None])                  # (R,F,3)
    det = torch.sum(pvec * e1[None], dim=-1)
    hit = torch.abs(det) > _EPS
    inv_det = torch.where(hit, 1.0 / det, torch.zeros_like(det))
    tvec = origins[:, None, :] - v0[None]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None])
    v = torch.sum(dirs[:, None, :] * qvec, dim=-1) * inv_det
    t = torch.sum(e2[None] * qvec, dim=-1) * inv_det
    valid = hit & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > _EPS)
    return torch.where(valid, t, torch.full_like(t, float("inf")))


def raycast(origins: torch.Tensor, dirs: torch.Tensor, vertices: torch.Tensor,
            faces: torch.Tensor, budget: int = BUDGET) -> Tuple[torch.Tensor, torch.Tensor]:
    """First hit per ray: (t_hit (R,), prim_id (R,) int64, -1 for a miss);
    the first face among equal nearest hits. Rays go in chunks of
    ``chunk_rays(F, budget)``."""
    faces = faces.to(torch.int64)
    chunk = chunk_rays(faces.shape[0], budget)
    v0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - v0
    e2 = vertices[faces[:, 2]] - v0
    t_out, id_out = [], []
    for s in range(0, origins.shape[0], chunk):
        t = _moller_trumbore(origins[s:s + chunk], dirs[s:s + chunk], v0, e1, e2)
        tmin = t.min(dim=-1).values
        pid = torch.argmin(t, dim=-1)
        t_out.append(tmin)
        id_out.append(torch.where(torch.isfinite(tmin), pid, torch.full_like(pid, -1)))
    return torch.cat(t_out), torch.cat(id_out)


def visibility(points: torch.Tensor, cam_center: torch.Tensor, vertices: torch.Tensor,
               faces: torch.Tensor, expected_face: torch.Tensor,
               tol: float = 1e-3) -> torch.Tensor:
    """Point visible from the camera: the camera→point ray's first hit is the
    face the point lies on, or is not nearer than the point. (R,) bool."""
    d = points - cam_center[None]
    dist = torch.linalg.norm(d, dim=-1)
    dirs = d / torch.clamp(dist[:, None], min=1e-12)
    t, pid = raycast(cam_center[None].expand_as(points), dirs, vertices, faces)
    return (pid == expected_face) | (t >= dist * (1.0 - tol))


def bvh(vertices: np.ndarray, faces: np.ndarray):
    """A reusable BVH over one mesh."""
    from gaussian_garments_tpu_torch.native import BVH

    return BVH(vertices, faces)


def raycast_first_hit(origins: np.ndarray, dirs: np.ndarray, vertices: np.ndarray,
                      faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """First hit per ray on the host: (t_hit (R,), prim_id (R,) int64, -1 for
    a miss)."""
    return bvh(vertices, faces).raycast(origins, dirs)
