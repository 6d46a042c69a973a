"""Host ray casting through the port's native BVH.

Port of ``raycast_first_hit`` from ``gaussian_garments_tpu/ops/raytrace.py``.
It uses the C++ BVH of ``gaussian_garments_tpu_torch.native``, which raises
when the library cannot be built: the numpy Möller–Trumbore sweep would take
hours at 262K texels × 64 AO samples.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def bvh(vertices: np.ndarray, faces: np.ndarray):
    """A reusable BVH over one mesh."""
    from gaussian_garments_tpu_torch.native import BVH

    return BVH(vertices, faces)


def raycast_first_hit(origins: np.ndarray, dirs: np.ndarray, vertices: np.ndarray,
                      faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """First hit per ray: (t_hit (R,), prim_id (R,) int64, -1 for a miss)."""
    return bvh(vertices, faces).raycast(origins, dirs)
