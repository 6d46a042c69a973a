"""General helpers (port of ``gaussian_garments_tpu/utils/general.py``;
reference ``utils/general_utils.py``)."""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def inverse_sigmoid(x):
    """log(x / (1 − x)) of a tensor or a numpy array / float."""
    if isinstance(x, torch.Tensor):
        return torch.log(x / (1 - x))
    return np.log(x / (1 - x))


def get_expon_lr_func(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
                      lr_delay_mult: float = 1.0, max_steps: int = 1000000) -> Callable:
    """Log-linear learning-rate decay (JaxNeRF style); reference
    ``general_utils.py:39-72``. The returned callable maps a step to a float,
    computed in float32 like the JAX version."""

    def helper(step) -> float:
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        t = np.float32(min(max(step / max_steps, 0.0), 1.0))
        log_lerp = np.exp(np.log(np.float32(lr_init)) * (1 - t) + np.log(np.float32(lr_final)) * t)
        return float(np.float32(delay_rate) * log_lerp)

    return helper


def knn_numpy(pts: np.ndarray, num_knn: int):
    """(sq_dists, indices) of each point's k nearest neighbours, excluding
    itself (scipy cKDTree on the host; the reference's ``o3d_knn``)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.ascontiguousarray(pts, np.float64))
    dists, idx = tree.query(pts, k=num_knn + 1)
    return dists[:, 1:] ** 2, idx[:, 1:]
