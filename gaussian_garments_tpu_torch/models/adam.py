"""Per-tensor Adam with ``torch.optim.Adam(eps=1e-15)`` semantics (port of
``gaussian_garments_tpu/models/adam.py``).

Plain tensor math, not ``torch.optim``: densification edits the moments row
by row and carries them across, as the JAX package does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TensorAdam(NamedTuple):
    step: int
    mu: torch.Tensor
    nu: torch.Tensor


def tensor_adam_init(p: torch.Tensor) -> TensorAdam:
    return TensorAdam(0, torch.zeros_like(p), torch.zeros_like(p))


def bias_corrections(step: int, b1: float, b2: float):
    """(1 − b1^step, 1 − b2^step) in float32, as the JAX step computes them."""
    s = torch.tensor(float(step), dtype=torch.float32)
    return (1.0 - torch.tensor(b1, dtype=torch.float32) ** s,
            1.0 - torch.tensor(b2, dtype=torch.float32) ** s)


def adam_update(p, g, mu, nu, lr, bc1, bc2, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15):
    """One Adam update of one tensor: (new p, new mu, new nu)."""
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    return p - lr * (mu / bc1.to(p.device)) / (torch.sqrt(nu / bc2.to(p.device)) + eps), mu, nu


def tensor_adam_step(p: torch.Tensor, g: torch.Tensor, state: TensorAdam, lr,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    step = state.step + 1
    bc1, bc2 = bias_corrections(step, b1, b2)
    new_p, mu, nu = adam_update(p, g, state.mu, state.nu, lr, bc1, bc2, b1, b2, eps)
    return new_p, TensorAdam(step, mu, nu)
