"""Per-tensor Adam with ``torch.optim.Adam(eps=1e-15)`` semantics (port of
``gaussian_garments_tpu/models/adam.py``).

Plain tensor math, not ``torch.optim``: densification edits the moments row
by row and carries them across, as the JAX package does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_garments_tpu_torch.utils import logging as log


class TensorAdam(NamedTuple):
    step: int
    mu: torch.Tensor
    nu: torch.Tensor


def tensor_adam_init(p: torch.Tensor) -> TensorAdam:
    return TensorAdam(0, torch.zeros_like(p), torch.zeros_like(p))


def bias_corrections(step: int, b1: float = 0.9, b2: float = 0.999):
    """(1 − b1^step, 1 − b2^step) in float32, as the JAX step computes them."""
    s = torch.tensor(float(step), dtype=torch.float32)
    return (1.0 - torch.tensor(b1, dtype=torch.float32) ** s,
            1.0 - torch.tensor(b2, dtype=torch.float32) ** s)


def to_device(bcs, device):
    """The host's bias corrections copied to ``device``. On a card each copy
    from pageable host memory waits for the stream: a host sync each."""
    with log.span("sync"):
        log.count("host_syncs", len(bcs))
        return tuple(x.to(device) for x in bcs)


def adam_update(p, g, mu, nu, lr, bc1, bc2, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15):
    """One Adam update of one tensor: (new p, new mu, new nu); ``bc1`` and
    ``bc2`` on ``p``'s device."""
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    return p - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps), mu, nu


def tensor_adam_step(p: torch.Tensor, g: torch.Tensor, state: TensorAdam, lr,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15, bcs=None):
    """One Adam step of ``p``. ``bcs``: the step's bias corrections already on
    ``p``'s device (a step under CUDA graph capture reads them from its
    inputs); by default ``bias_corrections`` of the step, copied there."""
    step = state.step + 1
    bc1, bc2 = to_device(bias_corrections(step, b1, b2), p.device) if bcs is None else bcs
    new_p, mu, nu = adam_update(p, g, state.mu, state.nu, lr, bc1, bc2, b1, b2, eps)
    return new_p, TensorAdam(step, mu, nu)


class TreeAdam(NamedTuple):
    """Adam state over a dict of tensors (the JAX package's ``TreeAdam``
    over a pytree): one step counter, first and second moments per key."""

    step: int
    mu: dict
    nu: dict


def tree_adam_init(params: dict) -> TreeAdam:
    return TreeAdam(0, {k: torch.zeros_like(v) for k, v in params.items()},
                    {k: torch.zeros_like(v) for k, v in params.items()})


def tree_adam_step(params: dict, grads: dict, state: TreeAdam, lr, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-15, bcs=None):
    """One Adam step of every tensor of ``params``; ``lr`` one learning rate
    for all, or a dict of one per key. ``bcs`` as ``tensor_adam_step`` takes
    it; by default copied to the card once, not once per tensor."""
    step = state.step + 1
    bc1, bc2 = to_device(bias_corrections(step, b1, b2),
                         next(iter(params.values())).device) if bcs is None else bcs
    lrs = lr if isinstance(lr, dict) else dict.fromkeys(params, lr)
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        new_p[k], mu[k], nu[k] = adam_update(p, grads[k], state.mu[k], state.nu[k], lrs[k],
                                             bc1, bc2, b1, b2, eps)
    return new_p, TreeAdam(step, mu, nu)
