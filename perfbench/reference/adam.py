"""Plain reference of Adam as ``torch.optim.Adam(eps=1e-15)`` steps it,
bias-corrected, one learning rate per tensor."""
from __future__ import annotations

B1, B2, EPS = 0.9, 0.999, 1e-15


def step(params: dict, grads: dict, mu: dict, nu: dict, lrs: dict, t: int):
    """In place: moments, then parameters, for step ``t`` (1-based)."""
    bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
    for k, p in params.items():
        g = grads[k]
        mu[k].mul_(B1).add_(g, alpha=1 - B1)
        nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
        p.sub_(lrs[k] * (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + EPS))
