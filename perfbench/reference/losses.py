"""Plain reference of the photometric losses (Gaussian Garments'
``utils/loss_utils.py``): masked L1 and the window-11 SSIM, whose mask
multiplies both images before the windows are taken (a published quirk,
kept)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.tf32 import round_tf32


def l1(img, gt, mask=None):
    d = torch.abs(img - gt)
    return (d if mask is None else d * mask).mean()


def _window(size: int, sigma: float, device):
    g = torch.tensor([math.exp(-((x - size // 2) ** 2) / (2 * sigma ** 2)) for x in range(size)],
                     dtype=torch.float32, device=device)
    return g / g.sum()


def ssim(img1, img2, mask=None, size: int = 11, tf32: bool = False):
    """Mean SSIM of (N,C,H,W) images, Gaussian window σ = 1.5, zero padding;
    ``tf32`` rounds the blur's operands to TF32 (the control)."""
    rnd = round_tf32 if tf32 else (lambda x: x)
    if mask is not None:
        img1, img2 = img1 * mask, img2 * mask
    c = img1.shape[1]
    w = rnd(_window(size, 1.5, img1.device))
    x = rnd(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], 1))
    k = x.shape[1]
    x = rnd(F.conv2d(x, w.view(1, 1, 1, -1).expand(k, 1, 1, size), padding=(0, size // 2),
                     groups=k))
    x = F.conv2d(x, w.view(1, 1, -1, 1).expand(k, 1, size, 1), padding=(size // 2, 0), groups=k)
    mu1, mu2, e11, e22, e12 = x.split(c, 1)
    s1, s2, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()
