"""Photometric losses: masked L1 and window-11 SSIM (port of
``gaussian_garments_tpu/utils/losses.py``; reference ``utils/loss_utils.py``).

The reference's quirk is kept: the SSIM mask multiplies both images *before*
the SSIM windows are computed (``loss_utils.py:44-46``).

The SSIM blur is a separable 11-tap Gaussian with zero padding, run as two
depthwise convolutions in full float32: the entry points turn TF32 off
(``pin_full_f32``), which cuDNN would otherwise use for float32
convolutions. The JAX training step runs its blur as a 3-pass bf16 matmul
(``fast=True``, ≤3.5e-3 on the SSIM term), a TPU speed trade the port does
not make.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def l1_loss(network_output: torch.Tensor, gt: torch.Tensor, mask=None) -> torch.Tensor:
    if mask is None:
        return torch.abs(network_output - gt).mean()
    return torch.abs((network_output - gt) * mask).mean()


def _gaussian_window(window_size: int, sigma: float, device) -> torch.Tensor:
    gauss = torch.tensor([math.exp(-((x - window_size // 2) ** 2) / float(2 * sigma ** 2))
                          for x in range(window_size)], dtype=torch.float32, device=device)
    return gauss / gauss.sum()


def _blur(img: torch.Tensor, window_size: int, sigma: float = 1.5) -> torch.Tensor:
    """Depthwise separable Gaussian blur of (N,C,H,W), SAME zero padding."""
    c = img.shape[1]
    w = _gaussian_window(window_size, sigma, img.device)
    pad = window_size // 2
    out = F.conv2d(img, w.view(1, 1, 1, -1).expand(c, 1, 1, window_size).contiguous(),
                   padding=(0, pad), groups=c)
    return F.conv2d(out, w.view(1, 1, -1, 1).expand(c, 1, window_size, 1).contiguous(),
                    padding=(pad, 0), groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, mask=None, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM over (C,H,W) or (N,C,H,W) images, in float32; reference
    ``loss_utils.py:36-69``."""
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
        if mask is not None:
            mask = mask[None]
    if mask is not None:
        mask = mask.to(torch.float32)
        img1 = img1 * mask
        img2 = img2 * mask
    c = img1.shape[1]
    b = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=1),
              window_size)
    mu1, mu2 = b[:, 0:c], b[:, c:2 * c]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = b[:, 2 * c:3 * c] - mu1_sq
    sigma2_sq = b[:, 3 * c:4 * c] - mu2_sq
    sigma12 = b[:, 4 * c:5 * c] - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1.to(torch.float32) - img2.to(torch.float32)) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
