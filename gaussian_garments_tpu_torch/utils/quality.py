"""Quality measurement: PSNR/SSIM over camera sets (port of
``gaussian_garments_tpu/utils/quality.py``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from gaussian_garments_tpu_torch.utils.losses import psnr as _psnr, ssim as _ssim


@torch.no_grad()
def image_metrics(render: torch.Tensor, gt: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """PSNR/SSIM of one (3,H,W) render against ground truth in [0,1], plus
    the masked variants (the MSE over the penalized-mask region, and SSIM
    with the mask applied to both images first, like the training loss)."""
    render = torch.clamp(render, 0.0, 1.0)
    out = {"psnr": float(_psnr(render, gt)), "ssim": float(_ssim(render[None], gt[None]))}
    if mask is not None:
        m = mask.to(torch.float32)
        if m.ndim == 2:
            m = m[None]
        denom = torch.clamp(m.sum() * gt.shape[0], min=1.0)
        mse = (((render - gt) * m) ** 2).sum() / denom
        out["psnr_masked"] = float(-10.0 * torch.log10(torch.clamp(mse, min=1e-12)))
        out["ssim_masked"] = float(_ssim(render[None], gt[None], mask=m[None]))
    return out


def evaluate_cameras(cams: Sequence, render_fn: Callable,
                     max_cams: Optional[int] = None) -> Dict[str, float]:
    """Mean metrics over ``cams``; ``render_fn(cam) -> (3,H,W)``. Returns {}
    for an empty camera list."""
    cams = list(cams)[: (max_cams or len(cams))]
    if not cams:
        return {}
    acc: Dict[str, float] = {}
    for cam in cams:
        for k, v in image_metrics(render_fn(cam), cam.original_image, cam.gt_alpha_mask).items():
            acc[k] = acc.get(k, 0.0) + v
    return {k: v / len(cams) for k, v in acc.items()}
