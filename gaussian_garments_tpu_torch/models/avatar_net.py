"""Appearance network AvatarNet as a torch module.

Port of ``gaussian_garments_tpu/models/avatar_net.py`` (reference
``scene/avatar_net.py``): a SWGAN UNet maps the per-frame [AO(1) +
camera-space normal(3)] texture to per-texel [Δxyz(3) + ΔSH((deg+1)²·3)],
with a small conv encoder of per-texel local view directions injected
mid-decoder and a constant style vector.

Reference quirks kept verbatim:
- ``viewdir_map[gs_u, gs_u]``: the (u,u) scatter, not (u,v) (:74);
- the "camera-space" normal is Rᵀ·n, from contracting the transposed-storage
  matrix on the wrong side (:66-67);
- the viewdir feature is added after the level's ToRGB at i == 8, so it does
  not reach the output at 512² textures;
- a Fourier embedder is constructed but never used (:15).

State-dict keys are the Flax parameter paths joined with dots
(``shadow_net.conv_0.conv.weight``, ``viewdir_net.conv0_w``, buffers
``shadow_net.noise_0``...); ``training.checkpoints`` converts both ways.

``act_dtype=torch.bfloat16`` (``s3_appearance --unet_bf16``) casts the UNet's
inputs to bf16 and its output back to float32; the caller casts the weights
(``training.s3._cast_net_vars``), as the JAX trainer does, so every op of the
UNet, the modulation and demodulation included, runs in bf16.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
from gaussian_garments_tpu_torch.models import gaussian as G
from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
from gaussian_garments_tpu_torch.models.appearance import get_embedder
from gaussian_garments_tpu_torch.models.styleunet import SWGANUnet, _c


class ViewdirNet(nn.Module):
    """Conv2d(3→64,k4,s2,p1) → LeakyReLU(0.2) → Conv2d(64→128,k4,s2,p1), NCHW."""

    def __init__(self, generator=None):
        super().__init__()
        for name, (o, i) in (("conv0", (64, 3)), ("conv1", (128, 64))):
            std = (2.0 / (i * 16)) ** 0.5
            setattr(self, f"{name}_w", nn.Parameter(torch.randn((o, i, 4, 4), generator=generator) * std))
            setattr(self, f"{name}_b", nn.Parameter(torch.zeros(o)))

    def forward(self, x):
        x = F.leaky_relu(F.conv2d(x, self.conv0_w, self.conv0_b, stride=2, padding=1),
                         _c(0.2, x.dtype))
        return F.conv2d(x, self.conv1_w, self.conv1_b, stride=2, padding=1)


class AvatarNet(nn.Module):
    def __init__(self, texture_size: int, sh_degree: int, generator=None,
                 act_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.texture_size = texture_size
        self.sh_degree = sh_degree
        self.act_dtype = act_dtype
        self.embedder, self.embedder_dim = get_embedder(input_dim=7)   # unused (:15)
        self.shadow_net = SWGANUnet(
            inp_size=texture_size, inp_ch=4, out_ch=(sh_degree + 1) ** 2 * 3 + 3,
            out_size=texture_size, style_dim=texture_size, n_mlp=2, generator=generator)
        self.viewdir_net = ViewdirNet(generator=generator)

    def forward(self, ambient, normal, world_view_transform, camera_center,
                bind: AG.AvatarBinding, mesh_v, mesh_f, frames: MG.FaceFrames,
                rows: Optional[torch.Tensor] = None):
        """Returns the raw (C_out, res, res) texture output.
        ambient (1,res,res); normal (3,res,res) object-space in [0,1]."""
        res = self.texture_size
        valid = (normal.sum(0, keepdim=True) > 0).to(torch.float32)
        nw_pad = torch.cat([normal * 2 - 1, normal.new_ones((1, res, res))], dim=0) * valid
        nc = torch.einsum("ab,bcd->acd", world_view_transform, nw_pad)[:3]
        nc = nc / torch.clamp(torch.linalg.norm(nc, dim=0, keepdim=True), min=1e-12)

        gs_3d = AG.barycentric_3d(bind, mesh_v, mesh_f, rows=rows)
        dir_pp = gs_3d - camera_center[None]
        dir_pp = dir_pp / torch.clamp(torch.linalg.norm(dir_pp, dim=1, keepdim=True), min=1e-12)
        rows9 = (MG.gather_frame_rows(frames, bind.binding) if rows is None else rows)[:, MG.FR_R]
        local_viewdir = MG.rows_rot_apply_t(rows9, dir_pp)
        uu_flat = bind.gs_u * res + bind.gs_u                       # the (u,u) quirk
        if bind.alive is not None:
            # dense layout: dead texels write a dropped dummy row, so only
            # alive texels land, as in the compact scatter
            uu_flat = torch.where(bind.alive, uu_flat, res * res)
        vd_flat = local_viewdir.new_zeros((res * res + 1, 3))
        vd_flat[uu_flat] = local_viewdir
        viewdir_map = vd_flat[:res * res].reshape(res, res, 3).permute(2, 0, 1)
        view_feature = self.viewdir_net(viewdir_map[None].to(self.act_dtype))

        style = ambient.new_ones((1, res), dtype=self.act_dtype) / _c(float(res) ** 0.5,
                                                                      self.act_dtype)
        combined = torch.cat([ambient, nc], dim=0)[None].to(self.act_dtype)
        out = self.shadow_net(style, combined, view_feature=view_feature)
        return out[0].to(torch.float32)


def apply_shadow(bind: AG.AvatarBinding, params: G.GaussianParams,
                 shadow_tex: torch.Tensor, sh_degree: int):
    """Split the net output into per-texel Δxyz and ΔSH (reference :82-85).
    Returns (local_xyz, shs (G,K,3))."""
    rows = AG.gather_texture(bind, shadow_tex)
    local_xyz = params.xyz + rows[:, :3]
    delta_sh = rows[:, 3:].reshape(rows.shape[0], -1, 3)
    return local_xyz, G.get_features(params) + delta_sh
