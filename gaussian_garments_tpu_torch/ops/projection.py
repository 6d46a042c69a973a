"""EWA projection of 3D Gaussians to screen space.

Port of ``gaussian_garments_tpu/ops/projection.py``: view/projection
transform, frustum cull, 3D covariance from (scale, rotation), EWA splat with
the 0.3 low-pass dilation, conic inversion, 3σ radius and SH→RGB, batched
over the splat axis. All of it is float32; the small transforms are written
as explicit multiply-adds, so no matmul precision setting (TF32) can touch
them.

Matrices are stored transposed, as in the reference:
``p_view = [p, 1] @ world_view_transform``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from gaussian_garments_tpu_torch.utils import sh as sh_utils


class ProjectedGaussians(NamedTuple):
    """Per-splat screen-space quantities consumed by the compositors."""

    means2d: torch.Tensor   # (N,2) pixel coords (ndc2Pix convention)
    conic: torch.Tensor     # (N,3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor     # (N,) view-space z
    radii: torch.Tensor     # (N,) int32 3σ pixel radius (0 = culled)
    rgb: torch.Tensor       # (N,3)
    opacity: torch.Tensor   # (N,) in [0,1]


def transform_point_4x3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row-vector affine transform: (N,3) @ (4,4)[:, :3], in f32."""
    return p[:, 0:1] * m[0, :3] + p[:, 1:2] * m[1, :3] + p[:, 2:3] * m[2, :3] + m[3, :3]


def transform_point_4x4(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Row-vector homogeneous transform -> (N,4), in f32."""
    return p[:, 0:1] * m[0, :] + p[:, 1:2] * m[1, :] + p[:, 2:3] * m[2, :] + m[3, :]


def build_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                scaling_modifier: float = 1.0) -> torch.Tensor:
    """Σ = (R S)(R S)ᵀ packed as (xx,xy,xz,yy,yz,zz), column-wise like the
    JAX version."""
    from gaussian_garments_tpu_torch.utils import quaternion

    q = quaternion.normalize(rotations)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s = scaling_modifier * scales
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    return torch.stack(
        [
            r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2,
            r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2,
            r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2,
            r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2,
            r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2,
            r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2,
        ],
        dim=-1,
    )


def _ewa_cov2d(means3d, cov3d, viewmatrix, focal_x, focal_y, tanfovx, tanfovy):
    """Σ₂D = J W Σ Wᵀ Jᵀ (upper 2×2) + 0.3·I. Returns ((N,3), view z)."""
    t = transform_point_4x3(means3d, viewmatrix)
    limx, limy = 1.3 * tanfovx, 1.3 * tanfovy
    tz = t[:, 2]
    txtz = torch.clamp(t[:, 0] / tz, -limx, limx)
    tytz = torch.clamp(t[:, 1] / tz, -limy, limy)
    tx, ty = txtz * tz, tytz * tz

    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)

    W = viewmatrix[:3, :3]     # transposed storage: W_row_r[c] = viewmatrix[c, r]
    m0 = j00[:, None] * W[:, 0][None, :] + j02[:, None] * W[:, 2][None, :]
    m1 = j11[:, None] * W[:, 1][None, :] + j12[:, None] * W[:, 2][None, :]

    sxx, sxy, sxz, syy, syz, szz = (cov3d[:, i] for i in range(6))

    def sigma_dot(v):
        return torch.stack([
            sxx * v[:, 0] + sxy * v[:, 1] + sxz * v[:, 2],
            sxy * v[:, 0] + syy * v[:, 1] + syz * v[:, 2],
            sxz * v[:, 0] + syz * v[:, 1] + szz * v[:, 2],
        ], dim=-1)

    s_m0 = sigma_dot(m0)
    s_m1 = sigma_dot(m1)
    c00 = torch.sum(m0 * s_m0, dim=-1) + 0.3
    c01 = torch.sum(m0 * s_m1, dim=-1)
    c11 = torch.sum(m1 * s_m1, dim=-1) + 0.3
    return torch.stack([c00, c01, c11], dim=-1), tz


def project_gaussians(
    means3d: torch.Tensor,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    campos: torch.Tensor,
    *,
    image_width: int,
    image_height: int,
    tanfovx: Union[float, torch.Tensor],
    tanfovy: Union[float, torch.Tensor],
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    opacities: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    scaling_modifier: float = 1.0,
    screen_offset: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """Project N Gaussians into one camera (argument contract of the CUDA
    rasterizer call: scales+rotations or cov3d_precomp; shs or colors).

    ``screen_offset`` (N,2), if given, is added to the pixel-space means: a
    differentiable hook whose gradient is ∂L/∂mean2D, the reference's
    ``screenspace_points.retain_grad()`` channel for densification stats. The
    cull still uses the means without it, as in the JAX package.

    ``tanfovx`` and ``tanfovy`` are floats or 0-d tensors on the splats'
    device: a step captured as a CUDA graph takes them as inputs, where a
    float would be frozen into the graph."""
    n = means3d.shape[0]
    cov3d = build_cov3d(scales, rotations, scaling_modifier) if cov3d_precomp is None \
        else cov3d_precomp

    focal_x = image_width / (2.0 * tanfovx)
    focal_y = image_height / (2.0 * tanfovy)

    p_hom = transform_point_4x4(means3d, projmatrix)
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]

    cov2d, depth = _ewa_cov2d(means3d, cov3d, viewmatrix, focal_x, focal_y, tanfovx, tanfovy)

    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack([cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det,
                         cov2d[:, 0] * inv_det], dim=-1)

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=1e-12)))

    mx = ((p_proj[:, 0] + 1.0) * image_width - 1.0) * 0.5
    my = ((p_proj[:, 1] + 1.0) * image_height - 1.0) * 0.5
    means2d = torch.stack([mx, my], dim=-1)
    if screen_offset is not None:
        means2d = means2d + screen_offset

    visible = ((depth > 0.2) & (det != 0.0) & (mx + radius >= 0) & (mx - radius < image_width)
               & (my + radius >= 0) & (my - radius < image_height))
    radii = torch.where(visible, radius, torch.zeros_like(radius)).to(torch.int32)

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        dirs = means3d - campos[None, :]
        dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
        rgb = sh_utils.eval_sh(sh_degree, shs.transpose(-1, -2), dirs)
        rgb = torch.clamp(rgb + 0.5, min=0.0)

    opac = means3d.new_zeros((n,)) if opacities is None else opacities.reshape(n)
    opac = torch.where(visible, opac, torch.zeros_like(opac))
    return ProjectedGaussians(means2d=means2d, conic=conic, depth=depth, radii=radii,
                              rgb=rgb, opacity=opac)
