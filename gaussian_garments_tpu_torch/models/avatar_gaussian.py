"""UV-texel Gaussians: one splat per texel inside the template's UV islands.

Port of the inference parts of ``gaussian_garments_tpu/models/avatar_gaussian.py``
(reference ``scene/avatar_gaussian_model.py``), compact layout only: a
scanline bind map gives each texel its face, each texel stores the
barycentric coordinates of its centre in that UV triangle, and its anchor and
world position follow the deforming mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gaussian_garments_tpu_torch import geometry as geo
from gaussian_garments_tpu_torch import resolve_device
from gaussian_garments_tpu_torch.models import gaussian as G
from gaussian_garments_tpu_torch.models import mesh_gaussian as MG


def rasterize_uv_bind_map(uvs: np.ndarray, texture_faces: np.ndarray, res: int) -> np.ndarray:
    """(res,res) bind map, -1 where no face covers the texel. Scanline fill
    with the reference's pixel rule (``avatar_gaussian_model.py:196-225``):
    centres (x+.5, y+.5), y ∈ [v1.y, v3.y), x ∈ [fmin, fmax); later faces
    overwrite earlier ones. Host numpy."""
    bind_map = np.full((res, res), -1, np.int64)
    uv_px = np.asarray(uvs, np.float64) * res
    for fi, tf in enumerate(np.asarray(texture_faces)):
        tri = uv_px[tf]
        v1, v2, v3 = tri[np.argsort(tri[:, 1], kind="stable")]
        if v3[1] == v1[1]:
            continue
        v4 = v1 + (v3 - v1) * ((v2[1] - v1[1]) / (v3[1] - v1[1]))
        ys = np.arange(int(np.floor(tri[:, 1].min())), int(np.floor(tri[:, 1].max())) + 1)
        yc = ys + 0.5
        ok = (yc >= v1[1]) & (yc < v3[1])
        for _y, y in zip(ys[ok], yc[ok]):
            if y < v2[1]:
                a, b, c, d = v1, v2, v1, v4
            else:
                a, b, c, d = v3, v2, v3, v4
            x1 = a[0] + (b[0] - a[0]) * (y - a[1]) / (b[1] - a[1]) if b[1] != a[1] else a[0]
            x2 = c[0] + (d[0] - c[0]) * (y - c[1]) / (d[1] - c[1]) if d[1] != c[1] else c[0]
            fmin, fmax = sorted([x1, x2])
            xs = np.arange(int(np.floor(fmin)), int(np.floor(fmax)) + 1)
            xs = xs[(xs + 0.5 >= fmin) & (xs + 0.5 < fmax)]
            if len(xs) and 0 <= _y < res:
                bind_map[_y, xs[(xs >= 0) & (xs < res)]] = fi
    return bind_map


@dataclasses.dataclass(frozen=True)
class AvatarBinding:
    """Static texel→face binding (compact layout: G texels inside UV islands)."""

    binding: torch.Tensor   # (G,) int64 face ids
    gs_bc: torch.Tensor     # (G,3) barycentric coords of the texel centre
    flat_idx: torch.Tensor  # (G,) int64 = gs_u*res + gs_v (row-major texel)
    gs_u: torch.Tensor      # (G,) int64 row (v) index
    gs_v: torch.Tensor      # (G,) int64 col (u) index
    texture_size: int = 512


def build_binding(uvs: np.ndarray, texture_faces: np.ndarray, res: int,
                  bind_map: Optional[np.ndarray] = None,
                  device=None) -> Tuple[AvatarBinding, np.ndarray]:
    """Bind map + barycentric anchors (reference __init__ :47-65), on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    if bind_map is None:
        bind_map = rasterize_uv_bind_map(uvs, texture_faces, res)
    gs_u, gs_v = np.where(bind_map > -1)
    binding = bind_map[gs_u, gs_v]
    uv_tri = np.asarray(uvs)[np.asarray(texture_faces)][binding] * res    # (G,3,2)
    uv_gs = np.stack([gs_v, gs_u], axis=1) + 0.5
    a, b, c = geo.barycentric_2d(torch.from_numpy(uv_tri.astype(np.float32)),
                                 torch.from_numpy(uv_gs.astype(np.float32)))
    as_long = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    bind = AvatarBinding(
        binding=as_long(binding), gs_bc=torch.stack([a, b, c], dim=1).to(device),
        flat_idx=as_long(gs_u * res + gs_v), gs_u=as_long(gs_u), gs_v=as_long(gs_v),
        texture_size=res)
    return bind, bind_map


def barycentric_3d(bind: AvatarBinding, mesh_v: torch.Tensor, mesh_f: torch.Tensor,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3D anchor of each texel on the current mesh (reference :151-159)."""
    tv = mesh_v[mesh_f].reshape(-1, 9)[bind.binding] if rows is None else rows[:, MG.FR_V]
    bc = bind.gs_bc
    return torch.stack([bc[:, 0] * tv[:, c] + bc[:, 1] * tv[:, 3 + c] + bc[:, 2] * tv[:, 6 + c]
                        for c in range(3)], dim=1)


def avatar_world_xyz(local_xyz: torch.Tensor, bind: AvatarBinding, frames: MG.FaceFrames,
                     anchor: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """world = R_face @ local · s_face + anchor (reference :140-148)."""
    if rows is None:
        rows = MG.gather_frame_rows(frames, bind.binding)
    return MG.rows_rot_apply(rows[:, MG.FR_R], local_xyz) * rows[:, MG.FR_S] + anchor


def gather_texture(bind: AvatarBinding, texture: torch.Tensor) -> torch.Tensor:
    """(C,res,res) texture → (G,C) per-texel rows."""
    res = bind.texture_size
    return texture.permute(1, 2, 0).reshape(res * res, -1)[bind.flat_idx]


def init_empty(bind: AvatarBinding, max_sh_degree: int) -> G.GaussianParams:
    """Zero splats to be filled from a texture checkpoint (reference :318-332)."""
    n = bind.binding.shape[0]
    r = (max_sh_degree + 1) ** 2 - 1
    z = lambda *s: torch.zeros((n, *s), dtype=torch.float32, device=bind.binding.device)
    return G.GaussianParams(xyz=z(3), features_dc=z(1, 3), features_rest=z(r, 3),
                            scaling=z(3), rotation=z(4), opacity=z(1))


def adapt_params_layout(bind: AvatarBinding, params: G.GaussianParams) -> G.GaussianParams:
    """Checkpoint rows → this binding's compact rows: a dense-layout checkpoint
    (res² rows) keeps its alive texels in row-major order."""
    if params.xyz.shape[0] == bind.binding.shape[0]:
        return params
    take = bind.flat_idx.to(params.xyz.device)
    return G.GaussianParams(**{k: getattr(params, k)[take] for k in G.PARAM_NAMES})
