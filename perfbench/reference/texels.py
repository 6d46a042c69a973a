"""Plain reference of the texel binding and the face-bound splat transforms
(Gaussian Garments, ``scene/avatar_gaussian_model.py`` and
``scene/mesh_gaussian_model.py``).

- ``uv_bind_map``: the published scanline fill of the UV triangles into a
  res² texel map (centres (x+.5, y+.5), rows y ∈ [v1.y, v3.y), columns
  x ∈ [fmin, fmax), later faces overwrite earlier ones), vectorised over
  (face, row) in float64;
- ``binding``: each texel inside an island, its face and the barycentric
  coordinates of its centre;
- ``face_frames``: the per-face orthonormal frame (with the published sign
  quirk on the third axis), its quaternion and isotropic scale;
- ``texel_splats``: local offsets and splat tensors → world-space splats.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def uv_bind_map(uvs: np.ndarray, texture_faces: np.ndarray, res: int) -> np.ndarray:
    """(res, res) int64 face id per texel, -1 where no face covers it."""
    tri = np.asarray(uvs, np.float64)[np.asarray(texture_faces)] * res       # (F,3,2)
    order = np.argsort(tri[:, :, 1], axis=1, kind="stable")
    tri = np.take_along_axis(tri, order[:, :, None], axis=1)
    v1, v2, v3 = tri[:, 0], tri[:, 1], tri[:, 2]
    ok_face = v3[:, 1] != v1[:, 1]
    den = np.where(ok_face, v3[:, 1] - v1[:, 1], 1.0)
    v4 = v1 + (v3 - v1) * ((v2[:, 1] - v1[:, 1]) / den)[:, None]
    y_lo = np.floor(tri[:, :, 1].min(1)).astype(np.int64)
    y_hi = np.floor(tri[:, :, 1].max(1)).astype(np.int64)
    n_rows = np.where(ok_face, y_hi - y_lo + 1, 0)
    face = np.repeat(np.arange(len(tri)), n_rows)
    y = (y_lo[face] + (np.arange(n_rows.sum()) - np.repeat(np.cumsum(n_rows) - n_rows, n_rows)))
    yc = y + 0.5
    keep = (yc >= v1[face, 1]) & (yc < v3[face, 1]) & (y >= 0) & (y < res)
    face, y, yc = face[keep], y[keep], yc[keep]
    upper = yc < v2[face, 1]
    a = np.where(upper[:, None], v1[face], v3[face])
    b = v2[face]
    d = v4[face]

    def edge_x(p, q):
        dy = q[:, 1] - p[:, 1]
        return np.where(dy != 0, p[:, 0] + (q[:, 0] - p[:, 0]) * (yc - p[:, 1])
                        / np.where(dy != 0, dy, 1.0), p[:, 0])

    x1, x2 = edge_x(a, b), edge_x(a, d)
    fmin, fmax = np.minimum(x1, x2), np.maximum(x1, x2)
    x_lo = np.floor(fmin).astype(np.int64)
    n_cols = np.floor(fmax).astype(np.int64) - x_lo + 1
    row = np.repeat(np.arange(len(face)), n_cols)
    x = x_lo[row] + (np.arange(n_cols.sum()) - np.repeat(np.cumsum(n_cols) - n_cols, n_cols))
    keep = (x + 0.5 >= fmin[row]) & (x + 0.5 < fmax[row]) & (x >= 0) & (x < res)
    flat = np.full(res * res, -1, np.int64)
    np.maximum.at(flat, y[row][keep] * res + x[keep], face[row][keep])   # later faces win
    return flat.reshape(res, res)


class Binding(NamedTuple):
    face: torch.Tensor   # (G,) int64
    bc: torch.Tensor     # (G,3) float32 barycentric coordinates of the texel centre
    gs_u: torch.Tensor   # (G,) row
    gs_v: torch.Tensor   # (G,) column
    res: int


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def binding(uvs: np.ndarray, texture_faces: np.ndarray, res: int, device) -> Binding:
    bind_map = uv_bind_map(uvs, texture_faces, res)
    gs_u, gs_v = np.where(bind_map > -1)
    face = bind_map[gs_u, gs_v]
    tri = torch.from_numpy((np.asarray(uvs)[np.asarray(texture_faces)][face] * res)
                           .astype(np.float32))
    p = torch.from_numpy((np.stack([gs_v, gs_u], axis=1) + 0.5).astype(np.float32))
    z = lambda t: torch.cat([t, t.new_zeros(t.shape[:-1] + (1,))], dim=-1)
    tri, p = z(tri), z(p)
    A, B, C = tri[:, 0], tri[:, 1], tri[:, 2]
    n = _cross(B - A, C - A)
    area = torch.clamp(torch.linalg.norm(n, dim=-1), min=1e-12)
    nn_ = n / area[:, None]
    alpha = (_cross(B - p, C - p) * nn_).sum(-1) / area
    beta = (_cross(C - p, A - p) * nn_).sum(-1) / area
    bc = torch.stack([alpha, beta, 1.0 - alpha - beta], dim=1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return Binding(t(face), bc.to(device), t(gs_u), t(gs_v), res)


def _normalize(x, eps):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def quat_normalize(q, eps=1e-12):
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    norm = torch.sqrt(torch.where(sq == 0.0, torch.ones_like(sq), sq)) * (sq != 0.0)
    return q / torch.clamp(norm, min=eps)


def rotmat_to_quat(m):
    """(...,3,3) → wxyz unit quaternion, the largest-pivot branch chosen by ``where``."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    sq = lambda x: torch.sqrt(torch.clamp(x, min=1e-12))
    qw = sq(1.0 + tr) / 2.0
    c0 = torch.stack([qw, (m21 - m12) / (4 * qw), (m02 - m20) / (4 * qw), (m10 - m01) / (4 * qw)],
                     dim=-1)
    s1 = sq(1.0 + m00 - m11 - m22) * 2
    c1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = sq(1.0 + m11 - m00 - m22) * 2
    c2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = sq(1.0 + m22 - m00 - m11) * 2
    c3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)
    q = torch.where((tr > 0.0)[..., None], c0, torch.where(
        ((m00 >= m11) & (m00 >= m22))[..., None], c1,
        torch.where((m11 >= m22)[..., None], c2, c3)))
    return quat_normalize(q)


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


class Frames(NamedTuple):
    rot: torch.Tensor     # (F,3,3) columns a0|a1|a2
    quat: torch.Tensor    # (F,4) normalised wxyz
    scale: torch.Tensor   # (F,)
    center: torch.Tensor  # (F,3)


def face_frames(v: torch.Tensor, f: torch.Tensor) -> Frames:
    tri = v[f]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    a0 = _normalize(v1 - v0, 1e-20)
    a1 = _normalize(_cross(a0, v2 - v0), 1e-20)
    a2 = -_normalize(_cross(a1, a0), 1e-20)
    rot = torch.stack([a0, a1, a2], dim=-1)
    s = (torch.linalg.norm(v1 - v0, dim=-1) + torch.abs((a2 * (v2 - v0)).sum(-1))) / 2.0
    return Frames(rot, quat_normalize(rotmat_to_quat(rot)), s, tri.mean(dim=1))


def anchors(b: Binding, v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(G,3) texel centres on the posed mesh."""
    tv = v[f][b.face]
    return (b.bc[:, :, None] * tv).sum(1)


def texel_splats(b: Binding, v, f, local_xyz, scaling, rotation):
    """World (means (G,3), scales (G,3), rotations (G,4)) of texel splats:
    world = R·local·s + anchor, scale = exp(scaling)·s, rotation = q_face ⊗ q."""
    fr = face_frames(v, f)
    rot, s = fr.rot[b.face], fr.scale[b.face][:, None]
    means = torch.einsum("gij,gj->gi", rot, local_xyz) * s + anchors(b, v, f)
    return (means, torch.exp(scaling) * s,
            quat_normalize(quat_multiply(fr.quat[b.face], quat_normalize(rotation))))


def local_viewdirs(b: Binding, v, f, campos) -> torch.Tensor:
    """(G,3) unit direction camera → texel anchor, in the texel's face frame."""
    d = _normalize(anchors(b, v, f) - campos[None], 1e-12)
    return torch.einsum("gji,gj->gi", face_frames(v, f).rot[b.face], d)
