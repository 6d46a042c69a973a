"""Mesh / cloth geometry: differentiable torch functions and the host-side
connectivity precompute (port of ``gaussian_garments_tpu/geometry.py``).

The small per-face products (2×2 inverses, 3×2 @ 2×2) are written as
elementwise sums, so no matmul precision setting (TF32) can touch them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _safe_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def gather_triangles(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(V,3),(F,3) -> (F,3,3) triangle vertex positions."""
    return v[f]


def face_normals(v: torch.Tensor, f: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Reference ``FaceNormals``: n = (v2 - v1) × (v0 - v1)."""
    tri = v[f]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    n = _cross(v2 - v1, v0 - v1)
    return _safe_normalize(n, 1e-12) if normalize else n


def barycentric_2d(triangles: torch.Tensor, points: torch.Tensor):
    """Barycentric coords of (N,2) points in (N,3,2) triangles -> (α,β,γ)."""
    zeros = triangles.new_zeros(triangles.shape[:-1] + (1,))
    tri = torch.cat([triangles, zeros], dim=-1)
    p = torch.cat([points, points.new_zeros(points.shape[:-1] + (1,))], dim=-1)
    A, B, C = tri[:, 0], tri[:, 1], tri[:, 2]
    N = _cross(B - A, C - A)
    area = torch.linalg.norm(N, dim=-1)
    safe_area = torch.clamp(area, min=1e-12)
    Nn = N / safe_area[:, None]
    alpha = (_cross(B - p, C - p) * Nn).sum(-1) / safe_area
    beta = (_cross(C - p, A - p) * Nn).sum(-1) / safe_area
    gamma = 1.0 - alpha - beta
    return alpha, beta, gamma


def compute_face_orientation(v: torch.Tensor, f: torch.Tensor):
    """Per-face orthonormal frame (columns a0|a1|a2) + isotropic scale,
    including the reference's sign quirk on the third axis."""
    tri = v[f]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    a0 = _safe_normalize(v1 - v0, 1e-20)
    a1 = _safe_normalize(_cross(a0, v2 - v0), 1e-20)
    a2 = -_safe_normalize(_cross(a1, a0), 1e-20)
    orientation = torch.stack([a0, a1, a2], dim=-1)
    s0 = torch.linalg.norm(v1 - v0, dim=-1)
    s1 = torch.abs((a2 * (v2 - v0)).sum(-1))
    return orientation, (s0 + s1) / 2.0


def face_areas(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(F,) triangle areas; reference ``get_face_areas``."""
    tri = v[f]
    return torch.linalg.norm(_cross(tri[:, 2] - tri[:, 0], tri[:, 1] - tri[:, 0]), dim=-1) / 2.0


def vertex_mass(v: torch.Tensor, f: torch.Tensor, density: float) -> torch.Tensor:
    """(V,) lumped vertex masses: 1/3 of each incident face mass."""
    fm = density * face_areas(v, f) / 3.0
    vm = v.new_zeros((v.shape[0],))
    for k in range(3):
        vm = vm.index_add(0, f[:, k], fm)
    return vm


def get_shape_matrix(tri: torch.Tensor) -> torch.Tensor:
    """(F,3,3) -> (F,3,2): columns [v0-v2, v1-v2]."""
    return torch.stack([tri[:, 0] - tri[:, 2], tri[:, 1] - tri[:, 2]], dim=-1)


def edges_3d_to_2d(edges: torch.Tensor) -> torch.Tensor:
    """Project (E,2,3) edge pairs into their intrinsic orthonormal 2D basis ->
    (E,2,2); reference ``edges_3d_to_2d``."""
    e0, e1 = edges[:, 0], edges[:, 1]
    b0 = e0 / torch.linalg.norm(e0, dim=-1, keepdim=True)
    b1 = _cross(_cross(b0, e1), e0)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    return torch.stack([
        torch.stack([(e0 * b0).sum(-1), (e0 * b1).sum(-1)], dim=-1),
        torch.stack([(e1 * b0).sum(-1), (e1 * b1).sum(-1)], dim=-1)], dim=1)


def inv2x2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) matrices."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    return torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) / det[..., None, None]


def make_dm_inv(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(F,2,2) inverse rest-shape matrix in the intrinsic 2D basis; reference
    ``MeshModel.make_Dm_inv``."""
    edges = get_shape_matrix(v[f]).transpose(1, 2)         # (F,2,3) rows = the two edges
    return inv2x2(edges_3d_to_2d(edges).transpose(1, 2))


def deformation_gradient(tri: torch.Tensor, dm_inv: torch.Tensor) -> torch.Tensor:
    """(F,3,2) = Ds @ Dm⁻¹."""
    return (get_shape_matrix(tri)[:, :, :, None] * dm_inv[:, None, :, :]).sum(dim=2)


def green_strain_tensor(F: torch.Tensor) -> torch.Tensor:
    """(F,2,2) = ½(FᵀF − I)."""
    ftf = (F[:, :, :, None] * F[:, :, None, :]).sum(dim=1)
    return 0.5 * (ftf - torch.eye(2, dtype=F.dtype, device=F.device))


def get_ve_len(face_pair: torch.Tensor, v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Length of virtual edges = distance between paired face centers."""
    pairs = v[f].mean(dim=1)[face_pair]
    return torch.linalg.norm(pairs[:, 0] - pairs[:, 1], dim=-1)


# ---------------------------------------------------------------------------
# host-side connectivity precompute (numpy, once per template)
# ---------------------------------------------------------------------------

def get_vertex_connectivity(faces: np.ndarray) -> np.ndarray:
    """(E,2) unique undirected edges, each sorted."""
    f = np.asarray(faces)
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0), axis=1)
    return np.unique(e, axis=0)


def get_face_connectivity_combined(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """For every interior edge: the two adjacent faces and the edge's vertex
    pair (reference ``get_face_connectivity_combined``)."""
    f = np.asarray(faces)
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0), axis=1)
    fid = np.tile(np.arange(f.shape[0]), 3)
    order = np.lexsort((fid, e[:, 1], e[:, 0]))
    e_s, fid_s = e[order], fid[order]
    is_new = np.ones(len(e_s), bool)
    is_new[1:] = (e_s[1:] != e_s[:-1]).any(axis=1)
    group_start = np.flatnonzero(is_new)
    group_len = np.diff(np.append(group_start, len(e_s)))
    s = group_start[group_len >= 2]
    return (np.stack([fid_s[s], fid_s[s + 1]], axis=1).astype(np.int64),
            e_s[s].astype(np.int64))


def init_virtual_edge(v: np.ndarray, f: np.ndarray, dot_product_t: float = -0.7):
    """Virtual anti-collapse edges between opposed faces: cast a ray from just
    below each face centre along −normal, keep first hits whose normals
    oppose (dot < −0.7). Reference ``init_virtual_edge``, with the native BVH
    in place of open3d."""
    from gaussian_garments_tpu_torch.ops.raytrace import raycast_first_hit

    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int64)
    tri = v[f]
    fn = np.cross(tri[:, 2] - tri[:, 1], tri[:, 0] - tri[:, 1])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    fc = tri.mean(axis=1)
    t_hit, prim_id = raycast_first_hit(fc - fn * 1e-6, -fn, v, f)
    hit = prim_id >= 0
    opposed = np.zeros(len(f), bool)
    opposed[hit] = (fn[hit] * fn[prim_id[hit]]).sum(-1) < dot_product_t
    mask = hit & opposed
    edge_id = np.stack([np.arange(len(f)), np.where(hit, prim_id, 0)], axis=1)
    return edge_id[mask].astype(np.int64), t_hit[mask].astype(np.float32)


def build_connectivity(v: np.ndarray, f: np.ndarray) -> Dict[str, np.ndarray]:
    """All static tables the cloth energies need (host, once per template)."""
    adjacent_faces, adjacent_face_edges = get_face_connectivity_combined(f)
    ve, ve_len = init_virtual_edge(v, f)
    return {
        "edges": get_vertex_connectivity(f),
        "f_connectivity": adjacent_faces,
        "f_connectivity_edges": adjacent_face_edges,
        "virtual_edge": ve,
        "ve_len": ve_len,
    }
