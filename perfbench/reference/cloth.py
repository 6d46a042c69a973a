"""Plain reference of the garment's cloth terms (Gaussian Garments'
``scene/mesh_model.py``): StVK membrane stretching, dihedral bending, the
cubic body-collision penalty, virtual anti-collapse edges, the momentum
rest-shape update, and the tables they need, worked out from the template:
the faces adjacent across each interior edge, the virtual edges (a ray from
just below each face centre along −normal; a first hit whose normal opposes,
dot < −0.7, pairs the two faces) and each vertex's nearest body face.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DENSITY = 0.20022
LAME_MU = 23600.0
LAME_LAMBDA = 44400.0
BENDING_COEFF = 3.9625778333333325e-05
THICKNESS = 4.7e-4


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def face_normals(v, f, normalize=True):
    tri = v[f]
    n = _cross(tri[:, 2] - tri[:, 1], tri[:, 0] - tri[:, 1])
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12) if normalize \
        else n


def face_areas(v, f):
    tri = v[f]
    return torch.linalg.norm(_cross(tri[:, 2] - tri[:, 0], tri[:, 1] - tri[:, 0]), dim=-1) / 2.0


def adjacent_faces(f: np.ndarray):
    """(E,2) faces and (E,2) sorted vertex pair of every interior edge, in
    lexicographic edge order, the lower face id first."""
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    fid = np.tile(np.arange(len(f)), 3)
    order = np.lexsort((fid, e[:, 1], e[:, 0]))
    e, fid = e[order], fid[order]
    same = (e[1:] == e[:-1]).all(1)
    first = np.flatnonzero(np.concatenate([[True], ~same]))
    count = np.diff(np.append(first, len(e)))
    s = first[count >= 2]
    return np.stack([fid[s], fid[s + 1]], 1), e[s]


@torch.no_grad()
def first_hits(origins, dirs, v, f, chunk: int = 256):
    """Möller–Trumbore first hit (t > 1e-9) of each ray against every
    triangle: (t (R,), face (R,), -1 for a miss)."""
    v0, e1, e2 = v[f[:, 0]], v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]
    ts, ids = [], []
    for s in range(0, len(origins), chunk):
        o, d = origins[s:s + chunk, None], dirs[s:s + chunk, None]
        p = _cross(d.expand(-1, len(f), -1), e2[None].expand(len(o), -1, -1))
        det = (p * e1[None]).sum(-1)
        inv = 1.0 / torch.where(det.abs() <= 1e-9, 1.0, det)
        tv = o - v0[None]
        u = (tv * p).sum(-1) * inv
        q = _cross(tv, e1[None].expand(len(o), -1, -1))
        w = (d * q).sum(-1) * inv
        t = (e2[None] * q).sum(-1) * inv
        ok = (det.abs() > 1e-9) & (u >= 0) & (u <= 1) & (w >= 0) & (u + w <= 1) & (t > 1e-9)
        t = torch.where(ok, t, torch.inf)
        best, arg = t.min(1)
        ts.append(best)
        ids.append(torch.where(torch.isfinite(best), arg, -1))
    return torch.cat(ts), torch.cat(ids)


def virtual_edges(v, f, dot_t: float = -0.7):
    n = face_normals(v, f)
    c = v[f].mean(1)
    _, hit = first_hits(c - n * 1e-6, -n, v, f)
    ok = hit >= 0
    opposed = torch.zeros_like(ok)
    opposed[ok] = (n[ok] * n[hit[ok]]).sum(-1) < dot_t
    keep = ok & opposed
    return torch.stack([torch.arange(len(f), device=v.device)[keep], hit[keep]], 1)


def ve_len(pairs, v, f):
    c = v[f].mean(1)[pairs]
    return torch.linalg.norm(c[:, 0] - c[:, 1], dim=-1)


def _inv2(m):
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    return torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2) / \
        (a * d - b * c)[..., None, None]


def _shape(tri):
    return torch.stack([tri[:, 0] - tri[:, 2], tri[:, 1] - tri[:, 2]], -1)   # (F,3,2)


def dm_inv(v, f):
    """(F,2,2) inverse rest-shape matrix in each face's own 2D basis."""
    e = _shape(v[f]).transpose(1, 2)                # rows: the two edges
    e0, e1 = e[:, 0], e[:, 1]
    b0 = e0 / torch.linalg.norm(e0, dim=-1, keepdim=True)
    b1 = _cross(_cross(b0, e1), e0)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    e2d = torch.stack([torch.stack([(e0 * b0).sum(-1), (e0 * b1).sum(-1)], -1),
                       torch.stack([(e1 * b0).sum(-1), (e1 * b1).sum(-1)], -1)], 1)
    return _inv2(e2d.transpose(1, 2))


class Cloth(NamedTuple):
    f: torch.Tensor
    f_area: torch.Tensor       # (F,) template areas
    adj: torch.Tensor          # (E,2)
    adj_edge: torch.Tensor     # (E,2)
    dm_inv: torch.Tensor       # (F,2,2), momentum-blended
    ve: torch.Tensor           # (Ev,2)
    ve_len: torch.Tensor       # (Ev,), momentum-blended
    nn_points: torch.Tensor    # (V,3)
    nn_normals: torch.Tensor   # (V,3)


def build(vt, f, prev_v, bind_v, body_v, body_f, me: float = 0.3) -> Cloth:
    """The terms of a frame: template ``vt``, the previous frame ``prev_v``
    (momentum), the mesh the body faces are bound at, ``bind_v``, and the
    frame's body."""
    adj, adj_e = adjacent_faces(f.cpu().numpy())
    dev = vt.device
    t = lambda a: torch.as_tensor(a, device=dev)
    dm = _inv2(_inv2(dm_inv(prev_v, f)) * (1 - me) + _inv2(dm_inv(vt, f)) * me)
    ve = virtual_edges(vt, f)
    vl = ve_len(ve, prev_v, f) * (1 - me) + ve_len(ve, vt, f) * me
    bc = body_v[body_f].mean(1)
    nn = torch.cdist(bind_v, bc).argmin(1)
    return Cloth(f, face_areas(vt, f), t(adj), t(adj_e), dm, ve, vl, bc[nn],
                 face_normals(body_v, body_f)[nn])


def bending(c: Cloth, v):
    fn = face_normals(v, c.f)
    n0, n1 = fn[c.adj[:, 0]], fn[c.adj[:, 1]]
    e = v[c.adj_edge[:, 1]] - v[c.adj_edge[:, 0]]
    l = torch.linalg.norm(e, dim=-1)
    en = e / torch.clamp(l, min=1e-12)[:, None]
    a = c.f_area[c.adj].sum(-1)
    theta = torch.atan2((en * _cross(n0, n1)).sum(-1), (n0 * n1).sum(-1))
    return (BENDING_COEFF * (l ** 2 / (4.0 * a)) * theta ** 2 / 2.0).sum()


def stretching(c: Cloth, v):
    F = (_shape(v[c.f])[:, :, :, None] * c.dm_inv[:, None]).sum(2)          # (F,3,2)
    G = 0.5 * ((F[:, :, :, None] * F[:, :, None, :]).sum(1) - torch.eye(2, device=v.device))
    tr = G[:, 0, 0] + G[:, 1, 1]
    S = LAME_MU * G + 0.5 * LAME_LAMBDA * tr[:, None, None] * torch.eye(2, device=v.device)
    return (c.f_area * THICKNESS * (S * G).sum((1, 2))).sum()


def collision(c: Cloth, v, eps: float = 1e-3):
    d = ((v - c.nn_points) * c.nn_normals).sum(-1)
    return (torch.clamp(eps - d, min=0.0) ** 3).sum()


def virtual(c: Cloth, v):
    if c.ve.shape[0] == 0:
        return v.new_zeros(())
    return torch.clamp(c.ve_len - ve_len(c.ve, v, c.f), min=0.0).mean()


def energies(c: Cloth, v, o: dict, use_body: bool):
    e = bending(c, v) * o["lambda_bending"] + stretching(c, v) * o["lambda_stretching"]
    if use_body:
        return e + collision(c, v) * o["lambda_collision"]
    return e + virtual(c, v) * o["lambda_virtual"]
