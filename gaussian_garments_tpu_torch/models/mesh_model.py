"""Garment mesh + cloth energies (port of
``gaussian_garments_tpu/models/mesh_model.py``; reference
``scene/mesh_model.py``): StVK membrane stretching, dihedral bending, cubic
body-collision penalty, virtual-edge anti-collapse, and the momentum
rest-shape update, with the reference's material constants. Every energy is
differentiable with respect to ``mesh.v``; the connectivity tables are numpy
precompute on the host, once per template.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gaussian_garments_tpu_torch import geometry as geo
from gaussian_garments_tpu_torch import resolve_device

# material constants (reference scene/mesh_model.py:23-27)
DENSITY = 0.20022
LAME_MU = 23600.0
LAME_LAMBDA = 44400.0
BENDING_COEFF = 3.9625778333333325e-05
THICKNESS = 4.7e-4


@dataclasses.dataclass
class MeshState:
    """All per-template mesh state the cloth energies need."""

    v: torch.Tensor                     # (V,3) current vertices
    vt: torch.Tensor                    # (V,3) template vertices
    f: torch.Tensor                     # (F,3) int64 faces
    v_mass: torch.Tensor                # (V,1)
    f_area: torch.Tensor                # (F,1)
    dm_inv: torch.Tensor                # (F,2,2), momentum-updated per frame
    f_connectivity: torch.Tensor        # (E,2) adjacent faces per interior edge
    f_connectivity_edges: torch.Tensor  # (E,2) edge vertex ids
    edges: torch.Tensor                 # (Eall,2) unique mesh edges
    virtual_edge: torch.Tensor          # (Ev,2) opposed face pairs
    ve_len: torch.Tensor                # (Ev,) rest virtual-edge lengths
    nn_points: torch.Tensor             # (V,3) nearest body-face centres
    nn_normals: torch.Tensor            # (V,3) their normals
    has_body: bool = False
    tar_v: Optional[torch.Tensor] = None  # inertial target

    def replace(self, **kw) -> "MeshState":
        return dataclasses.replace(self, **kw)


def create(vt: np.ndarray, ft: np.ndarray, device=None) -> MeshState:
    """MeshState of a template mesh (reference __init__/init_compute)."""
    device = resolve_device(device)
    vt = np.asarray(vt, np.float32)
    ft = np.asarray(ft, np.int64)
    conn = geo.build_connectivity(vt, ft)
    long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    v = torch.as_tensor(vt, device=device)
    f = long(ft)
    return MeshState(
        v=v, vt=v, f=f,
        v_mass=geo.vertex_mass(v, f, DENSITY)[:, None],
        f_area=geo.face_areas(v, f)[:, None],
        dm_inv=geo.make_dm_inv(v, f),
        f_connectivity=long(conn["f_connectivity"]),
        f_connectivity_edges=long(conn["f_connectivity_edges"]),
        edges=long(conn["edges"]),
        virtual_edge=long(conn["virtual_edge"]),
        ve_len=torch.as_tensor(conn["ve_len"], device=device),
        nn_points=torch.zeros_like(v), nn_normals=torch.zeros_like(v),
        has_body=False, tar_v=v)


def momentum_update(mesh: MeshState, v_new: torch.Tensor, me: float = 0.3,
                    mve: float = 0.3) -> MeshState:
    """Blend the rest-shape matrix and virtual-edge lengths toward the
    previous frame: Dm⁻¹ ← ((1−Me)·Dm_new + Me·Dm_t)⁻¹ (reference
    momentum_update :47-57)."""
    new_dm = geo.inv2x2(geo.make_dm_inv(v_new, mesh.f))
    tmp_dm = geo.inv2x2(geo.make_dm_inv(mesh.vt, mesh.f))
    dm_inv = geo.inv2x2(new_dm * (1 - me) + tmp_dm * me)
    new_ve = geo.get_ve_len(mesh.virtual_edge, v_new, mesh.f)
    tmp_ve = geo.get_ve_len(mesh.virtual_edge, mesh.vt, mesh.f)
    return mesh.replace(dm_inv=dm_inv, ve_len=new_ve * (1 - mve) + tmp_ve * mve)


def init_body(mesh: MeshState, body_v: np.ndarray, body_f: np.ndarray,
              collision_face_ids: np.ndarray) -> MeshState:
    """Bind each garment vertex to its precomputed nearest body face
    (reference init_body :163-175; the Scene finds the faces with a KD-tree)."""
    dev = mesh.v.device
    bv = torch.as_tensor(np.asarray(body_v, np.float32), device=dev)
    bf = torch.as_tensor(np.asarray(body_f, np.int64), device=dev)
    ids = torch.as_tensor(np.asarray(collision_face_ids).reshape(-1).astype(np.int64), device=dev)
    return mesh.replace(nn_points=bv[bf].mean(dim=1)[ids],
                        nn_normals=geo.face_normals(bv, bf)[ids], has_body=True)


# ---------------------------------------------------------------------------
# energies (differentiable with respect to mesh.v)
# ---------------------------------------------------------------------------

def bending_energy(mesh: MeshState) -> torch.Tensor:
    """Dihedral bending: Σ k·(l²/4a)·θ²/2 over interior edges."""
    fn = geo.face_normals(mesh.v, mesh.f)
    n0 = fn[mesh.f_connectivity[:, 0]]
    n1 = fn[mesh.f_connectivity[:, 1]]
    e = mesh.v[mesh.f_connectivity_edges[:, 1]] - mesh.v[mesh.f_connectivity_edges[:, 0]]
    l = torch.linalg.norm(e, dim=-1, keepdim=True)
    e_norm = e / torch.clamp(l, min=1e-12)
    a = mesh.f_area[:, 0][mesh.f_connectivity].sum(dim=-1)
    theta = torch.atan2((e_norm * torch.linalg.cross(n0, n1, dim=-1)).sum(-1),
                        (n0 * n1).sum(-1))
    return (BENDING_COEFF * (l[:, 0] ** 2 / (4.0 * a)) * theta ** 2 / 2.0).sum()


def stretching_energy(mesh: MeshState) -> torch.Tensor:
    """StVK membrane: Σ area·thickness·tr(Sᵀ G), S = μG + ½λ tr(G) I."""
    G = geo.green_strain_tensor(geo.deformation_gradient(mesh.v[mesh.f], mesh.dm_inv))
    g_trace = G[:, 0, 0] + G[:, 1, 1]
    eye = torch.eye(2, dtype=G.dtype, device=G.device)
    S = LAME_MU * G + 0.5 * LAME_LAMBDA * g_trace[:, None, None] * eye
    return (mesh.f_area[:, 0] * THICKNESS * (S * G).sum(dim=(1, 2))).sum()


def collision_energy(mesh: MeshState, eps: float = 1e-3) -> torch.Tensor:
    """Cubic penetration penalty against the bound body faces."""
    distance = ((mesh.v - mesh.nn_points) * mesh.nn_normals).sum(-1)
    return (torch.clamp(eps - distance, min=0.0) ** 3).sum()


def virtual_edge_energy(mesh: MeshState) -> torch.Tensor:
    """Penalize only compressed virtual edges; 0 when there are none."""
    if mesh.virtual_edge.shape[0] == 0:
        return mesh.v.new_zeros(())
    cur = geo.get_ve_len(mesh.virtual_edge, mesh.v, mesh.f)
    return torch.clamp(mesh.ve_len - cur, min=0.0).mean()


def get_energy_loss(mesh: MeshState, opt, use_body: bool) -> Dict[str, torch.Tensor]:
    """Dispatch of the reference get_energy_loss (:196-205)."""
    loss = {"bending": bending_energy(mesh) * opt.lambda_bending,
            "stretching": stretching_energy(mesh) * opt.lambda_stretching}
    if use_body:
        loss["collision"] = collision_energy(mesh) * opt.lambda_collision
    else:
        loss["virtual_edge"] = virtual_edge_energy(mesh) * opt.lambda_virtual
    return loss
