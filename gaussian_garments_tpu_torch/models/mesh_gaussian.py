"""Mesh-attached Gaussians: face frames, local→world transforms, creation
from a template and binding-aware densification.

Port of ``gaussian_garments_tpu/models/mesh_gaussian.py`` (reference
``scene/mesh_gaussian_model.py``), without the ARAP terms, which the s2 path
does not call:

    xyz_world   = R_face @ xyz_local · s_face + face_center
    scale_world = exp(scaling_local) · s_face
    rot_world   = q_face ⊗ q_local

Per-splat frame data comes from one row-gather of a flattened (F, 17|26)
frame table, with the JAX package's column layout. Densify/clone/split/prune
are host-side numpy edits; split sampling draws from the caller's
``np.random.RandomState`` exactly as the JAX package does, so one seed gives
the same splats in both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gaussian_garments_tpu_torch import geometry as geo
from gaussian_garments_tpu_torch.models import gaussian as G
from gaussian_garments_tpu_torch.utils.quaternion import (
    normalize as quat_normalize, quat_multiply, quat_to_rotmat, rotmat_to_quat)


@dataclasses.dataclass(frozen=True)
class FaceFrames:
    center: torch.Tensor      # (F,3)
    orien_mat: torch.Tensor   # (F,3,3) columns a0|a1|a2
    orien_quat: torch.Tensor  # (F,4) wxyz
    scaling: torch.Tensor     # (F,)


def compute_face_frames(v: torch.Tensor, f: torch.Tensor) -> FaceFrames:
    orien, scale = geo.compute_face_orientation(v, f)
    return FaceFrames(center=v[f].mean(dim=1), orien_mat=orien,
                      orien_quat=rotmat_to_quat(orien), scaling=scale)


FR_R = slice(0, 9)        # R row-major (R[i,j] at 3i+j)
FR_Q = slice(9, 13)       # normalized wxyz quaternion
FR_S = slice(13, 14)      # isotropic face scale
FR_C = slice(14, 17)      # face center
FR_V = slice(17, 26)      # face vertices v0|v1|v2 (only with mesh_v/mesh_f)


def frame_rows(frames: FaceFrames, mesh_v: Optional[torch.Tensor] = None,
               mesh_f: Optional[torch.Tensor] = None) -> torch.Tensor:
    cols = [frames.orien_mat.reshape(-1, 9), quat_normalize(frames.orien_quat),
            frames.scaling[:, None], frames.center]
    if mesh_v is not None:
        cols.append(mesh_v[mesh_f].reshape(-1, 9))
    return torch.cat(cols, dim=1)


def gather_frame_rows(frames: FaceFrames, binding: torch.Tensor,
                      mesh_v: Optional[torch.Tensor] = None,
                      mesh_f: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One (N, 17|26) row-gather of the frame table."""
    return frame_rows(frames, mesh_v, mesh_f)[binding]


def rows_rot_apply(r9: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """R @ v: out_i = Σ_j r9[:,3i+j]·v_j."""
    return torch.stack([r9[:, 3 * i] * vec[:, 0] + r9[:, 3 * i + 1] * vec[:, 1]
                        + r9[:, 3 * i + 2] * vec[:, 2] for i in range(3)], dim=1)


def rows_rot_apply_t(r9: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Rᵀ @ v: out_j = Σ_i r9[:,3i+j]·v_i."""
    return torch.stack([r9[:, j] * vec[:, 0] + r9[:, 3 + j] * vec[:, 1]
                        + r9[:, 6 + j] * vec[:, 2] for j in range(3)], dim=1)


def world_xyz(params: G.GaussianParams, binding: torch.Tensor, frames: FaceFrames,
              rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    if rows is None:
        rows = gather_frame_rows(frames, binding)
    return rows_rot_apply(rows[:, FR_R], params.xyz) * rows[:, FR_S] + rows[:, FR_C]


def world_scaling(params: G.GaussianParams, binding: torch.Tensor, frames: FaceFrames,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    fs = rows[:, FR_S] if rows is not None else frames.scaling[binding][:, None]
    return torch.exp(params.scaling) * fs


def world_rotation(params: G.GaussianParams, binding: torch.Tensor, frames: FaceFrames,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    q_face = rows[:, FR_Q] if rows is not None else quat_normalize(frames.orien_quat[binding])
    return quat_normalize(quat_multiply(q_face, quat_normalize(params.rotation)))


def local_to_world(params: G.GaussianParams, binding: torch.Tensor,
                   frames: FaceFrames) -> G.GaussianParams:
    """Bake the face frames into the raw tensors (reference local_to_world)."""
    return params.replace(
        xyz=world_xyz(params, binding, frames),
        scaling=torch.log(torch.clamp(world_scaling(params, binding, frames), min=1e-20)),
        rotation=world_rotation(params, binding, frames))


def create_from_template(template_vertices: np.ndarray, template_faces: np.ndarray,
                         face_colors: np.ndarray, max_sh_degree: int,
                         capacity: Optional[int] = None, device=None):
    """One splat per face at its anchor (local xyz = 0), coloured from the
    stage-1 cloud. Keeps the reference's quirk that the initial log-scales
    come from *world* nearest-neighbour distances of the face centres.
    Returns (params, aux, binding (capacity,) int64, binding_counter (F,))."""
    tv = np.asarray(template_vertices, np.float32)
    tf = np.asarray(template_faces, np.int64)
    n = len(tf)
    params, aux = G.create_from_pcd(tv[tf].mean(axis=1), face_colors, max_sh_degree, capacity,
                                    device=device)
    params = params.replace(xyz=torch.zeros_like(params.xyz))
    binding = np.zeros(params.xyz.shape[0], np.int64)
    binding[:n] = np.arange(n)
    return params, aux, binding, np.ones(n, dtype=np.int32)


def densify_and_prune(params: G.GaussianParams, aux: G.GaussianAux, adam: G.AdamState,
                      binding: np.ndarray, binding_counter: np.ndarray, mesh_v: np.ndarray,
                      mesh_f: np.ndarray, *, max_grad: float, min_opacity: float,
                      extent: float, max_screen_size: Optional[float], percent_dense: float,
                      rng: Optional[np.random.RandomState] = None, grow_capacity: float = 1.5,
                      ) -> Tuple[G.GaussianParams, G.GaussianAux, G.AdamState, np.ndarray,
                                 np.ndarray, Dict[str, int]]:
    """Binding-aware densify/clone/split/prune (reference :130-208).

    Thresholds use world scaling (local · face scale). Split writes the
    sampled world position into the local ``xyz`` slot (a reference quirk,
    kept). Pruning never removes the last splat of a face. The result is
    re-padded on the params' device; capacity grows by ``grow_capacity``
    only when the splats no longer fit."""
    rng = rng or np.random.RandomState(0)
    device = params.xyz.device
    old_capacity = params.xyz.shape[0]
    alive = G._np(aux.alive)
    bind = np.asarray(binding)[alive].copy()
    counter = np.asarray(binding_counter).copy()
    h = G._compact(params, aux, adam)
    with torch.no_grad():
        fr = compute_face_frames(torch.as_tensor(np.asarray(mesh_v, np.float32)),
                                 torch.as_tensor(np.asarray(mesh_f, np.int64)))
    f_scale, f_rot, f_center = (x.numpy() for x in (fr.scaling, fr.orien_mat, fr.center))

    def wscale(hh, bb):
        return np.exp(hh.params["scaling"]) * f_scale[bb][:, None]

    grads = h.grad_accum / np.maximum(h.denom, 1e-12)
    grads[~np.isfinite(grads)] = 0.0

    # --- clone ---
    clone_mask = (np.linalg.norm(grads, axis=-1) >= max_grad) & \
        (wscale(h, bind).max(axis=1) <= percent_dense * extent)
    n_clone = int(clone_mask.sum())
    if n_clone:
        h = G._cat(h, {k: h.params[k][clone_mask] for k in G.PARAM_NAMES})
        new_b = bind[clone_mask]
        np.add.at(counter, new_b, 1)
        bind = np.concatenate([bind, new_b])
        grads = np.concatenate([grads, np.zeros((n_clone, 1), np.float32)])

    # --- split ---
    ws = wscale(h, bind)
    split_mask = (grads[:, 0] >= max_grad) & (ws.max(axis=1) > percent_dense * extent)
    n_split = int(split_mask.sum())
    if n_split:
        N = 2
        sb = bind[split_mask]
        stds = np.repeat(ws[split_mask], N, axis=0)
        samples = rng.normal(0.0, 1.0, stds.shape).astype(np.float32) * stds
        rots = quat_to_rotmat(torch.as_tensor(
            np.tile(h.params["rotation"][split_mask], (N, 1)))).numpy()
        wxyz = (np.einsum("mij,mj->mi", f_rot[sb], h.params["xyz"][split_mask])
                * f_scale[sb][:, None] + f_center[sb])
        new_xyz = np.einsum("nij,nj->ni", rots, samples) + np.tile(wxyz, (N, 1))
        new_local_scale = np.log(np.repeat(ws[split_mask] / f_scale[sb][:, None], N, axis=0)
                                 / (0.8 * N))
        new = {
            "xyz": new_xyz.astype(np.float32),
            "scaling": new_local_scale.astype(np.float32),
            "rotation": np.tile(h.params["rotation"][split_mask], (N, 1)),
            "features_dc": np.tile(h.params["features_dc"][split_mask], (N, 1, 1)),
            "features_rest": np.tile(h.params["features_rest"][split_mask], (N, 1, 1)),
            "opacity": np.tile(h.params["opacity"][split_mask], (N, 1)),
        }
        new_b = np.tile(sb, N)
        np.add.at(counter, new_b, 1)
        n_before = h.params["xyz"].shape[0]
        h = G._cat(h, new)
        bind = np.concatenate([bind, new_b])
        keep = np.ones((h.params["xyz"].shape[0],), bool)
        keep[:n_before] = ~split_mask
        keep, bind, counter = _guarded_prune(~keep, bind, counter)
        h = G._select(h, keep)

    # --- prune ---
    prune = 1.0 / (1.0 + np.exp(-h.params["opacity"][:, 0])) < min_opacity
    if max_screen_size:
        prune |= h.max_radii2d > max_screen_size
        prune |= wscale(h, bind).max(axis=1) > 0.1 * extent
    keep, bind, counter = _guarded_prune(prune, bind, counter)
    n_prune = int((~keep).sum())
    h = G._select(h, keep)

    n = h.params["xyz"].shape[0]
    capacity = old_capacity if n <= old_capacity else int(np.ceil(n * grow_capacity))
    new_params, new_aux, new_adam = G._repack(h, adam.step, capacity, device=device)
    bind_padded = np.zeros(capacity, np.int64)
    bind_padded[:n] = bind
    stats = {"n_clone": n_clone, "n_split": n_split, "n_prune": n_prune, "n_alive": n,
             "capacity": capacity}
    return new_params, new_aux, new_adam, bind_padded, counter, stats


def _guarded_prune(prune: np.ndarray, bind: np.ndarray, counter: np.ndarray):
    """Never prune the last splat of a face (reference prune_points
    :130-137), then decrement the binding counters. Returns (keep, bind,
    counter)."""
    to_prune_bind = bind[prune]
    decrement = np.zeros_like(counter)
    np.add.at(decrement, to_prune_bind, 1)
    redundant = (counter - decrement) > 0
    real_prune = prune.copy()
    real_prune[prune] = redundant[to_prune_bind]
    np.add.at(counter, bind[real_prune], -1)
    keep = ~real_prune
    return keep, bind[keep], counter
