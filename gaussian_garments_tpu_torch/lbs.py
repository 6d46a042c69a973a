"""SMPL-X linear blend skinning in torch.

Port of ``gaussian_garments_tpu/lbs.py`` (reference ``lbs.py``): batch
Rodrigues (``lbs.py:76``), the kinematic-chain rigid transforms (``:89``),
the core ``lbs()`` (``:111``), ``smplx_pose2mesh`` (``:162``) and
``prepare_lbs``, the un-pose/re-pose of garment vertices by the blend weights
of their nearest body vertices (``:177``). The SMPL-X model is a plain arrays
container (``SmplxModel``) read from the official npz or pkl by a copy of the
JAX package's numpy loader.

The JAX package pins the skinning matmuls to float32 (``lbs.py:115-121``)
because the TPU rounds matmul inputs to bf16 by default. Here the same
holds when TF32 is off: the entry points call ``pin_full_f32``, and ``lbs``
computes in float32 whatever the caller's settings, by switching TF32 off for
its own matmuls.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

NUM_BODY_JOINTS = 21


class SmplxModel(NamedTuple):
    """SMPL-X model arrays (numpy; moved to the device at use)."""

    v_template: np.ndarray        # (V,3)
    shapedirs: np.ndarray         # (V,3,n_betas)
    expr_dirs: np.ndarray         # (V,3,n_expr)
    posedirs: np.ndarray          # (P, V*3)
    J_regressor: np.ndarray       # (J,V)
    parents: np.ndarray           # (J,)
    lbs_weights: np.ndarray       # (V,J)
    left_hand_components: np.ndarray   # (n_pca, 45)
    right_hand_components: np.ndarray  # (n_pca, 45)
    pose_mean: np.ndarray         # (165,)
    faces: np.ndarray             # (F,3)


def load_smplx_model(path: str) -> SmplxModel:
    """Load from the official SMPL-X .npz (or a pickled dict with the same
    keys)."""
    if path.endswith(".npz"):
        d = dict(np.load(path, allow_pickle=True))
    else:
        import pickle
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="latin1")
    shapedirs = np.asarray(d["shapedirs"], np.float32)
    posedirs = np.asarray(d["posedirs"], np.float32)
    return SmplxModel(
        v_template=np.asarray(d["v_template"], np.float32),
        shapedirs=shapedirs[..., :10],
        expr_dirs=shapedirs[..., 300:310] if shapedirs.shape[-1] >= 310
        else np.zeros((*shapedirs.shape[:2], 10), np.float32),
        posedirs=posedirs.reshape(-1, 486).T if posedirs.ndim == 3 else posedirs,
        J_regressor=np.asarray(d["J_regressor"], np.float32),
        parents=np.asarray(d["kintree_table"])[0].astype(np.int64)
        if "kintree_table" in d else np.asarray(d["parents"], np.int64),
        lbs_weights=np.asarray(d["weights"], np.float32),
        left_hand_components=np.asarray(d.get("hands_componentsl", np.eye(45))[:12], np.float32),
        right_hand_components=np.asarray(d.get("hands_componentsr", np.eye(45))[:12], np.float32),
        pose_mean=_build_pose_mean(d),
        faces=np.asarray(d["f"], np.int64) if "f" in d else np.asarray(d.get("faces"), np.int64),
    )


def _build_pose_mean(d: Dict) -> np.ndarray:
    pm = np.zeros(165, np.float32)
    if "hands_meanl" in d:
        pm[75:120] = np.asarray(d["hands_meanl"], np.float32)
        pm[120:165] = np.asarray(d["hands_meanr"], np.float32)
    return pm


@contextlib.contextmanager
def _full_f32():
    """TF32 off for the enclosed matmuls, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """(N,3) axis-angle -> (N,3,3) rotations."""
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[:, None]
    sin = torch.sin(angle)[:, None]
    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return ident + sin * K + (1 - cos) * (K @ K)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray):
    """Kinematic chain -> (posed_joints (B,J,3), rel_transforms (B,J,4,4))."""
    b, j = joints.shape[0], joints.shape[1]
    parents = np.asarray(parents)
    rel = joints.clone()
    rel[:, 1:] = joints[:, 1:] - joints[:, torch.as_tensor(parents[1:], device=joints.device)]

    t = torch.cat([rot_mats, rel[..., None]], dim=-1)                     # (B,J,3,4)
    bottom = joints.new_tensor([0.0, 0, 0, 1]).expand(b, j, 1, 4)
    transforms_mat = torch.cat([t, bottom], dim=-2)                       # (B,J,4,4)

    chain = [transforms_mat[:, 0]]
    for i in range(1, j):
        chain.append(chain[int(parents[i])] @ transforms_mat[:, i])
    transforms = torch.stack(chain, dim=1)

    posed_joints = transforms[:, :, :3, 3]
    jh = torch.cat([joints, joints.new_zeros((b, j, 1))], dim=-1)        # homogeneous w=0
    correction = torch.einsum("bjxy,bjy->bjx", transforms, jh)
    rel_transforms = transforms.clone()
    rel_transforms[:, :, :3, 3] = transforms[:, :, :3, 3] - correction[:, :, :3]
    return posed_joints, rel_transforms


def lbs(betas, pose, v_template, shapedirs, posedirs, J_regressor, parents, lbs_weights):
    """Core LBS. Returns (A (J,4,4), verts (V,3), pose_offsets (V,3)) for
    batch element 0, in float32 with TF32 off."""
    with _full_f32():
        b = max(betas.shape[0], pose.shape[0])
        v_shaped = v_template[None] + torch.einsum("bl,mkl->bmk", betas, shapedirs)
        J = torch.einsum("bik,ji->bjk", v_shaped, J_regressor)
        rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(b, -1, 3, 3)
        ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
        pose_feature = (rot_mats[:, 1:] - ident).reshape(b, -1)
        pose_offsets = (pose_feature @ posedirs).reshape(b, -1, 3)

        _, A = batch_rigid_transform(rot_mats, J, parents)
        v_posed = pose_offsets + v_shaped

        num_joints = J_regressor.shape[0]
        W = lbs_weights[None].expand(b, *lbs_weights.shape)
        T = (W @ A.reshape(b, num_joints, 16)).reshape(b, -1, 4, 4)
        vh = torch.cat([v_posed, v_posed.new_ones((b, v_posed.shape[1], 1))], dim=2)
        v = torch.einsum("bvxy,bvy->bvx", T, vh)[:, :, :3]
    return A[0], v[0], pose_offsets[0]


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _full_pose(model: SmplxModel, p: Dict, device) -> torch.Tensor:
    with _full_f32():
        lh = _t(p["left_hand_pose"], device).reshape(1, -1) @ _t(model.left_hand_components,
                                                                  device)
        rh = _t(p["right_hand_pose"], device).reshape(1, -1) @ _t(model.right_hand_components,
                                                                   device)
    full = torch.cat([
        _t(p["global_orient"], device).reshape(1, 3),
        _t(p["body_pose"], device).reshape(NUM_BODY_JOINTS, 3),
        _t(p["jaw_pose"], device).reshape(1, 3),
        _t(p["leye_pose"], device).reshape(1, 3),
        _t(p["reye_pose"], device).reshape(1, 3),
        lh.reshape(15, 3), rh.reshape(15, 3)], dim=0).reshape(1, 165)
    return full + _t(model.pose_mean, device)[None]


def _skin(model: SmplxModel, params: Dict, device):
    """lbs() of the model at ``params``: (A, body vertices, pose offsets)."""
    shape = torch.cat([_t(params["betas"], device).reshape(1, -1),
                       _t(params["expression"], device).reshape(1, -1)], dim=-1)
    dirs = torch.cat([_t(model.shapedirs, device), _t(model.expr_dirs, device)], dim=-1)
    return lbs(shape, _full_pose(model, params, device), _t(model.v_template, device), dirs,
               _t(model.posedirs, device), _t(model.J_regressor, device), model.parents,
               _t(model.lbs_weights, device))


def smplx_pose2mesh(model: SmplxModel, params: Dict, erase_transl: bool = False,
                    device=None) -> Dict:
    """Pose the SMPL-X body. ``device`` is where the skinning runs (the card
    unless the caller passes ``device="cpu"``); the vertices come back as
    numpy."""
    from gaussian_garments_tpu_torch import resolve_device

    _, verts, _ = _skin(model, params, resolve_device(device))
    v = verts.cpu().numpy() + np.asarray(params["transl"]).reshape(1, 3)
    if erase_transl:
        v = v - np.asarray(params["transl"]).reshape(1, 3)
    return {"vertices": v, "faces": model.faces}


def prepare_lbs(model: SmplxModel, params: Dict, vertices: np.ndarray,
                blend_weights: Optional[np.ndarray] = None,
                nn_ids: Optional[np.ndarray] = None, unpose: bool = False,
                device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Un-pose (to canonical) or re-pose garment vertices by the blend weights
    of their nearest body vertices. ``vertices`` must be translation-free.
    The skinning runs on ``device``; the per-vertex blend is float64 numpy, as
    in the JAX package."""
    from gaussian_garments_tpu_torch import resolve_device

    G, body_vertices, pose_offset = (x.cpu().numpy() for x in
                                     _skin(model, params, resolve_device(device)))
    if unpose:
        G = np.linalg.inv(G)

    vertices = np.asarray(vertices, np.float64).copy()
    if blend_weights is None:
        from scipy.spatial import cKDTree
        assert unpose, "forward pose should provide weights"
        _, nn_ids = cKDTree(body_vertices).query(vertices)
        blend_weights = np.asarray(model.lbs_weights)[nn_ids]

    Gv = np.einsum("ab,bcd->acd", blend_weights, G)       # (N,4,4)
    if not unpose:
        vertices += pose_offset[nn_ids]
    vh = np.concatenate([vertices, np.ones((len(vertices), 1))], axis=-1)
    out = np.einsum("abc,ac->ab", Gv, vh)[:, :3]
    if unpose:
        out -= pose_offset[nn_ids]
    return out.astype(np.float32), blend_weights, nn_ids
