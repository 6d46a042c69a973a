"""AO + object-space-normal texture baker (host numpy).

Port of ``gaussian_garments_tpu/data/baker.py``: smooth
normals interpolated at each texel anchor, packed to [0,1], and ambient
occlusion from 64 cosine-weighted hemisphere rays per texel cast against
garment + occluders with the native BVH. The BVH is built once per bake and
reused for every sample direction. A dense binding bakes its alive texels
only, so both layouts give the same textures. Bakes are cached as .npz per
frame.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from gaussian_garments_tpu_torch.models.avatar_gaussian import AvatarBinding
from gaussian_garments_tpu_torch.ops.raytrace import bvh


def vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    tri = v[f]
    fn = np.cross(tri[:, 2] - tri[:, 1], tri[:, 0] - tri[:, 1])   # area-weighted
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)


def _hemisphere_dirs(n_samples: int) -> np.ndarray:
    """Deterministic cosine-weighted hemisphere directions (+z up), Fibonacci spiral."""
    i = np.arange(n_samples) + 0.5
    u1 = i / n_samples
    u2 = (i * 0.6180339887498949) % 1.0
    r = np.sqrt(u1)
    theta = 2 * np.pi * u2
    return np.stack([r * np.cos(theta), r * np.sin(theta),
                     np.sqrt(np.maximum(1 - u1, 0.0))], axis=1).astype(np.float32)


def _onb(n: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Branchless orthonormal basis around normals (N,3)."""
    sign = np.where(n[:, 2] >= 0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = np.stack([1.0 + sign * n[:, 0] ** 2 * a, sign * b, -sign * n[:, 0]], axis=1)
    bt = np.stack([b, sign + n[:, 1] ** 2 * a, -n[:, 1]], axis=1)
    return t.astype(np.float32), bt.astype(np.float32)


def bake_textures(bind: AvatarBinding, mesh_v: np.ndarray, mesh_f: np.ndarray,
                  occluders: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None, *,
                  n_samples: int = 64, max_dist: float = np.inf, eps: float = 1e-4,
                  cache_path: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Bake (ambient (1,res,res), normal (3,res,res)) float32 for this pose."""
    if cache_path is not None and os.path.exists(cache_path):
        data = np.load(cache_path)
        return data["ambient"], data["normal"]

    res = bind.texture_size
    mesh_v = np.asarray(mesh_v, np.float32)
    mesh_f = np.asarray(mesh_f, np.int64)
    gs_u = bind.gs_u.cpu().numpy()
    gs_v = bind.gs_v.cpu().numpy()
    binding = bind.binding.cpu().numpy()
    bc = bind.gs_bc.cpu().numpy()
    if bind.alive is not None:
        a = bind.alive.cpu().numpy()
        gs_u, gs_v, binding, bc = gs_u[a], gs_v[a], binding[a], bc[a]

    vn = vertex_normals(mesh_v, mesh_f)
    anchors = np.einsum("gk,gkc->gc", bc, mesh_v[mesh_f[binding]])
    normals = np.einsum("gk,gkc->gc", bc, vn[mesh_f[binding]])
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12)

    normal_map = np.zeros((res, res, 3), np.float32)
    normal_map[gs_u, gs_v] = normals * 0.5 + 0.5

    all_v, all_f, off = [mesh_v], [mesh_f], len(mesh_v)
    for ov, of in (occluders or []):
        all_v.append(np.asarray(ov, np.float32))
        all_f.append(np.asarray(of, np.int64) + off)
        off += len(ov)
    scene = bvh(np.concatenate(all_v), np.concatenate(all_f))

    dirs_local = _hemisphere_dirs(n_samples)
    t, btan = _onb(normals)
    hits = np.zeros((len(anchors),), np.float64)
    origins = (anchors + normals * eps).astype(np.float32)
    for s in range(n_samples):
        d = dirs_local[s, 0] * t + dirs_local[s, 1] * btan + dirs_local[s, 2] * normals
        t_hit, pid = scene.raycast(origins, d.astype(np.float32))
        hits += ((pid >= 0) & (t_hit < max_dist)).astype(np.float64)

    ambient_map = np.zeros((res, res), np.float32)
    ambient_map[gs_u, gs_v] = (1.0 - hits / n_samples).astype(np.float32)
    ambient, normal = ambient_map[None], normal_map.transpose(2, 0, 1)
    if cache_path is not None:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        # written aside and renamed: data-parallel ranks bake the same frames
        tmp = f"{cache_path}.tmp-{os.getpid()}.npz"
        np.savez_compressed(tmp, ambient=ambient, normal=normal)
        os.replace(tmp, cache_path)
    return ambient, normal
