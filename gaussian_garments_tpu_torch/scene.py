"""Scene orchestration for stage 2: per-frame state transitions (port of
``gaussian_garments_tpu/scene.py``; reference ``scene/scene.py`` and
``scene/cross_scene.py``).

Loading frames, train/test splits, NeRF++ camera-extent normalization, body
collision setup, per-frame warm starts (linear motion extrapolation
v_t ≈ 2·v_{t−1} − v_{t−2} plus the momentum rest-shape update), the kNN
neighbour graphs ``post_each_frame`` keeps for the ARAP terms, and the on-disk
artifact layout (point_cloud/frame_%05d/{local_point_cloud.ply,
point_cloud.ply} + binding.pkl, meshes/frame_%05d.obj, cameras.json).
``arap_cache`` hands those graphs to the ARAP terms on the dataloader's
device; ``CrossScene.sparse_icp`` aligns the template to a sequence by ICP
between two sparse COLMAP clouds.
"""
from __future__ import annotations

import json
import os
import pickle
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from gaussian_garments_tpu_torch.config import DEFAULTS
from gaussian_garments_tpu_torch.models import gaussian as G
from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
from gaussian_garments_tpu_torch.models import mesh_model as MM
from gaussian_garments_tpu_torch.utils.camera import Camera, camera_to_json, get_world2view2
from gaussian_garments_tpu_torch.utils.general import knn_numpy
from gaussian_garments_tpu_torch.utils.io import read_obj, read_ply, write_obj


def get_nerfpp_norm(cameras: List[Camera]) -> dict:
    """NeRF++-style camera-extent normalization (scene/scene.py:19-40)."""
    centers = np.hstack([np.linalg.inv(get_world2view2(c.R, c.T))[:3, 3:4] for c in cameras])
    center = centers.mean(axis=1, keepdims=True)
    diagonal = np.linalg.norm(centers - center, axis=0).max()
    return {"translate": -center.flatten(), "radius": float(diagonal * 1.1)}


def store_cam(cameras: List[Camera], out_dir) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(Path(out_dir) / "cameras.json", "w") as f:
        json.dump([camera_to_json(i, c) for i, c in enumerate(cameras)], f)


def load_body_without_hands(body_path: str, hand_list: np.ndarray):
    """The SMPL-X body ply without its hand vertices (scene/scene.py:114-120).
    Returns (verts, faces)."""
    d = read_ply(body_path)
    verts = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
    keep = np.ones(len(verts), bool)
    hand_list = np.asarray(hand_list)
    keep[hand_list[hand_list < len(verts)]] = False
    remap = np.cumsum(keep) - 1
    faces = d["faces"]
    return verts[keep], remap[faces[keep[faces].all(axis=1)]]


def bind_collision_faces(mesh_v: np.ndarray, body_v: np.ndarray, body_f: np.ndarray) -> np.ndarray:
    """Nearest body-face id of each garment vertex (scene/scene.py:117-118)."""
    from scipy.spatial import cKDTree

    _, nn = cKDTree(body_v[body_f].mean(axis=1)).query(mesh_v)
    return nn


class Scene:
    """Template-sequence scene (reference Scene)."""

    def __init__(self, args, dataloader, hand_list: Optional[np.ndarray] = None):
        self.args = args
        self.subject_out = args.subject_out
        self.dataloader = dataloader
        self.hand_list = hand_list if hand_list is not None else np.zeros(0, np.int64)
        self.train_cameras: List[Camera] = []
        self.test_cameras: List[Camera] = []
        self.cameras_extent = 1.0
        self.current_frame = 0
        self.prev_xyz = self.prev_rot = self.prev_offset = None
        self.neighbor_indices = self.neighbor_weight = self.neighbor_dist = None
        self.prev_gv_offset = self.gv_neighbor_weight = None

    def stage2_path(self) -> Path:
        return Path(self.subject_out) / DEFAULTS.stage2 / self.args.sequence

    def split_cameras(self, cam_info: List[Camera]):
        if self.args.eval:
            train = [c for i, c in enumerate(cam_info) if i % self.args.llffhold != 0]
            test = [c for i, c in enumerate(cam_info) if i % self.args.llffhold == 0]
        else:
            train, test = list(cam_info), []
        self.train_cameras, self.test_cameras = train, test
        self.cameras_extent = get_nerfpp_norm(train)["radius"]
        return train, test

    def prepare_frame_cameras(self, t: int):
        self.current_frame = t
        return self.split_cameras(self.dataloader.load_frame(t))

    def setup_body(self, mesh: MM.MeshState, t: int,
                   bind_frame: Optional[int] = None) -> MM.MeshState:
        """Bind collision faces against frame ``bind_frame`` (default t) and
        set the body of frame t (scene.py:122-133)."""
        if not self.dataloader.smplx_list:
            return mesh
        bind_frame = t if bind_frame is None else bind_frame
        bv, bf = load_body_without_hands(self.dataloader.smplx_list[bind_frame], self.hand_list)
        nn = bind_collision_faces(mesh.v.detach().cpu().numpy(), bv, bf)
        bv2, bf2 = load_body_without_hands(self.dataloader.smplx_list[t], self.hand_list)
        return MM.init_body(mesh, bv2, bf2, nn)

    def body_for_frame(self, t: int):
        """(body_verts, body_faces) of frame t for the debug panel; None when
        the dataset has no smplx."""
        if not self.dataloader.smplx_list:
            return None
        return load_body_without_hands(self.dataloader.smplx_list[t], self.hand_list)

    def warm_start(self, mesh: MM.MeshState, t: int) -> MM.MeshState:
        """Linear motion extrapolation + momentum rest-shape update
        (scene/scene.py:132-141)."""
        meshes_dir = self.stage2_path() / "meshes"
        prev2 = meshes_dir / f"frame_{t - 2:05d}.obj"
        prev1 = meshes_dir / f"frame_{t - 1:05d}.obj"
        if not prev2.exists():
            prev2 = prev1
        previous = read_obj(prev2)["vertices"]
        current = read_obj(prev1)["vertices"]
        dev = mesh.v.device
        mesh = MM.momentum_update(mesh, torch.as_tensor(current, dtype=torch.float32, device=dev))
        extrap = torch.as_tensor((current + (current - previous)).astype(np.float32), device=dev)
        return mesh.replace(v=extrap, tar_v=extrap)

    def post_each_frame(self, is_ff: bool, xyz: np.ndarray, rot: np.ndarray,
                        mesh_vt: np.ndarray, mesh_f: np.ndarray, binding: np.ndarray,
                        num_knn: int = 20):
        """Neighbour graphs for the ARAP terms (scene/scene.py:160-181)."""
        self.prev_xyz = np.asarray(xyz)
        self.prev_rot = np.asarray(rot)
        if is_ff:
            sq, idx = knn_numpy(self.prev_xyz, num_knn)
            self.neighbor_indices = idx.astype(np.int64)
            self.neighbor_weight = np.exp(-2000.0 * sq).astype(np.float32)
            self.neighbor_dist = np.sqrt(sq).astype(np.float32)
            init_gv_offset = np.asarray(mesh_vt)[np.asarray(mesh_f)][np.asarray(binding)] \
                - self.prev_xyz[:, None]
            self.gv_neighbor_weight = np.exp(
                -2000.0 * np.linalg.norm(init_gv_offset, axis=-1)).astype(np.float32)
            self.prev_gv_offset = init_gv_offset.astype(np.float32)
        self.prev_offset = (self.prev_xyz[self.neighbor_indices]
                            - self.prev_xyz[:, None]).astype(np.float32)

    def arap_cache(self) -> MG.ArapCache:
        """The neighbour graphs of ``post_each_frame`` as tensors on the
        dataloader's device."""
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.dataloader.device)
        return MG.ArapCache(
            prev_rot=t(self.prev_rot), prev_offset=t(self.prev_offset),
            neighbor_indices=t(self.neighbor_indices), neighbor_weight=t(self.neighbor_weight),
            prev_gv_offset=t(self.prev_gv_offset), gv_neighbor_weight=t(self.gv_neighbor_weight))

    def save(self, frame: int, params: G.GaussianParams, aux: G.GaussianAux,
             binding: np.ndarray, frames: MG.FaceFrames, template: bool = False):
        """World and local PLYs and the binding pickle of one frame
        (scene/scene.py:183-192, mesh_gaussian_model.save_ply :251-283)."""
        if template:
            pc_path = Path(self.subject_out) / DEFAULTS.stage2 / "Template"
        else:
            pc_path = self.stage2_path() / "point_cloud" / f"frame_{int(frame):05d}"
        os.makedirs(pc_path, exist_ok=True)
        alive = aux.alive.cpu().numpy()
        G.save_ply(str(pc_path / "local_point_cloud.ply"), params, alive)
        bind = torch.as_tensor(np.asarray(binding), dtype=torch.int64, device=params.xyz.device)
        with torch.no_grad():
            world = MG.local_to_world(params, bind, frames)
        G.save_ply(str(pc_path / "point_cloud.ply"), world, alive)
        with open(pc_path / "binding.pkl", "wb") as f:
            pickle.dump(np.asarray(binding)[alive], f)

    def save_mesh(self, frame: int, template_dict: dict, mesh_v: np.ndarray):
        out = dict(template_dict)
        out["vertices"] = np.asarray(mesh_v)
        meshes = self.stage2_path() / "meshes"
        os.makedirs(meshes, exist_ok=True)
        write_obj(out, meshes / f"frame_{int(frame):05d}.obj")


class CrossScene(Scene):
    """Cross-sequence scene (reference crossScene): the driver reloads the
    Template splats every frame; ``sparse_icp`` is the optional global
    alignment of the first frame via a throwaway sparse COLMAP run
    (cross_scene.py:145-187)."""

    @staticmethod
    def _clean_cloud(points: np.ndarray) -> np.ndarray:
        """binary_to_o3d preprocessing (cross_scene.py:177-187): voxel
        downsample + radius outlier removal."""
        from gaussian_garments_tpu_torch.ops.icp import remove_radius_outliers, voxel_downsample

        return remove_radius_outliers(voxel_downsample(points, 0.005), nb_points=5, radius=0.05)

    def sparse_icp(self, template_vertices: np.ndarray, camera_model: str = "PINHOLE") -> np.ndarray:
        """Globally align the template to this sequence's first frame by ICP
        between the stage-1 sparse cloud and a fresh sparse COLMAP
        reconstruction (cross_scene.py:145-175). Returns the moved vertices."""
        import shutil

        from gaussian_garments_tpu_torch.ops.icp import registration_icp, transform_points
        from gaussian_garments_tpu_torch.stages import s1
        from gaussian_garments_tpu_torch.utils.colmap import read_points3D_binary

        stage1 = Path(self.subject_out) / DEFAULTS.stage1
        src_xyz, _, _ = read_points3D_binary(stage1 / "sparse" / "points3D.bin")
        source = self._clean_cloud(src_xyz)

        source_root = Path(DEFAULTS.data_root) / self.args.subject / self.args.sequence
        target_root = self.stage2_path() / "colmap"
        remove_folder = not target_root.exists()
        s1.prepare_dataset(source_root, target_root, camera_model, device=self.dataloader.device)
        s1.colmap_recon(target_root, skip_dense=True)
        tgt_xyz, _, _ = read_points3D_binary(target_root / "sparse" / "points3D.bin")
        target = self._clean_cloud(tgt_xyz)

        T = registration_icp(source, target, 10.0)
        if remove_folder:
            shutil.rmtree(target_root)
        return transform_points(np.asarray(template_vertices, np.float64), T).astype(np.float32)
