"""Stage-1 geometry initialisation pipeline (port of
``gaussian_garments_tpu/stages/s1.py``; reference
``utils/preprocess_utils.py``, ``utils/initialisation_utils.py`` and
``utils/parse_scan.py``).

Three pieces run on the device, as in the JAX package: ``rotmat2qvec``, the
Poisson FFT solve (``stages.meshing.poisson_indicator``) and the
segmentation raster of ``parse_scan`` (``ops.mesh_raster``). The rest is the
JAX package's host numpy/scipy code, copied: the export, the COLMAP
subprocess chain, the green and outlier filter, the vote accumulation and the
meshing around the solve. ``device`` defaults to the card and raises without
a GPU; only ``device="cpu"`` runs on the CPU.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from gaussian_garments_tpu_torch import resolve_device
from gaussian_garments_tpu_torch.config import DEFAULTS
from gaussian_garments_tpu_torch.utils.io import load_masked_image, save_image
from gaussian_garments_tpu_torch.utils.logging import phase

GREEN = np.array([0.0, 1.0, 0.0])  # bg in [0,1] (io.load_masked_image scale)


def rotmat2qvec(R: np.ndarray, device=None) -> np.ndarray:
    """Rotation matrix -> COLMAP wxyz quaternion (preprocess_utils export),
    in float32 on ``device`` as the JAX package computes it."""
    from gaussian_garments_tpu_torch.utils.quaternion import rotmat_to_quat

    m = torch.as_tensor(np.asarray(R, np.float32)[None], device=resolve_device(device))
    return rotmat_to_quat(m)[0].cpu().numpy()


def prepare_dataset(source_root, target_root, camera_model: str = "PINHOLE",
                    template_frame: int = 0, overwrite: bool = False, device=None) -> None:
    """Export the template frame of every camera with the background painted
    green, its garment mask (``masks/<cam>.png.png``) and the COLMAP text
    model with known poses (reference ``PrepareDataset``,
    utils/preprocess_utils.py:26-156)."""
    device = resolve_device(device)
    source_root, target_root = Path(source_root), Path(target_root)
    imgs_dir = target_root / "images"
    sparse_dir = target_root / "sparse_known"
    masks_dir = target_root / "masks"
    if target_root.exists() and overwrite:
        shutil.rmtree(target_root)
    for d in (imgs_dir, sparse_dir, masks_dir):
        os.makedirs(d, exist_ok=True)

    cam_params = json.load(open(source_root / "cameras.json"))
    cam_paths = sorted([p for p in source_root.iterdir() if p.is_dir() and p.name != "smplx"])

    cameras_txt, images_txt = [], []
    for idx, cam_path in enumerate(cam_paths, start=1):
        name = cam_path.name
        imgs = sorted((cam_path / DEFAULTS.rgb_images).glob("*.png")) or \
            sorted((cam_path / DEFAULTS.rgb_images).glob("*.jpg"))
        gms = sorted((cam_path / DEFAULTS.garment_masks).glob("*.png")) or \
            sorted((cam_path / DEFAULTS.garment_masks).glob("*.jpg"))
        fgs = sorted((cam_path / DEFAULTS.foreground_masks).glob("*.png"))
        d = load_masked_image(imgs[template_frame], gms[template_frame],
                              fgs[template_frame], GREEN)
        out_name = f"{name}.png"
        save_image(imgs_dir / out_name, d["masked_img"] / 255.0)
        # the reference writes masks/<cam>.png.png (utils/preprocess_utils.py:62,
        # 113) and parse_scan reads them back (utils/parse_scan.py:67)
        save_image(masks_dir / f"{out_name}.png", d["mask"])

        intr = np.asarray(cam_params[name]["intrinsics"])
        extr = np.asarray(cam_params[name]["extrinsics"])
        h, w = d["masked_img"].shape[:2]
        fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
        cameras_txt.append(f"{idx} {camera_model} {w} {h} {fx} {fy} {cx} {cy}")
        q = rotmat2qvec(extr[:3, :3], device)
        t = extr[:, 3]
        images_txt.append(f"{idx} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} {idx} {out_name}")
        images_txt.append("")  # empty 2D-points line

    (sparse_dir / "cameras.txt").write_text("\n".join(cameras_txt) + "\n")
    (sparse_dir / "images.txt").write_text("\n".join(images_txt) + "\n")
    (sparse_dir / "points3D.txt").write_text("")
    # cameras.json also sits beside the stage-1 outputs, for inference
    shutil.copy(source_root / "cameras.json", target_root / "cameras.json")


def colmap_recon(target_root, gpu: bool = False, skip_dense: bool = False) -> None:
    """The 6-stage COLMAP chain as subprocesses (reference ``COLMAP_recon``,
    utils/initialisation_utils.py:26-107); exits with the first failing
    step's return code."""
    target_root = Path(target_root)
    db = target_root / "database.db"
    steps = [
        ["colmap", "feature_extractor", "--database_path", str(db),
         "--image_path", str(target_root / "images")],
        ["colmap", "exhaustive_matcher", "--database_path", str(db)],
        ["colmap", "point_triangulator", "--database_path", str(db),
         "--image_path", str(target_root / "images"),
         "--input_path", str(target_root / "sparse_known"),
         "--output_path", str(target_root / "sparse")],
    ]
    if not skip_dense:
        steps += [
            ["colmap", "image_undistorter", "--image_path", str(target_root / "images"),
             "--input_path", str(target_root / "sparse"),
             "--output_path", str(target_root / "dense")],
            ["colmap", "patch_match_stereo", "--workspace_path", str(target_root / "dense")],
            ["colmap", "stereo_fusion", "--workspace_path", str(target_root / "dense"),
             "--output_path", str(target_root / "fused.ply")],
        ]
    os.makedirs(target_root / "sparse", exist_ok=True)
    for cmd in steps:
        print("[COLMAP]", " ".join(cmd))
        r = subprocess.run(cmd)
        if r.returncode != 0:
            sys.exit(r.returncode)


def filter_green_and_outliers(points: np.ndarray, colors: np.ndarray,
                              voxel: float = 0.005, nb_neighbors: int = 20,
                              std_ratio: float = 3.5):
    """Green-background filter + voxel downsample + statistical outlier
    removal (reference post_process :117-143)."""
    from scipy.spatial import cKDTree

    not_green = ~((colors[:, 1] > 0.6) & (colors[:, 0] < 0.4) & (colors[:, 2] < 0.4))
    points, colors = points[not_green], colors[not_green]

    # voxel downsample: mean per occupied voxel
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums_p = np.zeros((counts.shape[0], 3))
    sums_c = np.zeros((counts.shape[0], 3))
    np.add.at(sums_p, inv, points)
    np.add.at(sums_c, inv, colors)
    points = (sums_p / counts[:, None]).astype(np.float32)
    colors = (sums_c / counts[:, None]).astype(np.float32)

    # statistical outlier removal: mean distance to k NN
    d, _ = cKDTree(points).query(points, k=nb_neighbors + 1)
    mean_d = d[:, 1:].mean(axis=1)
    keep = mean_d < mean_d.mean() + std_ratio * mean_d.std()
    return points[keep], colors[keep]


def parse_scan(scan_v: np.ndarray, scan_f: np.ndarray, cameras, masks: List[np.ndarray],
               min_side: int = 512, device=None, split=None) -> np.ndarray:
    """Per-vertex garment probability in [0,1] by rasterize-and-vote over
    every camera (reference utils/parse_scan.py:53-119, pytorch3d replaced by
    ``ops.mesh_raster`` on ``device``). ``masks``: per-camera garment masks
    (H,W) in {0,1}; votes add up on the host.

    Cameras below ``min_side`` are integer-supersampled, so a dense Poisson
    scan still receives votes on most faces. ``split`` (a
    ``utils.logging.PhaseSplit``) times each camera as ``parse_scan``."""
    from gaussian_garments_tpu_torch.ops.mesh_raster import rasterize_mesh
    from gaussian_garments_tpu_torch.utils.camera import make_camera

    device = resolve_device(device)
    votes = np.zeros(len(scan_v))
    seen = np.zeros(len(scan_v))
    fv = np.asarray(scan_f)
    v_t = torch.as_tensor(np.asarray(scan_v, np.float32), device=device)
    f_t = torch.as_tensor(fv.astype(np.int32), device=device)
    for cam, mask in zip(cameras, masks):
        with phase(split, "parse_scan"):
            mask = np.asarray(mask)
            s = max(1, -(-min_side // max(cam.image_width, cam.image_height)))
            if s > 1:
                cam = make_camera(R=cam.R, T=cam.T, fx=cam.fx * s, fy=cam.fy * s,
                                  cx=cam.cx * s, cy=cam.cy * s, width=cam.image_width * s,
                                  height=cam.image_height * s, device=device)
                mask = np.repeat(np.repeat(mask, s, axis=0), s, axis=1)
            with torch.no_grad():
                p2f, _ = rasterize_mesh(v_t, f_t, cam.world_view_transform.to(device),
                                        cam.full_proj_transform.to(device),
                                        image_width=cam.image_width,
                                        image_height=cam.image_height)
            p2f = p2f.cpu().numpy()
            vis = p2f >= 0
            face_ids = p2f[vis]
            in_mask = mask[vis] > 0.5
            for k in range(3):
                np.add.at(seen, fv[face_ids, k], 1.0)
                np.add.at(votes, fv[face_ids, k], in_mask.astype(np.float64))
    return np.where(seen > 0, votes / np.maximum(seen, 1), 0.0)


def load_segmentation_inputs(target_root, device=None):
    """The cameras (on ``device``) and exported garment masks that
    ``prepare_dataset`` wrote under ``target_root`` (the reference's
    parse_scan input contract: cameras.json + masks/<cam>.png.png,
    utils/parse_scan.py:53-79), each camera at its mask's resolution.
    Returns (cameras, masks); (None, None) when there are no masks."""
    from PIL import Image

    from gaussian_garments_tpu_torch.utils.camera import camera_from_json_params

    device = resolve_device(device)
    target_root = Path(target_root)
    masks_dir = target_root / "masks"
    cam_json = target_root / "cameras.json"
    if not masks_dir.is_dir() or not cam_json.exists():
        return None, None
    cam_params = json.load(open(cam_json))
    cameras, masks = [], []
    for p in sorted(masks_dir.glob("*.png.png")):
        name = p.name[: -len(".png.png")]
        if name not in cam_params:
            continue
        m = np.array(Image.open(p)) / 255.0
        if m.ndim == 3:
            m = m[..., 0]
        cameras.append(camera_from_json_params(cam_params[name], h=m.shape[0], w=m.shape[1],
                                               device=device))
        masks.append((m > 0.5).astype(np.float32))
    if not cameras:
        return None, None
    return cameras, masks


def post_process(target_root, template_out, cameras=None, garment_masks=None,
                 poisson_depth: int = 13, remesh_faces: int = 8000,
                 grid_res: Optional[int] = None, device=None, split=None) -> None:
    """fused.ply -> filtered cloud -> Poisson mesh -> garment segmentation ->
    remeshed template (reference post_process :109-173).

    Writes ``point_cloud.ply``, ``poisson.obj`` and, with cameras and masks,
    ``segmented.obj``, ``segmented_labels.npy`` and ``parser.obj`` under
    ``target_root``, and ``template.obj`` under ``template_out``. ``grid_res``
    defaults to 2^min(poisson_depth, 8). ``split`` (a
    ``utils.logging.PhaseSplit``) times each phase."""
    from gaussian_garments_tpu_torch.stages.meshing import (cluster_remesh, estimate_normals,
                                                            largest_component,
                                                            poisson_indicator, surface_nets)
    from gaussian_garments_tpu_torch.utils.io import fetch_ply, store_ply, write_obj

    device = resolve_device(device)
    target_root = Path(target_root)
    with phase(split, "read_cloud"):
        pc = fetch_ply(target_root / "fused.ply")
    with phase(split, "filter"):
        points, colors = filter_green_and_outliers(np.asarray(pc.points), np.asarray(pc.colors))
    store_ply(target_root / "point_cloud.ply", points, colors * 255)

    res = grid_res or (1 << min(poisson_depth, 8))
    with phase(split, "normals"):
        normals = estimate_normals(points.astype(np.float32))
    chi, _, iso, origin_scale = poisson_indicator(points.astype(np.float32), normals, res=res,
                                                  device=device, split=split)
    with phase(split, "surface_nets"):
        verts, faces = surface_nets(chi, iso, origin_scale)
    if len(faces) == 0:
        raise RuntimeError("stage-1 Poisson produced no iso-surface; check "
                           "the fused cloud density")
    with phase(split, "largest_component"):
        verts, faces = largest_component(verts, faces)

    # the reference's intermediate artifacts (initialisation_utils.py:149-161):
    # poisson.obj = whole scan, segmented.obj = scan + per-vertex labels (a
    # sidecar .npy: OBJ has no portable colour channel), parser.obj = the cut
    write_obj({"vertices": verts, "faces": faces}, target_root / "poisson.obj")

    if cameras is not None and garment_masks is not None:
        prob = parse_scan(verts, faces, cameras, garment_masks, device=device, split=split)
        keep_v = prob > 0.5
        write_obj({"vertices": verts, "faces": faces}, target_root / "segmented.obj")
        np.save(target_root / "segmented_labels.npy", keep_v)
        remap = np.cumsum(keep_v) - 1
        keep_f = keep_v[faces].all(axis=1)
        verts, faces = verts[keep_v], remap[faces[keep_f]]
        if len(faces) == 0:
            raise RuntimeError("stage-1 segmentation removed every face; "
                               "check the garment masks / camera poses")
        with phase(split, "largest_component"):
            verts, faces = largest_component(verts, faces)
        write_obj({"vertices": verts, "faces": faces}, target_root / "parser.obj")

    with phase(split, "remesh"):
        verts, faces = cluster_remesh(verts, faces, remesh_faces, split=split)

    write_obj({"vertices": verts, "faces": faces}, Path(template_out) / "template.obj")
