"""Synthetic garments, cameras, multi-view datasets and splat scenes.

Port of ``gaussian_garments_tpu/data/synthetic.py`` (``make_cloth_template``,
``make_camera_ring``, ``face_checker_colors``, ``render_ground_truth``,
``make_scene``, ``write_reference_layout``), so a dataset can be built on a
machine without jax. The ground truth is rendered with the port's own tiled
compositor. Plus ``make_splat_scene``, a seeded random splat scene for kernel
checks, ``make_cull_scene``, screen-space splats aimed at the compositor's
culls, and ``build_garment_splats``, the 150K-splat scene of ``bench.py``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from gaussian_garments_tpu_torch.utils.camera import Camera, make_camera


def make_cloth_template(nx: int = 12, ny: int = 12, size: float = 1.0,
                        ripple: float = 0.05) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A rippled rectangular sheet: (vertices (V,3), faces (F,3), uvs (V,2))."""
    xs = np.linspace(-size / 2, size / 2, nx)
    ys = np.linspace(-size / 2, size / 2, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    gz = ripple * np.sin(3.0 * np.pi * gx / size) * np.cos(2.0 * np.pi * gy / size)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([(gx + size / 2) / size, (gy + size / 2) / size],
                   axis=-1).reshape(-1, 2).astype(np.float32)
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = (i * ny + j).reshape(-1)
    b = ((i + 1) * ny + j).reshape(-1)
    faces = np.stack([np.stack([a, b, a + 1], 1), np.stack([a + 1, b, b + 1], 1)],
                     axis=1).reshape(-1, 3)
    return verts, faces.astype(np.int64), uvs


def make_camera_ring(n: int = 8, radius: float = 2.0, height: float = 0.8,
                     target: Optional[np.ndarray] = None, fx: float = 200.0,
                     width: int = 128, height_px: int = 128, device=None) -> List[Camera]:
    """n pinhole cameras on a ring looking at ``target`` (x right, y down,
    z forward)."""
    target = np.zeros(3) if target is None else np.asarray(target, np.float64)
    cams = []
    for k in range(n):
        a = 2 * np.pi * k / n
        pos = np.array([radius * np.cos(a), radius * np.sin(a), height])
        fwd = target - pos
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, 0.0, -1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        r_w2c = np.stack([right, down, fwd], axis=0)
        cams.append(make_camera(R=r_w2c.T, T=-r_w2c @ pos, fx=fx, fy=fx, cx=width / 2,
                                cy=height_px / 2, width=width, height=height_px,
                                uid=k, image_name=f"synthetic_{k:02d}", device=device))
    return cams


def face_checker_colors(faces: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Deterministic per-face RGB in [0,1] (checker + position gradient)."""
    centers = verts[faces].mean(axis=1)
    c = np.zeros((len(faces), 3), np.float32)
    c[:, 0] = 0.5 + 0.5 * np.sin(12 * centers[:, 0])
    c[:, 1] = 0.5 + 0.5 * np.cos(12 * centers[:, 1])
    c[:, 2] = np.linspace(0.2, 0.9, len(faces))
    return np.clip(c, 0.0, 1.0)


def render_ground_truth(cameras: List[Camera], verts: np.ndarray, faces: np.ndarray,
                        colors: np.ndarray, splat_log_scale: float = -4.6,
                        opacity: float = 0.95) -> List[Camera]:
    """One opaque splat per face of the true mesh, rendered into every camera
    with the port's tiled compositor on the cameras' device. Returns the
    cameras with ``original_image`` and ``gt_alpha_mask`` (alpha > 0.5) set."""
    import torch

    from gaussian_garments_tpu_torch.ops.projection import project_gaussians
    from gaussian_garments_tpu_torch.ops.tiles import rasterize_tiles
    from gaussian_garments_tpu_torch.utils.sh import rgb2sh

    dev = cameras[0].world_view_transform.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    n = len(faces)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1
    centers = t(verts[faces].mean(axis=1))
    scales = t(np.full((n, 3), np.exp(splat_log_scale)))
    shs = t(rgb2sh(np.asarray(colors, np.float32))[:, None, :])
    opac = t(np.full((n,), opacity))
    out = []
    with torch.no_grad():
        for cam in cameras:
            proj = project_gaussians(
                centers, cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
                image_width=cam.image_width, image_height=cam.image_height,
                tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, scales=scales, rotations=t(rots),
                shs=shs, opacities=opac, sh_degree=0)
            img, _, alpha, _ = rasterize_tiles(proj, image_height=cam.image_height,
                                               image_width=cam.image_width,
                                               bg=torch.zeros(3, device=dev))
            out.append(cam.replace(original_image=img,
                                   gt_alpha_mask=(alpha > 0.5).to(torch.float32)))
    return out


def make_scene(n_cams: int = 8, nx: int = 12, ny: int = 12, width: int = 128,
               height: int = 128, device=None):
    """(cameras with ground truth, true verts, faces, uvs, colors)."""
    verts, faces, uvs = make_cloth_template(nx, ny)
    colors = face_checker_colors(faces, verts)
    cams = make_camera_ring(n_cams, width=width, height_px=height, device=device)
    return render_ground_truth(cams, verts, faces, colors), verts, faces, uvs, colors


def fit_focal(verts: np.ndarray, *, n: int, radius: float, height: float, width: int,
              height_px: int, cover: float) -> float:
    """The focal length at which the garment's projected bounding box spans
    ``cover`` of the frame, in the tighter of its two directions and in the
    tightest camera of the ring. Above 1, its extreme corners leave the
    frame: the ring sees the square sheet turned by each camera's azimuth."""
    cams = make_camera_ring(n, radius=radius, height=height, fx=1.0, width=2, height_px=2,
                            device="cpu")
    fit = []
    for cam in cams:
        p = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], 1) \
            @ cam.world_view_transform.numpy()
        xy = p[:, :2] / p[:, 2:3]
        span = xy.max(0) - xy.min(0)
        fit.append(min(cover * width / span[0], cover * height_px / span[1]))
    return float(min(fit))


def write_reference_layout(data_root, output_root, subject: str, sequence: str, *,
                           n_cams: int = 4, n_frames: int = 2, nx: int = 10, ny: int = 10,
                           res: int = 64, width: Optional[int] = None,
                           height: Optional[int] = None, ring_radius: float = 2.0,
                           ring_height: float = 0.8, cover: Optional[float] = None,
                           device=None) -> dict:
    """A synthetic dataset in the reference's on-disk layout: per-camera
    rgb_images/garment_masks/foreground_masks, cameras.json and smplx/*.ply
    under the data root; template_uv.obj, point_cloud.ply and cameras.json
    under ``<output>/<subject>/stage1``. The garment translates a little every
    frame, so sequence tracking has real motion.

    ``width``/``height`` default to ``res``. The focal length is the JAX
    package's 200 px unless ``cover`` is given: then it is chosen so the
    garment's bounding box spans that share of the frame (``fit_focal``).
    The ground truth is rendered on ``device`` (the card by default)."""
    import json
    import os
    from pathlib import Path

    from gaussian_garments_tpu_torch.utils.io import save_image, store_ply, write_obj, write_ply

    width = width or res
    height = height or res
    verts, faces, uvs = make_cloth_template(nx, ny)
    colors = face_checker_colors(faces, verts)
    ring = dict(radius=ring_radius, height=ring_height)
    fx = 200.0 if cover is None else fit_focal(verts, n=n_cams, **ring, width=width,
                                                 height_px=height, cover=cover)
    cams = make_camera_ring(n_cams, **ring, fx=fx, width=width, height_px=height,
                            device=device)

    seq_dir = Path(data_root) / subject / sequence
    cam_json = {}
    for k, cam in enumerate(cams):
        intr = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
        extr = np.concatenate([cam.R.T, np.asarray(cam.T)[:, None]], axis=1)
        cam_json[f"Cam{k:03d}"] = {"intrinsics": intr.tolist(), "extrinsics": extr.tolist(),
                                   "ids": k}

    frame_meshes, coverage = [], []
    for t in range(n_frames):
        v_t = verts + np.array([0.004 * t, 0.002 * t, 0.0], np.float32)
        frame_meshes.append(v_t)
        for k, cam in enumerate(render_ground_truth(cams, v_t, faces, colors)):
            name = f"Cam{k:03d}"
            mask = cam.gt_alpha_mask[0].cpu().numpy()
            coverage.append(float(mask.mean()))
            save_image(seq_dir / name / "rgb_images" / f"{t:05d}.png",
                       cam.original_image.cpu().numpy().transpose(1, 2, 0))
            save_image(seq_dir / name / "garment_masks" / f"{t:05d}.png", mask)
            save_image(seq_dir / name / "foreground_masks" / f"{t:05d}.png", mask)

        # the "body": the sheet 2 units below the garment (keeps collision inert)
        body_v = verts.copy()
        body_v[:, 2] -= 2.0
        os.makedirs(seq_dir / "smplx", exist_ok=True)
        write_ply(seq_dir / "smplx" / f"{t:05d}.ply",
                  {a: body_v[:, i].astype(np.float32) for i, a in enumerate("xyz")})
        _append_ply_faces(seq_dir / "smplx" / f"{t:05d}.ply", body_v, faces)

    with open(seq_dir / "cameras.json", "w") as f:
        json.dump(cam_json, f)
    stage1 = Path(output_root) / subject / "stage1"
    os.makedirs(stage1, exist_ok=True)
    write_obj({"vertices": verts, "faces": faces, "uvs": uvs, "texture_faces": faces},
              stage1 / "template_uv.obj")
    store_ply(stage1 / "point_cloud.ply", verts[faces].mean(1), colors * 255)
    with open(stage1 / "cameras.json", "w") as f:
        json.dump(cam_json, f)
    return {"verts": verts, "faces": faces, "uvs": uvs, "colors": colors,
            "frames": frame_meshes, "cams": cams, "fx": fx,
            "min_coverage": min(coverage)}


def _append_ply_faces(path, verts, faces):
    """Rewrite a vertex-only binary PLY with a triangular face element."""
    n, m = len(verts), len(faces)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {m}\n"
              "property list uchar int vertex_indices\nend_header\n")
    farr = np.empty(m, np.dtype([("n", "u1"), ("idx", "<i4", 3)]))
    farr["n"] = 3
    farr["idx"] = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(verts, np.float32).tobytes())
        f.write(farr.tobytes())


def build_garment_splats(n: int, rng: np.random.RandomState):
    """``bench.py``'s scene: n splats spread over a draped 64×64 sheet that
    covers about a third of a 1920×1080 frame seen from (0, 0, -2.2) with
    focal 2200. Returns (means, scales, rots, opacity (n,1), shs)."""
    verts, faces, _ = make_cloth_template(64, 64, size=1.2, ripple=0.08)
    tri = verts[faces]
    fid = rng.randint(0, len(faces), n)
    w = rng.dirichlet((1, 1, 1), n).astype(np.float32)
    means = np.einsum("nk,nkc->nc", w, tri[fid]).astype(np.float32)
    scales = np.exp(rng.randn(n, 3).astype(np.float32) * 0.3 + np.log(0.004))
    rots = rng.randn(n, 4).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.randn(n, 1)))).astype(np.float32)
    shs = rng.randn(n, 1, 3).astype(np.float32) * 0.3
    return means, scales, rots, opac, shs


def write_inference_inputs(output_root, traj_path, *, name: str = "garment", nx: int = 48,
                           ny: int = 48, texture_size: int = 512, sh_degree: int = 3,
                           width: int = 940, height: int = 1280, n_frames: int = 3,
                           seed: int = 0) -> dict:
    """Everything ``inference`` reads, for one synthetic garment:
    ``<output_root>/<name>/stage1/{template_uv.obj,cameras.json}``, a seeded
    ``stage3/ckpt/net.pkl`` in the JAX package's layout (random AvatarNet
    weights; texel splats as ``scripts/bench_inference.py`` makes them), and a
    trajectory pkl of a moving sheet in front of a larger body sheet. The
    camera frames the garment to cover about 40% of the frame."""
    import json
    import os
    import pickle
    from pathlib import Path

    import torch

    from gaussian_garments_tpu_torch.models.avatar_gaussian import rasterize_uv_bind_map
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.models.gaussian import GaussianParams
    from gaussian_garments_tpu_torch.training.checkpoints import (
        avatar_net_state_to_jax, save_s3_ckpt)
    from gaussian_garments_tpu_torch.utils.io import write_obj

    root = Path(output_root) / name
    verts, faces, uvs = make_cloth_template(nx, ny)
    os.makedirs(root / "stage1", exist_ok=True)
    write_obj({"vertices": verts, "faces": faces, "uvs": uvs, "texture_faces": faces},
              root / "stage1" / "template_uv.obj")
    f = 2.2 * np.sqrt(width * height / 3.0)
    cam = {"intrinsics": [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]],
           "extrinsics": [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 2.0]]}
    with open(root / "stage1" / "cameras.json", "w") as fh:
        json.dump({"Cam000": cam}, fh)

    n = int((rasterize_uv_bind_map(uvs, faces, texture_size) > -1).sum())
    rng = np.random.RandomState(seed)
    splats = GaussianParams(
        xyz=np.zeros((n, 3), np.float32),
        features_dc=rng.randn(n, 1, 3).astype(np.float32) * 0.1,
        features_rest=np.zeros((n, (sh_degree + 1) ** 2 - 1, 3), np.float32),
        scaling=np.full((n, 3), -6.5, np.float32),
        rotation=np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1)),
        opacity=np.full((n, 1), 2.0, np.float32))
    net = AvatarNet(texture_size, sh_degree, generator=torch.Generator().manual_seed(seed))
    params, buffers = avatar_net_state_to_jax(net.state_dict())
    save_s3_ckpt(root / "stage3", net_params=params, net_buffers=buffers, splats=splats,
                 active_sh_degree=sh_degree)

    body_v, body_f, _ = make_cloth_template(max(nx // 2, 2), max(ny // 2, 2), size=1.6, ripple=0.0)
    # off-centre shifts keep mesh edges off pixel centres, where a one-ulp
    # difference would decide coverage
    body_v += np.array([0.0137, -0.0211, 0.4], np.float32)
    pred = [verts + np.array([0.0031 + 0.01 * t, -0.0047 + 0.005 * t, 0.0], np.float32)
            + np.array([0, 0, 0.01], np.float32) * np.sin(4 * verts[:, :1] + t)
            for t in range(n_frames)]
    traj = {"pred": np.stack(pred).astype(np.float32), "cloth_faces": faces,
            "obstacle": np.stack([body_v] * n_frames), "obstacle_faces": body_f,
            "garment_names": [name]}
    with open(traj_path, "wb") as fh:
        pickle.dump(traj, fh)
    return {"n_texels": n, "verts": verts, "faces": faces, "uvs": uvs}


def make_splat_scene(n: int, seed: int, *, n_wide: int = 0, spread: float = 0.3,
                     log_scale: float = -4.0, max_opacity: float = 1.0) -> dict:
    """Seeded random splats in front of a camera at (0, 0, -3) looking down +z
    (``make_camera(np.eye(3), [0, 0, 3], ...)``), as numpy arrays.

    The first ``n_wide`` splats are made large enough that their tile rect
    exceeds the 6×6-tile clip window at a few hundred pixels of width.

    Opacities are ``max_opacity · sigmoid(N(0, 1))``. The tiled compositor,
    like every CUDA-style rasterizer, drops what a splat adds outside its 3σ
    radius, where α ≤ opacity·e^-4.5; the per-pixel oracle keeps it. With
    ``max_opacity`` ≤ 0.35 that tail is below the 1/255 α cut, so the two
    agree to rounding."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n, 3).astype(np.float32) * spread
    scales = np.exp(rng.randn(n, 3).astype(np.float32) * 0.4 + log_scale)
    rots = rng.randn(n, 4).astype(np.float32)
    opac = (max_opacity / (1 + np.exp(-rng.randn(n)))).astype(np.float32)
    shs = rng.randn(n, 1, 3).astype(np.float32) * 0.3
    if n_wide:
        means[:n_wide] = rng.randn(n_wide, 3).astype(np.float32) * 0.2
        scales[:n_wide] = rng.uniform(0.25, 0.4, (n_wide, 3)).astype(np.float32)
        opac[:n_wide] = 0.5
    return {"means": means, "scales": scales, "rots": rots, "opacity": opac, "shs": shs}


def make_cull_scene(n: int, seed: int, *, width: int, height: int, device=None):
    """Seeded screen-space splats aimed at the compositor's culls (the row
    spans of ``bin_pairs`` and the kernels' warp boxes), as a
    ``ProjectedGaussians`` on ``device``:

    - opacities 0.95-0.99, so the α ≥ 1/255 contour (3.30σ-3.33σ) reaches
      past the 3σ radius into tiles that the rect covers;
    - anisotropic, rotated covariances, σ from 0.3 to 12 px per axis;
    - half the centres within 0.5 px of a warp corner (x a multiple of 8, y
      of 4: the kernels' 8×4-pixel warps), which the tile corners are among;
    - every 50th splat with a bad conic (det ≤ 0, or negative definite) and
      a 12 px radius.

    Depths are distinct; colours are uniform in [0, 1]."""
    import torch

    from gaussian_garments_tpu_torch.ops.projection import ProjectedGaussians

    rng = np.random.RandomState(seed)
    xy = rng.uniform(0.0, 1.0, (n, 2)) * [width, height]
    corner = np.round(xy / [8.0, 4.0]) * [8.0, 4.0] + rng.uniform(-0.5, 0.5, (n, 2))
    xy = np.where((rng.rand(n) < 0.5)[:, None], corner, xy)
    var = np.exp(rng.uniform(np.log(0.3), np.log(12.0), (n, 2))) ** 2
    th = rng.uniform(0.0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    cxx = cs * cs * var[:, 0] + sn * sn * var[:, 1]
    cyy = sn * sn * var[:, 0] + cs * cs * var[:, 1]
    cxy = cs * sn * (var[:, 0] - var[:, 1])
    det = cxx * cyy - cxy * cxy
    conic = np.stack([cyy / det, -cxy / det, cxx / det], 1)
    radii = np.ceil(3.0 * np.sqrt(var.max(1)))
    bad = np.arange(n) % 50 == 0
    conic[bad] = np.array([[1.0, 2.0, 1.0], [0.5, 0.0, -0.2], [-0.3, 0.1, -0.4]])[
        np.arange(bad.sum()) % 3]
    radii[bad] = 12
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return ProjectedGaussians(
        means2d=f32(xy), conic=f32(conic), depth=f32(1.0 + 0.01 * rng.permutation(n)),
        radii=torch.as_tensor(radii.astype(np.int32), device=device),
        rgb=f32(rng.uniform(0.0, 1.0, (n, 3))), opacity=f32(rng.uniform(0.95, 0.99, n)))
