"""Frame and dataset readers (port of ``gaussian_garments_tpu/data/readers.py``),
each process loading every camera.

- ``FrameDataloader``: stage 2's whole-frame loader (reference
  ``scene/dataset_readers.py:53-159``): per-camera filename indexing with the
  first-camera dedup shortcut, then ``load_frame(t)`` reads every camera's
  RGB, garment mask and foreground mask into ``Camera`` objects whose image
  and penalized mask lie on ``device``.
- ``AvatarDataset``: stage 3's (sequence, frame, camera) items over every
  sequence of a subject (reference ``scene/dataloader.py:17-283``), with the
  llffhold split, a per-epoch reshuffle in the JAX package's order and the
  AO/normal bake (``data/baker.py``) cached per frame.

Data parallelism is ported (``parallel/``, the drivers' ``--data_parallel``),
but not the JAX package's per-host slicing of the camera list
(``process_index``/``process_count``), by design: every rank loads every
camera, and in stage 3 the whole batch, so that the numpy stream of random
backgrounds stays in step on every rank (``s3_appearance.py``), and each rank
renders its own contiguous block of the batch (``parallel.shard``).
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from gaussian_garments_tpu_torch import resolve_device
from gaussian_garments_tpu_torch.config import DEFAULTS
from gaussian_garments_tpu_torch.utils.camera import Camera, make_camera
from gaussian_garments_tpu_torch.utils.io import load_masked_image, read_obj


def _index_camera_files(cam_paths: List[Path]):
    """Per-camera filename lists; when the second camera's first image has
    the first camera's name, every camera reuses the first camera's lists
    (dataset_readers.py:73-106)."""
    img_names, gm_names, fg_names = {}, {}, {}
    cam_to_copy_from = None
    for i, cam_path in enumerate(cam_paths):
        cam_name = cam_path.name
        if cam_to_copy_from is not None:
            img_names[cam_name] = img_names[cam_to_copy_from]
            gm_names[cam_name] = gm_names[cam_to_copy_from]
            fg_names[cam_name] = fg_names[cam_to_copy_from]
            continue
        img_files = sorted((cam_path / DEFAULTS.rgb_images).glob("*.png")) or \
            sorted((cam_path / DEFAULTS.rgb_images).glob("*.jpg"))
        gm_files = sorted((cam_path / DEFAULTS.garment_masks).glob("*.png")) or \
            sorted((cam_path / DEFAULTS.garment_masks).glob("*.jpg"))
        fg_files = sorted((cam_path / DEFAULTS.foreground_masks).glob("*.png"))
        img_names[cam_name] = [f.name for f in img_files]
        gm_names[cam_name] = [f.name for f in gm_files]
        fg_names[cam_name] = [f.name for f in fg_files]
        if i == 1:
            first = cam_paths[0].name
            if img_names[cam_name] and img_names[first] and \
                    img_names[cam_name][0] == img_names[first][0]:
                cam_to_copy_from = first
    return img_names, gm_names, fg_names


def camera_from_params(params: dict, width: int, height: int, uid: int,
                       image: Optional[np.ndarray], mask: Optional[np.ndarray],
                       image_name: str = "", device=None) -> Camera:
    """A camera from a cameras.json entry {intrinsics, extrinsics}."""
    intr = np.asarray(params["intrinsics"])
    extr = np.asarray(params["extrinsics"])
    return make_camera(R=np.transpose(extr[:, :3]), T=extr[:, 3], fx=intr[0, 0],
                       fy=intr[1, 1], cx=intr[0, 2], cy=intr[1, 2], width=width,
                       height=height, image=image, gt_alpha_mask=mask, uid=uid,
                       image_name=image_name, device=device)


class FrameDataloader:
    """All cameras of one frame of ``<data_root>/<subject>/<sequence>``."""

    def __init__(self, args, device=None):
        self.device = resolve_device(device)
        self.subject_out = args.subject_out
        self.white_background = args.white_background
        seq_path = Path(DEFAULTS.data_root) / args.subject / args.sequence
        self.cam_paths = sorted(p for p in seq_path.iterdir() if p.is_dir() and p.name != "smplx")
        with open(seq_path / "cameras.json") as f:
            self.camera_params = json.load(f)
        self.cam_num = len(self.cam_paths)
        self._img_names, self._gm_names, self._fg_names = _index_camera_files(self.cam_paths)
        self._len = len(self._img_names[self.cam_paths[0].name])
        self.smplx_list = [str(p) for p in sorted((seq_path / "smplx").glob("*.ply"))]
        self.cam_info: List[Camera] = []

    def __len__(self):
        return self._len

    def load_frame(self, frame: int) -> List[Camera]:
        bg = np.array([1, 1, 1]) if self.white_background else np.array([0, 0, 0])
        cams = []
        for c_idx, cam_path in enumerate(self.cam_paths):
            name = cam_path.name
            d = load_masked_image(cam_path / DEFAULTS.rgb_images / self._img_names[name][frame],
                                  cam_path / DEFAULTS.garment_masks / self._gm_names[name][frame],
                                  cam_path / DEFAULTS.foreground_masks / self._fg_names[name][frame],
                                  bg)
            h, w = d["masked_img"].shape[:2]
            image = d["masked_img"].astype(np.float32).transpose(2, 0, 1) / 255.0
            mask = d["penalized_mask"].astype(np.float32)[None]
            cams.append(camera_from_params(self.camera_params[name], w, h, c_idx, image, mask,
                                           image_name=name, device=self.device))
        self.cam_info = sorted(cams, key=lambda c: c.image_name)
        return self.cam_info


class AvatarDataset:
    """Stage-3 items: every (sequence, frame, camera) of ``<data_root>/<subject>``
    (scene/dataloader.py:17-200). An item is a dict {current_seq,
    current_frame, bg (3,) float32, camera (image and mask on ``device``),
    ambient (1,res,res), normal (3,res,res), mesh_v (V,3)}, the last three
    numpy."""

    def __init__(self, args, bind=None, device=None):
        self.device = resolve_device(device)
        self.data_dir = Path(DEFAULTS.data_root) / args.subject
        self.output_dir = Path(args.subject_out)
        self.bg = np.array([1, 1, 1]) if args.white_background else np.array([0, 0, 0])
        self.random_bg = args.random_bg
        self.blur_mask = getattr(args, "blur_mask", False)
        self.texture_size = args.texture_size
        self.bind = bind
        self.shuffle = bool(args.shuffle)

        self.dataset_info: Dict[str, dict] = {}
        self._all_items: List[Tuple[str, int, str]] = []
        self.eval_collection: List[Tuple[str, int, str]] = []
        for seq_path in sorted(p for p in self.data_dir.iterdir() if p.is_dir()):
            seq = seq_path.name
            cam_folders = sorted(p for p in seq_path.iterdir() if p.is_dir() and p.name != "smplx")
            if args.eval:
                cam_names = [c.name for i, c in enumerate(cam_folders) if i % args.llffhold != 0]
                eval_names = [c.name for i, c in enumerate(cam_folders) if i % args.llffhold == 0]
            else:
                cam_names, eval_names = [c.name for c in cam_folders], []
            img_names, gm_names, fg_names = _index_camera_files(cam_folders)
            with open(seq_path / "cameras.json") as f:
                cameras = json.load(f)
            info = {"cam_names": cam_names, "cameras": cameras, "seq_path": seq_path,
                    "img_names": img_names, "gm_names": gm_names, "fg_names": fg_names,
                    "frame_num": len(img_names[cam_folders[0].name])}
            self.dataset_info[seq] = info
            self._all_items += [(seq, f, c) for f in range(info["frame_num"]) for c in cam_names]
            self.eval_collection += [(seq, f, c) for f in range(info["frame_num"])
                                     for c in eval_names]
        self.reshuffle(epoch=0)

    def reshuffle(self, epoch: int) -> None:
        """Per-epoch order (reference ``DataLoader(shuffle=True)``,
        s3_appearance.py:99): ``random.Random(31359 + epoch)``, as the JAX
        package shuffles."""
        items = list(self._all_items)
        if self.shuffle:
            random.Random(31359 + epoch).shuffle(items)
        self.frame_collection = items

    def __len__(self):
        return len(self.frame_collection)

    def __getitem__(self, index: int) -> dict:
        return self.load_frame(*self.frame_collection[index])

    def eval_item(self, index: int) -> dict:
        """A held-out (llffhold) item, for the quality metrics."""
        return self.load_frame(*self.eval_collection[index % len(self.eval_collection)])

    def load_frame(self, seq: str, frame: int, cam: str) -> dict:
        info = self.dataset_info[seq]
        # the global numpy stream, as in the JAX package: one draw per item
        bg = np.random.rand(3) if self.random_bg else self.bg
        folder = info["seq_path"] / cam
        d = load_masked_image(folder / DEFAULTS.rgb_images / info["img_names"][cam][frame],
                              folder / DEFAULTS.garment_masks / info["gm_names"][cam][frame],
                              folder / DEFAULTS.foreground_masks / info["fg_names"][cam][frame],
                              bg)
        image = d["masked_img"].astype(np.float32).transpose(2, 0, 1) / 255.0
        mask = d["penalized_mask"].astype(np.float32)[None]
        h, w = image.shape[1:]
        camera = camera_from_params(info["cameras"][cam], w, h, 0, image, mask, image_name=cam,
                                    device=self.device)
        mesh_path = self.output_dir / DEFAULTS.stage2 / seq / "meshes" / f"frame_{frame:05d}.obj"
        body_path = self.data_dir / seq / "smplx" / f"{frame:05d}.ply"
        ambient, normal, mesh_v = self.get_maps(mesh_path, body_path)
        return {"current_seq": seq, "current_frame": frame, "bg": bg.astype(np.float32),
                "camera": camera, "ambient": ambient, "normal": normal, "mesh_v": mesh_v}

    def get_maps(self, mesh_path: Path, body_path: Optional[Path] = None):
        """(ambient, normal, mesh_v) of a frame's mesh, the bake cached as
        ``<seq>/texture/<frame>.npz`` (dataloader.py:202-277, Blender
        replaced by ``data/baker.py``)."""
        from gaussian_garments_tpu_torch.data.baker import bake_textures
        from gaussian_garments_tpu_torch.utils.io import read_ply

        mesh = read_obj(mesh_path)
        cache = mesh_path.parents[1] / "texture" / f"{mesh_path.stem}.npz"
        occluders = []
        if body_path is not None and Path(body_path).exists():
            body = read_ply(body_path)
            if body.get("faces") is not None:
                occluders.append((np.stack([body["x"], body["y"], body["z"]], axis=1),
                                  body["faces"]))
        ambient, normal = bake_textures(self.bind, mesh["vertices"], mesh["faces"],
                                        occluders=occluders, cache_path=str(cache))
        return ambient, normal, mesh["vertices"].astype(np.float32)
