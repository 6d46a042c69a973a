"""Stage-2 frame reader (port of ``FrameDataloader`` from
``gaussian_garments_tpu/data/readers.py``; reference
``scene/dataset_readers.py:53-159``), reduced to one process.

Per-camera filename indexing with the first-camera dedup shortcut, then
``load_frame(t)`` reads every camera's RGB, garment mask and foreground mask
into ``Camera`` objects whose image and penalized mask lie on ``device``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from gaussian_garments_tpu_torch import resolve_device
from gaussian_garments_tpu_torch.config import DEFAULTS
from gaussian_garments_tpu_torch.utils.camera import Camera, make_camera
from gaussian_garments_tpu_torch.utils.io import load_masked_image


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
