"""Inference driver: render simulated garment trajectories to PNG rows.

Port of the repo's ``inference.py`` with the same flags and on-disk contract:
it reads a ContourCraft pkl (``pred``, ``cloth_faces``, ``obstacle``,
``obstacle_faces``, ``garment_names``) and, for each garment,
``<output_root>/<garment>/stage1/{template_uv.obj,cameras.json}`` and
``stage3/ckpt/net.pkl``; it writes ``<output_path>/renders/%05d.png``, each a
row of three panels ``shs | raw_shs | style``.

Per frame: bake the AO and normal textures (host), run each garment's
AvatarNet, compute depth-buffer joint visibility, rasterize the body and
garment meshes, render the three splat panels (CUDA compositor on a GPU),
composite, write the PNG.

    python -m gaussian_garments_tpu_torch.inference --traj_path traj.pkl \\
        --output_path out [--device cuda] [--texture_size 512 --sh_degree 3 \\
        --width 940 --height 1280]

``--device`` defaults to ``cuda`` and raises when no GPU is present; the CPU
path (the compositor's plain torch version) runs only with ``--device cpu``.
TF32 is turned off for the whole run. Not ported yet: ``--exact_visibility``
and ``--dense_texels`` (see ROADMAP.md).
"""
from __future__ import annotations

import json
import os
import sys
import time
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from gaussian_garments_tpu_torch import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = ArgumentParser(description="Inference parameters")
    parser.add_argument("--traj_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--camera", type=str, default=None,
                        help="camera name from stage-1 cameras.json (default: first)")
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--texture_size", type=int, default=512)
    parser.add_argument("--width", type=int, default=940)
    parser.add_argument("--height", type=int, default=1280)
    parser.add_argument("--hq", action="store_true", help="3004x4092 output")
    parser.add_argument("--white_background", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when no GPU is present")
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.hq:
        args.width, args.height = 3004, 4092
    return args


def load_camera(garment_name: str, args, device):
    from gaussian_garments_tpu_torch.config import DEFAULTS
    from gaussian_garments_tpu_torch.utils.camera import camera_from_json_params

    cam_json = Path(DEFAULTS.output_root) / garment_name / DEFAULTS.stage1 / "cameras.json"
    with open(cam_json) as f:
        cam_params = json.load(f)
    cam_name = args.camera or sorted(cam_params.keys())[0]
    return camera_from_json_params(cam_params[cam_name], h=args.height, w=args.width,
                                   device=device)


@torch.no_grad()
def render_frame(simu, idx: int, camera, bg: torch.Tensor, sh_degree: int, cfg):
    """One frame. Returns (uint8 row (H, 3W, 3) numpy, timings, garment coverage)."""
    from gaussian_garments_tpu_torch.doll import (body_mask_and_image, composite,
                                                  concat_bundle, joint_visibility_depth)
    from gaussian_garments_tpu_torch.renderer import render

    t0 = time.perf_counter()
    vert_list, textures, (body_v_np, body_f_np) = simu.prepare_frame(idx)
    t1 = time.perf_counter()
    dev = simu.device
    updates = simu.device_updates(vert_list, textures, camera)
    vis = joint_visibility_depth(updates, camera.world_view_transform,
                                 camera.full_proj_transform)
    body_v = torch.as_tensor(np.asarray(body_v_np, np.float32), device=dev)
    body_f = torch.as_tensor(np.asarray(body_f_np, np.int64), device=dev)
    body_mask, body_image = body_mask_and_image(
        body_v, body_f, [u["mesh_v"] for u in updates], [u["mesh_f"] for u in updates], camera)
    panels, coverage = [], None
    for key in ("shs", "raw_shs", "style"):
        out = render(camera, concat_bundle(updates, vis, sh_degree, override=key), bg,
                     config=cfg)
        if coverage is None:
            coverage = (out["alpha"] > 0.5).to(torch.float32).mean()
        panels.append(composite(out["render"], out["alpha"][0], body_image, body_mask))
    row = torch.cat(panels, dim=2).permute(1, 2, 0)
    row = torch.clamp(torch.round(row * 255.0), 0, 255).to(torch.uint8).cpu().numpy()
    timings = {"bake_mesh_io_s": t1 - t0, "device_s": time.perf_counter() - t1}
    return row, timings, float(coverage)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from gaussian_garments_tpu_torch import pin_full_f32
    from gaussian_garments_tpu_torch.doll import Simulation
    from gaussian_garments_tpu_torch.renderer import RasterConfig
    from gaussian_garments_tpu_torch.utils.io import save_image

    args = parse_args(argv)
    device = resolve_device(args.device)
    pin_full_f32()

    simu = Simulation(args.traj_path, args.output_path, sh_degree=args.sh_degree,
                      texture_size=args.texture_size, device=device)
    camera = load_camera(simu.garment_names[0], args, device)
    bg = torch.tensor([1.0, 1, 1] if args.white_background else [0.0, 0, 0], device=device)
    cfg = RasterConfig()

    out_dir = Path(args.output_path) / "renders"
    os.makedirs(out_dir, exist_ok=True)
    frames, coverage = [], []
    for idx in range(len(simu)):
        row, t, cov = render_frame(simu, idx, camera, bg, args.sh_degree, cfg)
        t2 = time.perf_counter()
        save_image(out_dir / f"{idx:05d}.png", row)
        t["png_s"] = time.perf_counter() - t2
        frames.append(t)
        coverage.append(cov)
        print(f"[{idx + 1}/{len(simu)}] rendered  "
              + " ".join(f"{k}={v:.3f}" for k, v in t.items()) + f" coverage={cov:.3f}")

    n = max(len(frames), 1)
    mean = {k: sum(t[k] for t in frames) / n for k in (frames[0] if frames else {})}
    print(f"timing per frame (s, mean over {len(frames)} frames, device {device}): "
          + " ".join(f"{k}={v:.3f}" for k, v in mean.items()))
    print("Inference complete.")
    return {"frames": frames, "mean": mean, "coverage": coverage, "device": str(device)}


if __name__ == "__main__":
    main()
