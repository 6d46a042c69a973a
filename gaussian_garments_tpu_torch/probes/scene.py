"""``bench.py``'s scene through the port: 150K splats over a draped sheet,
1920×1080, focal 2200, SH degree 0, projected and binned (6-tile clip)."""
from __future__ import annotations

import numpy as np
import torch

WIDTH, HEIGHT, N_SPLATS = 1920, 1080, 150_000


def project_arrays(cam, arrays: dict, width: int, height: int):
    """Project numpy splat arrays {means, scales, rots, shs, opacity} into
    ``cam`` on the camera's device."""
    from gaussian_garments_tpu_torch.ops.projection import project_gaussians

    dev = cam.world_view_transform.device
    t = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    return project_gaussians(
        t["means"], cam.world_view_transform, cam.full_proj_transform, cam.camera_center,
        image_width=width, image_height=height, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        scales=t["scales"], rotations=t["rots"], shs=t["shs"],
        opacities=t["opacity"].reshape(-1), sh_degree=0)


def bench_scene(device, n: int = N_SPLATS, width: int = WIDTH, height: int = HEIGHT):
    """(projected splats, binned pairs) of ``bench.py``'s scene on ``device``."""
    from gaussian_garments_tpu_torch.data.synthetic import build_garment_splats
    from gaussian_garments_tpu_torch.ops import tiles
    from gaussian_garments_tpu_torch.utils.camera import make_camera

    means, scales, rots, opac, shs = build_garment_splats(n, np.random.RandomState(0))
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 2.2]), fx=2200.0, fy=2200.0,
                      cx=width / 2, cy=height / 2, width=width, height=height, device=device)
    with torch.no_grad():
        proj = project_arrays(cam, {"means": means, "scales": scales, "rots": rots,
                                    "opacity": opac, "shs": shs}, width, height)
        pairs = tiles.bin_pairs(proj, image_width=width, image_height=height)
    return proj, pairs
