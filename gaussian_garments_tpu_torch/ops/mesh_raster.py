"""Mesh rasterizer (face-id + depth buffers) in chunked torch ops.

Port of ``gaussian_garments_tpu/ops/mesh_raster.py``: triangles are binned
like splats (``ops.tiled.bin_splats``: 16-px tiles, a 16-tile clip window, the
nearest 64 faces per tile), then each tile runs nearest-hit point-in-triangle
tests at pixel centres (x + 0.5, y + 0.5) with perspective-correct view depth.
"""
from __future__ import annotations

from typing import Tuple

import torch

from gaussian_garments_tpu_torch.ops.projection import transform_point_4x3, transform_point_4x4
from gaussian_garments_tpu_torch.ops.tiled import bin_splats


def project_mesh(verts: torch.Tensor, viewmatrix: torch.Tensor, projmatrix: torch.Tensor,
                 image_width: int, image_height: int):
    """Vertices -> (pixel xy (V,2), view z (V,))."""
    p_hom = transform_point_4x4(verts, projmatrix)
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    mx = ((p_proj[:, 0] + 1.0) * image_width - 1.0) * 0.5
    my = ((p_proj[:, 1] + 1.0) * image_height - 1.0) * 0.5
    z = transform_point_4x3(verts, viewmatrix)[:, 2]
    return torch.stack([mx, my], dim=-1), z


def rasterize_mesh(verts: torch.Tensor, faces: torch.Tensor, viewmatrix: torch.Tensor,
                   projmatrix: torch.Tensor, *, image_width: int, image_height: int,
                   tile_size: int = 16, max_tiles_side: int = 16, tile_capacity: int = 64,
                   chunk_tiles: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (pix_to_face (H,W) int64, -1 for background; depth (H,W) f32
    view-space z, +inf for background)."""
    faces = faces.to(torch.int64)
    xy, z = project_mesh(verts, viewmatrix, projmatrix, image_width, image_height)
    tri_xy = xy[faces]
    tri_z = z[faces]

    center = tri_xy.mean(dim=1)
    radius = torch.linalg.norm(tri_xy - center[:, None, :], dim=-1).max(dim=1).values
    in_front = torch.all(tri_z > 0.01, dim=1)
    e1 = tri_xy[:, 1] - tri_xy[:, 0]
    e2 = tri_xy[:, 2] - tri_xy[:, 0]
    area2d = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    radii = torch.where(in_front & (area2d != 0.0), torch.ceil(radius) + 1,
                        torch.zeros_like(radius)).to(torch.int32)

    tiles_x = -(-image_width // tile_size)
    tiles_y = -(-image_height // tile_size)
    binning = bin_splats(center, radii, tri_z.mean(dim=1), tiles_x=tiles_x, tiles_y=tiles_y,
                         tile_size=tile_size, max_tiles_side=max_tiles_side,
                         tile_capacity=tile_capacity)

    dev = verts.device
    num_tiles = tiles_x * tiles_y
    t_ids = torch.arange(num_tiles, device=dev)
    origin = torch.stack([(t_ids % tiles_x) * tile_size, (t_ids // tiles_x) * tile_size],
                         dim=-1).to(torch.float32)
    local = torch.arange(tile_size * tile_size, dtype=torch.float32, device=dev)
    lx, ly = local % tile_size, torch.div(local, tile_size, rounding_mode="floor")
    tri_tab = torch.cat([tri_xy.reshape(-1, 6), tri_z], dim=1)   # [ax ay bx by cx cy za zb zc]

    face_out, z_out = [], []
    for s in range(0, num_tiles, chunk_tiles):
        idx = binning.tile_idx[s:s + chunk_tiles]                 # (C,K)
        mask = binning.tile_mask[s:s + chunk_tiles]
        px = (origin[s:s + chunk_tiles, 0:1] + lx + 0.5)[:, None, :]   # (C,1,P)
        py = (origin[s:s + chunk_tiles, 1:2] + ly + 0.5)[:, None, :]
        rows = tri_tab[idx]                                        # (C,K,9)
        ax, ay, bx, by, cx, cy = (rows[..., i:i + 1] for i in range(6))
        za, zb, zc = rows[..., 6:7], rows[..., 7:8], rows[..., 8:9]

        def edge(p0x, p0y, p1x, p1y):
            return (p1x - p0x) * (py - p0y) - (p1y - p0y) * (px - p0x)

        w0 = edge(bx, by, cx, cy)
        w1 = edge(cx, cy, ax, ay)
        w2 = edge(ax, ay, bx, by)
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)      # (C,K,1)
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area > 0))
                  | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0) & (area < 0)))
        area_safe = torch.where(area == 0.0, torch.ones_like(area), area)
        inv_z = (w0 / area_safe) / za + (w1 / area_safe) / zb + (w2 / area_safe) / zc
        zpix = 1.0 / torch.clamp(inv_z, min=1e-9)
        ok = inside & mask[..., None] & (area != 0.0)
        zpix = torch.where(ok, zpix, torch.full_like(zpix, float("inf")))
        best_z, best = torch.min(zpix, dim=1)                      # first minimum
        best_face = torch.gather(idx, 1, best)
        face_out.append(torch.where(torch.isfinite(best_z), best_face,
                                    torch.full_like(best_face, -1)))
        z_out.append(best_z)

    def untile(x):
        x = torch.cat(x).reshape(tiles_y, tiles_x, tile_size, tile_size).permute(0, 2, 1, 3)
        return x.reshape(tiles_y * tile_size, tiles_x * tile_size)[:image_height, :image_width]

    return untile(face_out), untile(z_out)


def visible_faces(verts: torch.Tensor, faces: torch.Tensor, viewmatrix: torch.Tensor,
                  projmatrix: torch.Tensor, *, image_width: int, image_height: int,
                  **kw) -> torch.Tensor:
    """(F,) bool: the face owns at least one pixel of the face-id buffer."""
    pix_to_face, _ = rasterize_mesh(verts, faces, viewmatrix, projmatrix,
                                    image_width=image_width, image_height=image_height, **kw)
    flag = torch.zeros(faces.shape[0] + 1, dtype=torch.bool, device=verts.device)
    flag[torch.where(pix_to_face >= 0, pix_to_face, faces.shape[0]).reshape(-1)] = True
    return flag[:-1]
