"""Multi-garment inference model ("Doll") + simulated-trajectory dataset.

Port of ``gaussian_garments_tpu/doll.py`` (reference ``inference.py:229-415``)
with the depth-buffer joint visibility: per garment an AvatarNet forward
drives its texel Gaussians on the simulated mesh; the garments' splats are
concatenated with visibility as an opacity mask; the splat render is
composited over a shaded body render with depth-correct occlusion.

Everything after the host bake runs on one ``device``, the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

from gaussian_garments_tpu_torch import geometry as geo
from gaussian_garments_tpu_torch import resolve_device
from gaussian_garments_tpu_torch.config import DEFAULTS
from gaussian_garments_tpu_torch.models import avatar_gaussian as AG
from gaussian_garments_tpu_torch.models import gaussian as G
from gaussian_garments_tpu_torch.models import mesh_gaussian as MG
from gaussian_garments_tpu_torch.ops.mesh_raster import project_mesh, rasterize_mesh
from gaussian_garments_tpu_torch.renderer import SplatBundle
from gaussian_garments_tpu_torch.utils.io import read_obj


class Garment(NamedTuple):
    name: str
    template: dict              # read_obj dict of template_uv.obj
    faces: torch.Tensor         # (F,3) int64 on the device
    bind: AG.AvatarBinding
    splats: G.GaussianParams    # from the stage-3 texture checkpoint
    net: torch.nn.Module        # AvatarNet, eval mode
    sh_degree: int


def load_garment(name: str, *, sh_degree: int = 3, texture_size: int = 512,
                 device=None) -> Garment:
    """AvatarSimulationModel + AvatarNet.load_ckpt (inference.py:238-246).
    ``device`` defaults to the card."""
    from gaussian_garments_tpu_torch.models.avatar_net import AvatarNet
    from gaussian_garments_tpu_torch.training.checkpoints import (
        avatar_net_state_from_jax, load_s3_ckpt)

    device = resolve_device(device)
    root = Path(DEFAULTS.output_root) / name
    template = read_obj(root / DEFAULTS.stage1 / "template_uv.obj")
    bind, _ = AG.build_binding(template["uvs"], template["texture_faces"], texture_size,
                               device=device)
    ckpt = load_s3_ckpt(root / DEFAULTS.stage3)
    net = AvatarNet(texture_size=texture_size, sh_degree=sh_degree)
    net.load_state_dict(avatar_net_state_from_jax(ckpt["net_params"], ckpt["net_buffers"]))
    net = net.to(device).eval()
    splats = ckpt.get("splats")
    splats = AG.init_empty(bind, sh_degree) if splats is None else splats.to(device)
    return Garment(name=name, template=template,
                   faces=torch.as_tensor(np.asarray(template["faces"], np.int64), device=device),
                   bind=bind, splats=AG.adapt_params_layout(bind, splats), net=net,
                   sh_degree=sh_degree)


def update_garment(g: Garment, verts: torch.Tensor, ambient: torch.Tensor,
                   normal: torch.Tensor, world_view, campos) -> dict:
    """AvatarNet forward for one garment (inference.py:251-262): the bundle
    pieces of its texel splats for this frame."""
    from gaussian_garments_tpu_torch.models.avatar_net import apply_shadow

    v, f = verts, g.faces
    frames = MG.compute_face_frames(v, f)
    rows = MG.gather_frame_rows(frames, g.bind.binding, v, f)
    shadow_tex = g.net(ambient, normal, world_view, campos, g.bind, v, f, frames, rows=rows)
    local_xyz, shs = apply_shadow(g.bind, g.splats, shadow_tex, g.sh_degree)
    anchor = AG.barycentric_3d(g.bind, v, f, rows=rows)
    style_rows = AG.gather_texture(g.bind, shadow_tex)[:, 3:]
    return {
        "xyz": AG.avatar_world_xyz(local_xyz, g.bind, frames, anchor, rows=rows),
        "anchor": anchor,
        "rotation": MG.world_rotation(g.splats, g.bind.binding, frames, rows=rows),
        "scaling": MG.world_scaling(g.splats, g.bind.binding, frames, rows=rows),
        "opacity": G.get_opacity(g.splats),
        "shs": shs,
        "raw_shs": G.get_features(g.splats),
        "style": style_rows.reshape(style_rows.shape[0], -1, 3),
        "mesh_v": v,
        "mesh_f": f,
    }


def _merged_scene(updates: List[dict]):
    off, all_v, all_f = 0, [], []
    for u in updates:
        all_v.append(u["mesh_v"])
        all_f.append(u["mesh_f"] + off)
        off += u["mesh_v"].shape[0]
    return torch.cat(all_v), torch.cat(all_f)


def joint_visibility_depth(updates: List[dict], viewmatrix, projmatrix, *,
                           image_size: int = 256, rel_tol: float = 5e-3) -> torch.Tensor:
    """Depth-buffer joint visibility over the merged garment scene: one 256²
    depth raster plus an anchor projection; a splat is visible iff its anchor
    is within ``rel_tol`` of the nearest surface at its pixel."""
    scene_v, scene_f = _merged_scene(updates)
    anchors = torch.cat([u["anchor"] for u in updates])
    _, depth_buf = rasterize_mesh(scene_v, scene_f, viewmatrix, projmatrix,
                                  image_width=image_size, image_height=image_size)
    xy, z = project_mesh(anchors, viewmatrix, projmatrix, image_size, image_size)
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, image_size - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, image_size - 1)
    sampled = depth_buf.reshape(-1)[yi * image_size + xi]
    return (z > 0.0) & (z <= sampled * (1.0 + rel_tol))


def concat_bundle(updates: List[dict], vis: torch.Tensor, sh_degree: int,
                  override: str = "shs") -> SplatBundle:
    """prepare_gaussian (:270-283): concatenated splats, visibility as an
    opacity mask."""
    return SplatBundle(
        means3d=torch.cat([u["xyz"] for u in updates]),
        opacity=torch.cat([u["opacity"] for u in updates]) * vis[:, None],
        scales=torch.cat([u["scaling"] for u in updates]),
        rotations=torch.cat([u["rotation"] for u in updates]),
        shs=torch.cat([u[override] for u in updates]),
        active_sh_degree=sh_degree,
    )


def body_mask_and_image(body_v, body_f, garment_vs, garment_fs, camera):
    """Shaded body render + 'body in front of garments' mask (replaces the
    aitviewer depth-compare pass, inference.py:469-477)."""
    kw = dict(viewmatrix=camera.world_view_transform, projmatrix=camera.full_proj_transform,
              image_width=camera.image_width, image_height=camera.image_height)
    b_face, b_z = rasterize_mesh(body_v, body_f, **kw)
    g_z = torch.full_like(b_z, float("inf"))
    for gv, gf in zip(garment_vs, garment_fs):
        g_z = torch.minimum(g_z, rasterize_mesh(gv, gf, **kw)[1])
    body_mask = (b_face >= 0) & (b_z < g_z)

    normals = geo.face_normals(body_v, body_f)
    view = camera.camera_center - body_v[body_f].mean(dim=1)
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True), min=1e-12)
    shade = torch.abs((normals * view).sum(-1))
    shade_img = torch.where(b_face >= 0, shade[torch.clamp(b_face, min=0)],
                            torch.ones_like(b_z))
    return body_mask, torch.stack([shade_img] * 3, dim=0)


def composite(garment_rgb, garment_alpha, body_image, body_mask) -> torch.Tensor:
    """Doll.render compositing (:318-330): garment RGBA over the body image,
    body-occluded garment pixels removed."""
    rgb = torch.clamp(garment_rgb, 0.0, 1.0)
    a = torch.clamp(garment_alpha, 0.0, 1.0) * (~body_mask)[None].to(torch.float32)
    return torch.clamp(rgb * a + body_image * (1.0 - a), 0, 1)


class Simulation:
    """Trajectory dataset (inference.py:332-414) with the pkl contract of
    README.md:120-132: pred [N,V,3], cloth_faces, obstacle [N,B,3],
    obstacle_faces, garment_names."""

    def __init__(self, traj_path: str, output_path: str, *, sh_degree: int = 3,
                 texture_size: int = 512, device=None):
        self.device = resolve_device(device)
        with open(traj_path, "rb") as f:
            self.pkl = pickle.load(f)
        self.garment_names = self.pkl["garment_names"]
        self.garments = [load_garment(n, sh_degree=sh_degree, texture_size=texture_size,
                                      device=self.device) for n in self.garment_names]
        self.output = Path(output_path)
        os.makedirs(self.output, exist_ok=True)

    def __len__(self):
        return len(self.pkl["pred"])

    def split_vertices(self, vertices: np.ndarray) -> List[np.ndarray]:
        """Multi-garment concatenation split by template vertex counts."""
        out = []
        for g in self.garments:
            n = len(g.template["vertices"])
            out.append(vertices[:n])
            vertices = vertices[n:]
        return out

    def prepare_frame(self, idx: int):
        """Host part of a frame: per-frame meshes written to disk and AO/normal
        bakes (cached). Returns (garment vertex arrays, [(ambient, normal)],
        (body_v, body_f)) in numpy."""
        from gaussian_garments_tpu_torch.data.baker import bake_textures
        from gaussian_garments_tpu_torch.utils.io import write_obj

        vert_list = self.split_vertices(np.asarray(self.pkl["pred"][idx]))
        body_v = np.asarray(self.pkl["obstacle"][idx])
        body_f = np.asarray(self.pkl["obstacle_faces"])
        textures = []
        for gi, (g, verts) in enumerate(zip(self.garments, vert_list)):
            mesh_path = self.output / g.name / "meshes" / f"{idx:05d}.obj"
            os.makedirs(mesh_path.parent, exist_ok=True)
            if not mesh_path.exists():
                write_obj(dict(g.template, vertices=verts), mesh_path)
            occluders = [(body_v, body_f)] + [
                (np.asarray(v2), np.asarray(g2.template["faces"]))
                for gj, (g2, v2) in enumerate(zip(self.garments, vert_list)) if gj != gi]
            cache = self.output / g.name / "texture" / f"{idx:05d}.npz"
            textures.append(bake_textures(g.bind, verts, g.template["faces"],
                                          occluders=occluders, cache_path=str(cache)))
        return vert_list, textures, (body_v, body_f)

    def forward(self, idx: int, camera):
        """Host bake + every garment's net forward + joint visibility for one
        frame. Returns (updates, vis)."""
        vert_list, textures, _ = self.prepare_frame(idx)
        updates = self.device_updates(vert_list, textures, camera)
        vis = joint_visibility_depth(updates, camera.world_view_transform,
                                     camera.full_proj_transform)
        return updates, vis

    def device_updates(self, vert_list, textures, camera) -> List[dict]:
        dev = self.device
        return [update_garment(g, torch.as_tensor(np.asarray(v, np.float32), device=dev),
                               torch.as_tensor(amb, device=dev), torch.as_tensor(nrm, device=dev),
                               camera.world_view_transform, camera.camera_center)
                for g, v, (amb, nrm) in zip(self.garments, vert_list, textures)]
