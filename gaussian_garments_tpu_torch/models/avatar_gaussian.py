"""UV-texel Gaussians: one splat per texel inside the template's UV islands.

Port of ``gaussian_garments_tpu/models/avatar_gaussian.py`` (reference
``scene/avatar_gaussian_model.py``): a scanline bind map gives each texel its
face, each texel stores the barycentric coordinates of its centre in that UV
triangle, and its anchor and world position follow the deforming mesh. Stage 3
initialises the texel splats from the stage-2 Template (``init_from_template``)
and masks them with the per-texel depth-buffer visibility
(``get_visible_mask_depth``); ``get_visible_mask_exact`` is the reference's
per-texel ray cast and ``get_visible_mask_raster`` the face-granular
approximation.

Two layouts share ``AvatarBinding``: compact (the reference's: one row per
texel inside a UV island) and dense (``--dense_texels``: res² rows in
row-major texel order with an ``alive`` mask, so texture gathers and scatters
are reshapes; dead rows are bound to face 0 and never render). Checkpoints
convert between them (``adapt_params_layout``), and the texture checkpoint
(``gaussian_maps``) is the same for both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gaussian_garments_tpu_torch import geometry as geo
from gaussian_garments_tpu_torch import resolve_device
from gaussian_garments_tpu_torch.models import gaussian as G
from gaussian_garments_tpu_torch.models import mesh_gaussian as MG


def rasterize_uv_bind_map(uvs: np.ndarray, texture_faces: np.ndarray, res: int) -> np.ndarray:
    """(res,res) bind map, -1 where no face covers the texel. Scanline fill
    with the reference's pixel rule (``avatar_gaussian_model.py:196-225``):
    centres (x+.5, y+.5), y ∈ [v1.y, v3.y), x ∈ [fmin, fmax); later faces
    overwrite earlier ones. Host numpy."""
    bind_map = np.full((res, res), -1, np.int64)
    uv_px = np.asarray(uvs, np.float64) * res
    for fi, tf in enumerate(np.asarray(texture_faces)):
        tri = uv_px[tf]
        v1, v2, v3 = tri[np.argsort(tri[:, 1], kind="stable")]
        if v3[1] == v1[1]:
            continue
        v4 = v1 + (v3 - v1) * ((v2[1] - v1[1]) / (v3[1] - v1[1]))
        ys = np.arange(int(np.floor(tri[:, 1].min())), int(np.floor(tri[:, 1].max())) + 1)
        yc = ys + 0.5
        ok = (yc >= v1[1]) & (yc < v3[1])
        for _y, y in zip(ys[ok], yc[ok]):
            if y < v2[1]:
                a, b, c, d = v1, v2, v1, v4
            else:
                a, b, c, d = v3, v2, v3, v4
            x1 = a[0] + (b[0] - a[0]) * (y - a[1]) / (b[1] - a[1]) if b[1] != a[1] else a[0]
            x2 = c[0] + (d[0] - c[0]) * (y - c[1]) / (d[1] - c[1]) if d[1] != c[1] else c[0]
            fmin, fmax = sorted([x1, x2])
            xs = np.arange(int(np.floor(fmin)), int(np.floor(fmax)) + 1)
            xs = xs[(xs + 0.5 >= fmin) & (xs + 0.5 < fmax)]
            if len(xs) and 0 <= _y < res:
                bind_map[_y, xs[(xs >= 0) & (xs < res)]] = fi
    return bind_map


@dataclasses.dataclass(frozen=True)
class AvatarBinding:
    """Static texel→face binding. Compact layout: G texels inside the UV
    islands, ``alive`` None. Dense layout: G = res², ``alive`` marks the
    texels inside an island; dead rows carry face 0 and barycentrics
    (1, 0, 0)."""

    binding: torch.Tensor   # (G,) int64 face ids
    gs_bc: torch.Tensor     # (G,3) barycentric coords of the texel centre
    flat_idx: torch.Tensor  # (G,) int64 = gs_u*res + gs_v (row-major texel)
    gs_u: torch.Tensor      # (G,) int64 row (v) index
    gs_v: torch.Tensor      # (G,) int64 col (u) index
    alive: Optional[torch.Tensor] = None   # (G,) bool, dense layout only
    texture_size: int = 512
    dense: bool = False


def build_binding(uvs: np.ndarray, texture_faces: np.ndarray, res: int,
                  bind_map: Optional[np.ndarray] = None, dense: bool = False,
                  device=None) -> Tuple[AvatarBinding, np.ndarray]:
    """Bind map + barycentric anchors (reference __init__ :47-65), on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    if bind_map is None:
        bind_map = rasterize_uv_bind_map(uvs, texture_faces, res)
    mask = bind_map > -1
    alive = None
    if dense:
        idx = np.arange(res * res)
        gs_u, gs_v = idx // res, idx % res
        alive = mask.reshape(-1)
        binding = np.where(alive, bind_map.reshape(-1), 0)
    else:
        gs_u, gs_v = np.where(mask)
        binding = bind_map[gs_u, gs_v]
    uv_tri = np.asarray(uvs)[np.asarray(texture_faces)][binding] * res    # (G,3,2)
    uv_gs = np.stack([gs_v, gs_u], axis=1) + 0.5
    a, b, c = geo.barycentric_2d(torch.from_numpy(uv_tri.astype(np.float32)),
                                 torch.from_numpy(uv_gs.astype(np.float32)))
    bc = torch.stack([a, b, c], dim=1)
    if dense:
        # dead texels: anchored at v0 of face 0 (finite, never rendered)
        keep = torch.from_numpy(alive)[:, None]
        bc = torch.where(keep, bc, bc.new_tensor([1.0, 0.0, 0.0]))
    as_long = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    bind = AvatarBinding(
        binding=as_long(binding), gs_bc=bc.to(device),
        flat_idx=as_long(gs_u * res + gs_v), gs_u=as_long(gs_u), gs_v=as_long(gs_v),
        alive=None if alive is None else torch.as_tensor(alive, device=device),
        texture_size=res, dense=dense)
    return bind, bind_map


def barycentric_3d(bind: AvatarBinding, mesh_v: torch.Tensor, mesh_f: torch.Tensor,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3D anchor of each texel on the current mesh (reference :151-159)."""
    tv = mesh_v[mesh_f].reshape(-1, 9)[bind.binding] if rows is None else rows[:, MG.FR_V]
    bc = bind.gs_bc
    return torch.stack([bc[:, 0] * tv[:, c] + bc[:, 1] * tv[:, 3 + c] + bc[:, 2] * tv[:, 6 + c]
                        for c in range(3)], dim=1)


def avatar_world_xyz(local_xyz: torch.Tensor, bind: AvatarBinding, frames: MG.FaceFrames,
                     anchor: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """world = R_face @ local · s_face + anchor (reference :140-148)."""
    if rows is None:
        rows = MG.gather_frame_rows(frames, bind.binding)
    return MG.rows_rot_apply(rows[:, MG.FR_R], local_xyz) * rows[:, MG.FR_S] + anchor


def local_offset(bind: AvatarBinding, frames: MG.FaceFrames, gs_3d: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World anchor → local face-frame offset (reference get_local_offset)."""
    if rows is None:
        rows = MG.gather_frame_rows(frames, bind.binding)
    return MG.rows_rot_apply_t(rows[:, MG.FR_R], (gs_3d - rows[:, MG.FR_C]) / rows[:, MG.FR_S])


def scatter_texture(bind: AvatarBinding, values: torch.Tensor, channels: int) -> torch.Tensor:
    """(G,C) texel values → (C,res,res) texture (zeros elsewhere)."""
    res = bind.texture_size
    if bind.dense:
        flat = values * bind.alive[:, None].to(values.dtype)
    else:
        flat = values.new_zeros((res * res, channels))
        flat[bind.flat_idx] = values
    return flat.reshape(res, res, channels).permute(2, 0, 1)


def gather_texture(bind: AvatarBinding, texture: torch.Tensor) -> torch.Tensor:
    """(C,res,res) texture → (G,C) per-texel rows; a reshape in the dense
    layout."""
    res = bind.texture_size
    flat = texture.permute(1, 2, 0).reshape(res * res, -1)
    return flat if bind.dense else flat[bind.flat_idx]


def texel_opacity(bind: AvatarBinding, params: G.GaussianParams) -> torch.Tensor:
    """(G,1) activated opacity of the texel splats; zero on the dense
    layout's dead rows, so that they never render."""
    opacity = G.get_opacity(params)
    if bind.alive is None:
        return opacity
    return opacity * bind.alive[:, None].to(opacity.dtype)


def init_from_template(bind: AvatarBinding, template_v: np.ndarray, template_f: np.ndarray,
                       world_ply_path: str, local_ply_path: str, max_sh_degree: int,
                       device=None) -> Tuple[G.GaussianParams, G.GaussianAux]:
    """Texel splats from the stage-2 Template point clouds (reference
    init_gaussians :69-138): local xyz starts at zero; features, scales,
    rotations and opacity come from the Template splat nearest to the texel's
    anchor in world space. On ``device`` (the card unless given)."""
    from scipy.spatial import cKDTree

    from gaussian_garments_tpu_torch.utils.io import read_ply

    device = resolve_device(device)
    dev = bind.binding.device
    v = torch.as_tensor(np.asarray(template_v, np.float32), device=dev)
    f = torch.as_tensor(np.asarray(template_f, np.int64), device=dev)
    gs_3d = barycentric_3d(bind, v, f).cpu().numpy()
    world = read_ply(world_ply_path)
    _, nb = cKDTree(np.stack([world["x"], world["y"], world["z"]], axis=1)).query(gs_3d)
    try:
        local, _ = G.load_ply(local_ply_path, max_sh_degree, device="cpu")
    except ValueError:
        # stage 2 runs at SH degree 0; higher coefficients start at zero, as the
        # reference swallows the mismatch (avatar_gaussian_model.py:99-110)
        local, _ = G.load_ply(local_ply_path, 0, device="cpu")
        r = (max_sh_degree + 1) ** 2 - 1
        local = local.replace(features_rest=torch.zeros((local.xyz.shape[0], r, 3)))
    take = torch.as_tensor(nb, dtype=torch.int64)
    n = len(gs_3d)
    params = G.GaussianParams(xyz=torch.zeros((n, 3)), **{
        k: getattr(local, k)[take] for k in G.PARAM_NAMES if k != "xyz"}).to(device)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    aux = G.GaussianAux(alive=torch.ones((n,), dtype=torch.bool, device=device),
                        max_radii2d=z(n), xyz_gradient_accum=z(n, 1), denom=z(n, 1))
    return params, aux


def init_empty(bind: AvatarBinding, max_sh_degree: int) -> G.GaussianParams:
    """Zero splats to be filled from a texture checkpoint (reference :318-332)."""
    n = bind.binding.shape[0]
    r = (max_sh_degree + 1) ** 2 - 1
    z = lambda *s: torch.zeros((n, *s), dtype=torch.float32, device=bind.binding.device)
    return G.GaussianParams(xyz=z(3), features_dc=z(1, 3), features_rest=z(r, 3),
                            scaling=z(3), rotation=z(4), opacity=z(1))


def _identity_where_dead(bind: AvatarBinding, params: G.GaussianParams) -> G.GaussianParams:
    """Dead dense rows get the identity rotation, so the quaternion maths of
    the rows that never render gives no NaN."""
    alive = bind.alive.to(params.rotation.device)[:, None]
    unit = params.rotation.new_tensor([1.0, 0.0, 0.0, 0.0])
    return params.replace(rotation=torch.where(alive, params.rotation, unit))


def densify_params(bind: AvatarBinding, params: G.GaussianParams) -> G.GaussianParams:
    """Compact rows → dense res² rows: dead rows are zero, with the identity
    rotation."""
    if not bind.dense:
        raise ValueError("densify_params needs a dense binding")
    res = bind.texture_size
    alive = bind.alive.to(params.xyz.device)
    out = {}
    for name in G.PARAM_NAMES:
        val = getattr(params, name)
        out[name] = val.new_zeros((res * res, *val.shape[1:]))
        out[name][alive] = val
    return _identity_where_dead(bind, G.GaussianParams(**out))


def adapt_params_layout(bind: AvatarBinding, params: G.GaussianParams) -> G.GaussianParams:
    """Checkpoint rows → this binding's layout, so checkpoints do not depend
    on it: compact → dense by ``densify_params``; dense → compact keeps the
    alive texels in row-major order (``flat_idx`` is that order). A no-op
    when the row count already matches."""
    if params.xyz.shape[0] == bind.binding.shape[0]:
        return params
    if bind.dense:
        return densify_params(bind, params)
    take = bind.flat_idx.to(params.xyz.device)
    return G.GaussianParams(**{k: getattr(params, k)[take] for k in G.PARAM_NAMES})


def gaussian_maps(bind: AvatarBinding, params: G.GaussianParams) -> Dict[str, np.ndarray]:
    """Splat rows → (res,res,·) numpy textures plus the (res,res) bool
    ``mask`` (AvatarSimulationModel :334-360). The same for both layouts: a
    dense layout's dead texels are zero."""
    res = bind.texture_size
    gs_u, gs_v = bind.gs_u.cpu().numpy(), bind.gs_v.cpu().numpy()
    if bind.alive is not None:
        mask = bind.alive.cpu().numpy().reshape(res, res)
    else:
        mask = np.zeros((res, res), bool)
        mask[gs_u, gs_v] = True
    out = {"mask": mask}
    for name in G.PARAM_NAMES:
        val = getattr(params, name).detach().cpu().numpy()
        tex = np.zeros((res, res, *val.shape[1:]), val.dtype)
        tex[gs_u, gs_v] = val
        tex[~mask] = 0
        out[name] = tex
    return out


def load_gaussian_maps(maps: Dict[str, np.ndarray], bind: Optional[AvatarBinding] = None,
                       device=None) -> G.GaussianParams:
    """Texture checkpoint → splat rows: the mask's texels in row-major order,
    or with a dense ``bind`` all res² rows, dead rotations the identity. On
    ``bind``'s device when it is given, else on ``device`` (the card unless
    the caller passes ``device="cpu"``)."""
    device = bind.binding.device if bind is not None else resolve_device(device)
    if bind is not None and bind.dense:
        res = bind.texture_size
        params = G.GaussianParams(**{k: torch.as_tensor(
            np.asarray(maps[k]).reshape(res * res, *maps[k].shape[2:]), device=device)
            for k in G.PARAM_NAMES})
        return _identity_where_dead(bind, params)
    mask = np.asarray(maps["mask"])
    return G.GaussianParams(**{k: torch.as_tensor(np.asarray(maps[k])[mask], device=device)
                               for k in G.PARAM_NAMES})


def get_visible_mask_exact(bind: AvatarBinding, mesh_v: torch.Tensor, mesh_f: torch.Tensor,
                           cam_center: torch.Tensor) -> torch.Tensor:
    """Per-texel ray-cast visibility, the reference's semantics (:227-263):
    visible iff the first hit of the camera→anchor ray is the texel's own
    face. O(G·F) (``ops.raytrace.raycast``). (G,) bool."""
    from gaussian_garments_tpu_torch.ops.raytrace import raycast

    gs_3d = barycentric_3d(bind, mesh_v, mesh_f)
    d = gs_3d - cam_center[None]
    dirs = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    _, pid = raycast(cam_center[None].expand_as(gs_3d), dirs, mesh_v, mesh_f)
    return pid == bind.binding


def get_visible_mask_depth(bind: AvatarBinding, mesh_v: torch.Tensor, mesh_f: torch.Tensor,
                           viewmatrix: torch.Tensor, projmatrix: torch.Tensor, *,
                           image_width: int, image_height: int, rel_tol: float = 5e-3,
                           rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-texel depth-buffer visibility: render the mesh's depth buffer,
    project each texel's anchor, and call it visible iff its view depth is
    within ``rel_tol`` of the nearest surface at that pixel (the raster
    counterpart of the reference's per-texel ray cast,
    avatar_gaussian_model.py:227-263). (G,) bool."""
    from gaussian_garments_tpu_torch.ops.mesh_raster import project_mesh, rasterize_mesh

    _, depth_buf = rasterize_mesh(mesh_v, mesh_f, viewmatrix, projmatrix,
                                  image_width=image_width, image_height=image_height)
    anchors = barycentric_3d(bind, mesh_v, mesh_f, rows=rows)
    xy, z = project_mesh(anchors, viewmatrix, projmatrix, image_width, image_height)
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, image_width - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, image_height - 1)
    sampled = depth_buf.reshape(-1)[yi * image_width + xi]
    return (z > 0.0) & (z <= sampled * (1.0 + rel_tol))


def get_visible_mask_raster(bind: AvatarBinding, mesh_v: torch.Tensor, mesh_f: torch.Tensor,
                            viewmatrix: torch.Tensor, projmatrix: torch.Tensor, *,
                            image_width: int, image_height: int) -> torch.Tensor:
    """Face-granular visibility: a texel is visible iff its face owns at
    least one pixel of the face-id buffer. (G,) bool."""
    from gaussian_garments_tpu_torch.ops.mesh_raster import visible_faces

    return visible_faces(mesh_v, mesh_f, viewmatrix, projmatrix, image_width=image_width,
                         image_height=image_height)[bind.binding]
