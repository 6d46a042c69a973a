"""Seeded scenes for the benchmark: a garment, a body, a capture rig, and
the ground truth a plain mesh raster makes of them, all on the device.

- ``garment``: a 64×64 vertex grid closed into a tube around the torso
  (7,938 faces), its UVs filling [0, 1]², posed per frame by a seeded ripple
  and sway;
- ``body``: a closed ellipsoid of about SMPL-X's 10,475 vertices;
- ``rig``: cameras on rings around the subject, looking at its centre;
- ``raster``: a z-buffered triangle raster at integer pixel centres (the
  splat renderer's convention), returning per pixel the nearest face, its
  depth and barycentric coordinates;
- ``ground_truth``: the garment's UV checker texture where it is the
  nearest surface, and that mask.

Nothing here imports the program; the program receives what these make.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch


def grid_faces(nx: int, ny: int) -> np.ndarray:
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = (i * ny + j).reshape(-1)
    b = ((i + 1) * ny + j).reshape(-1)
    return np.stack([np.stack([a, b, a + 1], 1), np.stack([a + 1, b, b + 1], 1)],
                    1).reshape(-1, 3).astype(np.int64)


def garment_uvs(nx: int, ny: int) -> np.ndarray:
    u, v = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny), indexing="ij")
    return np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)


def garment_motion(g: dict, rng: np.random.Generator) -> dict:
    """Seeded parameters of the garment's motion (see ``garment_pose``)."""
    return {"phase": rng.uniform(0, 2 * np.pi, 3), "amp": g["ripple"] * rng.uniform(0.5, 1.5),
            "turn": rng.uniform(-1, 1) * math.radians(g["turn_deg"])}


def garment_pose(g: dict, motion: dict, t: float) -> np.ndarray:
    """(V,3) float32 vertices at time ``t`` (in frames): the tube of ``g``
    (the garment block of a configuration) with a travelling ripple, a sway
    and a turn; ``motion`` None gives the rest shape (the template)."""
    nx, ny = g["nx"], g["ny"]
    th, z = np.meshgrid(np.linspace(0, 2 * np.pi, nx), np.linspace(0, 1, ny), indexing="ij")
    if motion is None:
        r, sway, turn = 1.0, 0.0, 0.0
    else:
        ph = motion["phase"] + t * np.array([0.3, 0.2, 0.25])
        r = 1.0 + motion["amp"] * np.sin(3 * th + ph[0]) * np.cos(2 * np.pi * z + ph[1])
        sway = g["sway"] * np.sin(np.pi * z + ph[2]) * z
        turn = motion["turn"] * np.cos(0.2 * t)
    th = th + turn
    x = g["radius_x"] * r * np.cos(th) + sway
    y = g["radius_y"] * r * np.sin(th)
    zz = g["z0"] + g["height"] * z
    return np.stack([x, y, zz], -1).reshape(-1, 3).astype(np.float32)


def body(b: dict):
    """(V,3) float32, (F,3) int64: an ellipsoid of ``rings`` × ``segments``
    vertices plus the two poles."""
    rings, segs = b["rings"], b["segments"]
    phi = np.linspace(0, np.pi, rings + 2)[1:-1]
    th = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    p, t = np.meshgrid(phi, th, indexing="ij")
    ax = np.asarray(b["axes"], np.float64)
    c = np.asarray(b["center"], np.float64)
    v = np.stack([np.sin(p) * np.cos(t), np.sin(p) * np.sin(t), np.cos(p)], -1).reshape(-1, 3)
    v = np.concatenate([[[0, 0, 1]], v, [[0, 0, -1]]]) * ax + c
    idx = lambda r, s: 1 + r * segs + (s % segs)
    f = []
    for s in range(segs):
        f.append([0, idx(0, s), idx(0, s + 1)])
        f.append([len(v) - 1, idx(rings - 1, s + 1), idx(rings - 1, s)])
    r, s = np.meshgrid(np.arange(rings - 1), np.arange(segs), indexing="ij")
    a, b_, c_, d = idx(r, s), idx(r + 1, s), idx(r + 1, s + 1), idx(r, s + 1)
    quads = np.stack([np.stack([a, b_, c_], -1), np.stack([a, c_, d], -1)], -2).reshape(-1, 3)
    return v.astype(np.float32), np.concatenate([np.asarray(f), quads]).astype(np.int64)


class Cam(NamedTuple):
    world_view: torch.Tensor   # (4,4) transposed world → view
    full_proj: torch.Tensor    # (4,4) transposed projection · world → view
    campos: torch.Tensor       # (3,)
    tanfovx: float
    tanfovy: float
    width: int
    height: int


def _camera(pos, target, f, width, height, device, znear=0.01, zfar=100.0) -> Cam:
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd])                   # world → camera rows
    w2v = np.eye(4)
    w2v[:3, :3] = r
    w2v[:3, 3] = -r @ pos
    cx, cy = width / 2, height / 2
    top, bottom = cy / f * znear, -(height - cy) / f * znear
    rgt, left = cx / f * znear, -(width - cx) / f * znear
    P = np.zeros((4, 4))
    P[0, 0] = 2 * znear / (rgt - left)
    P[1, 1] = 2 * znear / (top - bottom)
    P[0, 2] = (rgt + left) / (rgt - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return Cam(t(w2v.T), t((P @ w2v).T), t(pos), width / (2 * f), height / (2 * f), width, height)


def rig(r: dict, device) -> List[Cam]:
    """``rings`` heights × ``per_ring`` azimuths on a cylinder, each ring
    turned by half a step from the one below."""
    tgt = np.asarray(r["target"], np.float64)
    cams = []
    for k, h in enumerate(np.linspace(r["z_min"], r["z_max"], r["rings"])):
        for s in range(r["per_ring"]):
            a = 2 * np.pi * (s + 0.5 * (k % 2)) / r["per_ring"]
            pos = np.array([r["radius"] * np.cos(a), r["radius"] * np.sin(a), h])
            cams.append(_camera(pos, tgt, r["focal"], r["width"], r["height"], device))
    return cams


def project_points(v: torch.Tensor, cam: Cam, width: int, height: int):
    """(N,2) pixel coordinates and (N,) view z, at ``width`` × ``height``."""
    ph = torch.cat([v, v.new_ones((v.shape[0], 1))], 1)
    p = ph @ cam.full_proj
    ndc = p[:, :2] / (p[:, 3:4] + 1e-7)
    xy = torch.stack([((ndc[:, 0] + 1) * width - 1) * 0.5, ((ndc[:, 1] + 1) * height - 1) * 0.5], 1)
    return xy, (ph @ cam.world_view)[:, 2]


class Raster(NamedTuple):
    face: torch.Tensor    # (H,W) int64, -1 where empty
    depth: torch.Tensor   # (H,W) view z, +inf where empty
    bary: torch.Tensor    # (H,W,3)


@torch.no_grad()
def raster(v: torch.Tensor, f: torch.Tensor, cam: Cam, width: int, height: int) -> Raster:
    """Nearest face at each integer pixel centre; depth interpolated
    perspective-correctly."""
    xy, z = project_points(v, cam, width, height)
    txy, tz = xy[f], z[f]                                           # (F,3,2), (F,3)
    ok = (tz > 0.01).all(1)
    lo = torch.clamp(torch.ceil(txy.min(1).values), min=0)
    hi = torch.minimum(torch.floor(txy.max(1).values),
                       txy.new_tensor([width - 1, height - 1]))
    span = (hi - lo + 1).clamp(min=0).long()
    n = torch.where(ok, span[:, 0] * span[:, 1], 0)
    fid = torch.repeat_interleave(torch.arange(f.shape[0], device=v.device), n)
    k = torch.arange(fid.shape[0], device=v.device) - (torch.cumsum(n, 0) - n)[fid]
    px = lo[fid, 0] + (k % span[fid, 0]).float()
    py = lo[fid, 1] + (k // span[fid, 0]).float()
    a, b, c = txy[fid, 0], txy[fid, 1], txy[fid, 2]
    area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    e = lambda p, q: (q[:, 0] - p[:, 0]) * (py - p[:, 1]) - (q[:, 1] - p[:, 1]) * (px - p[:, 0])
    w0, w1, w2 = e(b, c), e(c, a), e(a, b)
    sgn = torch.sign(area)
    inside = (area != 0) & (w0 * sgn >= 0) & (w1 * sgn >= 0) & (w2 * sgn >= 0)
    bary = torch.stack([w0, w1, w2], 1) / torch.where(area == 0, 1.0, area)[:, None]
    inv_z = (bary / tz[fid]).sum(1)
    depth = 1.0 / inv_z
    fid, px, py, depth, bary = fid[inside], px[inside], py[inside], depth[inside], bary[inside]
    flat = py.long() * width + px.long()
    zbuf = torch.full((height * width,), float("inf"), device=v.device)
    zbuf.scatter_reduce_(0, flat, depth, "amin")
    win = depth <= zbuf[flat]
    fbuf = torch.full((height * width,), -1, dtype=torch.long, device=v.device)
    fbuf.scatter_reduce_(0, flat[win], fid[win], "amax")
    sel = win & (fbuf[flat] == fid)
    bbuf = torch.zeros((height * width, 3), device=v.device)
    pc = bary[sel] / tz[fid[sel]]
    bbuf[flat[sel]] = pc / pc.sum(1, keepdim=True)
    return Raster(fbuf.reshape(height, width), zbuf.reshape(height, width),
                  bbuf.reshape(height, width, 3))


def checker(uv: torch.Tensor, squares: int) -> torch.Tensor:
    """(...,3) in [0, 1]: a two-colour checker with a smooth gradient."""
    sq = (torch.floor(uv[..., 0] * squares) + torch.floor(uv[..., 1] * squares)) % 2
    base = torch.stack([0.25 + 0.5 * uv[..., 0], 0.3 + 0.4 * uv[..., 1],
                        0.6 - 0.3 * uv[..., 0]], -1)
    return torch.clamp(base + (sq[..., None] - 0.5) * 0.3, 0.0, 1.0)


@torch.no_grad()
def ground_truth(v, f, uvs, cam: Cam, squares: int):
    """(image (3,H,W), mask (1,H,W)) of the garment mesh in ``cam``."""
    r = raster(v, f, cam, cam.width, cam.height)
    hit = r.face >= 0
    uv = (uvs[f[r.face.clamp(min=0)]] * r.bary[..., None]).sum(-2)
    img = torch.where(hit[..., None], checker(uv, squares), 0.0)
    return img.permute(2, 0, 1).contiguous(), hit[None].float()


def vertex_normals(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    tri = v[f]
    fn = torch.linalg.cross(tri[:, 2] - tri[:, 1], tri[:, 0] - tri[:, 1], dim=-1)
    vn = torch.zeros_like(v).index_add_(0, f.reshape(-1), fn.repeat_interleave(3, 0))
    return vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True), min=1e-12)


def hemisphere(n: int, device) -> torch.Tensor:
    """Cosine-weighted Fibonacci directions around +z."""
    i = torch.arange(n, dtype=torch.float64, device=device) + 0.5
    u1, u2 = i / n, (i * 0.6180339887498949) % 1.0
    r, th = torch.sqrt(u1), 2 * math.pi * u2
    return torch.stack([r * torch.cos(th), r * torch.sin(th), torch.sqrt(1 - u1)], 1).float()


@torch.no_grad()
def bake(face, bc, gs_u, gs_v, res, v, f, body_cfg: dict, n_rays: int):
    """(ambient (1,res,res), normal (3,res,res)): smooth normals at the texel
    anchors packed to [0, 1], and ambient occlusion as the share of
    ``n_rays`` cosine-weighted rays that miss the body ellipsoid."""
    vn = vertex_normals(v, f)
    anchor = (bc[:, :, None] * v[f][face]).sum(1)
    nrm = (bc[:, :, None] * vn[f][face]).sum(1)
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True), min=1e-12)
    sign = torch.where(nrm[:, 2] >= 0, 1.0, -1.0)
    a = -1.0 / (sign + nrm[:, 2])
    b = nrm[:, 0] * nrm[:, 1] * a
    t = torch.stack([1.0 + sign * nrm[:, 0] ** 2 * a, sign * b, -sign * nrm[:, 0]], 1)
    bt = torch.stack([b, sign + nrm[:, 1] ** 2 * a, -nrm[:, 1]], 1)
    ax = torch.as_tensor(body_cfg["axes"], dtype=torch.float32, device=v.device)
    ctr = torch.as_tensor(body_cfg["center"], dtype=torch.float32, device=v.device)
    o = (anchor + 1e-4 * nrm - ctr) / ax
    hits = torch.zeros(len(face), device=v.device)
    for d in hemisphere(n_rays, v.device):
        dw = (d[0] * t + d[1] * bt + d[2] * nrm) / ax
        qa = (dw * dw).sum(1)
        qb = 2 * (o * dw).sum(1)
        qc = (o * o).sum(1) - 1.0
        disc = qb * qb - 4 * qa * qc
        far = (-qb + torch.sqrt(torch.clamp(disc, min=0))) / (2 * qa)
        hits += ((disc >= 0) & (far > 0)).float()
    amb = torch.zeros(res * res, device=v.device)
    nmap = torch.zeros((res * res, 3), device=v.device)
    flat = gs_u * res + gs_v
    amb[flat] = 1.0 - hits / n_rays
    nmap[flat] = nrm * 0.5 + 0.5
    return amb.reshape(1, res, res), nmap.reshape(res, res, 3).permute(2, 0, 1).contiguous()


@torch.no_grad()
def visibility(anchor: torch.Tensor, v, f, cam: Cam, size: int, rel_tol: float) -> torch.Tensor:
    """(G,) float: a texel is visible iff its anchor's view depth is within
    ``rel_tol`` of the garment's depth buffer (``size``² over the frame)."""
    r = raster(v, f, cam, size, size)
    xy, z = project_points(anchor, cam, size, size)
    xi = torch.clamp(torch.round(xy[:, 0]).long(), 0, size - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).long(), 0, size - 1)
    return ((z > 0) & (z <= r.depth[yi, xi] * (1 + rel_tol))).float()
