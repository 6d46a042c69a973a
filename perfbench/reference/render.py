"""Plain reference of the differentiable splat render (Gaussian Garments'
``gaussian_renderer``, the 3D Gaussian Splatting rasterizer), in float32
torch, computed in blocks of tiles so that it fits at 940×1280.

Semantics held: EWA projection with the 0.3 low-pass dilation, the frustum
cull (view z > 0.2, 3σ radius on screen), SH → RGB + 0.5 clamped at 0; per
pixel (integer centres) a front-to-back blend of the splats in depth order,
α = min(0.99, opacity·exp(power)), a splat skipped where power > 0 or
α < 1/255, and a splat counted only while the transmittance before it is
≥ 1e-4. Tiles are 16×32 pixels; a splat covers the tiles of its α ≥ 1/255
extent (clamped by its 3σ radius), clipped to a window of 6×6 tiles
anchored at the extent's top-left corner.

``composite`` is differentiable: each block of tiles is a checkpointed
dense (tiles × splats × pixels) blend, so its backward recomputes it.
``count_terms`` walks the same blocks without autograd and counts the
(pixel, splat) terms that contribute.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference.tf32 import round_tf32

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
TILE_W, TILE_H = 16, 32
WINDOW = 6
BLOCK_TERMS = 1 << 24

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792,
      0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
      -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class Projected(NamedTuple):
    means2d: torch.Tensor   # (N,2)
    conic: torch.Tensor     # (N,3)
    depth: torch.Tensor     # (N,)
    radii: torch.Tensor     # (N,) float, 0 where culled
    rgb: torch.Tensor       # (N,3)
    opacity: torch.Tensor   # (N,)


def eval_sh(deg: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """sh (N,K,3), d (N,3) unit → (N,3); bands 0..3."""
    s = lambda k: sh[:, k]
    r = C0 * s(0)
    if deg > 0:
        x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        r = r - C1 * y * s(1) + C1 * z * s(2) - C1 * x * s(3)
        if deg > 1:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            r = (r + C2[0] * xy * s(4) + C2[1] * yz * s(5) + C2[2] * (2.0 * zz - xx - yy) * s(6)
                 + C2[3] * xz * s(7) + C2[4] * (xx - yy) * s(8))
            if deg > 2:
                r = (r + C3[0] * y * (3 * xx - yy) * s(9) + C3[1] * xy * z * s(10)
                     + C3[2] * y * (4 * zz - xx - yy) * s(11)
                     + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * s(12)
                     + C3[4] * x * (4 * zz - xx - yy) * s(13) + C3[5] * z * (xx - yy) * s(14)
                     + C3[6] * x * (xx - 3 * yy) * s(15))
    return r


def _quat_rot(q):
    n = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    r, x, y, z = n.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def project(means3d, scales, rotations, shs, opacity, cam, sh_degree: int) -> Projected:
    """Splats (world means, activated scales, rotations, SH (N,K,3), opacity
    (N,)) into one camera: ``cam`` has the fields of ``gen.scene.Cam``
    (transposed world → view and full projection, centre, tan of the half
    fields of view, width, height)."""
    wv, fp = cam.world_view, cam.full_proj
    ones = means3d.new_ones((means3d.shape[0], 1))
    ph = torch.cat([means3d, ones], 1)
    p_hom = (ph[:, :, None] * fp[None]).sum(1)
    p_proj = p_hom[:, :3] / (p_hom[:, 3:4] + 1e-7)
    t = (ph[:, :, None] * wv[None, :, :3]).sum(1)
    fx = cam.width / (2.0 * cam.tanfovx)
    fy = cam.height / (2.0 * cam.tanfovy)
    tz = t[:, 2]
    tx = torch.clamp(t[:, 0] / tz, -1.3 * cam.tanfovx, 1.3 * cam.tanfovx) * tz
    ty = torch.clamp(t[:, 1] / tz, -1.3 * cam.tanfovy, 1.3 * cam.tanfovy) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
                     torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)], -2)   # (N,2,3)
    W = wv[:3, :3].T                                                              # view rotation
    M = (J[:, :, :, None] * W[None, None]).sum(2)                                 # (N,2,3)
    R = _quat_rot(rotations)
    RS = R * scales[:, None, :]
    cov3 = (RS[:, :, None, :] * RS[:, None, :, :]).sum(-1)                        # (N,3,3)
    MS = (M[:, :, :, None] * cov3[:, None]).sum(2)
    cov2 = (MS[:, :, None, :] * M[:, None, :, :]).sum(-1)                         # (N,2,2)
    c00, c01, c11 = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = c00 * c11 - c01 * c01
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack([c11 * inv, -c01 * inv, c00 * inv], -1)
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=1e-12)))
    mx = ((p_proj[:, 0] + 1.0) * cam.width - 1.0) * 0.5
    my = ((p_proj[:, 1] + 1.0) * cam.height - 1.0) * 0.5
    vis = ((tz > 0.2) & (det != 0.0) & (mx + radius >= 0) & (mx - radius < cam.width)
           & (my + radius >= 0) & (my - radius < cam.height))
    d = means3d - cam.campos[None]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    rgb = torch.clamp(eval_sh(sh_degree, shs, d) + 0.5, min=0.0)
    return Projected(torch.stack([mx, my], -1), conic, tz,
                     torch.where(vis, radius, torch.zeros_like(radius)), rgb,
                     torch.where(vis, opacity, torch.zeros_like(opacity)))


class Pairs(NamedTuple):
    """Per tile, its splats in depth order: ``splat`` (P,) and ``starts``/
    ``counts`` (T,) into it."""
    splat: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    tiles_x: int
    tiles_y: int


@torch.no_grad()
def tile_pairs(p: Projected, width: int, height: int) -> Pairs:
    tx, ty = -(-width // TILE_W), -(-height // TILE_H)
    a, b, c = p.conic.unbind(1)
    det = a * c - b * b
    tau2 = 2.0 * torch.log(torch.clamp(p.opacity, min=1e-12) / ALPHA_EPS)
    ext = torch.sqrt(torch.clamp(tau2[:, None] * torch.stack([c, a], 1), min=0.0)
                     / torch.clamp(det, min=1e-24)[:, None])
    ok = (det > 1e-24) & torch.isfinite(tau2) & torch.isfinite(det)
    r = p.radii[:, None]
    e = torch.where(ok[:, None], ext, r)
    e = torch.minimum(torch.where(torch.isfinite(e), e, r), r)
    size = p.means2d.new_tensor([TILE_W, TILE_H])
    grid = p.means2d.new_tensor([tx, ty])
    lo = torch.clamp(torch.floor((p.means2d - e) / size), min=0.0)
    lo = torch.minimum(lo, grid).long()
    hi = torch.minimum(torch.clamp(torch.floor((p.means2d + e + size - 1) / size + 1), min=0.0),
                       grid).long()
    hi = torch.minimum(hi, lo + WINDOW)
    alive = (p.radii > 0) & (p.opacity >= ALPHA_EPS)
    w = torch.where(alive, (hi[:, 0] - lo[:, 0]).clamp(min=0) * (hi[:, 1] - lo[:, 1]).clamp(min=0),
                    0)
    n = p.means2d.shape[0]
    sid = torch.repeat_interleave(torch.arange(n, device=w.device), w)
    k = torch.arange(sid.shape[0], device=w.device) - (torch.cumsum(w, 0) - w)[sid]
    span_x = (hi[:, 0] - lo[:, 0])[sid]
    tile = (lo[sid, 1] + k // span_x) * tx + lo[sid, 0] + k % span_x
    rank = torch.empty(n, dtype=torch.long, device=w.device)
    rank[torch.argsort(p.depth, stable=True)] = torch.arange(n, device=w.device)
    order = torch.argsort(tile * n + rank[sid])
    counts = torch.bincount(tile, minlength=tx * ty)
    return Pairs(sid[order], torch.cumsum(counts, 0) - counts, counts, tx, ty)


def _blend(feat, idx, valid, px, py, pix_ok, tf32=False):
    """Dense blend of a block: feat (N,9) [mx,my,a,b,c,op,r,g,b]; idx/valid
    (t,K); px/py/pix_ok (t,1,512). Returns (rgb (t,512,3), alpha (t,512),
    contributing terms (t,)). ``tf32`` rounds to TF32 the operands that a
    TF32 compositor would take into its products: the conic, the opacity,
    the colours and the blend weights; positions and their offsets from the
    pixel stay float32, as a compositor subtracts them before any product
    (the control)."""
    rnd = round_tf32 if tf32 else (lambda x: x)
    f = feat[idx]                                                   # (t,K,9)
    f = torch.cat([f[:, :, :2], rnd(f[:, :, 2:])], 2)
    col = lambda i: f[:, :, i:i + 1]
    dx, dy = col(0) - px, col(1) - py
    power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
    al = torch.clamp(col(5) * torch.exp(power), max=ALPHA_MAX)
    use = valid[:, :, None] & pix_ok & (power <= 0.0) & (al >= ALPHA_EPS)
    al = torch.where(use, al, torch.zeros_like(al))
    l1m = torch.log1p(-al)
    t_before = torch.exp(torch.cumsum(l1m, dim=1) - l1m)
    wgt = rnd(torch.where(t_before >= T_EPS, al * t_before, torch.zeros_like(al)))
    rgb = torch.einsum("tkp,tkc->tpc", wgt, f[:, :, 6:9])
    return rgb, wgt.sum(1), (wgt > 0).sum((1, 2))


def _blocks(pairs: Pairs):
    """Tiles in order of decreasing count, grouped so that a block's dense
    blend holds at most ``BLOCK_TERMS`` terms: [(tile ids, K)]."""
    counts = pairs.counts.tolist()
    order = sorted(range(len(counts)), key=lambda t: -counts[t])
    out, cur = [], []
    for t in order:
        if counts[t] == 0:
            break
        if cur and (len(cur) + 1) * counts[cur[0]] * TILE_W * TILE_H > BLOCK_TERMS:
            out.append((cur, counts[cur[0]]))
            cur = []
        cur.append(t)
    if cur:
        out.append((cur, counts[cur[0]]))
    return out


def _block_inputs(pairs: Pairs, tiles, k, width, height, device):
    t = torch.as_tensor(tiles, device=device)
    j = torch.arange(k, device=device)
    valid = j[None, :] < pairs.counts[t][:, None]
    idx = pairs.splat[torch.where(valid, pairs.starts[t][:, None] + j[None, :], 0)]
    q = torch.arange(TILE_W * TILE_H, device=device)
    pxi = (t % pairs.tiles_x)[:, None] * TILE_W + (q % TILE_W)[None, :]
    pyi = (t // pairs.tiles_x)[:, None] * TILE_H + (q // TILE_W)[None, :]
    pix_ok = ((pxi < width) & (pyi < height))[:, None, :]
    return t, idx, valid, pxi, pyi, pix_ok


def composite(p: Projected, pairs: Pairs, width: int, height: int, tf32: bool = False):
    """(rgb (3,H,W) on a zero background, alpha (1,H,W)), differentiable in
    ``p``'s means, conics, opacities and colours; ``tf32``: the control."""
    dev = p.means2d.device
    feat = torch.cat([p.means2d, p.conic, p.opacity[:, None], p.rgb], 1)
    rgb = feat.new_zeros((height * width, 3))
    alpha = feat.new_zeros((height * width,))
    for tiles, k in _blocks(pairs):
        t, idx, valid, pxi, pyi, pix_ok = _block_inputs(pairs, tiles, k, width, height, dev)
        c, a, _ = checkpoint(_blend, feat, idx, valid, pxi[:, None].float(), pyi[:, None].float(),
                             pix_ok, tf32, use_reentrant=False)
        flat = (pyi.clamp(max=height - 1) * width + pxi.clamp(max=width - 1))
        keep = pix_ok[:, 0]
        rgb = rgb.index_put((flat[keep],), c[keep], accumulate=True)
        alpha = alpha.index_put((flat[keep],), a[keep], accumulate=True)
    return rgb.T.reshape(3, height, width), alpha.reshape(1, height, width)


@torch.no_grad()
def count_terms(p: Projected, pairs: Pairs, width: int, height: int) -> dict:
    """The work these inputs need: contributing (pixel, splat) terms, pairs,
    splats with a pair, pixels, tiles."""
    dev = p.means2d.device
    feat = torch.cat([p.means2d, p.conic, p.opacity[:, None], p.rgb], 1)
    terms = 0
    for tiles, k in _blocks(pairs):
        t, idx, valid, pxi, pyi, pix_ok = _block_inputs(pairs, tiles, k, width, height, dev)
        terms += int(_blend(feat, idx, valid, pxi[:, None].float(), pyi[:, None].float(),
                            pix_ok)[2].sum())
    return {"terms": terms, "pairs": int(pairs.splat.shape[0]),
            "splats": int(torch.unique(pairs.splat).numel()), "pixels": width * height,
            "tiles": pairs.tiles_x * pairs.tiles_y}


def full_sh(features_dc, features_rest, delta=None):
    sh = torch.cat([features_dc, features_rest], 1)
    return sh if delta is None else sh + delta
