"""Tile binning and the splat compositor, forward and backward.

Port of ``gaussian_garments_tpu/ops/pallas_tiles.py``:

- ``tile_rects``: the opacity-aware per-axis splat rect and the ``alive``
  rule, ported exactly from ``_tile_rects``;
- ``row_spans``: the exact per-(splat, tile-row) x-span of the α ≥ 1/255
  ellipse inside the rect, ported exactly from ``_row_spans``; both share
  the per-splat ellipse terms of ``ellipse``;
- ``bin_pairs``: CUDA-style binning as torch ops. Each alive splat emits the
  tiles of its row spans inside a ``max_tiles_side``² window anchored at the
  rect's top-left; an exclusive scan of the per-(splat, row) widths places
  the pairs, each pair gets the int64 key ``tile·N + depth_rank`` (rank from
  a stable argsort of depth), ``torch.sort`` orders them and a search gives
  per-tile ranges. Pairs are allocated exactly from the counts, so nothing
  overflows (``n_overflow`` is always 0). The row spans drop only pairs
  whose α is below 1/255 at every pixel of their tile, so every output and
  gradient equals that of the plain rect; the JAX package applies them at
  ``max_tiles_side`` ≤ 8 (its nibble packing), the port at every side;
- ``composite_tiles``: the compositor, one ``torch.autograd.Function``. Its
  forward runs the hand-written kernel ``csrc/composite_fwd.cu`` for CUDA
  tensors and ``composite_tiles_plain``, the same math in plain torch, for
  CPU tensors; its backward likewise runs ``csrc/composite_bwd.cu`` or
  ``composite_tiles_backward_plain``. Both kernels are built with nvcc at
  first use and loaded with ctypes (``ops/cuda.py``).

Tiles are 16 wide × 32 tall, as in the JAX package. The kernels skip, per
warp of 8×4 pixels, the splats whose warp box misses the warp; they compute
the box from the conic and opacity as they stage a splat, and
``warp_extents`` is its torch twin, for the tests. Columns 10-11 of the
feature table are zero.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaussian_garments_tpu_torch.ops.cuda import check_tensor, launch, route, stream
from gaussian_garments_tpu_torch.ops.projection import ProjectedGaussians
from gaussian_garments_tpu_torch.ops.rasterizer_ref import ALPHA_EPS, ALPHA_MAX, T_EPS

TILE_W = 16
TILE_H = 32
PIX = TILE_W * TILE_H
FEAT_DIM = 12       # [mx, my, ca, cb, cc, opacity, r, g, b, depth, ex, ey]
SPAN_EPS_PX = 1e-3  # margin of the row spans and the warp boxes (``_SPAN_EPS_PX``)
# rounding allowance of a warp box per pixel of extent and unit of conic
# condition: 2^-18, 64 float32 unit roundoffs (see ``warp_extents``)
BOX_ROUND = 2.0 ** -18


def tile_grid(image_width: int, image_height: int):
    return -(-image_width // TILE_W), -(-image_height // TILE_H)


class Ellipse(NamedTuple):
    """Per-splat terms of the α ≥ 1/255 ellipse {dᵀ·C·d ≤ τ²}, C = [[a, b],
    [b, c]] the conic and τ² = 2·ln(opacity·255), float32. ``ext`` (N, 2)
    holds its half-extents (x, y) = (√(τ²·c/det), √(τ²·a/det)), unclamped;
    ``rect_ok`` is ``_tile_rects``' test of a usable conic, ``ok`` the stricter
    one of ``_row_spans`` (also a, c > 0)."""
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    det: torch.Tensor
    det_c: torch.Tensor       # det clamped to ≥ 1e-24
    tau2: torch.Tensor
    ext: torch.Tensor
    rect_ok: torch.Tensor
    ok: torch.Tensor


def ellipse(proj: ProjectedGaussians) -> Ellipse:
    """The terms that ``tile_rects`` and ``row_spans`` share, computed once:
    binning costs host time per launch on the card. A finite test is one
    comparison where the sign is known (τ² > −∞; NaN fails every comparison
    and survives ``maximum`` and ``minimum``, so two tests share one op);
    ``torch.isfinite`` launches four ops."""
    a, b, c = proj.conic.unbind(1)
    det = a * c - b * b
    tau2 = 2.0 * torch.log(torch.clamp(proj.opacity, min=1e-12) / ALPHA_EPS)
    det_c = torch.clamp(det, min=1e-24)
    ext = torch.sqrt(torch.clamp(tau2[:, None] * torch.stack([c, a], dim=1), min=0.0)
                     / det_c[:, None])
    rect_ok = (det > 1e-24) & (torch.maximum(det, tau2) < math.inf)
    ok = rect_ok & (torch.minimum(a, c) > 1e-24)
    return Ellipse(a, b, c, det, det_c, tau2, ext, rect_ok, ok)


def tile_rects(proj: ProjectedGaussians, *, tiles_x: int, tiles_y: int,
               ell: Ellipse = None):
    """Per-splat tile rect (x0, y0, x1, y1) and alive mask: the ellipse's
    alpha ≥ 1/255 extent per axis, with the 3σ radius as the outer clamp."""
    lo, hi, alive = _rects(proj, ellipse(proj) if ell is None else ell, tiles_x, tiles_y)
    x0, y0 = lo.unbind(1)
    x1, y1 = hi.unbind(1)
    return x0, y0, x1, y1, alive


def _rects(proj: ProjectedGaussians, ell: Ellipse, tiles_x: int, tiles_y: int):
    """``tile_rects`` as (lo, hi, alive), lo = (x0, y0) and hi = (x1, y1)
    (N, 2) int64: both axes in each op, with the same float32 roundings
    (the divisions are by powers of two)."""
    means2d, radii = proj.means2d, proj.radii
    size, grid, zero = means2d.new_tensor([[TILE_W, TILE_H], [tiles_x, tiles_y], [0, 0]])
    r = radii.to(torch.float32)[:, None]
    e = torch.where(ell.rect_ok[:, None], ell.ext, r)         # ≥ 0, +inf or NaN
    e = torch.minimum(torch.where(e < math.inf, e, r), r)
    edge = lambda v: torch.clamp(torch.floor(v), zero, grid).to(torch.int64)
    lo = edge((means2d - e) / size)
    hi = edge((means2d + e + size - 1) / size + 1)
    alive = (radii > 0) & (proj.opacity >= ALPHA_EPS)
    return lo, hi, alive


def row_spans(proj: ProjectedGaussians, ell: Ellipse, lo, hi, alive, *, side: int,
              tiles_x: int):
    """Per-(splat, tile-row) exact x-span of the α ≥ 1/255 ellipse inside the
    rect (``_rects``' lo, hi) clipped to its ``side``² window: (count,
    first), the row's pairs and its first tile, (N, side) int64 (first is
    meaningless where count is 0). Ported from ``_row_spans`` with the
    same float32 roundings: for tile row r with pixel-y strip dy ∈ [l, u],
    px − mx ∈ [dx⁻, dx⁺] with dx±(dy) = (−b·dy ± √D(dy))/a and
    D(dy) = (b² − ac)·dy² + a·τ²; dx⁺ is concave, so its strip maximum sits at
    dy* = −(b/c)·ex clamped into [l, u] (and −dx⁻'s at the mirrored point),
    plus a margin of ``SPAN_EPS_PX``. The two sides are evaluated together on
    a last axis of 2, with sign s = −1 for dx⁺ and +1 for −dx⁻ (a sign flip
    rounds nothing). A row whose D ≤ 0 is empty; a bad conic keeps its full
    rect row; a dead splat has no row."""
    col = lambda v: v.reshape(-1, 1, 1)
    good = ell.ok
    a_ = torch.where(good, ell.a, 1.0)
    c_ = torch.where(good, ell.c, 1.0)
    s = torch.linspace(-1.0, 1.0, 2, device=a_.device)        # exact -1, +1
    x0, y0 = lo.unbind(1)
    x1, y1 = hi.unbind(1)

    ry = y0[:, None] + torch.arange(side, device=a_.device)[None, :]
    in_rect = ry < y1[:, None]
    top = (ry * TILE_H).to(torch.float32) - proj.means2d[:, 1:2]
    dy = torch.clamp(s * col((ell.b / c_) * ell.ext[:, 0]), top[..., None],
                     (top + float(TILE_H - 1))[..., None])
    d_ = col(-ell.det) * dy * dy + col(a_ * ell.tau2)          # b² − ac = −det exactly
    ext = (s * col(ell.b) * dy + torch.sqrt(torch.clamp(d_, min=0.0))) / col(a_) + SPAN_EPS_PX
    edge = torch.floor((col(proj.means2d[:, 0]) - s * ext) / TILE_W).to(torch.int64)

    x_lo, x_hi = x0[:, None], torch.minimum(x1, x0 + side)[:, None]
    rx0 = torch.clamp(edge[..., 1], x_lo, x_hi)
    rx1 = torch.clamp(edge[..., 0] + 1, rx0, x_hi)                # x_lo ≤ rx0 ≤ x_hi
    row_ok = in_rect & ((d_ > 0.0).all(dim=-1) | ~good[:, None])
    w_full = torch.clamp(x1 - x0, 0, side)[:, None]
    count = torch.where(row_ok & alive[:, None], torch.where(good[:, None], rx1 - rx0, w_full), 0)
    first = ry * tiles_x + torch.where(good[:, None], rx0, x_lo)
    return count, first


def warp_extents(ell: Ellipse) -> torch.Tensor:
    """(N, 2) float32 half-widths (x, y) in pixels of each splat's warp box,
    centred on its mean: every pixel at which its α can reach 1/255 lies in
    the box. -1 where the conic is bad (the kernels then give the splat to
    every warp). The kernels compute the same box as they stage a splat
    (``csrc/splat_tile.cuh::warp_mask``); this twin is what the tests hold.

    The box is the bounding box of the α ≥ 1/255 ellipse, (ex, ey), not
    clamped by the 3σ radius (the compositor keeps the tail between 3σ and
    that contour in the tiles it covers), widened by ``SPAN_EPS_PX`` and by a
    rounding allowance: float32 evaluates the power's three terms before
    they cancel, which moves the α gate's contour by up to a few unit
    roundoffs × extent × κ, κ = (ac + |b|·√(ac)) / det (1 for a round splat,
    large for a long thin one); the box allows ``BOX_ROUND`` (64 unit
    roundoffs) × extent × κ."""
    ac = torch.clamp(ell.a * ell.c, min=0.0)
    kappa = (ac + ell.b.abs() * torch.sqrt(ac)) / ell.det_c
    ext = ell.ext + SPAN_EPS_PX + BOX_ROUND * ell.ext * kappa[:, None]   # ≥ 0, +inf or NaN
    return torch.where(ell.ok[:, None] & (ext < math.inf), ext, -1.0)


class TilePairs(NamedTuple):
    feats: torch.Tensor       # (N, 12) f32 per-splat features, splat order
    pair_splat: torch.Tensor  # (P,) int32 splat of each pair, (tile, depth)-sorted
    ranges: torch.Tensor      # (T+1,) int32 pair range of each tile
    n_clipped: torch.Tensor   # () int32 splats whose rect exceeded the window
    tiles_x: int
    tiles_y: int


def splat_features(proj: ProjectedGaussians) -> torch.Tensor:
    z = torch.zeros_like(proj.depth)
    return torch.stack([
        proj.means2d[:, 0], proj.means2d[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        proj.opacity, proj.rgb[:, 0], proj.rgb[:, 1], proj.rgb[:, 2],
        proj.depth, z, z], dim=1).to(torch.float32).contiguous()


def bin_pairs(proj: ProjectedGaussians, *, image_width: int, image_height: int,
              max_tiles_side: int = 6) -> TilePairs:
    """Duplicate-with-keys, sort and per-tile ranges (see module doc). Only
    ``feats`` carries autograd; the integer binning runs without it."""
    tiles_x, tiles_y = tile_grid(image_width, image_height)
    with torch.no_grad():
        binned = _bin(proj, ellipse(proj), tiles_x, tiles_y, max_tiles_side)
    return binned._replace(feats=splat_features(proj))


def _bin(proj, ell, tiles_x, tiles_y, side) -> TilePairs:
    num_tiles = tiles_x * tiles_y
    n = proj.means2d.shape[0]
    dev = proj.means2d.device
    lo, hi, alive = _rects(proj, ell, tiles_x, tiles_y)
    n_clipped = (alive & ((hi - lo) > side).any(dim=1)).sum().to(torch.int32)
    # entry e = splat·side + row: its pair count, its first tile, its pairs
    count, first_tile = (v.reshape(-1) for v in row_spans(proj, ell, lo, hi, alive, side=side,
                                                            tiles_x=tiles_x))
    total = int(count.sum())
    e = torch.repeat_interleave(torch.arange(n * side, device=dev), count, output_size=total)
    tile = ((first_tile - (torch.cumsum(count, 0) - count))[e]
            + torch.arange(total, device=dev))
    sid = torch.div(e, side, rounding_mode="floor")

    order = torch.argsort(proj.depth, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    key_sorted, perm = torch.sort(tile * n + rank[sid])
    bounds = torch.arange(num_tiles + 1, device=dev, dtype=torch.int64) * n
    ranges = torch.searchsorted(key_sorted, bounds)
    return TilePairs(feats=None,
                     pair_splat=sid[perm].to(torch.int32).contiguous(),
                     ranges=ranges.to(torch.int32).contiguous(),
                     n_clipped=n_clipped, tiles_x=tiles_x, tiles_y=tiles_y)


class Composite(NamedTuple):
    color: torch.Tensor       # (3,H,W) premultiplied
    depth: torch.Tensor       # (1,H,W) Σ depth·w
    alpha: torch.Tensor       # (1,H,W) Σ w
    final_logt: torch.Tensor  # (H,W) log T after the last contributing splat
    last_pair: torch.Tensor   # (H,W) int32 last contributing pair, -1 if none


def _untile(x: torch.Tensor, tiles_x: int, tiles_y: int, h: int, w: int) -> torch.Tensor:
    """(T, 512) -> (H, W); pixel p of a tile is (y = p // 16, x = p % 16)."""
    x = x.reshape(tiles_y, tiles_x, TILE_H, TILE_W).permute(0, 2, 1, 3)
    return x.reshape(tiles_y * TILE_H, tiles_x * TILE_W)[:h, :w]


def composite_tiles_plain(pairs: TilePairs, *, image_height: int,
                          image_width: int) -> Composite:
    """Plain-torch version of the CUDA kernel: a loop over the per-tile slot k,
    vectorised over (tiles × 512 pixels), with the kernel's math and gates.
    Tiles are visited in order of decreasing pair count, so the tiles still
    active at slot k are a prefix and every step works on views."""
    feats, ranges = pairs.feats, pairs.ranges.to(torch.int64)
    dev = feats.device
    tx, ty = pairs.tiles_x, pairs.tiles_y
    counts = ranges[1:] - ranges[:-1]
    tile_order = torch.argsort(counts, descending=True, stable=True)
    starts = ranges[:-1][tile_order]
    counts_host = counts[tile_order].tolist()

    p = torch.arange(PIX, device=dev)
    pxi = (tile_order % tx)[:, None] * TILE_W + (p % TILE_W)[None, :]
    pyi = (tile_order // tx)[:, None] * TILE_H + (p // TILE_W)[None, :]
    px, py = pxi.to(torch.float32), pyi.to(torch.float32)

    nt = tx * ty
    zeros = torch.zeros((nt, PIX), dtype=torch.float32, device=dev)
    log_t, trans = zeros.clone(), torch.ones_like(zeros)
    acc = [zeros.clone() for _ in range(5)]              # r, g, b, depth, alpha
    last = torch.full((nt, PIX), -1, dtype=torch.int64, device=dev)
    done = (pxi >= image_width) | (pyi >= image_height)

    m = nt
    for k in range(counts_host[0] if counts_host else 0):
        while counts_host[m - 1] <= k:
            m -= 1
        pid = starts[:m] + k
        f = feats[pairs.pair_splat[pid].to(torch.int64)]      # (m, 12)
        col = lambda i: f[:, i:i + 1]
        dx = col(0) - px[:m]
        dy = col(1) - py[:m]
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        al = torch.clamp(col(5) * torch.exp(power), max=ALPHA_MAX)
        use = ~done[:m] & (power <= 0.0) & (al >= ALPHA_EPS)
        wgt = torch.where(use, al * trans[:m], zeros[:m])
        for a, i in zip(acc, (6, 7, 8, 9)):
            a[:m] += col(i) * wgt
        acc[4][:m] += wgt
        log_t[:m] = torch.where(use, log_t[:m] + torch.log1p(-al), log_t[:m])
        trans[:m] = torch.where(use, torch.exp(log_t[:m]), trans[:m])
        last[:m] = torch.where(use, pid[:, None], last[:m])
        done[:m] |= use & (trans[:m] < T_EPS)

    def image(x):
        full = torch.empty_like(x)
        full[tile_order] = x
        return _untile(full, tx, ty, image_height, image_width)

    return Composite(
        color=torch.stack([image(a) for a in acc[:3]]),
        depth=image(acc[3])[None], alpha=image(acc[4])[None],
        final_logt=image(log_t), last_pair=image(last).to(torch.int32))


def _tile_pixels(x: torch.Tensor, tiles_x: int, tiles_y: int, fill) -> torch.Tensor:
    """(H, W) -> (T, 512), padded with ``fill``: the inverse of ``_untile``."""
    h, w = x.shape
    full = x.new_full((tiles_y * TILE_H, tiles_x * TILE_W), fill)
    full[:h, :w] = x
    full = full.reshape(tiles_y, TILE_H, tiles_x, TILE_W).permute(0, 2, 1, 3)
    return full.reshape(tiles_x * tiles_y, PIX)


def composite_tiles_backward_plain(pairs: TilePairs, final_logt: torch.Tensor,
                                   last_pair: torch.Tensor, g_color: torch.Tensor,
                                   g_depth: torch.Tensor, g_alpha: torch.Tensor, *,
                                   image_height: int, image_width: int) -> torch.Tensor:
    """Plain-torch version of ``csrc/composite_bwd.cu``: (N, 12) gradients of
    the splat features (columns 10 and 11 stay zero).

    A loop over the per-tile slot k from the back, vectorised over (tiles ×
    512 pixels), with the kernel's math and gates; each step's per-pair sums
    over pixels go into the splats with ``index_add_``. A tile walks from the
    deepest ``last_pair`` of its pixels, and tiles are visited in order of
    decreasing walk length, so the tiles still active at slot k are a prefix."""
    feats, ranges = pairs.feats, pairs.ranges.to(torch.int64)
    dev = feats.device
    tx, ty = pairs.tiles_x, pairs.tiles_y
    tiled = lambda x, fill=0.0: _tile_pixels(x, tx, ty, fill)
    last = tiled(last_pair.to(torch.int64), -1)
    starts = ranges[:-1]
    walk = torch.clamp(last.max(dim=1).values - starts + 1, min=0)
    order = torch.argsort(walk, descending=True, stable=True)
    walk_host = walk[order].tolist()
    starts, last = starts[order], last[order]
    log_t = tiled(final_logt)[order]
    gr, gg, gb = (tiled(g_color[c])[order] for c in range(3))
    gd = tiled(g_depth[0])[order]
    ga = tiled(g_alpha[0])[order]

    p = torch.arange(PIX, device=dev)
    px = ((order % tx)[:, None] * TILE_W + (p % TILE_W)[None, :]).to(torch.float32)
    py = ((order // tx)[:, None] * TILE_H + (p // TILE_W)[None, :]).to(torch.float32)
    suffix = torch.zeros_like(log_t)
    d_feats = torch.zeros_like(feats)

    m = 0
    for k in reversed(range(walk_host[0] if walk_host else 0)):
        while m < len(walk_host) and walk_host[m] > k:
            m += 1
        pid = starts[:m] + k
        splat = pairs.pair_splat[pid].to(torch.int64)
        f = feats[splat]
        col = lambda i: f[:, i:i + 1]
        dx = col(0) - px[:m]
        dy = col(1) - py[:m]
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        ep = torch.exp(torch.clamp(power, max=0.0))
        raw = col(5) * ep
        al = torch.clamp(raw, max=ALPHA_MAX)
        use = (pid[:, None] <= last[:m]) & (power <= 0.0) & (al >= ALPHA_EPS)
        log_before = log_t[:m] - torch.log1p(-al)
        trans = torch.exp(log_before)
        g = gr[:m] * col(6) + gg[:m] * col(7) + gb[:m] * col(8) + gd[:m] * col(9) + ga[:m]
        w = al * trans
        d_alpha = trans * g - suffix[:m] / (1.0 - al)
        suffix[:m] = torch.where(use, suffix[:m] + g * w, suffix[:m])
        log_t[:m] = torch.where(use, log_before, log_t[:m])
        d_al = torch.where(raw > ALPHA_MAX, torch.zeros_like(d_alpha), d_alpha)
        d_pow = d_al * al
        vals = torch.stack([
            -d_pow * (col(2) * dx + col(3) * dy), -d_pow * (col(4) * dy + col(3) * dx),
            -0.5 * d_pow * dx * dx, -d_pow * dx * dy, -0.5 * d_pow * dy * dy,
            d_al * ep, gr[:m] * w, gg[:m] * w, gb[:m] * w, gd[:m] * w], dim=-1)
        vals = torch.where(use[..., None], vals, torch.zeros_like(vals)).sum(dim=1)
        d_feats[:, :10].index_add_(0, splat, vals)
    return d_feats


# ---------------------------------------------------------------------------
# the CUDA kernels: launch (build and load in ``ops/cuda.py``)
# ---------------------------------------------------------------------------

def check_pairs(pairs: TilePairs) -> torch.device:
    """Raise unless ``pairs`` is what the kernels over the pair table take
    (this module's and the probes'); returns its card."""
    feats = pairs.feats
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take cuda tensors, got {dev}")
    check_tensor(feats, "feats", torch.float32, dev)
    check_tensor(pairs.pair_splat, "pair_splat", torch.int32, dev)
    check_tensor(pairs.ranges, "ranges", torch.int32, dev, (pairs.tiles_x * pairs.tiles_y + 1,))
    if feats.ndim != 2 or feats.shape[1] != FEAT_DIM:
        raise ValueError(f"feats must be (N, {FEAT_DIM}), got {tuple(feats.shape)}")
    return dev


def composite_tiles_cuda(pairs: TilePairs, *, image_height: int,
                         image_width: int) -> Composite:
    """Launch ``csrc/composite_fwd.cu``. Raises if it cannot be built or launched."""
    dev = check_pairs(pairs)
    h, w = image_height, image_width
    color = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    depth = torch.empty((1, h, w), dtype=torch.float32, device=dev)
    alpha = torch.empty((1, h, w), dtype=torch.float32, device=dev)
    final_logt = torch.empty((h, w), dtype=torch.float32, device=dev)
    last_pair = torch.empty((h, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        launch("composite_fwd", "gg_composite_fwd",
               pairs.feats.data_ptr(), pairs.pair_splat.data_ptr(), pairs.ranges.data_ptr(),
               pairs.tiles_x * pairs.tiles_y, pairs.tiles_x, w, h, color.data_ptr(),
               depth.data_ptr(), alpha.data_ptr(), final_logt.data_ptr(), last_pair.data_ptr(),
               stream(dev))
    composite_tiles_cuda.launches += 1
    return Composite(color, depth, alpha, final_logt, last_pair)


composite_tiles_cuda.launches = 0


def composite_tiles_backward_cuda(pairs: TilePairs, final_logt: torch.Tensor,
                                  last_pair: torch.Tensor, g_color: torch.Tensor,
                                  g_depth: torch.Tensor, g_alpha: torch.Tensor, *,
                                  image_height: int, image_width: int) -> torch.Tensor:
    """Launch ``csrc/composite_bwd.cu``: (N, 12) feature gradients. Raises if
    it cannot be built or launched."""
    dev = check_pairs(pairs)
    h, w = image_height, image_width
    check_tensor(final_logt, "final_logt", torch.float32, dev, (h, w))
    check_tensor(last_pair, "last_pair", torch.int32, dev, (h, w))
    check_tensor(g_color, "g_color", torch.float32, dev, (3, h, w))
    check_tensor(g_depth, "g_depth", torch.float32, dev, (1, h, w))
    check_tensor(g_alpha, "g_alpha", torch.float32, dev, (1, h, w))
    d_feats = torch.zeros_like(pairs.feats)
    with torch.cuda.device(dev):
        launch("composite_bwd", "gg_composite_bwd",
               pairs.feats.data_ptr(), pairs.pair_splat.data_ptr(), pairs.ranges.data_ptr(),
               final_logt.data_ptr(), last_pair.data_ptr(), g_color.data_ptr(),
               g_depth.data_ptr(), g_alpha.data_ptr(), pairs.tiles_x * pairs.tiles_y,
               pairs.tiles_x, w, h, d_feats.data_ptr(), stream(dev))
    composite_tiles_backward_cuda.launches += 1
    return d_feats


composite_tiles_backward_cuda.launches = 0


class _Composite(torch.autograd.Function):
    """The compositor as an autograd node: forward and backward each run the
    CUDA kernel for CUDA tensors and the plain version for CPU tensors. There
    is no fallback between the two."""

    @staticmethod
    def forward(ctx, feats, pairs, h, w):
        pairs = pairs._replace(feats=feats)
        fwd = route(feats.device, composite_tiles_cuda, composite_tiles_plain)
        out = fwd(pairs, image_height=h, image_width=w)
        ctx.save_for_backward(feats, pairs.pair_splat, pairs.ranges, out.final_logt,
                              out.last_pair)
        ctx.grid = (pairs.tiles_x, pairs.tiles_y, h, w)
        ctx.mark_non_differentiable(out.final_logt, out.last_pair)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_color, g_depth, g_alpha, _g_logt, _g_last):
        feats, pair_splat, ranges, final_logt, last_pair = ctx.saved_tensors
        tx, ty, h, w = ctx.grid
        pairs = TilePairs(feats.detach(), pair_splat, ranges, None, tx, ty)
        bwd = route(feats.device, composite_tiles_backward_cuda,
                     composite_tiles_backward_plain)
        d_feats = bwd(pairs, final_logt, last_pair, g_color.contiguous(),
                      g_depth.contiguous(), g_alpha.contiguous(), image_height=h,
                      image_width=w)
        return d_feats, None, None, None


def composite_tiles(pairs: TilePairs, *, image_height: int, image_width: int) -> Composite:
    """Composite the binned pairs, differentiably with respect to ``feats``."""
    return Composite(*_Composite.apply(pairs.feats, pairs, image_height, image_width))


def rasterize_tiles(proj: ProjectedGaussians, *, image_height: int, image_width: int,
                    bg: torch.Tensor, max_tiles_side: int = 6):
    """Bin + composite. Returns (image (3,H,W), depth (1,H,W), alpha (1,H,W),
    aux) with aux = {n_clipped, n_overflow (always 0)}. The background blend
    is plain torch, so autograd folds it into the alpha cotangent."""
    pairs = bin_pairs(proj, image_width=image_width, image_height=image_height,
                      max_tiles_side=max_tiles_side)
    out = composite_tiles(pairs, image_height=image_height, image_width=image_width)
    image = out.color + (1.0 - out.alpha) * bg[:, None, None]
    aux = {"n_clipped": pairs.n_clipped,
           "n_overflow": torch.zeros((), dtype=torch.int32, device=bg.device)}
    return image, out.depth, out.alpha, aux
