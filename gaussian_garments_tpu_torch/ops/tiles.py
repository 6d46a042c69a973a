"""Tile binning and the splat compositor, forward and backward.

Port of ``gaussian_garments_tpu/ops/pallas_tiles.py``:

- ``tile_rects``: the opacity-aware per-axis splat rect and the ``alive``
  rule, ported exactly from ``_tile_rects``;
- ``bin_pairs``: CUDA-style binning as torch ops. Each splat emits the tiles
  of its rect clipped to a ``max_tiles_side``² window anchored at the rect's
  top-left; an exclusive scan of the per-splat counts places the pairs, each
  pair gets the int64 key ``tile·N + depth_rank`` (rank from a stable argsort
  of depth), ``torch.sort`` orders them and a search gives per-tile ranges.
  Pairs are allocated exactly from the counts, so nothing overflows
  (``n_overflow`` is always 0);
- ``composite_tiles``: the compositor, one ``torch.autograd.Function``. Its
  forward runs the hand-written kernel ``csrc/composite_fwd.cu`` for CUDA
  tensors and ``composite_tiles_plain``, the same math in plain torch, for
  CPU tensors; its backward likewise runs ``csrc/composite_bwd.cu`` or
  ``composite_tiles_backward_plain``. Both kernels are built with nvcc at
  first use and loaded with ctypes.

Tiles are 16 wide × 32 tall, as in the JAX package. The row-exact span culling
of the JAX package (``_row_spans``) is not ported: it removes only pairs whose
contribution is exactly zero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from gaussian_garments_tpu_torch.ops.projection import ProjectedGaussians
from gaussian_garments_tpu_torch.ops.rasterizer_ref import ALPHA_EPS, ALPHA_MAX, T_EPS

TILE_W = 16
TILE_H = 32
PIX = TILE_W * TILE_H
FEAT_DIM = 12       # [mx, my, ca, cb, cc, opacity, r, g, b, depth, 0, 0]


def tile_grid(image_width: int, image_height: int):
    return -(-image_width // TILE_W), -(-image_height // TILE_H)


def tile_rects(proj: ProjectedGaussians, *, tiles_x: int, tiles_y: int):
    """Per-splat tile rect (x0, y0, x1, y1) and alive mask: the ellipse's
    alpha ≥ 1/255 extent per axis, with the 3σ radius as the outer clamp."""
    means2d, radii = proj.means2d, proj.radii
    r = radii.to(torch.float32)
    ca, cb, cc = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
    det = ca * cc - cb * cb
    tau2 = 2.0 * torch.log(torch.clamp(proj.opacity, min=1e-12) / ALPHA_EPS)
    good = torch.isfinite(det) & (det > 1e-24) & torch.isfinite(tau2)
    det_c = torch.clamp(det, min=1e-24)
    ex = torch.where(good, torch.sqrt(torch.clamp(tau2 * cc, min=0.0) / det_c), r)
    ey = torch.where(good, torch.sqrt(torch.clamp(tau2 * ca, min=0.0) / det_c), r)
    ex = torch.minimum(torch.where(torch.isfinite(ex), ex, r), r)
    ey = torch.minimum(torch.where(torch.isfinite(ey), ey, r), r)

    def edge(v, n):
        return torch.clamp(torch.floor(v), 0, n).to(torch.int64)

    x0 = edge((means2d[:, 0] - ex) / TILE_W, tiles_x)
    y0 = edge((means2d[:, 1] - ey) / TILE_H, tiles_y)
    x1 = edge((means2d[:, 0] + ex + TILE_W - 1) / TILE_W + 1, tiles_x)
    y1 = edge((means2d[:, 1] + ey + TILE_H - 1) / TILE_H + 1, tiles_y)
    alive = (radii > 0) & (proj.opacity >= ALPHA_EPS)
    return x0, y0, x1, y1, alive


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
    feats = splat_features(proj)
    with torch.no_grad():
        return _bin(proj, feats, tiles_x, tiles_y, max_tiles_side)


def _bin(proj, feats, tiles_x, tiles_y, side) -> TilePairs:
    num_tiles = tiles_x * tiles_y
    n = proj.means2d.shape[0]
    dev = proj.means2d.device
    x0, y0, x1, y1, alive = tile_rects(proj, tiles_x=tiles_x, tiles_y=tiles_y)
    n_clipped = (alive & (((x1 - x0) > side) | ((y1 - y0) > side))).sum().to(torch.int32)
    w = torch.clamp(x1 - x0, 0, side)
    h = torch.clamp(y1 - y0, 0, side)
    count = torch.where(alive, w * h, torch.zeros_like(w))
    total = int(count.sum())

    sid = torch.repeat_interleave(torch.arange(n, device=dev), count, output_size=total)
    first = torch.cumsum(count, 0) - count
    j = torch.arange(total, device=dev) - first[sid]
    wj = w[sid]
    jy = torch.div(j, wj, rounding_mode="floor")
    tile = (y0[sid] + jy) * tiles_x + x0[sid] + (j - jy * wj)

    order = torch.argsort(proj.depth, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    key_sorted, perm = torch.sort(tile * n + rank[sid])
    bounds = torch.arange(num_tiles + 1, device=dev, dtype=torch.int64) * n
    ranges = torch.searchsorted(key_sorted, bounds)
    return TilePairs(feats=feats,
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
# the CUDA kernels: build, load, launch
# ---------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parent.parent
KERNEL_SOURCES = {"composite_fwd": _PKG / "csrc" / "composite_fwd.cu",
                  "composite_bwd": _PKG / "csrc" / "composite_bwd.cu"}
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_libs = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the compositor kernels are built from "
                       f"{_PKG / 'csrc'} with the CUDA toolkit at first use")


def kernel_library_path(name: str) -> Path:
    source = KERNEL_SOURCES[name]
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgg_{name}_{digest.hexdigest()[:16]}.so"


def build_kernel(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` into ``build/`` unless a library of the same
    source and flags is there. Returns {path, seconds, ptxas}."""
    so = kernel_library_path(name)
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "ptxas": "cached"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCES[name])],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {KERNEL_SOURCES[name]}:\n{res.stderr}")
    os.replace(tmp, so)
    return {"path": str(so), "seconds": time.perf_counter() - t0, "ptxas": res.stderr.strip()}


def build_kernels() -> dict:
    """Build every kernel, one nvcc per source, all started together.
    Returns {name: build_kernel(name)}; raises if any build fails."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        futures = {name: pool.submit(build_kernel, name) for name in KERNEL_SOURCES}
        return {name: f.result() for name, f in futures.items()}


def _library(name: str):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_kernel(name)["path"])
            if name == "composite_fwd":
                lib.gg_composite_fwd.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp,
                                                 vp, vp]
                lib.gg_composite_fwd.restype = ci
            else:
                lib.gg_composite_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                                 ci, vp, vp]
                lib.gg_composite_bwd.restype = ci
            lib.gg_cuda_error_string.argtypes = [ci]
            lib.gg_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def _check(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_pairs(pairs: TilePairs) -> torch.device:
    feats = pairs.feats
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA compositor takes cuda tensors, got {dev}")
    _check(feats, "feats", torch.float32, dev)
    _check(pairs.pair_splat, "pair_splat", torch.int32, dev)
    _check(pairs.ranges, "ranges", torch.int32, dev,
           (pairs.tiles_x * pairs.tiles_y + 1,))
    if feats.ndim != 2 or feats.shape[1] != FEAT_DIM:
        raise ValueError(f"feats must be (N, {FEAT_DIM}), got {tuple(feats.shape)}")
    return dev


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: " + lib.gg_cuda_error_string(err).decode())


def composite_tiles_cuda(pairs: TilePairs, *, image_height: int,
                         image_width: int) -> Composite:
    """Launch ``csrc/composite_fwd.cu``. Raises if it cannot be built or launched."""
    dev = _check_pairs(pairs)
    lib = _library("composite_fwd")
    h, w = image_height, image_width
    color = torch.empty((3, h, w), dtype=torch.float32, device=dev)
    depth = torch.empty((1, h, w), dtype=torch.float32, device=dev)
    alpha = torch.empty((1, h, w), dtype=torch.float32, device=dev)
    final_logt = torch.empty((h, w), dtype=torch.float32, device=dev)
    last_pair = torch.empty((h, w), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gg_composite_fwd(
            pairs.feats.data_ptr(), pairs.pair_splat.data_ptr(), pairs.ranges.data_ptr(),
            pairs.tiles_x * pairs.tiles_y, pairs.tiles_x, w, h, color.data_ptr(),
            depth.data_ptr(), alpha.data_ptr(), final_logt.data_ptr(), last_pair.data_ptr(),
            stream)
    _raise_on(lib, err, "composite_fwd")
    composite_tiles_cuda.launches += 1
    return Composite(color, depth, alpha, final_logt, last_pair)


composite_tiles_cuda.launches = 0


def composite_tiles_backward_cuda(pairs: TilePairs, final_logt: torch.Tensor,
                                  last_pair: torch.Tensor, g_color: torch.Tensor,
                                  g_depth: torch.Tensor, g_alpha: torch.Tensor, *,
                                  image_height: int, image_width: int) -> torch.Tensor:
    """Launch ``csrc/composite_bwd.cu``: (N, 12) feature gradients. Raises if
    it cannot be built or launched."""
    dev = _check_pairs(pairs)
    h, w = image_height, image_width
    _check(final_logt, "final_logt", torch.float32, dev, (h, w))
    _check(last_pair, "last_pair", torch.int32, dev, (h, w))
    _check(g_color, "g_color", torch.float32, dev, (3, h, w))
    _check(g_depth, "g_depth", torch.float32, dev, (1, h, w))
    _check(g_alpha, "g_alpha", torch.float32, dev, (1, h, w))
    lib = _library("composite_bwd")
    d_feats = torch.zeros_like(pairs.feats)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gg_composite_bwd(
            pairs.feats.data_ptr(), pairs.pair_splat.data_ptr(), pairs.ranges.data_ptr(),
            final_logt.data_ptr(), last_pair.data_ptr(), g_color.data_ptr(),
            g_depth.data_ptr(), g_alpha.data_ptr(), pairs.tiles_x * pairs.tiles_y,
            pairs.tiles_x, w, h, d_feats.data_ptr(), stream)
    _raise_on(lib, err, "composite_bwd")
    composite_tiles_backward_cuda.launches += 1
    return d_feats


composite_tiles_backward_cuda.launches = 0


def _route(dev: torch.device, cuda_fn, plain_fn):
    if dev.type == "cuda":
        return cuda_fn
    if dev.type == "cpu":
        return plain_fn
    raise RuntimeError(f"no compositor for device {dev}")


class _Composite(torch.autograd.Function):
    """The compositor as an autograd node: forward and backward each run the
    CUDA kernel for CUDA tensors and the plain version for CPU tensors. There
    is no fallback between the two."""

    @staticmethod
    def forward(ctx, feats, pairs, h, w):
        pairs = pairs._replace(feats=feats)
        fwd = _route(feats.device, composite_tiles_cuda, composite_tiles_plain)
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
        bwd = _route(feats.device, composite_tiles_backward_cuda,
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
