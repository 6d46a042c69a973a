"""Forward-compositor cost split on the card: the full kernel against a null
body and an elementwise body.

Counterpart of the TPU probe ``scripts/profile_kernel_null.py`` at its scene
(``bench.py``: 150K splats, 1920×1080, through the port's projection and
``bin_pairs``). Three rows:

- ``full``: ``csrc/composite_fwd.cu`` as it is;
- ``null``: the same launch shape and shared-memory staging of every batch of
  splats (all 12 features; the full kernel stages 10 and a warp mask), no
  per-pixel work; it writes the tile's empty outputs and
  one float64 checksum per tile (the sum of the staged features);
- ``alpha_only``: the forward's per-warp walk with its gates but no colour,
  depth, transmittance or early stop; it writes Σα and Σlog1p(−α) per pixel
  (the counterpart of ``nomxu_kernel``). Like the forward, a warp of 8×4
  pixels walks only the splats whose warp box reaches it (``warp_hits``), and
  each pixel sums the same terms in the same order as a walk over every pair
  of its tile.

    python -m gaussian_garments_tpu_torch.probes.composite_null [--device cuda] [--reps 20]

Each row prints its ms, its share of ``full`` and its bound. ``alpha_only``'s
bound counts the terms its function sums (``gated_terms``: every pair and
pixel that passes the gates), one special-function evaluation each; the
bound of every pair of a tile at each of its pixels (what a walk without the
warp cull evaluates) is printed beside it.
"""
from __future__ import annotations

import argparse
import sys
import types
from typing import List, Optional, Sequence

import torch

from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.ops.cuda import launch, route, stream
from gaussian_garments_tpu_torch.ops.rasterizer_ref import ALPHA_EPS, ALPHA_MAX
from gaussian_garments_tpu_torch.probes.common import Entry, max_abs, report

WARP_W, WARP_H = 8, 4  # a warp's sub-tile of pixels (csrc/splat_tile.cuh)

REPLACES = {"null": "scripts/profile_kernel_null.py:81",
            "alpha_only": "scripts/profile_kernel_null.py:93",
            "full": "gaussian_garments_tpu/ops/pallas_tiles.py:666"}


def _tile_of_pair(ranges: torch.Tensor) -> torch.Tensor:
    counts = (ranges[1:] - ranges[:-1]).long()
    return torch.repeat_interleave(torch.arange(len(counts), device=ranges.device), counts,
                                   output_size=int(ranges[-1]))


def pair_feature_sums(pairs: tiles.TilePairs) -> torch.Tensor:
    """(P,) float64 sum of each pair's 12 features."""
    return pairs.feats.double().sum(1)[pairs.pair_splat.long()]


def probe_null_plain(pairs: tiles.TilePairs, *, image_height: int, image_width: int):
    """(empty Composite, (T,) float64 per-tile sum of the staged features)."""
    dev = pairs.feats.device
    h, w = image_height, image_width
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    out = tiles.Composite(color=z(3, h, w), depth=z(1, h, w), alpha=z(1, h, w),
                          final_logt=z(h, w),
                          last_pair=torch.full((h, w), -1, dtype=torch.int32, device=dev))
    t = pairs.ranges.numel() - 1
    checksum = torch.zeros(t, dtype=torch.float64, device=dev).index_add_(
        0, _tile_of_pair(pairs.ranges), pair_feature_sums(pairs))
    return out, checksum


def probe_null_cuda(pairs: tiles.TilePairs, *, image_height: int, image_width: int):
    """Launch ``probe_null`` (``csrc/probe_composite.cu``)."""
    dev = tiles.check_pairs(pairs)
    h, w = image_height, image_width
    e = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device=dev)
    out = tiles.Composite(color=e(3, h, w), depth=e(1, h, w), alpha=e(1, h, w),
                          final_logt=e(h, w), last_pair=e(h, w, dtype=torch.int32))
    num_tiles = pairs.tiles_x * pairs.tiles_y
    checksum = e(num_tiles, dtype=torch.float64)
    with torch.cuda.device(dev):
        launch("probe_composite", "gg_probe_null", pairs.feats.data_ptr(),
               pairs.pair_splat.data_ptr(), pairs.ranges.data_ptr(), num_tiles, pairs.tiles_x,
               w, h, out.color.data_ptr(), out.depth.data_ptr(), out.alpha.data_ptr(),
               out.final_logt.data_ptr(), out.last_pair.data_ptr(), checksum.data_ptr(),
               stream(dev))
    probe_null_cuda.launches += 1
    return out, checksum


probe_null_cuda.launches = 0


def probe_null(pairs: tiles.TilePairs, *, image_height: int, image_width: int):
    """The null body: the kernel for CUDA tensors, the plain version for CPU."""
    return route(pairs.feats.device, probe_null_cuda, probe_null_plain)(
        pairs, image_height=image_height, image_width=image_width)


def warp_boxes(pairs: tiles.TilePairs) -> torch.Tensor:
    """(N, 2) warp-box half-widths of each splat, from its features as the
    kernels stage them (``tiles.warp_extents``); -1 for a bad conic."""
    f = pairs.feats
    return tiles.warp_extents(tiles.ellipse(types.SimpleNamespace(conic=f[:, 2:5],
                                                                  opacity=f[:, 5])))


def warp_hits(means: torch.Tensor, box: torch.Tensor, ox: torch.Tensor,
              oy: torch.Tensor) -> torch.Tensor:
    """(M, 16) bool: whether warp w = 2·row + column of the tile whose top-left
    pixel is (ox, oy) holds a pixel of the warp box of half-widths ``box``
    (M, 2) centred on ``means`` (M, 2), as ``csrc/splat_tile.cuh::warp_mask``
    decides; every warp where the box is -1 (a bad conic)."""
    dev = means.device
    x0 = ox[:, None] + WARP_W * torch.arange(2, device=dev)
    y0 = oy[:, None] + WARP_H * torch.arange(8, device=dev)
    mx, my, ex, ey = means[:, 0:1], means[:, 1:2], box[:, 0:1], box[:, 1:2]
    cols = (mx - ex <= (x0 + WARP_W - 1).float()) & (mx + ex >= x0.float())
    rows = (my - ey <= (y0 + WARP_H - 1).float()) & (my + ey >= y0.float())
    bad = ~((ex >= 0) & (ey >= 0))
    return (rows[:, :, None] & cols[:, None, :]).reshape(-1, 16) | bad


def _gated(pairs: tiles.TilePairs, warp_cull: bool):
    """The walk that the plain versions share: a loop over the per-tile slot
    k, vectorised over (tiles × 512 pixels, row-major in the tile), tiles in
    order of decreasing pair count. Yields (order, m, al, use, px, py) per
    slot: the first m tiles of ``order`` hold a k-th pair; ``use`` (m, 512)
    is where it passes the gates (and, with ``warp_cull``, where its warp box
    reaches the pixel's warp of 8×4 pixels)."""
    feats, ranges = pairs.feats, pairs.ranges.to(torch.int64)
    dev = feats.device
    tx, ty = pairs.tiles_x, pairs.tiles_y
    counts = ranges[1:] - ranges[:-1]
    order = torch.argsort(counts, descending=True, stable=True)
    starts = ranges[:-1][order]
    counts_host = counts[order].tolist()
    p = torch.arange(tiles.PIX, device=dev)
    ox, oy = (order % tx) * tiles.TILE_W, (order // tx) * tiles.TILE_H
    px = (ox[:, None] + (p % tiles.TILE_W)[None, :]).to(torch.float32)
    py = (oy[:, None] + (p // tiles.TILE_W)[None, :]).to(torch.float32)
    warp_of_pixel = (p // tiles.TILE_W // WARP_H) * 2 + (p % tiles.TILE_W) // WARP_W
    box = warp_boxes(pairs) if warp_cull else None
    m = tx * ty
    for k in range(counts_host[0] if counts_host else 0):
        while counts_host[m - 1] <= k:
            m -= 1
        splat = pairs.pair_splat[starts[:m] + k].to(torch.int64)
        f = feats[splat]
        col = lambda i: f[:, i:i + 1]
        dx = col(0) - px[:m]
        dy = col(1) - py[:m]
        power = -0.5 * (col(2) * dx * dx + col(4) * dy * dy) - col(3) * dx * dy
        al = torch.clamp(col(5) * torch.exp(power), max=ALPHA_MAX)
        use = (power <= 0.0) & (al >= ALPHA_EPS)
        if box is not None:
            use &= warp_hits(f[:, :2], box[splat], ox[:m], oy[:m])[:, warp_of_pixel]
        yield order, m, al, use, px[:m], py[:m]


def alpha_only_plain(pairs: tiles.TilePairs, *, image_height: int, image_width: int,
                     warp_cull: bool = False) -> torch.Tensor:
    """(2, H, W): Σα and Σlog1p(−α) over every pair of the pixel's tile that
    passes the forward's gates, summed in pair order like the kernel.
    ``warp_cull`` skips, as the kernel does, the pairs whose warp box misses
    the pixel's warp: the sums stay the same, bit for bit, since every
    skipped pair fails the gates there."""
    tx, ty = pairs.tiles_x, pairs.tiles_y
    sum_alpha = torch.zeros((tx * ty, tiles.PIX), dtype=torch.float32,
                            device=pairs.feats.device)
    sum_log = torch.zeros_like(sum_alpha)
    order = None
    for order, m, al, use, _, _ in _gated(pairs, warp_cull):
        sum_alpha[:m] += torch.where(use, al, torch.zeros_like(al))
        sum_log[:m] += torch.where(use, torch.log1p(-al), torch.zeros_like(al))

    def image(x):
        full = torch.empty_like(x)
        full[order] = x
        return tiles._untile(full, tx, ty, image_height, image_width)

    if order is None:
        return sum_alpha.new_zeros((2, image_height, image_width))
    return torch.stack([image(sum_alpha), image(sum_log)])


def gated_terms(pairs: tiles.TilePairs, h: int, w: int) -> int:
    """The terms that ``alpha_only`` sums: (pair, pixel inside the image) of
    its tile that pass the gates (power ≤ 0, α ≥ 1/255). They need one
    special-function evaluation each, and do not depend on how the kernel
    walks."""
    total = 0
    for _, _, _, use, px, py in _gated(pairs, False):
        total += int((use & (px < w) & (py < h)).sum())
    return total


def alpha_only_cuda(pairs: tiles.TilePairs, *, image_height: int,
                    image_width: int) -> torch.Tensor:
    """Launch ``probe_alpha_only`` (``csrc/probe_composite.cu``)."""
    dev = tiles.check_pairs(pairs)
    out = torch.empty((2, image_height, image_width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch("probe_composite", "gg_probe_alpha_only", pairs.feats.data_ptr(),
               pairs.pair_splat.data_ptr(), pairs.ranges.data_ptr(),
               pairs.tiles_x * pairs.tiles_y, pairs.tiles_x, image_width, image_height,
               out.data_ptr(), stream(dev))
    alpha_only_cuda.launches += 1
    return out


alpha_only_cuda.launches = 0


# kernel name -> the wrapper that counts its launches
WRAPPERS = {"probe_null": probe_null_cuda, "probe_alpha_only": alpha_only_cuda}


def alpha_only(pairs: tiles.TilePairs, *, image_height: int, image_width: int) -> torch.Tensor:
    """The elementwise body: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    return route(pairs.feats.device, alpha_only_cuda, alpha_only_plain)(
        pairs, image_height=image_height, image_width=image_width)


def inside_pixels(pairs: tiles.TilePairs, h: int, w: int) -> torch.Tensor:
    """(T,) pixels of each tile that lie inside the image."""
    t = torch.arange(pairs.tiles_x * pairs.tiles_y, device=pairs.feats.device)
    iw = torch.clamp(w - (t % pairs.tiles_x) * tiles.TILE_W, 0, tiles.TILE_W)
    ih = torch.clamp(h - (t // pairs.tiles_x) * tiles.TILE_H, 0, tiles.TILE_H)
    return iw * ih


def _compare_null(got, want):
    (ko, kc), (po, pc) = got, want
    same = all(torch.equal(a, b) for a, b in zip(ko, po))
    err = max_abs(kc, pc)
    scale = float(pc.abs().max()) if pc.numel() else 0.0
    return err, same and err <= 1e-6 * max(scale, 1e-30)


def _compare_alpha(got, want):
    ok, err = True, 0.0
    for c in range(2):
        e = max_abs(got[c], want[c])
        err = max(err, e)
        ok &= e <= 1e-5 * float(want[c].abs().max())
    return err, ok


def warp_lanes(pairs: tiles.TilePairs) -> int:
    """Lane evaluations of the per-warp walk before any early stop: 32 for
    each (pair, warp of its tile that the pair's warp box reaches)."""
    counts = (pairs.ranges[1:] - pairs.ranges[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(counts.numel(), device=counts.device), counts)
    splat = pairs.pair_splat.long()
    hit = warp_hits(pairs.feats[splat, :2], warp_boxes(pairs)[splat],
                    (tile % pairs.tiles_x) * tiles.TILE_W, (tile // pairs.tiles_x) * tiles.TILE_H)
    return 32 * int(hit.sum())


def entries(pairs: tiles.TilePairs, h: int, w: int) -> List[Entry]:
    """The two probe rows at the scene of ``pairs``. ``alpha_only``'s bound
    counts its gate-passing terms; its walked bound, every pair of a tile at
    each of its pixels inside the image."""
    n, p = pairs.feats.shape[0], int(pairs.ranges[-1])
    t = pairs.ranges.numel()
    counts = (pairs.ranges[1:] - pairs.ranges[:-1]).long()
    walked = int((counts * inside_pixels(pairs, h, w)).sum())
    pair_bytes = n * 48 + p * 4 + t * 4
    kw = dict(image_height=h, image_width=w)
    shape = f"{n} splats, {p} pairs, {t - 1} tiles, {w}x{h}"
    return [
        Entry(name="probe_null", row="null", replaces=REPLACES["null"], wrapper=probe_null_cuda,
              run=lambda: probe_null(pairs, **kw), plain=lambda: probe_null_plain(pairs, **kw),
              compare=_compare_null, tolerance="outputs exact, checksums 1e-6 x max",
              nbytes=pair_bytes + h * w * 4 * 7 + (t - 1) * 8, shape=shape),
        Entry(name="probe_alpha_only", row="alpha_only", replaces=REPLACES["alpha_only"],
              wrapper=alpha_only_cuda, run=lambda: alpha_only(pairs, **kw),
              plain=lambda: alpha_only_plain(pairs, **kw), compare=_compare_alpha,
              tolerance="1e-5 x max per channel", nbytes=pair_bytes + h * w * 4 * 2,
              evals=gated_terms(pairs, h, w), walked_evals=walked, shape=shape),
    ]


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' raises without a GPU")
    p.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    return p.parse_args(sys.argv[1:] if argv is None else list(argv))


def main(argv: Optional[Sequence[str]] = None) -> list:
    from gaussian_garments_tpu_torch import pin_full_f32, resolve_device
    from gaussian_garments_tpu_torch.probes.common import cuda_ms
    from gaussian_garments_tpu_torch.probes.scene import HEIGHT, WIDTH, bench_scene

    args = parse_args(argv)
    device = resolve_device(args.device)
    pin_full_f32()
    _, pairs = bench_scene(device)
    print(f"bench.py scene: {pairs.feats.shape[0]} splats, {int(pairs.ranges[-1])} pairs, "
          f"{pairs.tiles_x * pairs.tiles_y} tiles; alpha_only walks {warp_lanes(pairs)} lane "
          f"evaluations after the warp cull, {tiles.PIX * int(pairs.ranges[-1])} without it",
          flush=True)
    full_ms = None
    if device.type == "cuda":
        full_ms = cuda_ms(lambda: tiles.composite_tiles_cuda(
            pairs, image_height=HEIGHT, image_width=WIDTH), args.reps)
        print(f"  full composite_fwd {full_ms:9.4f} ms (CUDA events, mean of {args.reps})",
              flush=True)

    def share(e, row):
        if full_ms:
            row["share_of_full"] = row["ms"] / full_ms
            print(f"{'':>6} {'':<20} {row['share_of_full']:.3f} of full", flush=True)

    rows = report(entries(pairs, HEIGHT, WIDTH), device, args.reps, share)
    return {"full_ms": full_ms, "rows": rows}


if __name__ == "__main__":
    main()
