"""What does one block per work item cost on the card, and what is that cost
made of?

Counterpart of the TPU probe ``scripts/profile_grid_overhead.py``: a ladder of
null kernels (``csrc/probe_composite.cu``, ``grid_ladder``) over the
(tile × 256-pair chunk) work list of ``bench.py``'s scene
(``probes/worklist.py``), 256 threads a block:

- a: one block per item, reading 5 separate metadata arrays; it stages its
  chunk's features in shared memory, zeroes its tile's (8, 512) output when
  k == 0 and writes one checksum per item;
- b: the item metadata merged into one int4 table, the tile ranges into int2;
- c: no staging of the chunk;
- d: a fixed output tile: every block zeroes tile 0;
- e: one block per 2 items.

    python -m gaussian_garments_tpu_torch.probes.grid_overhead [--device cuda] [--reps 20]

Prints ms, µs per block and µs per item, with the ``null`` row of
``composite_null`` (one 512-thread block per tile) beside them. Checksums go
to one slot per item. The plain versions compute the zeros and checksums
with ``index_add_``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import torch

from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.ops.cuda import launch, route, stream
from gaussian_garments_tpu_torch.probes.common import Entry, max_abs, report
from gaussian_garments_tpu_torch.probes.composite_null import pair_feature_sums
from gaussian_garments_tpu_torch.probes.worklist import CHUNK, WorkList, build_worklist

VARIANTS = "abcde"
OUT_ROWS = 8
REPLACES = {v: f"scripts/profile_grid_overhead.py:{line}"
            for v, line in zip(VARIANTS, (72, 101, 124, 147, 178))}


def items_per_block(variant: str) -> int:
    return 2 if variant == "e" else 1


def grid_ladder_plain(pairs: tiles.TilePairs, wl: WorkList, variant: str):
    """(out (T, 8, 512): 0 in the tiles the kernel zeroes, NaN in the tiles
    it does not write; (W,) float64 checksums: the item's staged feature
    sum, or for variant c its count of valid pairs)."""
    dev = pairs.feats.device
    nt = pairs.tiles_x * pairs.tiles_y
    out = torch.full((nt, OUT_ROWS, tiles.PIX), float("nan"), device=dev)
    first = wl.tile_of_item[wl.k_of_item == 0].long()
    out[torch.zeros_like(first[:1]) if variant == "d" else first] = 0.0
    # each pair lies in exactly one item: the chunk it falls in, of its tile
    counts = wl.counts.long()
    tile = torch.repeat_interleave(torch.arange(nt, device=dev), counts,
                                   output_size=int(counts.sum()))
    pid = torch.arange(tile.numel(), device=dev)
    per_tile = torch.zeros(nt, dtype=torch.int64, device=dev).index_add_(
        0, wl.tile_of_item.long(), torch.ones(wl.n_items, dtype=torch.int64, device=dev))
    item_start = torch.cumsum(per_tile, 0) - per_tile
    item = item_start[tile] + pid // CHUNK - wl.starts.long()[tile] // CHUNK
    vals = (torch.ones(pid.numel(), dtype=torch.float64, device=dev) if variant == "c"
            else pair_feature_sums(pairs))
    checksum = torch.zeros(wl.n_items, dtype=torch.float64, device=dev).index_add_(0, item, vals)
    return out, checksum


def _ladder_cuda(variant: str):
    code = VARIANTS.index(variant)

    def grid_ladder_cuda(pairs: tiles.TilePairs, wl: WorkList):
        dev = tiles.check_pairs(pairs)
        nt = pairs.tiles_x * pairs.tiles_y
        out = torch.empty((nt, OUT_ROWS, tiles.PIX), dtype=torch.float32, device=dev)
        checksum = torch.empty(wl.n_items, dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            launch("probe_composite", "gg_grid_ladder", pairs.feats.data_ptr(),
                   pairs.pair_splat.data_ptr(), wl.chunk_of_item.data_ptr(),
                   wl.tile_of_item.data_ptr(), wl.k_of_item.data_ptr(), wl.starts.data_ptr(),
                   wl.counts.data_ptr(), wl.item4.data_ptr(), wl.seg2.data_ptr(),
                   out.data_ptr(), checksum.data_ptr(), wl.n_items, code, stream(dev))
        grid_ladder_cuda.launches += 1
        return out, checksum

    grid_ladder_cuda.__name__ = f"grid_ladder_{variant}_cuda"
    grid_ladder_cuda.__doc__ = f"Launch variant {variant} of ``grid_ladder``."
    grid_ladder_cuda.launches = 0
    return grid_ladder_cuda


GRID_LADDER_CUDA = {v: _ladder_cuda(v) for v in VARIANTS}
# kernel name -> the wrapper that counts its launches
WRAPPERS = {f"grid_{v}": GRID_LADDER_CUDA[v] for v in VARIANTS}


def grid_ladder(pairs: tiles.TilePairs, wl: WorkList, variant: str):
    """Variant ``variant`` of the ladder: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return route(pairs.feats.device, GRID_LADDER_CUDA[variant],
                 lambda p, w: grid_ladder_plain(p, w, variant))(pairs, wl)


def _compare(got, want):
    """The tiles the plain version zeroes are zero in the kernel's output
    (the kernel leaves the others as ``torch.empty`` made them); the
    checksums agree to 1e-6 × their largest."""
    (k_out, k_sum), (p_out, p_sum) = got, want
    written = ~torch.isnan(p_out)
    same = bool((k_out[written] == 0).all())
    err = max_abs(k_sum, p_sum)
    return err, same and err <= 1e-6 * max(float(p_sum.abs().max()), 1e-30)


def entries(pairs: tiles.TilePairs, wl: WorkList) -> List[Entry]:
    n, p = pairs.feats.shape[0], int(pairs.ranges[-1])
    nt = pairs.tiles_x * pairs.tiles_y
    tiles_zeroed = int((wl.k_of_item == 0).sum())
    tile_bytes = OUT_ROWS * tiles.PIX * 4
    out = []
    for v in VARIANTS:
        meta = wl.n_items * 16 + nt * 8 if v == "b" else wl.n_items * 12 + nt * 8
        feats = 0 if v == "c" else n * 48 + p * 4
        zeroed = tile_bytes * (1 if v == "d" else tiles_zeroed)
        out.append(Entry(
            name=f"grid_{v}", row=v, replaces=REPLACES[v], wrapper=GRID_LADDER_CUDA[v],
            run=lambda v=v: grid_ladder(pairs, wl, v),
            plain=lambda v=v: grid_ladder_plain(pairs, wl, v),
            compare=_compare, tolerance="outputs exact, checksums 1e-6 x max",
            nbytes=meta + feats + zeroed + wl.n_items * 8,
            shape=f"{wl.n_items} items, {-(-wl.n_items // items_per_block(v))} blocks "
                  f"of 256 threads"))
    return out


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' raises without a GPU")
    p.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    return p.parse_args(sys.argv[1:] if argv is None else list(argv))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from gaussian_garments_tpu_torch import resolve_device
    from gaussian_garments_tpu_torch.probes import composite_null
    from gaussian_garments_tpu_torch.probes.common import cuda_ms
    from gaussian_garments_tpu_torch.probes.scene import HEIGHT, WIDTH, bench_scene

    args = parse_args(argv)
    device = resolve_device(args.device)
    _, pairs = bench_scene(device)
    wl = build_worklist(pairs.ranges)
    print(f"work items: {wl.n_items}   tiles: {pairs.tiles_x * pairs.tiles_y}   pairs: "
          f"{int(pairs.ranges[-1])}", flush=True)

    def per_item(e, row):
        if "ms" in row:
            blocks = -(-wl.n_items // items_per_block(e.row))
            row["us_per_block"] = row["ms"] * 1e3 / blocks
            row["us_per_item"] = row["ms"] * 1e3 / wl.n_items
            print(f"{'':>6} {'':<20} {row['us_per_block']:.4f} us/block, "
                  f"{row['us_per_item']:.4f} us/item", flush=True)

    rows = report(entries(pairs, wl), device, args.reps, per_item)
    null_ms = None
    if device.type == "cuda":
        null_ms = cuda_ms(lambda: composite_null.probe_null(
            pairs, image_height=HEIGHT, image_width=WIDTH), args.reps)
        nt = pairs.tiles_x * pairs.tiles_y
        print(f"  null (composite_null, one 512-thread block per tile): {null_ms:.4f} ms, "
              f"{null_ms * 1e3 / nt:.4f} us/block", flush=True)
    return {"n_items": wl.n_items, "rows": rows, "null_ms": null_ms}


if __name__ == "__main__":
    main()
