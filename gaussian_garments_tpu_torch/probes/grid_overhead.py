"""What does one block per work item cost on the card, against a persistent
walk of the work list?

Counterpart of the TPU probe ``scripts/profile_grid_overhead.py``: a ladder of
null kernels (``csrc/probe_composite.cu``, ``grid_ladder``) over the
(tile × 256-pair chunk) work list of ``bench.py``'s scene
(``probes/worklist.py``), 256 threads a block. Each variant launches as many
blocks as the card holds at once; block b walks steps b, b + grid, ...
(``ladder_schedule`` is the CPU twin), staging the next step's chunk with
``cp.async`` while it sums this one:

- a: a step is one item, read from 5 separate metadata arrays; it stages
  its chunk's features in shared memory, zeroes its tile's (8, 512) output
  when k == 0 and writes one checksum per item;
- b: the item metadata merged into one int4 table, the tile ranges into int2;
- c: no staging of the chunk; its checksum is the count of valid pairs;
- d: a fixed output tile, as the TPU's ``kern_d`` maps every step to one
  output block: a block whose item has k == 0 zeroes its shared-memory copy
  of the tile, and only the block that takes the first item with k == 0
  writes tile 0 to global memory, once a launch. d is the ladder with no
  output write-backs: a–c less d is the price they pay per tile;
- e: a step is two items (2j, 2j + 1), both staged in one ``cp.async``
  group. The TPU's ``kern_e`` takes the tile and k of the even item only
  and drops an odd last item; here each item is taken whole, as the plain
  version computes.

    python -m gaussian_garments_tpu_torch.probes.grid_overhead [--device cuda] [--reps 20]

Prints ms, the grid, µs per step and µs per item, and the launch's writes
of output tiles to global memory (counted by the kernel), with the ``null``
row of ``composite_null`` (one 512-thread block per tile) beside them.
Checksums go to one slot per item. The plain versions compute the zeros and
checksums with ``index_add_``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

import torch

from gaussian_garments_tpu_torch.ops import tiles
from gaussian_garments_tpu_torch.ops.cuda import check_tensor, launch, route, stream
from gaussian_garments_tpu_torch.probes.common import Entry, max_abs, report
from gaussian_garments_tpu_torch.probes.composite_null import pair_feature_sums
from gaussian_garments_tpu_torch.probes.worklist import CHUNK, WorkList, build_worklist

VARIANTS = "abcde"
OUT_ROWS = 8
REPLACES = {v: f"scripts/profile_grid_overhead.py:{line}"
            for v, line in zip(VARIANTS, (72, 101, 124, 147, 178))}


def items_per_step(variant: str) -> int:
    return 2 if variant == "e" else 1


def n_steps(n_items: int, variant: str) -> int:
    return -(-n_items // items_per_step(variant))


def ladder_schedule(n_items: int, grid: int, variant: str) -> List[List[Tuple[int, ...]]]:
    """CPU twin of the kernel's walk: for each block, its steps in order,
    each the items it takes. The grid holds at most one block per step."""
    per, steps = items_per_step(variant), n_steps(n_items, variant)
    grid = min(grid, steps)
    return [[tuple(range(s * per, min((s + 1) * per, n_items))) for s in range(b, steps, grid)]
            for b in range(grid)]


def ladder_tile_writes(schedule, k_of_item, tile_of_item, variant: str) -> List[Tuple[int, int]]:
    """(block, tile) of each write of an output tile to global memory in the
    walk ``schedule``, in each block's order: a–c and e write the tile of
    each item with k == 0 as they take it; d zeroes its shared copy instead,
    and the block that takes the first item with k == 0 writes tile 0 once,
    at the end of its walk."""
    k = [int(x) for x in k_of_item]
    if variant != "d":
        return [(b, int(tile_of_item[i])) for b, steps in enumerate(schedule)
                for step in steps for i in step if k[i] == 0]
    first = k.index(0)
    return [(b, 0) for b, steps in enumerate(schedule) if any(first in st for st in steps)]


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

    def grid_ladder_cuda(pairs: tiles.TilePairs, wl: WorkList,
                         tile_writes: Optional[torch.Tensor] = None):
        dev = tiles.check_pairs(pairs)
        if tile_writes is not None:
            check_tensor(tile_writes, "tile_writes", torch.int64, dev, (1,))
        nt = pairs.tiles_x * pairs.tiles_y
        out = torch.empty((nt, OUT_ROWS, tiles.PIX), dtype=torch.float32, device=dev)
        checksum = torch.empty(wl.n_items, dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            launch("probe_composite", "gg_grid_ladder", pairs.feats.data_ptr(),
                   pairs.pair_splat.data_ptr(), wl.chunk_of_item.data_ptr(),
                   wl.tile_of_item.data_ptr(), wl.k_of_item.data_ptr(), wl.starts.data_ptr(),
                   wl.counts.data_ptr(), wl.item4.data_ptr(), wl.seg2.data_ptr(),
                   out.data_ptr(), checksum.data_ptr(),
                   None if tile_writes is None else tile_writes.data_ptr(), wl.n_items, code,
                   stream(dev))
        grid_ladder_cuda.launches += 1
        return out, checksum

    grid_ladder_cuda.__name__ = f"grid_ladder_{variant}_cuda"
    grid_ladder_cuda.__doc__ = (
        f"Launch variant {variant} of ``grid_ladder``; ``tile_writes``, a zeroed "
        "(1,) int64 tensor, gets the launch's writes of output tiles to global memory.")
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


def ladder_grid(n_items: int, variant: str, device) -> int:
    """How many blocks variant ``variant`` launches over ``n_items`` on
    ``device``'s card: as many as it holds at once, at most one per step."""
    out = torch.zeros(1, dtype=torch.int32)
    with torch.cuda.device(device):
        launch("probe_composite", "gg_grid_ladder_grid", n_items, VARIANTS.index(variant),
               out.data_ptr())
    return int(out)


def count_tile_writes(pairs: tiles.TilePairs, wl: WorkList, variant: str) -> int:
    """One launch of the kernel, returning its writes of output tiles to
    global memory as the kernel counts them."""
    writes = torch.zeros(1, dtype=torch.int64, device=pairs.feats.device)
    GRID_LADDER_CUDA[variant](pairs, wl, writes)
    return int(writes)


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
            shape=f"{wl.n_items} items, {n_steps(wl.n_items, v)} steps of "
                  f"{items_per_step(v)}, blocks of 256 threads"))
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
        if "ms" not in row:
            return
        steps = n_steps(wl.n_items, e.row)
        row["grid"] = ladder_grid(wl.n_items, e.row, device)
        row["tile_writes"] = count_tile_writes(pairs, wl, e.row)
        row["us_per_step"] = row["ms"] * 1e3 / steps
        row["us_per_item"] = row["ms"] * 1e3 / wl.n_items
        print(f"{'':>6} {'':<20} grid {row['grid']} blocks, {steps} steps: "
              f"{row['us_per_step']:.4f} us/step, {row['us_per_item']:.4f} us/item; "
              f"{row['tile_writes']} output tiles written to global memory", flush=True)

    rows = report(entries(pairs, wl), device, args.reps, per_item)
    null_ms = None
    if device.type == "cuda":
        null_ms = cuda_ms(lambda: composite_null.probe_null(
            pairs, image_height=HEIGHT, image_width=WIDTH), args.reps)
        nt = pairs.tiles_x * pairs.tiles_y
        print(f"  null (composite_null, one 512-thread block per tile): {null_ms:.4f} ms, "
              f"{null_ms * 1e3 / nt:.4f} us/block", flush=True)
    return {"n_items": wl.n_items, "first_items": int((wl.k_of_item == 0).sum()), "rows": rows,
            "null_ms": null_ms}


if __name__ == "__main__":
    main()
