"""The (tile × 256-pair chunk) work list of the TPU compositor, built from
the port's tile ranges (``TilePairs.ranges``).

The JAX package walks its pair space in chunks of 256 pairs aligned to the
global pair index (``pack_pairs``, ``gaussian_garments_tpu/ops/pallas_tiles.py``):
a tile with pairs in ``[start, end)`` owns
``n_items = (end − 1)//256 − start//256 + 1`` items, item ``k`` reads chunk
``start//256 + k``, and a chunk that straddles two tiles appears once per
tile, each masking the pairs outside its own range. Plain torch, no kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

CHUNK = 256


class WorkList(NamedTuple):
    chunk_of_item: torch.Tensor  # (W,) int32 chunk each item reads
    tile_of_item: torch.Tensor   # (W,) int32 tile each item writes
    k_of_item: torch.Tensor      # (W,) int32 item index within its tile
    starts: torch.Tensor         # (T,) int32 first pair of each tile
    counts: torch.Tensor         # (T,) int32 pairs of each tile
    item4: torch.Tensor          # (W, 4) int32 [chunk, tile, k, 0]: the items as one table
    seg2: torch.Tensor           # (T, 2) int32 [start, count]: the ranges as one table
    n_items: int


def build_worklist(ranges: torch.Tensor) -> WorkList:
    """Work items of the tiles whose pair ranges are ``ranges`` (T+1,)."""
    ranges = ranges.to(torch.int64)
    starts, ends = ranges[:-1], ranges[1:]
    counts = ends - starts
    per_tile = torch.where(counts > 0, (ends - 1) // CHUNK - starts // CHUNK + 1,
                           torch.zeros_like(counts))
    total = int(per_tile.sum())
    tile = torch.repeat_interleave(torch.arange(len(counts), device=ranges.device), per_tile,
                                   output_size=total)
    first = torch.cumsum(per_tile, 0) - per_tile
    k = torch.arange(total, device=ranges.device) - first[tile]
    chunk = starts[tile] // CHUNK + k
    i32 = lambda x: x.to(torch.int32).contiguous()
    return WorkList(i32(chunk), i32(tile), i32(k), i32(starts), i32(counts),
                    i32(torch.stack([chunk, tile, k, torch.zeros_like(k)], dim=1)),
                    i32(torch.stack([starts, counts], dim=1)), total)
