"""Gather probes: is a table held on chip faster than a gather through L2?

Counterparts of the TPU probes ``scripts/profile_pallas_gather.py`` (row 3 of
the kernel table: a flat gather from a VMEM-resident table),
``scripts/profile_pallas_gather2.py`` (rows 4A, 4B: ``take_along_axis`` on
axis 0 and 1; 4C: the flat gather of row 3 in blocks of 2,048) and
``scripts/profile_pallas_gather3.py`` (row 5: the flat gather at a 163,840
entry table in blocks of 1,280), at their shapes and with their seeds.

A 606–655 KB table does not fit one block's 227 KB of shared memory, so the
flat gather runs as two kernels (``csrc/probe_gather.cu``): ``flat_l2``
reads the table through L2, as many blocks as the card holds at once
striding over the indices' int4 groups (``l2_groups`` is the CPU twin of
that partition), each thread with two groups' eight table reads in flight
before its float4 stores (on the card the probe also times it with the
table in an L2 persisting window); ``flat_cluster`` stages it across the shared
memory of a cluster of 4, 8 or 16 blocks (its float4 groups dealt to the
ranks in turn, ``cluster_slices``) and gathers through distributed shared
memory, the counterpart of the VMEM-resident table. On the card the probe
times it at every cluster size, with the staging and without it.

The axis gathers (rows 4A, 4B) move under 1.2 MB, less than a launch costs:
one thread an output in blocks of 256, launched with programmatic dependent
launch (the next kernel on the stream may launch once this one has stored;
it waits for this one before its first read). Beside their bound the probe
prints the launch floor: an empty kernel launched and timed the same way
(``launch_floor``), at their grid and at one block.

    python -m gaussian_garments_tpu_torch.probes.gather [--device cuda] [--reps 20] \
        [--rows 3 4C 5 4A 4B]

The plain versions are ``table.reshape(-1)[idx]`` and ``torch.gather``; the
library yardsticks, timed beside the kernels and used nowhere in the port,
are ``torch.take`` and ``torch.gather``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from gaussian_garments_tpu_torch.ops.cuda import check_tensor, launch, route, stream
from gaussian_garments_tpu_torch.probes.common import Entry, cuda_ms, max_abs, report

L2_THREADS, L2_VEC = 256, 2  # flat_l2's block, and the int4 groups a thread has in flight
CLUSTER_SIZES = (4, 8, 16)  # the cluster sizes the kernel is built for
CLUSTER = 4                 # the default: the fastest of them at every flat row on an H100
SMEM_BLOCK_BYTES = 232_448

# row -> (table rows, table lanes, indices, indices per block, TPU kernel)
FLAT_ROWS = {
    "3": (1184, 128, 2_097_152, 8192, "scripts/profile_pallas_gather.py:42"),
    "4C": (1184, 128, 2_097_152, 2048, "scripts/profile_pallas_gather2.py:98"),
    "5": (1280, 128, 2_097_920, 1280, "scripts/profile_pallas_gather3.py:54"),
}
# row -> (axis, table shape, index shape, TPU kernel)
AXIS_ROWS = {
    "4A": (0, (1184, 128), (512, 128), "scripts/profile_pallas_gather2.py:46"),
    "4B": (1, (8, 18_944), (8, 1024), "scripts/profile_pallas_gather2.py:72"),
}
ROWS = (*FLAT_ROWS, *AXIS_ROWS)
AXIS_THREADS = 256  # an axis-gather block's threads, one an output


def _check_flat(table: torch.Tensor, idx: torch.Tensor) -> torch.device:
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the gather kernels take cuda tensors, got {dev}")
    check_tensor(table, "table", torch.float32, dev)
    check_tensor(idx, "idx", torch.int32, dev)
    return dev


def gather_flat_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[p] = table.flat[idx[p]]."""
    return table.reshape(-1)[idx.reshape(-1).long()]


def _check_vector_args(kernel, table, idx, vectors):
    """Raise unless ``kernel`` can take ``table`` and ``idx``: fewer than 2^31
    entries each, and each of ``vectors`` (name -> tensor read as 16-byte
    vectors) 16-byte aligned."""
    if idx.numel() >= 2 ** 31 or table.numel() >= 2 ** 31:
        raise ValueError(f"{kernel} takes fewer than 2^31 indices and table entries")
    for name, t in vectors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} reads {name} as 16-byte vectors: it must be "
                             "16-byte aligned")


def gather_flat_l2_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch ``flat_l2``: as many blocks as the card holds at once stride
    over the indices' int4 groups, the table read through L2. Raises for
    indices that are not 16-byte aligned."""
    dev = _check_flat(table, idx)
    _check_vector_args("flat_l2", table, idx, {"idx": idx})
    out = torch.empty(idx.numel(), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch("probe_gather", "gg_gather_flat_l2", table.data_ptr(), idx.data_ptr(),
               out.data_ptr(), idx.numel(), stream(dev))
    gather_flat_l2_cuda.launches += 1
    return out


gather_flat_l2_cuda.launches = 0


def l2_groups(n: int, grid: int) -> np.ndarray:
    """CPU twin of ``flat_l2``'s partition of ``n`` indices over ``grid``
    blocks: (threads, rounds, L2_VEC) int64, the int4 group of the index
    stream that each thread takes in each round of its loop, slot by slot
    (-1 for none). Thread t's round r takes groups t + (r·L2_VEC + v)·stride,
    stride = grid·L2_THREADS; group g holds indices 4g … min(4g + 4, n) − 1."""
    n4 = -(-n // 4)
    stride = grid * L2_THREADS
    rounds = max(1, -(-n4 // (L2_VEC * stride)))
    base = np.arange(stride)[:, None, None] + np.arange(rounds)[None, :, None] * L2_VEC * stride
    g = base + np.arange(L2_VEC)[None, None, :] * stride
    return np.where((base < n4) & (g < n4), g, -1)


def _slots(table_size: int, cluster: int) -> int:
    """float4 groups of the table that each rank of a cluster holds."""
    groups = -(-table_size // 4)
    return -(-groups // cluster)


def cluster_slices(table: torch.Tensor, cluster: int) -> torch.Tensor:
    """(cluster, 4·slots) float32: the slice of the table that each rank of a
    cluster holds in ``flat_cluster``. The table's float4 groups (zero-padded
    to whole groups) are dealt to the ranks in turn, group q to rank
    q mod cluster, which keeps it at slot q div cluster; a rank's slice is
    zero-padded to ``slots`` = ceil(groups / cluster)."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got {cluster}")
    flat = table.reshape(-1)
    slots = _slots(flat.numel(), cluster)
    padded = flat.new_zeros(slots * cluster * 4)
    padded[:flat.numel()] = flat
    return padded.reshape(slots, cluster, 4).transpose(0, 1).reshape(cluster, slots * 4)


def cluster_address(idx: torch.Tensor, cluster: int):
    """(owner, offset) of each index in ``cluster_slices``: rank
    (j >> 2) & (cluster − 1), float offset ((j >> (2 + log2 cluster)) << 2) | (j & 3),
    as the kernel computes them."""
    shift = cluster.bit_length() - 1
    j = idx.reshape(-1).long()
    return (j >> 2) & (cluster - 1), ((j >> (2 + shift)) << 2) | (j & 3)


def _check_cluster_args(table, idx, blk, cluster):
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got {cluster}")
    if blk <= 0 or blk % 4:
        raise ValueError(f"blk must be a positive multiple of 4, got {blk}")
    _check_vector_args("flat_cluster", table, idx, {"table": table, "idx": idx})
    slice_bytes = _slots(table.numel(), cluster) * 16
    if slice_bytes > SMEM_BLOCK_BYTES:
        raise ValueError(f"a {table.numel()}-entry table needs {slice_bytes} B of shared "
                         f"memory a block in clusters of {cluster}; a block has "
                         f"{SMEM_BLOCK_BYTES}")


def gather_flat_cluster_cuda(table: torch.Tensor, idx: torch.Tensor, *, blk: int,
                             cluster: int = CLUSTER, stage: bool = True) -> torch.Tensor:
    """Launch ``flat_cluster``: clusters of ``cluster`` blocks, as many as the
    card holds at once, each hold the table in their shared memory and take
    the index stream's units of ``blk`` indices in turn. ``stage=False``
    skips the staging (the output is then undefined): the gathers alone,
    for timing. A launch the card refuses raises."""
    dev = _check_flat(table, idx)
    _check_cluster_args(table, idx, blk, cluster)
    out = torch.empty(idx.numel(), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch("probe_gather", "gg_gather_flat_cluster", table.data_ptr(), idx.data_ptr(),
               out.data_ptr(), idx.numel(), table.numel(), cluster, blk, 0 if stage else 1,
               stream(dev))
    gather_flat_cluster_cuda.launches += 1
    return out


gather_flat_cluster_cuda.launches = 0


def cluster_grid(table: torch.Tensor, cluster: int) -> int:
    """How many clusters of ``cluster`` blocks ``flat_cluster`` launches at
    most for ``table`` on its card (``cudaOccupancyMaxActiveClusters``)."""
    out = torch.zeros(1, dtype=torch.int32)
    with torch.cuda.device(table.device):
        launch("probe_gather", "gg_gather_cluster_grid", table.numel(), cluster, out.data_ptr())
    return int(out)


def l2_grid(n: int, device) -> int:
    """How many blocks ``flat_l2`` launches for ``n`` indices on ``device``'s
    card: as many as it holds at once, at most one thread per int4 group."""
    out = torch.zeros(1, dtype=torch.int32)
    with torch.cuda.device(device):
        launch("probe_gather", "gg_gather_l2_grid", n, out.data_ptr())
    return int(out)


def l2_window_ms(table: torch.Tensor, idx: torch.Tensor, reps: int = 20) -> float:
    """``flat_l2``'s ms (CUDA events, mean of ``reps``) with the table in an
    L2 persisting access-policy window on the current stream; the window is
    cleared afterwards, whatever happens."""
    with torch.cuda.device(table.device):
        s = stream(table.device)
        launch("probe_gather", "gg_l2_persisting_window", s, table.data_ptr(),
               table.numel() * 4)
        try:
            return cuda_ms(lambda: gather_flat_l2_cuda(table, idx), reps)
        finally:
            torch.cuda.synchronize()
            launch("probe_gather", "gg_l2_persisting_window", s, table.data_ptr(), 0)


def gather_axis_plain(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``take_along_axis(tab, idx, axis)`` for 2-D tensors."""
    return torch.gather(tab, axis, idx.long())


def _gather_axis_cuda(tab, idx, axis):
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"the gather kernels take cuda tensors, got {dev}")
    check_tensor(tab, "tab", torch.float32, dev)
    check_tensor(idx, "idx", torch.int32, dev)
    if tab.ndim != 2 or idx.ndim != 2:
        raise ValueError("the axis gathers take 2-D tensors")
    if idx.shape[1 - axis] != tab.shape[1 - axis]:
        raise ValueError(f"axis {axis}: idx {tuple(idx.shape)} and tab {tuple(tab.shape)}")
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if axis == 0:
            launch("probe_gather", "gg_gather_axis0", tab.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), idx.shape[0], idx.shape[1], stream(dev))
        else:
            launch("probe_gather", "gg_gather_axis1", tab.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), tab.shape[0], tab.shape[1], idx.shape[1], stream(dev))
    return out


def gather_axis0_cuda(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch ``axis0``: out[e, j] = tab[idx[e, j], j]."""
    out = _gather_axis_cuda(tab, idx, 0)
    gather_axis0_cuda.launches += 1
    return out


def gather_axis1_cuda(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch ``axis1``: out[r, k] = tab[r, idx[r, k]]."""
    out = _gather_axis_cuda(tab, idx, 1)
    gather_axis1_cuda.launches += 1
    return out


gather_axis0_cuda.launches = 0
gather_axis1_cuda.launches = 0


def launch_floor(blocks: int, threads: int, device) -> None:
    """One launch of an empty kernel of ``blocks`` blocks of ``threads``
    threads on ``device``'s current stream, with programmatic dependent launch
    as the axis gathers: the launch floor. It replaces no TPU kernel and
    counts no launches."""
    with torch.cuda.device(device):
        launch("probe_gather", "gg_launch_floor", blocks, threads, stream(device))


# kernel name -> the wrapper that counts its launches
WRAPPERS = {"gather_flat_l2": gather_flat_l2_cuda,
            "gather_flat_cluster": gather_flat_cluster_cuda,
            "gather_axis0": gather_axis0_cuda, "gather_axis1": gather_axis1_cuda}


def gather_flat(table: torch.Tensor, idx: torch.Tensor, *, variant: str = "l2",
                blk: int = 8192) -> torch.Tensor:
    """The flat gather: ``flat_l2`` or ``flat_cluster`` for CUDA tensors, the
    plain version for CPU tensors."""
    if variant == "l2":
        cuda = gather_flat_l2_cuda
    elif variant == "cluster":
        cuda = lambda t, i: gather_flat_cluster_cuda(t, i, blk=blk)
    else:
        raise ValueError(f"variant must be 'l2' or 'cluster', got {variant!r}")
    return route(table.device, cuda, gather_flat_plain)(table, idx)


def gather_axis(tab: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``take_along_axis`` on axis 0 or 1: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    cuda = {0: gather_axis0_cuda, 1: gather_axis1_cuda}[axis]
    return route(tab.device, cuda, lambda t, i: gather_axis_plain(t, i, axis))(tab, idx)


def make_inputs(device) -> dict:
    """Every row's (table, indices) as the JAX scripts seed them, on ``device``."""
    t = lambda a: torch.as_tensor(a, device=device)
    out = {}
    rng = np.random.RandomState(0)                          # profile_pallas_gather.py
    n = 1184 * 128
    out["3"] = (t(rng.randn(n).astype(np.float32).reshape(1184, 128)),
                t(rng.randint(0, n, 2_097_152).astype(np.int32)))
    rng = np.random.RandomState(0)                          # profile_pallas_gather2.py
    out["4A"] = (t(rng.randn(1184, 128).astype(np.float32)),
                 t(rng.randint(0, 1184, (512, 128)).astype(np.int32)))
    out["4B"] = (t(rng.randn(8, 18_944).astype(np.float32)),
                 t(rng.randint(0, 18_944, (8, 1024)).astype(np.int32)))
    out["4C"] = (t(rng.randn(1184, 128).astype(np.float32)),
                 t(rng.randint(0, n, 2_097_152).astype(np.int32)))
    rng = np.random.RandomState(0)                          # profile_pallas_gather3.py
    out["5"] = (t(rng.randn(1280, 128).astype(np.float32)),
                t(rng.randint(0, 1280 * 128, 2_097_920).astype(np.int32)))
    return out


def _exact(got, want):
    err = max_abs(got, want)
    return err, bool(torch.equal(got, want))


def entries(device, inputs: Optional[dict] = None, rows: Sequence[str] = ROWS) -> List[Entry]:
    """Every gather kernel at each of ``rows`` of the TPU scripts' table."""
    inputs = inputs or make_inputs(device)
    out = []
    for row, (n_rows, lanes, n, blk, replaces) in FLAT_ROWS.items():
        if row not in rows:
            continue
        table, idx = inputs[row]
        idx64 = idx.long()
        nbytes = table.numel() * 4 + idx.numel() * 8
        shape = f"table ({n_rows}, {lanes}) f32, {n} int32 indices in blocks of {blk}"
        common = dict(row=row, replaces=replaces,
                      plain=lambda t=table, i=idx: gather_flat_plain(t, i),
                      compare=_exact, tolerance="exact", nbytes=nbytes,
                      library=lambda t=table, i=idx64: torch.take(t, i), shape=shape)
        out.append(Entry(name="gather_flat_l2", wrapper=gather_flat_l2_cuda,
                         run=lambda t=table, i=idx: gather_flat(t, i, variant="l2"), **common))
        out.append(Entry(name="gather_flat_cluster", wrapper=gather_flat_cluster_cuda,
                         run=lambda t=table, i=idx, b=blk: gather_flat(t, i, variant="cluster",
                                                                       blk=b), **common))
    for row, (axis, tshape, ishape, replaces) in AXIS_ROWS.items():
        if row not in rows:
            continue
        tab, idx = inputs[row]
        idx64 = idx.long()
        blocks = -(-int(np.prod(ishape)) // AXIS_THREADS)
        out.append(Entry(
            name=f"gather_axis{axis}", row=row, replaces=replaces,
            wrapper=gather_axis0_cuda if axis == 0 else gather_axis1_cuda,
            run=lambda t=tab, i=idx, a=axis: gather_axis(t, i, a),
            plain=lambda t=tab, i=idx, a=axis: gather_axis_plain(t, i, a),
            compare=_exact, tolerance="exact", nbytes=tab.numel() * 4 + idx.numel() * 8,
            library=lambda t=tab, i=idx64, a=axis: torch.gather(t, a, i),
            floor=lambda b=blocks: launch_floor(b, AXIS_THREADS, device),
            shape=f"take_along_axis axis {axis}: tab {tshape} f32, idx {ishape} int32; "
                  f"{blocks} blocks of {AXIS_THREADS}, programmatic dependent launch"))
    return out


def cluster_sweep(inputs: dict, row: str, reps: int = 20) -> dict:
    """``flat_cluster`` at ``row`` at every cluster size it is built for:
    {size: {"clusters", "exact", "ms", "ms_unstaged"}}, the times by CUDA
    events (mean of ``reps``), "exact" whether the staged output equals
    ``table[idx]``."""
    table, idx = inputs[row]
    blk = FLAT_ROWS[row][3]
    want = gather_flat_plain(table, idx)
    out = {}
    for c in CLUSTER_SIZES:
        run = lambda stage: gather_flat_cluster_cuda(table, idx, blk=blk, cluster=c, stage=stage)
        exact = bool(torch.equal(run(True), want))
        out[c] = {"clusters": cluster_grid(table, c), "exact": exact,
                  "ms": cuda_ms(lambda: run(True), reps),
                  "ms_unstaged": cuda_ms(lambda: run(False), reps)}
    return out


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' raises without a GPU")
    p.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    p.add_argument("--rows", nargs="+", choices=ROWS, default=list(ROWS),
                   help="rows of the TPU scripts' table to run")
    return p.parse_args(sys.argv[1:] if argv is None else list(argv))


def main(argv: Optional[Sequence[str]] = None) -> list:
    from gaussian_garments_tpu_torch import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    inputs = make_inputs(device)
    es = entries(device, inputs, args.rows)

    def extra(e, row):
        if e.name.startswith("gather_axis") and device.type == "cuda":
            row["floor_one_block_ms"] = cuda_ms(
                lambda: launch_floor(1, AXIS_THREADS, device), args.reps)
            print(f"{'':>6} {'':<20} empty kernel at one block of {AXIS_THREADS} "
                  f"{row['floor_one_block_ms']:.4f} ms", flush=True)
        if e.name == "gather_flat_l2" and device.type == "cuda":
            table, idx = inputs[e.row]
            row["grid"] = l2_grid(idx.numel(), device)
            row["ms_l2_window"] = l2_window_ms(table, idx, args.reps)
            print(f"{'':>6} {'':<20} grid {row['grid']} blocks of 256 threads; with the table "
                  f"in an L2 persisting window {row['ms_l2_window']:.4f} ms", flush=True)
        if e.name == "gather_flat_cluster" and device.type == "cuda":
            row["sweep"] = cluster_sweep(inputs, e.row, args.reps)
            row["ms_unstaged"] = row["sweep"][CLUSTER]["ms_unstaged"]
            row["ok"] = row["ok"] and all(s["exact"] for s in row["sweep"].values())
            for c, s in row["sweep"].items():
                print(f"{'':>6} {'':<20} clusters of {c:>2} ({s['clusters']} of them): "
                      f"{s['ms']:.4f} ms, without the staging {s['ms_unstaged']:.4f} ms, "
                      f"exact={s['exact']}", flush=True)

    return report(es, device, args.reps, extra)


if __name__ == "__main__":
    main()
