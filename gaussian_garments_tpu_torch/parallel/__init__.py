"""Data parallelism over ``torch.distributed``: one process per device, the
camera or item batch sharded over the ranks, the gradients all-reduced.

Counterpart of ``gaussian_garments_tpu/parallel/__init__.py``. The JAX
package runs one program over a ``("data",)`` mesh and reduces inside
``shard_map`` with ``jax.lax.pmean``/``psum``/``pmax`` over an axis name
(``training/s2.py:207-262``, ``training/s3.py:336-341``). Here each rank is
a process, launched by ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``), and a ``Group`` takes the axis name's
place:

- ``setup``: the process group from that environment, NCCL on ``cuda`` and
  gloo on ``cpu``; on ``cuda`` each rank first makes ``cuda:LOCAL_RANK`` its
  current device (NCCL needs one GPU per rank). A group that the caller has
  already initialised is used as it is;
- ``shard``: rank r's contiguous block ``[r·b/w, (r+1)·b/w)`` of a batch,
  the block that ``P("data")`` gives device r (not ``r::w``);
- ``pmean``/``psum``/``pmax``: ``all_reduce`` of a tree of tensors,
  coalesced into one flat buffer per dtype, so that stage 3's 54.7M-parameter
  gradient is one collective, not one per tensor;
- ``broadcast_from_rank0`` for a state that must start equal everywhere;
- ``barrier`` and ``teardown``;
- ``spawn``: n local ranks of a gloo (or other) group in new processes,
  joined through a file, for the tests, ``graft_entry.dryrun_multichip`` and
  the card's checks (their rank workers are in ``parallel/rank_checks.py``).

Without a group (``group=None``) every reduction is the identity, as the
JAX drivers run their plain step when ``jax.device_count() == 1``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """A data-parallel group: this process's rank, the world size, the
    backend, the process group (None: the default group), and whether
    ``setup`` started it (and ``teardown`` ends it)."""

    rank: int
    world: int
    backend: str
    pg: Any = None
    owned: bool = False


def setup(device: torch.device, backend: Optional[str] = None) -> Tuple[torch.device, Group]:
    """Join (or start) the process group. Returns this rank's device (on
    ``cuda``, ``cuda:LOCAL_RANK``, made current before anything touches the
    card) and the ``Group``. ``backend`` defaults to NCCL on ``cuda`` and gloo
    on ``cpu``."""
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", device.index or 0))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    owned = not dist.is_initialized()
    if owned:
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError("data parallel needs a launcher: run under torchrun "
                               "(python -m torch.distributed.run --nproc_per_node N ...)")
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", **kw)
    return device, Group(dist.get_rank(), dist.get_world_size(), dist.get_backend(),
                         owned=owned)


def driver_group(enabled: bool, device: torch.device, batch: int,
                 flag: str) -> Tuple[torch.device, Optional[Group]]:
    """A driver's ``--data_parallel``: ``(device, group)`` under a launcher,
    with this rank's device; ``(device, None)`` when the flag is off or no
    launcher started the process. Prints the backend and world size once,
    and raises unless ``batch`` (the value of ``flag``) splits evenly over the
    ranks."""
    if not enabled:
        return device, None
    if not launched():
        print("[data parallel] no launcher (torchrun): one process, world size 1")
        return device, None
    device, group = setup(device)
    if is_main(group):
        print(f"[data parallel] backend {group.backend}, world size {group.world}")
    if batch % group.world:
        raise ValueError(f"{flag} {batch} must be a multiple of the world size {group.world}")
    return device, group


def current(device: torch.device) -> Tuple[torch.device, Optional[Group]]:
    """This process's device and group: the group of its launcher or of an
    initialised process group (``setup``), else ``(device, None)``."""
    if launched():
        return setup(device)
    return device, None


def launched() -> bool:
    """Whether this process runs under a launcher or in an initialised
    group."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def shard_bounds(n: int, rank: int, world: int) -> Tuple[int, int]:
    """``[r·n/w, (r+1)·n/w)``; ``n`` must be a multiple of ``world``."""
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks")
    per = n // world
    return rank * per, (rank + 1) * per


def shard(batch, group: Optional[Group]):
    """This rank's contiguous block of ``batch`` (a sequence or a tensor,
    sharded on its leading axis); the whole batch without a group."""
    if group is None:
        return batch
    lo, hi = shard_bounds(len(batch), group.rank, group.world)
    return batch[lo:hi]


def _leaves(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses, and
    a function that rebuilds the tree from new tensors in that order."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_leaves(tree[k]) for k in keys]
    elif dataclasses.is_dataclass(tree):
        keys = [f.name for f in dataclasses.fields(tree)]
        parts = [_leaves(getattr(tree, k)) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_leaves(x) for x in tree]
    else:
        return [], lambda xs: tree
    counts = [len(p[0]) for p in parts]
    leaves = [x for p in parts for x in p[0]]

    def rebuild(xs):
        out, i = [], 0
        for (_, fn), n in zip(parts, counts):
            out.append(fn(xs[i:i + n]))
            i += n
        if isinstance(tree, dict):
            return dict(zip(keys, out))
        if keys is not None:
            return dataclasses.replace(tree, **dict(zip(keys, out)))
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)

    return leaves, rebuild


def _coalesced(tree, collective):
    """Run ``collective`` in place on one flat buffer per dtype of the
    tree's tensors. Returns (the rebuilt tree, its new leaves in order)."""
    leaves, rebuild = _leaves(tree)
    out = list(leaves)
    by_dtype = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        collective(flat)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view_as(leaves[i])
            off += n
    return rebuild(out), out


def psum(tree, group: Optional[Group]):
    """The sum over the ranks of every tensor of ``tree``."""
    if group is None:
        return tree
    return _coalesced(tree, lambda x: dist.all_reduce(x, group=group.pg))[0]


def pmean(tree, group: Optional[Group]):
    """The mean over the ranks of every (floating) tensor of ``tree``."""
    if group is None:
        return tree
    summed, leaves = _coalesced(tree, lambda x: dist.all_reduce(x, group=group.pg))
    return _leaves(summed)[1]([x / group.world for x in leaves])


def pmax(tree, group: Optional[Group]):
    """The elementwise maximum over the ranks of every tensor of ``tree``."""
    if group is None:
        return tree
    return _coalesced(tree, lambda x: dist.all_reduce(x, op=dist.ReduceOp.MAX,
                                                      group=group.pg))[0]


def broadcast_from_rank0(tree, group: Optional[Group]):
    """Rank 0's values of every tensor of ``tree``, on every rank (one
    broadcast per dtype). Anything in the tree that is not a tensor is left
    as it is."""
    if group is None:
        return tree
    return _coalesced(tree, lambda x: dist.broadcast(x, src=0, group=group.pg))[0]


def is_main(group: Optional[Group]) -> bool:
    """Rank 0, or no group: the process that writes artifacts."""
    return group is None or group.rank == 0


def barrier(group: Optional[Group]) -> None:
    if group is not None:
        dist.barrier(group=group.pg)


def teardown(group: Optional[Group]) -> None:
    """Leave the process group that ``setup`` started (a no-op otherwise)."""
    if group is not None and group.owned and dist.is_initialized():
        dist.barrier(group=group.pg)
        dist.destroy_process_group()


FOREIGN_MODULES = ("jax", "jaxlib", "flax", "orbax", "gaussian_garments_tpu")


def foreign_modules() -> List[str]:
    """The loaded modules of jax, flax, orbax or the JAX package; the port
    loads none."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN_MODULES)


def _rank_main(rank: int, world: int, init_method: str, backend: str, device: str, fn,
               args, queue) -> None:
    """One spawned rank: join the group, run ``fn(*args)`` with TF32 off (a
    new process starts with PyTorch's defaults, which run cuDNN convolutions
    in TF32), report."""
    from gaussian_garments_tpu_torch import pin_full_f32

    try:
        pin_full_f32()
        if device == "cpu":
            torch.set_num_threads(1)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
        result = fn(*args)
        foreign = foreign_modules()
        if foreign:
            raise RuntimeError(f"rank {rank} loaded {foreign[:5]}")
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, "ok", result))
    except BaseException:
        import traceback

        queue.put((rank, "error", traceback.format_exc()))
        raise


def spawn(fn, world: int, args=(), *, backend: str = "gloo", device: str = "cpu",
          timeout: float = 600.0, workdir: Optional[str] = None) -> list:
    """Run ``fn(*args)`` on ``world`` new processes, each a rank of one
    ``backend`` group joined through a file in ``workdir`` (a fresh temporary
    directory by default, so that concurrent callers never share a port).
    ``fn`` must be importable by name, and it finds its group through
    ``setup``. Returns the ranks' results in rank order; raises if a rank
    fails, loads jax or the JAX package, or outlives ``timeout`` seconds (all
    ranks are then killed). Each rank runs with TF32 off, and with
    ``device="cpu"`` torch on one thread."""
    import queue as queue_mod
    import tempfile
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(dir=workdir)
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init_method, backend, device, fn, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks of {fn.__name__} outlived {timeout:.0f} s")
            try:
                rank, status, payload = q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank of {fn.__name__} died with exit code "
                                       f"{dead[0].exitcode}")
                continue
            if status == "ok":
                results[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
                break
        if errors:
            raise RuntimeError(f"{fn.__name__} failed on " + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=max(1.0, min(30.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
