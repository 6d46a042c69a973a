"""A training step replayed as one CUDA graph (``training/s2``'s vertex
modes, ``training/s3``'s steps).

A step is given as ``run(inputs, scalars) -> outputs``: ``inputs`` a dict of
the tensors it reads, by name, ``scalars`` a float64 vector on the card of
the per-step numbers it reads (learning rates, Adam's bias corrections, the
cameras' ``tanfov``), ``outputs`` a dict of the tensors it makes, by name.
``StepGraph`` captures it once on static copies of its inputs and replays it
at each later call; ``Graphs`` keeps one step object's captures by key, in
one memory pool. Each call copies the inputs in with one ``_foreach_copy_``
a dtype, puts the scalars on the card with one copy from pinned memory,
replays, and returns the outputs cloned into one fresh buffer a dtype, so
that no later replay overwrites what the caller holds.

Counters ``<name>.capture`` and ``<name>.replay`` count the two, and a span
``replay`` marks the copy-in and the graph's launch. The counts the step
made while it was captured (the compositors' launches) are taken back after
the capture and added on each replay.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from gaussian_garments_tpu_torch.utils import logging as log

Tensors = Dict[str, torch.Tensor]


def signature(inputs: Tensors) -> tuple:
    """Each input's name, device, dtype and shape: what a capture is
    specialised to, besides what its caller adds to the key."""
    return tuple((k, v.device, v.dtype, tuple(v.shape)) for k, v in inputs.items())


def prefixed(tensors: Tensors, prefix: str) -> Tensors:
    """The entries of ``tensors`` whose name starts with ``prefix``, by the
    rest of their name: how a step's inputs and outputs group by name."""
    return {k[len(prefix):]: v for k, v in tensors.items() if k.startswith(prefix)}


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` grouped by (device, dtype), in order: a
    ``_foreach`` op takes its fast path only within one group."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return list(groups.values())


def clone_into_one_buffer(tensors: Tensors) -> Tensors:
    """Contiguous clones of ``tensors``, each a view of one fresh buffer a
    (device, dtype): one allocation and one grouped copy a dtype instead of
    a clone each."""
    names, srcs = list(tensors), list(tensors.values())
    out: Tensors = {}
    for idx in _by_dtype(srcs):
        sizes = [srcs[i].numel() for i in idx]
        flat = torch.empty(sum(sizes), dtype=srcs[idx[0]].dtype, device=srcs[idx[0]].device)
        views = [v.view(srcs[i].shape) for v, i in zip(flat.split(sizes), idx)]
        torch._foreach_copy_(views, [srcs[i] for i in idx])
        out.update((names[i], v) for i, v in zip(idx, views))
    return {k: out[k] for k in names}


class StepGraph:
    """``run`` captured as a CUDA graph on static copies of its inputs.

    Built at the first call of its input signature: it copies the inputs,
    runs the step once on a side stream on those copies (its lazy set-up:
    libraries, handles, cached constants; the results are thrown away and
    the caller's tensors are never written), then captures it in ``pool``
    (None: a pool of its own). Scalars go through two pinned buffers in
    turn, one rewritten only after its last copy ran."""

    def __init__(self, name: str, run: Callable[[Tensors, torch.Tensor], Tensors],
                 inputs: Tensors, scalars: Sequence[float], pool=None):
        dev = next(iter(inputs.values())).device
        self.name = name
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.groups = _by_dtype(list(self.inputs.values()))
        self.scalars = torch.zeros(len(scalars), dtype=torch.float64, device=dev)
        self.host = [torch.zeros(len(scalars), dtype=torch.float64, pin_memory=True)
                     for _ in range(2)]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.turn = 0
        self._load_scalars(scalars)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run(self.inputs, self.scalars)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = log.counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = run(self.inputs, self.scalars)
        after = log.counters()
        self.counts = {k: n - before.get(k, 0) for k, n in after.items()
                       if n != before.get(k, 0)}
        for k, n in self.counts.items():
            log.count(k, -n)
        log.count(f"{name}.capture")

    def _load_scalars(self, scalars: Sequence[float]):
        self.turn = i = 1 - self.turn
        self.copied[i].synchronize()
        self.host[i].numpy()[:] = scalars
        self.scalars.copy_(self.host[i], non_blocking=True)
        self.copied[i].record()

    def __call__(self, inputs: Tensors, scalars: Sequence[float]) -> Tensors:
        with log.span("replay"):
            static, srcs = list(self.inputs.values()), list(inputs.values())
            for idx in self.groups:
                torch._foreach_copy_([static[i] for i in idx], [srcs[i] for i in idx])
            self._load_scalars(scalars)
            self.graph.replay()
        for k, n in self.counts.items():
            log.count(k, n)
        log.count(f"{self.name}.replay")
        return clone_into_one_buffer(self.outputs)


class Graphs:
    """The captures of one step object, by key, sharing one memory pool. A
    replay may write what another capture of the pool left in it, which is
    safe because every replay's outputs are cloned before the next replay
    runs, and the graphs run on one stream, one at a time."""

    def __init__(self, name: str):
        self.name = name
        self.graphs: Dict[tuple, StepGraph] = {}
        self.pool = None

    def __call__(self, key: tuple, run: Callable[[Tensors, torch.Tensor], Tensors],
                 inputs: Tensors, scalars: Sequence[float]) -> Tensors:
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = StepGraph(self.name, run, inputs, scalars, self.pool)
            if self.pool is None:
                self.pool = graph.graph.pool()
        return graph(inputs, scalars)
