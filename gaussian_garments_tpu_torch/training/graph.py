"""A training step replayed as one CUDA graph (``training/s2``'s vertex
modes, ``training/s3``'s steps).

A capturable step is ``fn(*args)``: ``args`` a tree of dataclasses,
NamedTuples, dicts, tuples and lists, its result a tree of tensors. One
walker (``flatten``, ``rebuild``) reads both, with one rule a kind of leaf.
A tensor is an input: each call copies it into its static copy, with one
``_foreach_copy_`` a dtype. A Python float is a per-step scalar (a learning
rate, an Adam bias correction, a camera's ``tanfov``): each call puts the
floats on the card in one float64 vector, from pinned memory, and the step
reads each as a 0-d view of it. Anything else (an int, a bool, a string,
None, a dtype) is static: part of the key, with the tree's structure and
each tensor's device, dtype and shape. A tensor the step closes over would
be baked into the graph, so a step takes what it reads as its arguments.

``StepGraph`` captures a step on static copies of its inputs and replays it;
each call returns the outputs cloned into one fresh buffer a dtype, rebuilt
on the tree the capture returned, so that no later replay overwrites what
the caller holds. ``Graphs`` keeps one step object's captures by key, in one
memory pool. Counters ``<name>.capture`` and ``<name>.replay`` count the
two, and a span ``replay`` marks the copy-in and the graph's launch. The
counts the step made while it was captured (the compositors' launches) are
taken back after the capture and added on each replay.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from gaussian_garments_tpu_torch.utils import logging as log


@functools.cache
def _fields(cls: type) -> Optional[Tuple[str, ...]]:
    """The field names of a dataclass, None for any other type."""
    return tuple(f.name for f in dataclasses.fields(cls)) if dataclasses.is_dataclass(cls) else None


def flatten(tree) -> Tuple[List[torch.Tensor], List[float], tuple]:
    """``tree``'s tensors and floats, in order, and its key: its structure,
    each tensor's device, dtype and shape, and every other leaf's value."""
    tensors: List[torch.Tensor] = []
    floats: List[float] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return x.device, x.dtype, x.shape
        if isinstance(x, float):
            floats.append(x)
            return float
        if isinstance(x, dict):
            return dict, tuple(x), tuple(map(walk, x.values()))
        names = _fields(type(x))
        if names is not None:
            return type(x), tuple([walk(getattr(x, n)) for n in names])
        if isinstance(x, (tuple, list)):
            return type(x), tuple(map(walk, x))
        return type(x), x

    return tensors, floats, walk(tree)


def rebuild(tree, tensors: Iterable[torch.Tensor], floats: Iterable):
    """``tree`` with its tensors and floats replaced, in ``flatten``'s order,
    by ``tensors`` and ``floats``."""
    tensors, floats = iter(tensors), iter(floats)

    def walk(x):
        if isinstance(x, torch.Tensor):
            return next(tensors)
        if isinstance(x, float):
            return next(floats)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        names = _fields(type(x))
        if names is not None:
            return dataclasses.replace(x, **{n: walk(getattr(x, n)) for n in names})
        if hasattr(x, "_fields"):
            return x._make(map(walk, x))
        if isinstance(x, (tuple, list)):
            return type(x)(map(walk, x))
        return x

    return walk(tree)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` grouped by (device, dtype), in order: a
    ``_foreach`` op takes its fast path only within one group."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return list(groups.values())


def clone_into_one_buffer(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Contiguous clones of ``tensors``, each a view of one fresh buffer a
    (device, dtype): one allocation and one grouped copy a dtype instead of
    a clone each."""
    out: List[torch.Tensor] = list(tensors)
    for idx in _by_dtype(tensors):
        sizes = [tensors[i].numel() for i in idx]
        flat = torch.empty(sum(sizes), dtype=tensors[idx[0]].dtype, device=tensors[idx[0]].device)
        views = [v.view(tensors[i].shape) for v, i in zip(flat.split(sizes), idx)]
        torch._foreach_copy_(views, [tensors[i] for i in idx])
        for i, v in zip(idx, views):
            out[i] = v
    return out


class StepGraph:
    """``fn(*args)`` captured as a CUDA graph on static copies of its inputs.

    Built at the first call of its key: it copies the inputs, runs the step
    once on a side stream on those copies (its lazy set-up: libraries,
    handles, cached constants; the results are thrown away and the caller's
    tensors are never written), then captures it in ``pool`` (None: a pool
    of its own). Scalars go through two pinned buffers in turn, one
    rewritten only after its last copy ran."""

    def __init__(self, name: str, fn: Callable, args: tuple, pool=None):
        tensors, floats, _ = flatten(args)
        dev = tensors[0].device
        self.name = name
        self.inputs = [t.clone() for t in tensors]
        self.groups = _by_dtype(self.inputs)
        self.scalars = torch.zeros(len(floats), dtype=torch.float64, device=dev)
        self.host = [torch.zeros(len(floats), dtype=torch.float64, pin_memory=True)
                     for _ in range(2)]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.turn = 0
        self._load_scalars(floats)
        static = rebuild(args, self.inputs, self.scalars.unbind())

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = log.counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.result = fn(*static)
        self.outputs = flatten(self.result)[0]
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

    def __call__(self, tensors: Sequence[torch.Tensor], floats: Sequence[float]):
        with log.span("replay"):
            for idx in self.groups:
                torch._foreach_copy_([self.inputs[i] for i in idx], [tensors[i] for i in idx])
            self._load_scalars(floats)
            self.graph.replay()
        for k, n in self.counts.items():
            log.count(k, n)
        log.count(f"{self.name}.replay")
        return rebuild(self.result, clone_into_one_buffer(self.outputs), ())


class Graphs:
    """The captures of one step object, by key, sharing one memory pool. A
    replay may write what another capture of the pool left in it, which is
    safe because every replay's outputs are cloned before the next replay
    runs, and the graphs run on one stream, one at a time."""

    def __init__(self, name: str):
        self.name = name
        self.graphs: Dict[tuple, StepGraph] = {}
        self.pool = None

    def __call__(self, fn: Callable, args: tuple, extra_key: tuple):
        """``fn(*args)``, replayed from the capture of its key: ``args``' key
        (``flatten``) and ``extra_key``, what ``fn`` closes over that
        changes what it launches."""
        tensors, floats, key = flatten(args)
        key = (extra_key, key)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = StepGraph(self.name, fn, args, self.pool)
            if self.pool is None:
                self.pool = graph.graph.pool()
        return graph(tensors, floats)
