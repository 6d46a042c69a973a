"""Reading a ``torch.profiler`` chrome trace: the device's busy intervals,
kernels by name, and idle gaps named by what the host was doing.

Device activity is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; busy time is the length of the union of their intervals
inside the traced window (not the sum of their durations, which counts
overlap twice)."""
from __future__ import annotations

import json
from typing import List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace(NamedTuple):
    start: float                              # µs, the traced window
    end: float
    device: List[Tuple[float, float, str]]    # (start, end, name) inside the window
    spans: List[Tuple[float, float, str]]     # the benchmark's own host spans
    host_ops: List[Tuple[float, float, str]]  # CPU ops and runtime calls


def load(path, span_names) -> Trace:
    """The window runs from the first to the last host span named in
    ``span_names``' first entry (the step span)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    dev, spans, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d, cat, name = float(e["ts"]), float(e["dur"]), e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((s, s + d, name))
        elif cat == "user_annotation" and name in span_names:
            spans.append((s, s + d, name))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            ops.append((s, s + d, name))
    steps = [x for x in spans if x[2] == span_names[0]]
    if not steps:
        raise RuntimeError("the trace holds no step span")
    start, end = min(x[0] for x in steps), max(x[1] for x in steps)
    dev = [(max(a, start), min(b, end), n) for a, b, n in dev if b > start and a < end]
    return Trace(start, end, sorted(dev), sorted(spans), sorted(ops))


def union(iv) -> List[Tuple[float, float]]:
    out = []
    for a, b, *_ in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(t: Trace) -> float:
    return sum(b - a for a, b in union(t.device)) * 1e-6


def window_s(t: Trace) -> float:
    return (t.end - t.start) * 1e-6


def kernels(t: Trace, name_part: str) -> List[float]:
    """Durations (s) of the kernels whose name holds ``name_part``."""
    return [(b - a) * 1e-6 for a, b, n in t.device if name_part in n]


def top_ops(t: Trace, k: int = 10) -> list:
    tot = {}
    for a, b, n in t.device:
        tot[n] = tot.get(n, 0.0) + (b - a) * 1e-6
    return [[n[:120], s] for n, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def _innermost(iv, at: float) -> str:
    best = None
    for a, b, n in iv:
        if a > at:
            break
        if a <= at < b and (best is None or a >= best[0]):
            best = (a, n)
    return best[1] if best else ""


def idle_gaps(t: Trace, k: int = 10) -> list:
    """The ``k`` longest idle gaps, each named by the benchmark's span and
    the host op that was running when the device went idle."""
    u = union(t.device)
    edges = [(t.start, u[0][0])] if u else [(t.start, t.end)]
    edges += [(u[i][1], u[i + 1][0]) for i in range(len(u) - 1)]
    if u:
        edges.append((u[-1][1], t.end))
    gaps = sorted((g for g in edges if g[1] > g[0]), key=lambda g: g[0] - g[1])[:k]
    out = []
    for a, b in gaps:
        span = _innermost(t.spans, a) or "-"
        op = _innermost(t.host_ops, a) or "-"
        out.append([f"{span}/{op}"[:120], (b - a) * 1e-6])
    return out
