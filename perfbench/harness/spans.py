"""The program's own spans and counters, read after a traced window.

The port records a span (``gaussian_garments_tpu_torch.utils.logging``)
only while ``torch.profiler`` runs, so its records are those of the traced
steps. Each recorded root span ``step`` has a twin in ``run.trace.spans``:
the program's ``step`` span, nested in the harness's. The records are put
on the trace's clock by the median offset between the starts of each root
and its twin;
"per step" means per recorded root. A program that records no spans (a
checkout without them) gives None everywhere here, and the metrics that
read it are left out of the line.
"""
from __future__ import annotations

import statistics
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

from perfbench.harness import trace as tr

ROOT = "step"


def _port():
    try:
        from gaussian_garments_tpu_torch.utils import logging as L
    except ImportError:
        return None
    return L if hasattr(L, "records") and hasattr(L, "self_times") else None


def twins(t: tr.Trace) -> List[Tuple[float, float]]:
    """The ``step`` spans of the trace that lie inside another one."""
    out, outer = [], None
    for a, b, n in sorted(t.spans, key=lambda x: (x[0], -x[1])):
        if n != ROOT:
            continue
        if outer is not None and outer[0] <= a and b <= outer[1]:
            out.append((a, b))
        else:
            outer = (a, b)
    return out


def window(run) -> Optional[SimpleNamespace]:
    """The window's records: ``recs`` (every record, for the parent
    indices), ``steps`` (the window's step indices), ``offsets`` (µs,
    record clock − trace clock, per root), ``offset`` (their median), or
    None."""
    if run.trace is None:
        return None
    if hasattr(run, "_port_spans"):
        return run._port_spans
    w = None
    L = _port()
    inner = twins(run.trace)
    if L is not None and inner:
        recs = L.records()
        roots = [r for r in recs if r.parent < 0 and r.name == ROOT and r.t1_ns is not None]
        if len(roots) >= len(inner):
            roots = roots[len(roots) - len(inner):]
            offsets = [r.t0_ns * 1e-3 - a for r, (a, _) in zip(roots, inner)]
            w = SimpleNamespace(L=L, recs=recs, steps={r.step for r in roots}, offsets=offsets,
                                offset=statistics.median(offsets))
    run._port_spans = w
    return w


def self_ms(run) -> Optional[Dict[str, float]]:
    """Host self time a step (ms) of each span name."""
    w = window(run)
    if w is None:
        return None
    return {k: v * 1e-6 / len(w.steps) for k, v in w.L.self_times(w.recs, w.steps).items()}


def ms_per_step(run, name: str) -> Optional[float]:
    s = self_ms(run)
    return None if s is None or name not in s else s[name]


def count_per_step(run, name: str) -> Optional[float]:
    w = window(run)
    if w is None:
        return None
    return sum(w.L.counters(s).get(name, 0) for s in w.steps) / len(w.steps)


def _innermost(w) -> List[Tuple[float, float, str]]:
    """Disjoint (start, end, name) on the trace clock (µs): at each moment
    inside a root, the innermost span open."""
    kids, roots = {}, []
    for i, r in enumerate(w.recs):
        if r.step in w.steps and r.t1_ns is not None:
            (roots if r.parent < 0 else kids.setdefault(r.parent, [])).append(i)
    at = lambda ns: ns * 1e-3 - w.offset
    out = []

    def walk(i):
        r = w.recs[i]
        cur = at(r.t0_ns)
        for j in kids.get(i, []):
            a = at(w.recs[j].t0_ns)
            if a > cur:
                out.append((cur, a, r.name))
            walk(j)
            cur = max(cur, at(w.recs[j].t1_ns))
        if at(r.t1_ns) > cur:
            out.append((cur, at(r.t1_ns), r.name))

    for i in roots:
        walk(i)
    return sorted(out)


def idle_ms(run) -> Optional[Dict[str, float]]:
    """The device's idle time in the traced window (ms a step), split among
    the innermost spans open over it; ``-`` is outside the program's step."""
    w = window(run)
    if w is None:
        return None
    t = run.trace
    busy = tr.union(t.device)
    idle, cur = [], t.start
    for a, b in busy:
        if a > cur:
            idle.append((cur, a))
        cur = max(cur, b)
    if t.end > cur:
        idle.append((cur, t.end))
    segs = _innermost(w)
    out: Dict[str, float] = {}
    j = 0
    for a, b in idle:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            o = min(b, segs[k][1]) - max(a, segs[k][0])
            if o > 0:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + o
                covered += o
            k += 1
        out["-"] = out.get("-", 0.0) + (b - a) - covered
    return {k: v * 1e-3 / len(w.steps) for k, v in out.items()}


def idle_unspanned_pct(run) -> Optional[float]:
    """The share of the device's idle time during which the host was in no
    layer span: in the root's own self time or outside the program's step."""
    d = idle_ms(run)
    if d is None or sum(d.values()) <= 0:
        return None
    return 100.0 * (d.get(ROOT, 0.0) + d.get("-", 0.0)) / sum(d.values())
