"""Per-step scalar logging, spans and counters, and the stage-2 debug panel
(port of ``gaussian_garments_tpu/utils/logging.py``; the reference's
observability is tqdm postfix dicts and debug renders,
``s2_registration.py:65-78,98-122``).

- ``MetricLogger``: cumulative averages like the reference's logger, plus an
  append-only JSONL stream;
- ``span`` and ``count``: named host spans at the layer boundaries of the
  s2 and s3 steps, and process-wide event counters (below);
- ``PhaseSplit``: host-clock seconds of each run of each phase, with a device
  synchronize around each (the stage-1 split);
- ``shaded_mesh_image`` and ``debug_panel``: GT | penalized mask | render |
  abs-diff | shaded mesh, the stage-2 saver's panel.

Spans record only while a ``torch.profiler`` session runs or after
``enable()``. Off, ``span`` returns one shared null context after reading
a flag. On, a span enters ``torch.profiler.record_function`` (when the
profiler runs), so it shows in the trace under its name, and appends a
``Record`` stamped with ``time.time_ns()``, the clock of the profiler's
exported ``ts · 1e3 + baseTimeNanoseconds``. A span opened with no span open
is a root: the step index of the spans inside it. Spans nest on one thread.
``count`` adds to a process-wide total always, and, while a root span is
open, to that step's counts. Records stay in memory until ``reset``. The
port counts ``host_syncs`` (``sync`` spans), ``composite_fwd.launches`` and
``composite_bwd.launches`` (``ops/tiles``), and ``s2_graph.capture``,
``s2_graph.replay``, ``s3_graph.capture`` and ``s3_graph.replay`` (the s2
and s3 steps' CUDA graphs, ``training/graph``).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch.autograd.profiler as _profiler
from torch.profiler import record_function


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None):
        self.sums: Dict[str, float] = {}
        self.count = 0
        self._f = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._f = open(jsonl_path, "a")

    def log(self, step: int, scalars: Dict[str, float], **extra):
        vals = {k: float(v) for k, v in scalars.items()}
        self.count += 1
        for k, v in vals.items():
            self.sums[k] = self.sums.get(k, 0.0) + v
        if self._f is not None:
            rec = {"step": int(step), **vals,
                   **{k: (v if isinstance(v, str) else float(v)) for k, v in extra.items()},
                   "time": time.time()}
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return self.averages()

    def averages(self) -> Dict[str, float]:
        """Cumulative averages (the reference's tqdm postfix)."""
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}

    def close(self):
        if self._f is not None:
            self._f.close()


class Record(NamedTuple):
    """One span: ``parent`` is the index in ``records()`` of the span it
    opened in (-1 for a root), ``step`` the index of its root; ``t1_ns`` is
    None while it is open."""

    name: str
    parent: int
    step: int
    t0_ns: int
    t1_ns: Optional[int]


_enabled = False
_records: List[list] = []
_stack: List[int] = []
_step_counts: List[Dict[str, int]] = []
_totals: Dict[str, int] = {}
_count_lock = threading.Lock()     # the compositor's backward counts on autograd's thread
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "i", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = record_function(self.name) if _profiler._is_profiler_enabled else None
        if self.rf is not None:
            self.rf.__enter__()
        parent = _stack[-1] if _stack else -1
        if parent < 0:
            _step_counts.append({})
        self.i = len(_records)
        _records.append([self.name, parent, len(_step_counts) - 1, time.time_ns(), None])
        _stack.append(self.i)
        return self

    def __exit__(self, *exc):
        _records[self.i][4] = time.time_ns()
        _stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records the span ``name`` (see the module doc)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to the total ``name``, and to the open step's count."""
    with _count_lock:
        _totals[name] = _totals.get(name, 0) + n
        if _stack:
            c = _step_counts[-1]
            c[name] = c.get(name, 0) + n


def records() -> List[Record]:
    return [Record(*r) for r in _records]


def counters(step: Optional[int] = None) -> Dict[str, int]:
    """The process-wide totals, or with ``step`` the counts of that root span."""
    return dict(_totals if step is None else _step_counts[step])


def reset():
    """Forget every record and count. Not inside a span."""
    _records.clear()
    _stack.clear()
    _step_counts.clear()
    _totals.clear()


def enable():
    """Record spans without a profiler session."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def self_times(recs: Optional[List[Record]] = None, steps=None) -> Dict[str, int]:
    """Nanoseconds per span name of the closed spans of ``recs`` (default
    ``records()``; parents index into it) whose step is in ``steps`` (default
    every step): each span's duration less what its children cover."""
    recs = records() if recs is None else recs
    out: Dict[str, int] = {}
    for r in recs:
        if r.t1_ns is None or (steps is not None and r.step not in steps):
            continue
        d = r.t1_ns - r.t0_ns
        out[r.name] = out.get(r.name, 0) + d
        if r.parent >= 0:
            parent = recs[r.parent].name
            out[parent] = out.get(parent, 0) - d
    return out


class PhaseSplit:
    """Host-clock seconds of every run of each named phase. With a CUDA
    ``device``, each phase starts and ends with a synchronize, so the
    device work it queued counts in it. ``times[name]`` lists the runs."""

    def __init__(self, device=None):
        self.device = device
        self.times: Dict[str, list] = {}

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.times.setdefault(name, []).append(time.perf_counter() - t0)


def phase(split: Optional[PhaseSplit], name: str):
    """``split.phase(name)``, or a null context without a split."""
    return contextlib.nullcontext() if split is None else split.phase(name)


def shaded_mesh_image(verts, faces, camera, body_v=None, body_f=None) -> np.ndarray:
    """Flat-shaded render of the tracked garment (tinted blue) over the body
    (grey), depth-correct by rasterizing both meshes together on the camera's
    device: the role of the reference saver's aitviewer column
    (s2_registration.py:40-62,110-113). Returns (3,H,W) in [0,1] on a white
    background."""
    import torch

    from gaussian_garments_tpu_torch.ops.mesh_raster import rasterize_mesh

    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    n_garment = len(f)
    if body_v is not None and len(body_v):
        f = np.concatenate([f, np.asarray(body_f, np.int64) + len(v)])
        v = np.concatenate([v, np.asarray(body_v, np.float32)])
    dev = camera.world_view_transform.device
    with torch.no_grad():
        p2f, _ = rasterize_mesh(torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev),
                                camera.world_view_transform, camera.full_proj_transform,
                                image_width=camera.image_width, image_height=camera.image_height)
    p2f = p2f.cpu().numpy()

    normals = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    view = camera.camera_center.cpu().numpy()[None] - v[f].mean(axis=1)
    view /= np.maximum(np.linalg.norm(view, axis=1, keepdims=True), 1e-12)
    shade = 0.3 + 0.7 * np.abs((normals * view).sum(axis=1))          # headlight
    tint = np.where((np.arange(len(f)) < n_garment)[:, None],
                    np.array([[0.55, 0.70, 1.00]]), np.array([[0.80, 0.80, 0.80]]))
    face_rgb = shade[:, None] * tint

    img = np.ones((camera.image_height, camera.image_width, 3), np.float32)
    hit = p2f >= 0
    img[hit] = face_rgb[p2f[hit]]
    return img.transpose(2, 0, 1)


def debug_panel(gt_image: np.ndarray, penalized_mask: np.ndarray, render: np.ndarray,
                path: Optional[str] = None, mesh_render: Optional[np.ndarray] = None) -> np.ndarray:
    """GT | penalized mask | render | abs-diff [| shaded mesh] row panel
    (s2_registration.py:98-122). Inputs (3,H,W)/(1,H,W) in [0,1]."""
    gt = np.asarray(gt_image).transpose(1, 2, 0)
    rd = np.clip(np.asarray(render), 0, 1).transpose(1, 2, 0)
    mask = np.repeat(np.asarray(penalized_mask).transpose(1, 2, 0), 3, axis=2)
    cols = [gt, mask, rd, np.abs(gt - rd)]
    if mesh_render is not None:
        cols.append(np.clip(np.asarray(mesh_render), 0, 1).transpose(1, 2, 0))
    panel = np.concatenate(cols, axis=1)
    if path is not None:
        from gaussian_garments_tpu_torch.utils.io import save_image

        save_image(path, panel)
    return panel
