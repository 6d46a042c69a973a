"""The comparison that decides ``correct`` for a training cell.

The program's step object runs its first three steps in set-up, on three
different inputs, and a plain reference follows them. Readings: each step's
loss and, where an entry records them, the terms of step 1's loss; per leaf,
the norm of the first gradient as the optimizer holds it after step 1; per
leaf, the norm of the parameters' change after three steps. A leaf's is a
gap of norms, |‖program‖ − ‖reference‖|, relative to the
larger of the leaf's reference norm and the median leaf's. The change leaves
out leaves whose reference gradient is under a thousandth of the median
leaf's: Adam moves those by round-off alone. A group of leaves that an entry
names (``readings["groups"]``) is also read on its own, against its own
median leaf, so that a fault confined to a few leaves is not lost in the
median of all.

The reference runs with cuDNN off: which algorithm cuDNN picks depends on
the state of the process, and its choice moved the reference's gradients by
as much as a TF32 control does.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch


class TrainingEntry:
    """What the harness asks of a training cell's entry module: ``setup``
    (inputs, the program, its first steps), ``step`` (one timed step),
    ``failed_in``, ``close`` (free the program), ``reference``, ``check``
    and ``counters``. Subclasses define ``setup``, ``_run(i)`` (step ``i``,
    appending its loss to ``losses``), ``reference`` and ``counters``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        self.n = 0              # steps run
        self.readings = {}      # the program's first steps, for ``check``
        self.losses = []
        self.setup_parts = {}

    def _mark(self, name: str, t0: float) -> float:
        """Record the seconds since ``t0`` as set-up part ``name``."""
        t = time.perf_counter()
        self.setup_parts[name] = t - t0
        return t

    def step(self):
        """One timed step; the loss read ends it on the host."""
        self._run(self.n)
        self.n += 1

    def failed_in(self, first: int, count: int) -> int:
        """Steps of the window whose loss is not finite."""
        return sum(1 for x in self.losses[first:first + count] if not np.isfinite(x))

    def close(self):
        """Free the program's state; keep its readings."""
        self.prog = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, ref: dict, prog: dict = None) -> dict:
        """``compare`` of ``prog`` (default: the program's readings) with
        ``ref``, reading the groups of leaves that the program's readings name."""
        return compare(self.readings if prog is None else prog, ref,
                       self.readings.get("groups", {}))


@contextlib.contextmanager
def reference_mode(tf32: bool, device):
    """The reference's backend: cuDNN off, so that convolutions run as
    matrix products whose result does not hang on an algorithm chosen by the
    process's state; TF32 matmuls on for the control, then off again."""
    cu = device.type == "cuda"
    if cu:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=False):
            yield
    finally:
        if cu:
            torch.backends.cuda.matmul.allow_tf32 = False


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.norm(v.detach().double())) for k, v in d.items()}


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """Per leaf of ``keys``: |‖prog‖ − ‖ref‖| / max(‖ref‖, the median
    ‖ref‖ of ``keys``)."""
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys} if med > 0 else {}


def _worst(gaps: dict) -> tuple:
    if not gaps:
        return float("nan"), "-"
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def _median(gaps: dict) -> tuple:
    if not gaps:
        return float("nan"), "-"
    return statistics.median(gaps.values()), f"median of {len(gaps)} leaves"


def compare(prog: dict, ref: dict, groups: dict = None) -> dict:
    """Every reading of the module doc, each with the step or leaf where it
    is worst: ``loss1`` the first step's loss, ``loss`` the worst of the
    three; ``grad`` the worst leaf's first gradient, ``grad_median`` the
    median leaf's; ``change`` the worst leaf's change after three steps,
    ``change_median`` the median leaf's; for each group ``g`` of
    ``groups`` ({name: leaf keys}), ``grad_g`` and ``change_g`` the worst leaf of the
    group against the group's median; for each term ``k`` of step 1's loss
    that both sides name (``terms1``), ``term1_k`` its relative gap. The
    cell's limits file says which are compared."""
    finite = all(np.isfinite(prog["loss"]))
    lg = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"])]
    bad = (float("inf"), "non-finite loss")
    keys = list(ref["g1"])
    grad = _gaps(prog["g1"], ref["g1"], keys)
    gn = _norms(ref["g1"])
    med = statistics.median(gn.values())
    change = _gaps(prog["change"], ref["change"], [k for k in keys if gn[k] >= 1e-3 * med])
    out = {"loss1": (lg[0], "step 1") if finite else bad,
           "loss": (max(lg), f"step {lg.index(max(lg)) + 1}") if finite else bad,
           "grad": _worst(grad), "grad_median": _median(grad),
           "change": _worst(change), "change_median": _median(change)}
    for k in set(prog.get("terms1", {})) & set(ref.get("terms1", {})):
        r = ref["terms1"][k]
        out[f"term1_{k}"] = (abs(prog["terms1"][k] - r) / max(abs(r), 1e-30), "step 1")
    for g, members in (groups or {}).items():
        out[f"grad_{g}"] = _worst(_gaps(prog["g1"], ref["g1"], members))
        out[f"change_{g}"] = _worst(_gaps(prog["change"], ref["change"], members))
    return out
