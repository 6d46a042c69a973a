"""Arithmetic that the metric readers share. A reader that finds nothing to
read returns None, and its metric is left out of the line."""
from __future__ import annotations

from perfbench.harness import trace as tr

# H100 SXM data sheet, dense float32 outside the tensor cores
F32_PEAK_FLOP_S = 67e12


def rate(run):
    """Completed steps over the window: from its start to the end of the
    last step."""
    return run.steps / run.window_s if run.steps else None


def p95_ms(run):
    """Nearest-rank 95th percentile of every step's wall time."""
    w = sorted(run.walls)
    if not w:
        return None
    return w[max(0, -(-95 * len(w) // 100) - 1)] * 1e3


def idle_pct(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - tr.busy_s(run.trace) / tr.window_s(run.trace))


def kernels_per_step(run):
    if run.trace is None or not run.steps:
        return None
    return len(run.trace.device) / run.steps


def roofline_pct(run, kernel: str, counter: str):
    """The counted work's least time over the kernel's mean device time
    per step, in percent."""
    if run.trace is None or counter not in run.counters:
        return None
    times = tr.kernels(run.trace, kernel)
    if not times:
        return None
    per_step = sum(times) / run.steps
    return 100.0 * run.counters[counter]["least_s"] / per_step


def mfu_pct(run):
    """The step's counted FLOPs over (the mean wall of the steps timed
    without the profiler just before the traced ones × the float32 peak),
    in percent."""
    if "step_flops" not in run.counters or not run.plain_step_s:
        return None
    return 100.0 * run.counters["step_flops"] / (run.plain_step_s * F32_PEAK_FLOP_S)
