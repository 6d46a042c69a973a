"""The benchmark's run, driven by ``BENCHMARK.json`` and the files it names.

A cell names a configuration (a JSON file of sizes) and a traffic mix
(``perfbench/traffic/<traffic>.json``), whose ``entry`` names the module
under ``perfbench/entries/`` that drives the program's entry point and holds
its reference check. Each metric is read by ``perfbench/metrics/<name>.py``;
each cell's limits are in ``perfbench/limits/<cell>.json``. Nothing here
names a cell, a configuration or a metric.

One run: set-up (inputs from the seed, the program built and warmed, its
first steps checked later against the reference), then either the measured
window (``--trace 0``: every step timed on the host clock, each ending in a
synchronize, until ``--seconds`` have passed) or the traced window
(``--trace 1``: the traffic's ``trace_steps`` steps timed without the
profiler, whose mean wall the whole-step shares read, then as many under
``torch.profiler``),
then, with the program's state freed, the reference check, and the result
line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gaussian_garments_tpu")
ROOT = Path(__file__).resolve().parents[2]


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_file_{path.stem}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    applies = lambda m: name in m.get("workloads", [name])
    return SimpleNamespace(
        name=name, chips=cell["chips"], bench=bench,
        cfg=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        limits=json.loads((root / "perfbench" / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def make_entry(cell, seed: int, device, root: Path = ROOT):
    mod = load_module(root / "perfbench" / "entries" / f"{cell.traffic['entry']}.py")
    return mod.Entry(cell.cfg, cell.traffic, seed, device)


def read_metrics(metrics: list, run, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds a value."""
    out = {}
    for m in metrics:
        v = load_module(root / "perfbench" / "metrics" / f"{m['name']}.py").read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _sync(device):
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()


def measured_window(entry, seconds: float, device) -> SimpleNamespace:
    walls = []
    first = entry.n
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        entry.step()
        _sync(device)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        if t1 - t_start >= seconds:
            break
    return SimpleNamespace(start=t_start, first=first, steps=len(walls), walls=walls,
                           window_s=t1 - t_start, trace=None)


def traced_window(entry, n_steps: int, spans: list, device, tmpdir: str) -> SimpleNamespace:
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.harness import trace as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    # the profiler slows every launch; the step's own wall is taken first
    plain = measured_steps(entry, n_steps, device)
    walls = []
    first = entry.n
    with profile(activities=acts) as prof:
        t_start = time.perf_counter()
        for _ in range(n_steps):
            t0 = time.perf_counter()
            with record_function(spans[0]):
                entry.step()
                _sync(device)
            walls.append(time.perf_counter() - t0)
        t_end = time.perf_counter()
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    t = tr.load(path, spans)
    os.remove(path)
    return SimpleNamespace(start=t_start, first=first, steps=n_steps, walls=walls,
                           window_s=t_end - t_start, trace=t, plain_step_s=plain)


def measured_steps(entry, n_steps: int, device) -> float:
    """The mean wall of ``n_steps`` steps, each ending in a synchronize,
    timed as one stretch on the host clock."""
    t0 = time.perf_counter()
    for _ in range(n_steps):
        entry.step()
        _sync(device)
    return (time.perf_counter() - t0) / n_steps


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "at"}}, in the limits' order."""
    return {k: {"value": numbers[k][0], "limit": limits[k], "at": numbers[k][1]} for k in limits}


def parse(argv):
    p = argparse.ArgumentParser(description="run one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, t_process: float, device=None, fault=None, out=sys.stdout,
         root: Path = ROOT) -> int:
    """Run a cell and print its result line. ``device``, ``fault`` and
    ``root`` are for tests: a CPU run skips the look for a card, ``fault``
    wraps the program's step, ``root`` is a checkout to read the cell from."""
    args = parse(argv)
    cell = load_cell(args.workload, root)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    entry = make_entry(cell, args.seed, device, root)
    t_entry = time.perf_counter()
    entry.setup(fault=fault)
    _sync(device)
    setup_s = time.perf_counter() - t_process
    parts = {"start": t_entry - t_process, **entry.setup_parts}
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()), file=sys.stderr)
    with tempfile.TemporaryDirectory() as tmp:
        if args.trace:
            w = traced_window(entry, cell.traffic["trace_steps"], cell.traffic["spans"], device,
                              tmp)
        else:
            w = measured_window(entry, args.seconds, device)
    dev_info = device_info(device)     # the peak before the reference runs
    failed = entry.failed_in(w.first, w.steps)
    entry.close()
    numbers = entry.check(entry.reference())
    checks = judge(numbers, cell.limits)
    counters = entry.counters(w.first, w.steps) if args.trace else {}
    run = SimpleNamespace(setup_s=setup_s, steps=w.steps, walls=w.walls, window_s=w.window_s,
                          trace=w.trace, counters=counters,
                          plain_step_s=getattr(w, "plain_step_s", None))
    metrics = read_metrics(cell.per_layer if args.trace else cell.end_to_end, run, root)
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": w.steps, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if args.trace:
        from perfbench.harness import trace as tr

        result["device"]["busy_s"] = tr.busy_s(w.trace)
        result["device"]["window_s"] = tr.window_s(w.trace)
        result["breakdown"] = {"device_ops": tr.top_ops(w.trace), "idle_gaps": tr.idle_gaps(w.trace)}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    found = forbidden_modules()
    if found:
        print(f"JAX modules loaded in the run: {found}", file=sys.stderr)
        return 4
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r}; worst at {c['at']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
