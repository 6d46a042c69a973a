"""What the program's spans cost and what they find, on one cell:

    python3 perfbench/probe_spans.py --workload <cell> --seed <n> [--turns 4] [--steps 20]

from the root of a checkout, on the card. Prints one JSON line:

- ``loop_us``: a loop of 10^6 on the host, per pass, empty, entering a span
  that is off, and counting;
- ``walls_ms``: the mean step wall (each step ending in a synchronize) with
  the spans off and with ``enable()`` (recording, no profiler), in turns;
- from the harness's traced window: ``offsets_us`` (the record clock against
  the trace clock at the starts, which align the records, and at the ends of
  the window's roots, each from its median, and their spread), ``self_ms`` (host
  self time a step of each span), ``idle_ms`` (the device's idle time a
  step, split among the innermost spans open over it; ``-`` is outside the
  program's step), ``step_ms`` (the program's ``step`` span in the trace,
  a step) and ``self_sum_over_step`` (the self times' sum over it).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def loop_us(L, n: int = 10 ** 6, repeats: int = 5) -> dict:
    """µs a pass of each loop: the least and the median of ``repeats``."""
    out = {}
    for name in ("empty", "span_off", "count"):
        runs = []
        for _ in range(repeats):
            t = time.perf_counter()
            if name == "empty":
                for _ in range(n):
                    pass
            elif name == "span_off":
                for _ in range(n):
                    with L.span("probe"):
                        pass
            else:
                for _ in range(n):
                    L.count("probe")
            runs.append((time.perf_counter() - t) / n * 1e6)
        out[name] = {"min": min(runs), "median": statistics.median(runs)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal, with --root")
    p.add_argument("--root", default=str(ROOT), help="the checkout to read the cell from")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gaussian_garments_tpu_torch.utils import logging as L
    from perfbench.harness import bench, spans

    root = Path(args.root)
    cell = bench.load_cell(args.workload, root)
    dev = torch.device(args.device)
    res = {"cell": args.workload, "loop_us": loop_us(L),
           "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    entry = bench.make_entry(cell, args.seed, dev, root)
    entry.setup()
    walls = {"off": [], "enable": []}
    for _ in range(args.turns):
        for mode in walls:
            if mode == "enable":
                L.enable()
            walls[mode].append(bench.measured_steps(entry, args.steps, dev) * 1e3)
            L.disable()
            L.reset()
    res["walls_ms"] = walls
    res["walls_mean_ms"] = {k: statistics.mean(v) for k, v in walls.items()}
    with tempfile.TemporaryDirectory() as tmp:
        w = bench.traced_window(entry, cell.traffic["trace_steps"], cell.traffic["spans"], dev,
                                tmp)
    run = SimpleNamespace(trace=w.trace)
    sw = spans.window(run)
    roots = [r for r in sw.recs if r.parent < 0 and r.step in sw.steps]
    ends = [r.t1_ns * 1e-3 - b for r, (_, b) in zip(roots, spans.twins(w.trace))]
    res["offsets_us"] = {k: {"spread": max(v) - min(v),
                             "from_median": [x - statistics.median(v) for x in v]}
                         for k, v in (("starts", sw.offsets), ("ends", ends))}
    res["self_ms"] = spans.self_ms(run)
    res["idle_ms"] = spans.idle_ms(run)
    res["idle_unspanned_pct"] = spans.idle_unspanned_pct(run)
    res["host_syncs_per_step"] = spans.count_per_step(run, "host_syncs")
    inner = spans.twins(w.trace)
    res["step_ms"] = sum(b - a for a, b in inner) * 1e-3 / len(inner)
    res["self_sum_over_step"] = sum(res["self_ms"].values()) / res["step_ms"]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
