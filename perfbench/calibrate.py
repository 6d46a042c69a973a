"""Readings that the limits of a cell are set from: on each seed, the
program's numbers against the reference and the reference's seconds, the
numbers of a state left unchanged and, where the entry names groups of
leaves, of each group left untrained; and with ``--control`` the control's (the reference computed in
the nearest precision below the configuration's, TF32, in the program's
place) and, where a step renders a batch of cameras, those of the reference
that renders half of them; all in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds <first> <count> [--control <count>]

Prints one JSON line a seed. Needs the card. The benchmark's own runs do not
run this."""
import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, root)
    import torch

    from perfbench.harness.bench import load_cell, make_entry

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs=2, required=True)
    p.add_argument("--control", type=int, default=0, help="seeds (of the first) with a control")
    a = p.parse_args()
    cell = load_cell(a.workload)
    dev = torch.device("cuda", 0)
    first, count = a.seeds
    for k, seed in enumerate(range(first, first + count)):
        entry = make_entry(cell, seed, dev)
        entry.traffic = {**entry.traffic, "warmup_steps": 0}
        entry.setup()
        entry.close()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref = entry.reference()
        torch.cuda.synchronize()
        row = {"seed": seed, "ref_s": time.perf_counter() - t, "prog": entry.check(ref)}
        still = {**entry.readings, "change": {k: v * 0 for k, v in entry.readings["change"].items()}}
        row["unchanged_state"] = {k: v for k, v in entry.check(ref, still).items()
                                  if k.startswith("change")}
        for g, members in entry.readings.get("groups", {}).items():
            cut = {r: {k: v * 0 if k in members else v for k, v in entry.readings[r].items()}
                   for r in ("g1", "change")}
            row[f"untrained_{g}"] = {k: v for k, v in entry.check(ref, {**entry.readings, **cut})
                                     .items() if k.endswith("_" + g)}
        if k < a.control:
            row["control"] = entry.check(ref, entry.reference(tf32=True))
            if "half_batch" in entry.reference.__code__.co_varnames:
                row["half_batch"] = entry.check(ref, entry.reference(half_batch=True))
        print(json.dumps(row), flush=True)
        del entry, ref
        torch.cuda.empty_cache()
