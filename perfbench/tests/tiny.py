"""Tiny CPU copies of the benchmark's cells: a checkout in a temporary
directory holding ``BENCHMARK.json`` and ``perfbench/``, with each cell's
configuration cut to a few faces, a 32² texture and 96×128 frames, added as
cells of their own (``<cell>.tiny``)."""
from __future__ import annotations

import io
import json
import shutil
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {"texture_size": 32, "sh_degree": 1}
GARMENT = {"nx": 8, "ny": 8}
BODY = {"rings": 10, "segments": 12}
RIG = {"rings": 2, "per_ring": 4, "width": 96, "height": 128, "focal": 180.0}
TRAFFIC = {"frames": 2, "cameras": 3, "trace_steps": 3, "block": [5, 2], "block_offset": 3}


def checkout(tmp: Path) -> Path:
    """A checkout with a tiny twin of every cell; returns its root."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell in list(bench["workloads"]):
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        cfg = json.loads((REPO / conf["file"]).read_text())
        for k, v in TINY.items():
            if k in cfg:
                cfg[k] = v
        cfg["garment"].update(GARMENT)
        cfg["body"].update(BODY)
        cfg["rig"].update(RIG)
        if "extra" in cfg.get("splats", {}):
            cfg["splats"]["extra"] = 20
        if "bake" in cfg:
            cfg["bake"]["rays"] = 8
        name = cell["name"] + ".tiny"
        cfile = f"perfbench/configs/{conf['name']}.tiny.json"
        (root / cfile).write_text(json.dumps(cfg))
        traffic = json.loads((REPO / "perfbench/traffic" / f"{cell['traffic']}.json").read_text())
        traffic.update({k: v for k, v in TRAFFIC.items() if k in traffic})
        (root / "perfbench/traffic" / f"{cell['traffic']}.tiny.json").write_text(
            json.dumps(traffic))
        limits = REPO / "perfbench/limits" / f"{cell['name']}.json"
        shutil.copy(limits, root / "perfbench/limits" / f"{name}.json")
        if not any(c["name"] == conf["name"] + ".tiny" for c in bench["configs"]):
            bench["configs"].append({**conf, "name": conf["name"] + ".tiny", "file": cfile})
        bench["workloads"].append({**cell, "name": name, "config": conf["name"] + ".tiny",
                                   "traffic": cell["traffic"] + ".tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run(root: Path, argv, fault=None):
    """(rc, stdout lines, stderr) of one CPU run of the harness."""
    import torch

    sys.path.insert(0, str(REPO))
    from perfbench.harness.bench import main

    torch.set_num_threads(4)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv, t_process=time.perf_counter(), device=torch.device("cpu"), fault=fault,
                  out=out, root=root)
    return rc, out.getvalue().splitlines(), err.getvalue()


def cells() -> list:
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
